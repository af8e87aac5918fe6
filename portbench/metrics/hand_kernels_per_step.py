"""Launches a step of the program's hand-written kernels, by the program's
own launch counter (``rrin_tpu_torch._build.launch_counts``) over the traced
window."""


def read(r):
    return sum(r.launches.values()) / r.steps if r.steps else None
