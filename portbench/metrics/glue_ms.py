"""Device milliseconds a step of everything that is neither a hand-written
kernel of the program nor a copy between host and device: PyTorch's
elementwise kernels, concatenations, resamples, device copies and memsets."""

from portbench import groups, trace


def read(r):
    s = trace.device_seconds(
        r, lambda name, g: not groups.is_hand_written(g) and not groups.is_host_copy(name))
    return None if s is None else 1e3 * s / r.steps
