"""Device milliseconds a step of the program's conv kernels (K1, K5-K9, in
every precision; not their weight prep), from the trace."""

from portbench import groups, trace


def read(r):
    s = trace.device_seconds(r, lambda name, g: groups.is_conv(g))
    return None if s is None else 1e3 * s / r.steps
