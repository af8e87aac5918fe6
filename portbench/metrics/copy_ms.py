"""Device milliseconds a step of copies between host and device memory
(the pair batch in, the frames out), from the trace."""

from portbench import groups, trace


def read(r):
    s = trace.device_seconds(r, lambda name, g: groups.is_host_copy(name))
    return None if s is None else 1e3 * s / r.steps
