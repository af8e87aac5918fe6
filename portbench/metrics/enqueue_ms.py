"""Host milliseconds a step spends inside ``Interpolator.step`` (the
benchmark's span around the call: the input copy, calibration or prepare
where due, and enqueueing the cascade), over the traced window."""


def read(r):
    return 1e3 * sum(r.enqueue_s) / len(r.enqueue_s) if r.enqueue_s else None
