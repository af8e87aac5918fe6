"""Device kernels a step, all of them (the program's hand-written ones and
PyTorch's), from the trace; copies and memsets not counted."""


def read(r):
    if not r.complete:
        return None
    low = [name.lower() for name, _, _, _ in r.events]
    return sum(1 for n in low if "memcpy" not in n and "memset" not in n) / r.steps
