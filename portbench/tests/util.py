"""Small cells for the CPU: a cell of BENCHMARK.json at a tiny frame size."""

import torch

from portbench import spec


def tiny(name: str, height: int = 48, width: int = 80, pool_batches: int = 2) -> dict:
    parts = spec.cell(name)
    t = parts["traffic"]
    t.update(height=height, width=width, pool=t["batch"] * pool_batches, warm_steps=1,
             check_answers=4, trace_seconds=0.5)
    return parts


def cpu() -> torch.device:
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch.device("cpu")
