"""Load generators, one module per kind of loop that a traffic file's
``loop`` names. Each has ``drive(step, pool, traffic, seconds=..., steps=...,
sampler=..., spans=...) -> portbench.loops.Window``."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Window:
    steps: int               # steps started, every one completed
    frames: int              # interpolated frames delivered to host memory
    seconds: float           # first step call to last result on the host
    latency_s: List[float]   # per step: its call to its uint8 result on the host
    enqueue_s: List[float]   # per step: host time inside the step call
