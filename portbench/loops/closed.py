"""The closed loop: the next step is called at once, with at most
``in_flight`` steps enqueued behind the one whose result is being fetched,
as the program's video loop does with its ``max_in_flight``. The pool's
batches are served in turn."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from portbench.loops import Window
from portbench.trace import FETCH_SPAN, STEP_SPAN


def drive(step: Callable, pool: List[np.ndarray], traffic: dict,
          seconds: Optional[float] = None, steps: Optional[int] = None,
          sampler=None, spans: bool = False) -> Window:
    """Serve the pool for ``seconds`` (or ``steps`` steps); each result is
    fetched to host memory with ``.cpu()``. ``sampler.offer(i, j, out)``
    sees step ``i``'s result on the host, ``j`` its pool index. ``spans``
    marks each call and fetch for the profiler."""
    span = torch.profiler.record_function if spans else (lambda _: contextlib.nullcontext())
    in_flight = traffic["in_flight"]
    frames_per_step = traffic["batch"] * ((1 << traffic["exp"]) - 1)
    latency: List[float] = []
    enqueue: List[float] = []
    queue: collections.deque = collections.deque()

    def finish():
        i, j, t0, out = queue.popleft()
        with span(FETCH_SPAN):
            host = out.cpu()
        latency.append(time.perf_counter() - t0)
        if sampler is not None:
            sampler.offer(i, j, host)

    i = 0
    start = time.perf_counter()
    deadline = None if seconds is None else start + seconds
    while (steps is None or i < steps) and (deadline is None or time.perf_counter() < deadline):
        j = i % len(pool)
        t0 = time.perf_counter()
        with span(STEP_SPAN):
            out = step(pool[j])
        enqueue.append(time.perf_counter() - t0)
        queue.append((i, j, t0, out))
        i += 1
        while len(queue) > in_flight:
            finish()
    while queue:
        finish()
    return Window(steps=i, frames=i * frames_per_step, seconds=time.perf_counter() - start,
                  latency_s=latency, enqueue_s=enqueue)
