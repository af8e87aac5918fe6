"""The traced window: one ``torch.profiler`` trace of a steady closed loop,
checked against the program's launch counter and read into a ``Reading``
that the per-layer metrics take their numbers from.

The trace on this card has lost launches. So a trace counts only where it
recorded every launch of the program's hand-written kernels that
``rrin_tpu_torch._build`` counted over the same window, bucket by bucket;
``Reading.complete`` says whether it did, and ``Reading.lost`` which
buckets it missed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from portbench import groups

# host spans the benchmark puts around the calls into the program
STEP_SPAN = "portbench.step"
FETCH_SPAN = "portbench.fetch"
WINDOW_SPAN = "portbench.window"
_LABELS = {STEP_SPAN: "host in Interpolator.step", FETCH_SPAN: "host in the result fetch"}


@dataclasses.dataclass
class Reading:
    steps: int
    window_s: float          # the traced window, host clock
    busy_s: float            # union of device operations inside the window
    enqueue_s: List[float]   # host seconds inside Interpolator.step, per step
    launches: Dict[str, int]  # the program's launch counter over the window
    events: List[Tuple[str, str, float, float]]  # (name, group, start s, end s)
    gaps: List[Tuple[str, float]]                # (host span, idle seconds)
    totals: Dict[str, float]                     # roofline.step_totals
    complete: bool
    lost: Dict[str, Tuple[int, int]]             # bucket -> (counted, traced)


def union_s(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds covered by the union of intervals, and the gaps between them."""
    busy, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None:
            busy, end = b - a, b
        elif a > end:
            gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def _label(t: float, spans: List[Tuple[str, float, float]]) -> str:
    for name, a, b in spans:
        if a <= t <= b:
            return _LABELS[name]
    return "host in the benchmark loop"


def read(prof, launches: Dict[str, int], steps: int, enqueue_s: List[float],
         totals: Dict[str, float], plain: bool) -> Reading:
    """The Reading of a finished profile ``prof`` of one window."""
    us = 1e-6
    dev, spans, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start * us, e.time_range.end * us
        if e.name.startswith("portbench.") and e.device_type != torch.autograd.DeviceType.CPU:
            continue  # the device's copy of a host span is no device work
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, groups.group(e.name, plain), a, b))
        elif e.name in _LABELS:
            spans.append((e.name, a, b))
        elif e.name == WINDOW_SPAN:
            window = (a, b)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    inside = [(n, g, max(a, window[0]), min(b, window[1])) for n, g, a, b in dev
              if b > window[0] and a < window[1]]
    busy, gaps = union_s([(a, b) for _, _, a, b in inside])
    traced: Dict[str, int] = {}
    for _, g, _, _ in inside:
        k = groups.bucket(g)
        if k is not None:
            traced[k] = traced.get(k, 0) + 1
    counted: Dict[str, int] = {}
    for key, n in launches.items():
        if n:
            k = groups.counter_bucket(key)
            counted[k] = counted.get(k, 0) + n
    lost = {k: (counted.get(k, 0), traced.get(k, 0)) for k in set(counted) | set(traced)
            if counted.get(k, 0) != traced.get(k, 0)}
    gap_list = sorted(((_label((a + b) / 2, spans), b - a) for a, b in gaps),
                      key=lambda g: -g[1])
    return Reading(steps=steps, window_s=window[1] - window[0], busy_s=busy,
                   enqueue_s=enqueue_s, launches=launches, events=inside, gaps=gap_list,
                   totals=totals, complete=not lost, lost=lost)


def breakdown(r: Reading, top: int = 10) -> Dict[str, list]:
    """The device operations by group that took most time, and the longest
    idle gaps by what the host was doing, in seconds over the window."""
    by: Dict[str, float] = {}
    for _, g, a, b in r.events:
        by[g] = by.get(g, 0.0) + (b - a)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[g, s] for g, s in ops],
            "idle_gaps": [[label, s] for label, s in r.gaps[:top]]}


def device_seconds(r: Reading, pick) -> Optional[float]:
    """Device seconds of the window's operations whose (name, group) ``pick``
    accepts; None where the trace is not complete."""
    if not r.complete:
        return None
    return sum(b - a for n, g, a, b in r.events if pick(n, g))
