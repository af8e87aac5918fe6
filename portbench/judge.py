"""Whether what the timed path produced is correct.

A run keeps a sample of its window's answers, drawn from the seed (a
reservoir, so every step of the window is equally likely to be in it), as
the uint8 results the loop fetched. Once the window has closed and the
program's state is freed, the plain reference (``portbench.reference``)
interpolates the same pool pairs from the same weights twice: in float32
without TF32, and in the precision the configuration states (its
``stated`` entry: bfloat16 operands, weights and U-Net outputs, and in an
int8 configuration the convs but the heads on 8-bit grids calibrated as the
program calibrates). Both are rounded to uint8 as the program rounds.

The number compared is ``off2_ratio``: over the sample, the values of the
program's answers that lie 2 or more levels of 255 off the float32
reference's, over the same count for the reference in the stated precision
(each count plus one). One level is the rounding of a value that lies near a
half; two or more takes an error of the arithmetic. How many values such an
error moves that far depends on the seed's frames and weights (how far the
flows move samples across the squares' edges) as much as on the arithmetic,
alike for every computation in one precision: the ratio takes the seed's
share out, and reads about 1 for a program that computes as the
configuration states. Summed over the sample, it rests on hundreds of values
or more where one answer holds a few dozen (see PERF.md for the readings
each limit was set from, and for the worst answer's ratio, which swung too
widely to be held to a limit). ``off2_pct``, the worst answer's share of
such values, is printed beside it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import rrin as ref


class Sampler:
    """A reservoir of ``n`` answers over the window's steps, drawn from
    ``seed``."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng([seed, 0x5A17])
        self.kept: List[Tuple[int, int, torch.Tensor]] = []

    def offer(self, i: int, j: int, out: torch.Tensor) -> None:
        if len(self.kept) < self.n:
            self.kept.append((i, j, out))
        else:
            r = int(self.rng.integers(0, i + 1))
            if r < self.n:
                self.kept[r] = (i, j, out)


def off2(got: np.ndarray, want: np.ndarray) -> int:
    """How many of ``got``'s values lie 2 or more levels off ``want``."""
    return int(np.count_nonzero(np.abs(got.astype(np.int16) - want.astype(np.int16)) >= 2))


def references(weights: dict, pool: List[np.ndarray], idx, config: dict, traffic: dict,
               device: torch.device, precision: dict = None) -> Dict[int, np.ndarray]:
    """The reference's uint8 frames of the pool batches ``idx`` (pool index
    -> (B, m, H, W, 3)): in float32 without TF32, or with ``precision``
    (``{"bits": b, "margin": m}``) in bfloat16 with the convs but the heads
    on ``b``-bit grids (none where ``b`` is 0), calibrated by absmax times
    ``m`` on the pool's first batch, which the program calibrates on."""
    ref.no_tf32()
    ranges, bits, lowp = None, 0, precision is not None
    if lowp and precision.get("bits"):
        bits = precision["bits"]
        ranges = ref.calibrate(weights, torch.from_numpy(pool[0]).to(device), config["model"],
                               precision["margin"])
    out = {}
    for j in sorted(set(idx)):
        x = torch.from_numpy(pool[j]).to(device)
        out[j] = ref.interpolate(weights, x, config["model"], traffic["exp"], traffic["mode"],
                                 ranges=ranges, bits=bits, lowp=lowp).cpu().numpy()
    return out


def compare(answers: List[Tuple[int, int, np.ndarray]], want: Dict[int, np.ndarray],
            stated: Dict[int, np.ndarray]) -> Dict:
    """``off2_ratio`` of the sampled ``answers`` against the float32
    reference ``want`` and the reference in the stated precision ``stated``,
    with the worst answer's ``off2_pct`` (each pair of a batch is one
    answer)."""
    n_got = n_stated = 0
    vals = []
    for i, j, got in answers:
        for b in range(got.shape[0]):
            n = off2(got[b], want[j][b])
            n_got += n
            n_stated += off2(stated[j][b], want[j][b])
            vals.append((100.0 * n / got[b].size, i, j, b))
    v, i, j, b = max(vals)
    return {"off2_ratio": (n_got + 1) / (n_stated + 1), "off2_values": n_got,
            "off2_values_stated": n_stated, "off2_pct": v, "answers": len(vals),
            "worst_step": i, "worst_pool": j, "worst_row": b}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """``correct`` and each number compared beside its limit."""
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    return all(numbers[k] <= lim for k, lim in limits.items()), checks
