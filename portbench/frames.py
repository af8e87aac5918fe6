"""The frame pairs a run serves: squares moving over a noisy gradient.

The scene is that of ``moving_squares`` in the repository's chip smoke
script: a colour gradient (x / W, y / H, 0.5) * 160 + 40 with Gaussian
noise of std 2, and eight squares of H/16 to H/5 pixels in random colours,
each moved between the two frames by up to H/60 + 2 pixels along y and x.
The squares are drawn on the host by numpy from the pair's seed; the
gradient, the noise and the rounding to uint8 run on ``device`` (a 4K pair
drawn on the host took 2 s), and the pairs are then copied to host memory.
The pool stays pageable numpy there, as a decoder hands frames over.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def pairs(seed: int, n: int, h: int, w: int, device: torch.device) -> np.ndarray:
    """``n`` uint8 frame pairs (n, 2, h, w, 3) from ``seed``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    base = torch.stack([xx / w, yy / h, torch.full_like(xx, 0.5)], dim=-1) * 160.0 + 40.0
    noise = torch.randn((n, h, w, 3), generator=gen, device=device, dtype=torch.float32)
    frames = (base + 2.0 * noise)[:, None].repeat(1, 2, 1, 1, 1)
    for i in range(n):
        for _ in range(8):
            size = int(rng.integers(h // 16, h // 5))
            y0 = int(rng.integers(0, h - size))
            x0 = int(rng.integers(0, w - size))
            dy, dx = (int(v) for v in rng.integers(-h // 60 - 2, h // 60 + 3, 2))
            color = torch.as_tensor(rng.integers(0, 256, 3), dtype=torch.float32).to(device)
            for shift in (0, 1):
                ys, xs = y0 + shift * dy, x0 + shift * dx
                frames[i, shift, max(ys, 0):max(ys + size, 0),
                       max(xs, 0):max(xs + size, 0)] = color
    return frames.round_().clamp_(0, 255).to(torch.uint8).cpu().numpy()


def pool(seed: int, traffic: dict, device: torch.device) -> List[np.ndarray]:
    """The run's steps' inputs: ``traffic["pool"]`` pairs grouped into
    batches of ``traffic["batch"]``, a list of (B, 2, H, W, 3) uint8
    arrays in pageable host memory."""
    n, b = traffic["pool"], traffic["batch"]
    if n % b:
        raise ValueError(f"pool {n} is no multiple of batch {b}")
    allp = pairs(seed, n, traffic["height"], traffic["width"], device)
    return [np.ascontiguousarray(allp[i:i + b]) for i in range(0, n, b)]
