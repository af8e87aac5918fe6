"""2x average-pool and 2x bilinear upsample on NHWC tensors.

The exact-2x half-pixel bilinear upsample has fixed weights {0.25, 0.75}
per output row/column parity, so it is written as shifted adds and an
interleave; this equals ``F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)`` and rounds at the same points as the JAX package's
``ops/resize.py`` in every dtype.
"""

from __future__ import annotations

import torch


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool on NHWC. H and W must be even."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return (x[:, :, 0, :, 0] + x[:, :, 0, :, 1]
            + x[:, :, 1, :, 0] + x[:, :, 1, :, 1]) * 0.25


def _upsample_2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Double one spatial axis with half-pixel bilinear weights.

    Output position 2k   samples src k - 0.25 -> 0.25*x[k-1] + 0.75*x[k]
    Output position 2k+1 samples src k + 0.25 -> 0.75*x[k]   + 0.25*x[k+1]
    with edge clamping.
    """
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    stacked = torch.stack([even, odd], dim=axis + 1)  # (..., L, 2, ...)
    new_shape = list(x.shape)
    new_shape[axis] *= 2
    return stacked.reshape(new_shape)


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample on NHWC, align_corners=False semantics."""
    x = _upsample_2x_axis(x, axis=1)
    x = _upsample_2x_axis(x, axis=2)
    return x
