"""Pad spatial dims up to a multiple of 16 and crop back.

The four 2x pooling stages of each U-Net require H and W divisible by 16.
Padding is replicate-edge so the flow U-Net sees no fabricated dark border.
"""

from __future__ import annotations

from typing import Tuple

import torch


def padded_size(size: int, multiple: int = 16) -> int:
    return -(-size // multiple) * multiple


def _edge_pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate the last row/column of (..., H, W, C) ``ph``/``pw`` times."""
    if pw:
        x = torch.cat([x, x[..., :, -1:, :].expand(
            *x.shape[:-2], pw, x.shape[-1])], dim=-2)
    if ph:
        x = torch.cat([x, x[..., -1:, :, :].expand(
            *x.shape[:-3], ph, *x.shape[-2:])], dim=-3)
    return x


def pad_to_multiple(
    x: torch.Tensor, multiple: int = 16
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad NHWC (or HWC) ``x`` on the bottom/right to /multiple.

    Returns the padded tensor and the original (H, W) for :func:`unpad`.
    """
    h, w = x.shape[-3], x.shape[-2]
    ph = padded_size(h, multiple) - h
    pw = padded_size(w, multiple) - w
    if ph == 0 and pw == 0:
        return x, (h, w)
    return _edge_pad_hw(x, ph, pw), (h, w)


def unpad(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Crop NHWC (or HWC) ``x`` back to the original (H, W)."""
    h, w = hw
    return x[..., :h, :w, :]
