"""On-device synthetic triplet generator (training and eval data feed).

Vimeo-style linear-motion triplets: smooth random textures translated by a
per-sample subpixel motion, the middle frame exactly midway (the recipe of
:func:`rrin_tpu_torch.eval.synthesize_triplets`), made entirely on the
device: no host<->device copy per batch, deterministic from one generator.

The JAX package draws its noise from a ``jax.random`` key, which PyTorch
cannot reproduce. So the draws and the arithmetic are split:
:func:`synthetic_triplet_batch` draws the low-resolution noise and the
shifts from a ``torch.Generator``, and :func:`triplets_from_noise` turns
them into frames deterministically, exactly as the JAX package does with
its own draws.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.ops.warp import warp_bilinear


def triplets_from_noise(
    base: torch.Tensor, d: torch.Tensor, hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i0, gt, i1) float32 NHWC from the texture noise ``base`` (batch, th,
    tw, 3) and the per-sample shifts ``d`` (batch, 2) as (dx, dy).

    The noise is upsampled bilinearly to (2H, 2W) with half-pixel centres.
    ``jax.image.resize`` renormalises the weights of taps outside the source;
    when upsampling (every scale >= 1 here) that equals clamping the source
    coordinate, which is what ``F.interpolate(align_corners=False)`` does.
    The texture is then sampled at three window positions offset by j*d,
    j = 0, 1, 2: backward warps with constant flow and a centre crop, so gt
    is the exact midpoint of a linear motion.
    """
    h, w = hw
    batch = base.shape[0]
    tex = F.interpolate(base.to(torch.float32).permute(0, 3, 1, 2), size=(2 * h, 2 * w),
                        mode="bilinear", align_corners=False, antialias=False)
    tex = tex.permute(0, 2, 3, 1).contiguous()
    d = d.to(torch.float32)
    y0, x0 = h // 2, w // 2  # centre-crop origin

    def frame(j: float) -> torch.Tensor:
        flow = (d * j)[:, None, None, :].expand(batch, 2 * h, 2 * w, 2)
        # align_corners=True: plain absolute-pixel sampling, the intended
        # "shift by j*d" motion.
        full = warp_bilinear(tex, flow, align_corners=True)
        return full[:, y0: y0 + h, x0: x0 + w, :]

    # j = 0 is the identity: a plain crop.
    i0 = tex[:, y0: y0 + h, x0: x0 + w, :]
    return i0, frame(1.0), frame(2.0)


def synthetic_triplet_batch(
    gen: torch.Generator,
    batch: int,
    hw: Tuple[int, int] = (256, 448),
    max_shift: float = 6.0,
    texture_cells: int = 8,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i0, gt, i1) float32 NHWC in [0, 1] on ``device``: linear-motion
    triplets.

    A (2H, 2W) smooth texture per sample (bilinear-upsampled uniform noise,
    one cell per ``texture_cells`` pixels) is sampled at three window
    positions (see :func:`triplets_from_noise`). The noise and the shifts,
    uniform in [-max_shift, max_shift), are drawn from ``gen`` on the
    generator's device and then moved to ``device``.
    """
    dev = resolve_device(device)
    h, w = hw
    th, tw = 2 * h // texture_cells, 2 * w // texture_cells
    base = torch.rand((batch, th, tw, 3), generator=gen, device=gen.device)
    d = torch.rand((batch, 2), generator=gen, device=gen.device) * (2 * max_shift) - max_shift
    return triplets_from_noise(base.to(dev), d.to(dev), hw)
