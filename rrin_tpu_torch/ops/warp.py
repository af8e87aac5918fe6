"""Backward bilinear warp + weighted blend in plain PyTorch.

The warp follows ``grid_sample`` (bilinear, zero padding) applied to a pixel
mesh-grid plus flow that was normalized with ``2p/(S-1) - 1``. Under
``align_corners=False`` that makes the effective sample position

    s = (p + f) * S / (S - 1) - 0.5        (align_corners=False)
    s = (p + f)                            (align_corners=True)

so ``align_corners=False`` here is NOT ``grid_sample`` on pixel coordinates.
Out-of-bounds corner taps contribute zero.

:func:`warp_bilinear` works on any device and any flow magnitude; it is also
the plain version the hand-written CUDA warp kernels (ops/warp_kernel.py) are
held against. :func:`warp_pair` is the dispatch point of the cascade.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sample_coords(
    flow: torch.Tensor, height: int, width: int, align_corners: bool, row0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute bilinear sample positions (sy, sx) for each output pixel of
    the flow's rows, the first of which is row ``row0`` of a frame
    ``height`` rows high."""
    xs = torch.arange(width, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(row0, row0 + flow.shape[-3], dtype=flow.dtype, device=flow.device)[:, None]
    px = xs + flow[..., 0]
    py = ys + flow[..., 1]
    if align_corners:
        return py, px
    # grid_sample unnormalization for align_corners=False applied to the
    # 2p/(S-1)-1 grid: ((u+1)*S - 1)/2 with u = 2p/(S-1)-1.
    sx = px * (width / max(width - 1, 1)) - 0.5
    sy = py * (height / max(height - 1, 1)) - 0.5
    return sy, sx


def _gather_2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Gather img[b, yi, xi, :] with in-bounds integer indices.

    img: (B, H, W, C); yi/xi: (B, Ho, W) int64 (Ho output rows).
    """
    b, h, w, c = img.shape
    ho = yi.shape[1]
    flat = (yi * w + xi).reshape(b, ho * w, 1).expand(b, ho * w, c)
    return torch.gather(img.reshape(b, h * w, c), 1, flat).reshape(b, ho, w, c)


def warp_bilinear(
    img: torch.Tensor, flow: torch.Tensor, align_corners: bool = False, row0: int = 0,
) -> torch.Tensor:
    """Backward-warp ``img`` by ``flow`` with bilinear sampling, zeros outside.

    Args:
      img:  (B, H, W, C) source frame.
      flow: (B, H, W, 2) displacement field; channel 0 = dx, 1 = dy. Or the
        (B, Ho, W, 2) field of rows ``row0 .. row0 + Ho - 1`` only (one
        shard of an H-sharded frame, ``parallel.spatial``): the positions
        are normalised by the whole frame's H as ever.
      align_corners: grid_sample normalization variant (see module doc).
      row0: the frame row of the flow's first row.

    Returns (B, Ho, W, C): img sampled at p + flow(p).
    """
    b, h, w, c = img.shape
    ho = flow.shape[1]
    f32 = torch.float32
    sy, sx = _sample_coords(flow.to(f32), h, w, align_corners, row0)

    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    wx = sx - x0f
    wy = sy - y0f
    # Clamp before the integer cast: far-out positions have no valid tap and
    # a float beyond the integer range has no defined conversion.
    x0 = x0f.clamp(-2.0, float(w)).to(torch.int64)
    y0 = y0f.clamp(-2.0, float(h)).to(torch.int64)

    imgf = img.to(f32)
    out = torch.zeros((b, ho, w, c), dtype=f32, device=img.device)
    for dy, dx, wgt in (
        (0, 0, (1 - wy) * (1 - wx)),
        (0, 1, (1 - wy) * wx),
        (1, 0, wy * (1 - wx)),
        (1, 1, wy * wx),
    ):
        yi = y0 + dy
        xi = x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        tap = _gather_2d(imgf, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        out = out + tap * (wgt * valid.to(f32))[..., None]
    return out.to(img.dtype)


def warp_pair(
    i0: torch.Tensor,
    i1: torch.Tensor,
    flow_t0: torch.Tensor,
    flow_t1: torch.Tensor,
    align_corners: bool = False,
    use_pallas: bool = False,
    pairs=False,
    planar_out: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp both source frames toward time t.

        g0 = warp(i0, flow_t0);  g1 = warp(i1, flow_t1)

    ``use_pallas`` (the JAX package's flag name, kept so call sites port line
    by line) selects the hand-written warp kernel wrapper of
    ops/warp_kernel.py: the CUDA kernel for tensors on the card, its plain
    version for CPU tensors. ``pairs`` picks the source format there (False:
    float32, True: bfloat16-rounded, "u8": byte-packed). ``planar_out``
    returns (B, C, H, W).
    """
    if use_pallas:
        from rrin_tpu_torch.ops.warp_kernel import warp_pair_kernel

        return warp_pair_kernel(
            i0, i1, flow_t0, flow_t1, align_corners=align_corners,
            pairs=pairs, planar_out=planar_out,
        )
    g0 = warp_bilinear(i0, flow_t0, align_corners=align_corners)
    g1 = warp_bilinear(i1, flow_t1, align_corners=align_corners)
    if planar_out:
        g0 = g0.movedim(-1, 1)
        g1 = g1.movedim(-1, 1)
    return g0, g1


def warp_blend(
    i0: torch.Tensor,
    i1: torch.Tensor,
    flow_t0: torch.Tensor,
    flow_t1: torch.Tensor,
    w0: torch.Tensor,
    w1: torch.Tensor,
    eps: float = 1e-8,
    align_corners: bool = False,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Double-warp + adaptive weighted blend.

        g0 = warp(i0, flow_t0); g1 = warp(i1, flow_t1)
        coarse = (w0*g0 + w1*g1) / (w0 + w1 + eps)

    Returns (coarse, g0, g1): g0/g1 also feed the weight-map U-Net.
    """
    g0, g1 = warp_pair(
        i0, i1, flow_t0, flow_t1, align_corners=align_corners, use_pallas=use_pallas
    )
    coarse = (w0 * g0 + w1 * g1) / (w0 + w1 + eps)
    return coarse, g0, g1
