"""The cascade over row shards of one frame (H sharded over the spatial axis).

The JAX package shards H and lets XLA insert the halo exchanges; this is the
port's counterpart, the plain cascade run layer by layer across the shards
(``use_pallas=False, packed=False``, as the reference's spatial path):

  * cuts: the padded height at multiples of ``cfg.pad_multiple`` (16 rows,
    ``sharding.row_cuts``), so every 2x2 pool of the four levels stays
    inside a shard; the shards may be uneven;
  * convs (:class:`SpatialOps`): each shard takes ``k // 2`` rows from its
    neighbours (none past the frame's top and bottom), runs
    ``conv2d_fused`` on the extended shard and crops back: inside the crop
    that is the SAME conv of the whole frame, and a bf16 site is K1 on the
    card;
  * upsampling: one row from each neighbour by the same rule, the edge clamp
    of ``ops.resize`` at the frame's edges;
  * pool, skip concat, time projection, sigmoid blend and residual are local;
  * the warp reads anywhere in the source: each shard holds the whole
    source frames and warps its own rows of the flow with their row offset
    (``ops.warp.warp_bilinear(row0=)``), normalised by the whole frame's H.

Every op is one that autograd differentiates (slices, ``torch.cat``,
``.to(device)``, ``conv2d_fused``), so gradients cross the halos by
themselves. :func:`forward_spatial` returns the whole frame on the first
device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.models.rrin import TimeLike, _as_t, _cascade
from rrin_tpu_torch.models.unet import _unet
from rrin_tpu_torch.ops.conv_phase import conv2d_fused
from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear
from rrin_tpu_torch.ops.warp import warp_bilinear
from rrin_tpu_torch.parallel.sharding import row_cuts

Shards = List[torch.Tensor]  # (B, rows, W, C) pieces of one frame, top to bottom


def _starts(shards: Shards) -> List[int]:
    starts = [0]
    for t in shards:
        starts.append(starts[-1] + t.shape[1])
    return starts


def _rows(shards: Shards, starts: List[int], a: int, b: int, dev) -> torch.Tensor:
    """Frame rows [a, b) of the shards, on ``dev``."""
    parts = []
    for t, lo in zip(shards, starts):
        x0, x1 = max(a, lo), min(b, lo + t.shape[1])
        if x0 < x1:
            parts.append(t[:, x0 - lo: x1 - lo].to(dev))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def with_halo(shards: Shards, p: int) -> List[tuple]:
    """Each shard with up to ``p`` rows of the frame above and below it (as
    many as the frame has there), contiguous on its device, and the number of
    rows added on top: ``[(extended, top), ...]``."""
    starts = _starts(shards)
    height = starts[-1]
    out = []
    for t, r0, r1 in zip(shards, starts, starts[1:]):
        a, b = max(r0 - p, 0), min(r1 + p, height)
        parts = [t]
        if a < r0:
            parts.insert(0, _rows(shards, starts, a, r0, t.device))
        if r1 < b:
            parts.append(_rows(shards, starts, r1, b, t.device))
        ext = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        out.append((ext.contiguous(), r0 - a))
    return out


def halo_conv(shards: Shards, w, b, slope: Optional[float]) -> Shards:
    """``conv2d_fused`` (SAME) of the frame the shards cut, shard by shard:
    ``w`` and ``b`` hold one tensor per shard (on its device)."""
    p = (w[0].shape[0] - 1) // 2
    return [conv2d_fused(ext, wi, bi, slope)[:, top: top + t.shape[1]]
            for (ext, top), t, wi, bi in zip(with_halo(shards, p), shards, w, b)]


def halo_upsample(shards: Shards) -> Shards:
    """``upsample_2x_bilinear`` of the frame the shards cut, shard by shard:
    one neighbour row on each side, the edge clamp at the frame's edges."""
    return [upsample_2x_bilinear(ext)[:, 2 * top: 2 * (top + t.shape[1])]
            for (ext, top), t in zip(with_halo(shards, 1), shards)]


class _PerShard:
    """A params (sub)tree per shard, indexed as one tree: ``p["up1"]["conv1"]``
    gives the per-shard list of that node."""

    def __init__(self, trees):
        self.trees = list(trees)

    def __getitem__(self, key):
        nodes = [t[key] for t in self.trees]
        return nodes if isinstance(nodes[0], torch.Tensor) else _PerShard(nodes)


class SpatialOps:
    """``models.unet._unet``'s ops on row shards."""

    conv = staticmethod(halo_conv)
    up = staticmethod(halo_upsample)

    @staticmethod
    def pool(shards: Shards) -> Shards:
        return [avg_pool_2x(t) for t in shards]

    @staticmethod
    def cat(parts: List[Shards]) -> Shards:
        return [torch.cat(ts, dim=-1) for ts in zip(*parts)]


def unet_apply_spatial(ps: Sequence, shards: Shards, cfg: ModelConfig,
                       remat: bool = False) -> Shards:
    """One plain U-Net over row shards; ``ps`` holds its params once per
    shard. ``remat`` recomputes its activations in the backward, as
    ``forward(remat=True)`` does for one device."""
    def run(*xs):
        return tuple(_unet(_PerShard(ps), list(xs), cfg, lambda name, t: t, ops=SpatialOps))
    if remat:
        return list(checkpoint(run, *shards, use_reentrant=False))
    return list(run(*shards))


def _each(stage, *xs: Shards):
    """``models.rrin._cascade``'s ``each`` on row shards: the stage shard by
    shard (a stage that returns a tuple gives a tuple of shard lists)."""
    outs = [stage(*parts) for parts in zip(*xs)]
    return tuple(map(list, zip(*outs))) if isinstance(outs[0], tuple) else outs


def forward_spatial(
    replicas: Dict[torch.device, dict],
    i0: torch.Tensor,
    i1: torch.Tensor,
    t: TimeLike,
    devices: Sequence[torch.device],
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    flows: Optional[torch.Tensor] = None,
    flows_only: bool = False,
) -> torch.Tensor:
    """``models.rrin.forward`` on the plain path with the frame's rows cut
    over ``devices`` (one shard each, top to bottom; a device may repeat).

    ``replicas`` maps each device to its copy of the params
    (``sharding.replicate_params``; in training, differentiable copies of
    the master params). ``i0``/``i1``: (B, H, W, 3) float frames, H and W
    multiples of ``cfg.pad_multiple`` and H at least that times the shard
    count. ``flows``/``flows_only`` as in ``forward`` (whole frames).
    Returns the (B, H, W, 3) float32 frame (or the flows) on ``devices[0]``.
    """
    f32, cd = torch.float32, compute_dtype
    devices = [torch.device(d) for d in devices]
    i0 = torch.as_tensor(i0)
    i1 = torch.as_tensor(i1)
    b, h, w, _ = i0.shape
    if h % cfg.pad_multiple or w % cfg.pad_multiple:
        raise ValueError(
            f"H and W must be multiples of {cfg.pad_multiple}, got {h}x{w}")
    cuts = row_cuts(h, len(devices), cfg.pad_multiple)
    # the whole source frames once per distinct device: the warps read them
    full = {dev: (i0.to(device=dev, dtype=f32), i1.to(device=dev, dtype=f32))
            for dev in dict.fromkeys(devices)}
    spans = list(zip(cuts, cuts[1:]))
    i0s = [full[d][0][:, r0:r1] for d, (r0, r1) in zip(devices, spans)]
    i1s = [full[d][1][:, r0:r1] for d, (r0, r1) in zip(devices, spans)]
    tbs = [_as_t(t, b, d) for d in devices]

    def run_unet(name: str, *feats: Shards) -> Shards:
        xs = [torch.cat([f.to(cd) for f in fs], dim=-1) for fs in zip(*feats)]
        out = unet_apply_spatial([replicas[d][name] for d in devices], xs, cfg, remat)
        return [o.to(f32) for o in out]

    def warp(ftcs: Shards):
        """Each shard's rows of both warped frames, from the whole frames."""
        return tuple([warp_bilinear(full[d][k], f[..., 2 * k: 2 * k + 2], cfg.align_corners,
                                    row0=r0)
                      for d, f, (r0, _) in zip(devices, ftcs, spans)] for k in (0, 1))

    if flows is not None:
        flows = torch.as_tensor(flows)
        flows = [flows[:, r0:r1].to(device=d, dtype=f32) for d, (r0, r1) in zip(devices, spans)]
    if flows_only:
        out = run_unet("flow", i0s, i1s) if flows is None else flows
    else:
        out = _cascade(run_unet, i0s, i1s, tbs, cfg, flows=flows, warp=warp, each=_each)
    return torch.cat([s.to(devices[0]) for s in out], dim=1)
