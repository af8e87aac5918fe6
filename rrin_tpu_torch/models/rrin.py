"""The RRIN cascade: forward(I0, I1, t) -> It.

Four U-Nets in a fixed dataflow:

  1. flow:   (F01, F10)      = UNet1(I0 | I1)                       6 -> 4
  2. time projection (linear motion, quadratic in t):
         Ft0 = -(1-t)*t*F01 + t^2*F10
         Ft1 =  (1-t)^2*F01 - t*(1-t)*F10
  3. refine: (dFt0, dFt1)    = UNet2(Ft0 | Ft1 | I0 | I1)          10 -> 4
  4. warp:   g0 = warp(I0, Ft0); g1 = warp(I1, Ft1)   [backward bilinear]
  5. mask:   M = sigmoid(UNet3(Ft0 | Ft1 | I0 | I1 | g0 | g1))     16 -> 2
         w0 = (1-t)*M0, w1 = t*M1
         I^ = (w0*g0 + w1*g1) / (w0 + w1 + eps)
  6. final:  It = clamp(I^ + UNet4(I0 | I1 | I^), 0, 1)             9 -> 3

NHWC activations, HWIO weights in a nested params dict. Only the U-Net
inputs and outputs are cast to ``compute_dtype``; time projection, warp,
sigmoid, blend and residual stay float32 (no autocast anywhere).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.models.unet import (
    _PERCENTILE_ITEM,
    packed_bf16_supported,
    packed_supported,
    unet_apply,
    unet_apply_packed,
    unet_apply_stats,
    unet_init,
)
from rrin_tpu_torch.ops.warp import warp_pair

Params = Dict[str, Any]
# unet name -> producer site -> calibrated |x| maximum (float32 scalars).
QuantStats = Dict[str, Dict[str, Any]]
TimeLike = Union[float, np.ndarray, torch.Tensor]

# Warp source format on the bfloat16 compute path: the byte-packed variant
# (pairs="u8") is exact for uint8-decoded frames and the default;
# RRIN_WARP_U8=0 selects the bfloat16-rounded variant instead. Read at
# import, as the JAX package reads it, since it selects a kernel.
_WARP_U8 = os.environ.get("RRIN_WARP_U8", "1") == "1"


def _warp_pairs_mode(cd: torch.dtype):
    if cd != torch.bfloat16:
        return False
    return "u8" if _WARP_U8 else True


# (in_ch, out_ch) signatures of the four cascade stages.
UNET_SIGNATURES = {
    "flow": (6, 4),
    "refine": (10, 4),
    "mask": (16, 2),
    "final": (9, 3),
}


def init_params(
    gen: Optional[torch.Generator] = None, cfg: ModelConfig = ModelConfig(),
    device: DeviceLike = "cuda",
) -> Params:
    """Random-init the full cascade parameter dict (four U-Nets, float32)
    on ``device`` from ``gen`` (default: a CPU generator seeded with 0)."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    return {
        name: unet_init(gen, cin, cout, cfg, device=dev)
        for name, (cin, cout) in UNET_SIGNATURES.items()
    }


def _as_t(t: TimeLike, batch: int, device: torch.device) -> torch.Tensor:
    """Broadcast t (scalar or per-example (B,)) to (B, 1, 1, 1) float32."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    if t.ndim == 0:
        t = t.expand(batch)
    return t.reshape(-1, 1, 1, 1)


def _cascade(
    run_unet,
    i0f: torch.Tensor,
    i1f: torch.Tensor,
    tb: torch.Tensor,
    cfg: ModelConfig,
    use_pallas: bool,
    pairs,
    flows: Optional[torch.Tensor] = None,
    planar: bool = False,
) -> torch.Tensor:
    """The shared 4-U-Net dataflow; ``run_unet(name, *feats)`` applies one
    U-Net to the channel-concat of ``feats``."""
    # 1. coarse bidirectional flow: the only t-independent stage, so callers
    # that want m times of one pair compute it once (``flows_only``) and pass
    # it back in.
    if flows is None:
        flows = run_unet("flow", i0f, i1f)
    f01, f10 = flows[..., :2], flows[..., 2:]

    # 2. flow-to-time projection (float32)
    ft0 = -(1.0 - tb) * tb * f01 + tb * tb * f10
    ft1 = (1.0 - tb) * (1.0 - tb) * f01 - tb * (1.0 - tb) * f10

    # 3. residual flow refinement; I0|I1 and Ft0|Ft1 are carried as single
    # tensors so no U-Net entry concatenates more than four operands.
    i01 = torch.cat([i0f, i1f], dim=-1)
    res = run_unet("refine", ft0, ft1, i01)
    ftc = torch.cat([ft0, ft1], dim=-1) + res
    ft0, ft1 = ftc[..., :2], ftc[..., 2:]

    # 4. backward bilinear warp of both frames (float32 accumulation)
    planar = use_pallas and planar
    g0, g1 = warp_pair(
        i0f, i1f, ft0, ft1, align_corners=cfg.align_corners,
        use_pallas=use_pallas, pairs=pairs, planar_out=planar,
    )

    # 5. adaptive weight map + normalized blend (float32). With ``planar``
    # the warps return (B, C, H, W) and the blend runs planar; only `coarse`
    # moves back to NHWC. Same math either way.
    if planar:
        g0n, g1n = g0.movedim(1, -1), g1.movedim(1, -1)
    else:
        g0n, g1n = g0, g1
    m = torch.sigmoid(run_unet("mask", ftc, i01, g0n, g1n))
    if planar:
        w0 = ((1.0 - tb) * m[..., 0:1]).movedim(-1, 1)  # (B,1,H,W)
        w1 = (tb * m[..., 1:2]).movedim(-1, 1)
        coarse = ((w0 * g0 + w1 * g1) / (w0 + w1 + cfg.blend_eps)).movedim(1, -1)
    else:
        w0 = (1.0 - tb) * m[..., 0:1]
        w1 = tb * m[..., 1:2]
        coarse = (w0 * g0 + w1 * g1) / (w0 + w1 + cfg.blend_eps)

    # 6. residue refinement
    out = coarse + run_unet("final", i01, coarse)
    return out.clamp(0.0, 1.0)


def forward(
    params: Params,
    i0: torch.Tensor,
    i1: torch.Tensor,
    t: TimeLike = 0.5,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    remat: bool = False,
    packed: Optional[bool] = False,
    quant_stats: Optional[QuantStats] = None,
    flows: Optional[torch.Tensor] = None,
    flows_only: bool = False,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Interpolate the frame at time t between i0 and i1 (inference; runs
    under ``torch.no_grad()``).

    Args:
      params: dict from :func:`init_params` / ``params_from_numpy`` /
        ``load_params``, on ``device``.
      i0, i1: (B, H, W, 3) float frames in [0, 1] (tensors or numpy arrays;
        moved to ``device``); H, W divisible by 16 (use ops.pad_to_multiple).
      t: scalar or (B,) interpolation time(s) in (0, 1).
      compute_dtype: dtype of the U-Net convs (``torch.bfloat16`` sends them
        to the CUDA conv kernels on the card); warp, time projection and
        blend stay float32.
      use_pallas: route the double warp through the hand-written warp kernel
        (the flag keeps the JAX package's name).
      remat: training-time rematerialization; not ported yet (ROADMAP Queue
        A, "training") and raises ``NotImplementedError`` when set.
      packed: run the U-Nets through the packed-path kernels
        (``models.unet.unet_apply_packed``): the serving path, inference
        only. ``None`` follows ``use_pallas``. A shape or config that
        ``packed_supported`` rejects takes the plain path (routing by shape,
        as in the JAX package). On the card the packed kernels are bfloat16:
        ``compute_dtype=torch.float32`` there raises ``NotImplementedError``,
        so float32 requests pass ``packed=False``.
      quant_stats: calibration stats from :func:`forward_calibrate` (per
        U-Net |x| maxima, on ``device``). Requires the packed path (raises
        ``ValueError`` without it); every packed conv but the heads then runs
        int8 x int8 -> int32. Quality bar: > 35 dB PSNR against the float32
        output (the JAX package's).
      flows: optional precomputed flow-U-Net output (B, H, W, 4) from a
        ``flows_only=True`` call on the same (i0, i1); skips that U-Net.
      flows_only: run only the t-independent flow U-Net and return its
        (B, H, W, 4) float32 output.
      device: where to run; defaults to the card and raises without one.

    Returns (B, H, W, 3) float32 frame in [0, 1] (or flows, see above).
    """
    dev = resolve_device(device)
    if packed is None:
        packed = use_pallas
    if packed and remat:
        raise ValueError("packed=True is inference-only (no remat/VJP)")
    if remat:
        raise NotImplementedError(
            "remat=True belongs to training, which is not ported yet: "
            "ROADMAP.md Queue A item 'training'")
    f32 = torch.float32
    i0f = torch.as_tensor(i0).to(device=dev, dtype=f32).contiguous()
    i1f = torch.as_tensor(i1).to(device=dev, dtype=f32).contiguous()
    if i0f.shape[-3] % cfg.pad_multiple or i0f.shape[-2] % cfg.pad_multiple:
        raise ValueError(
            f"H and W must be multiples of {cfg.pad_multiple}, got "
            f"{i0f.shape[-3]}x{i0f.shape[-2]}; pad with "
            "rrin_tpu_torch.ops.pad_to_multiple (the video pipeline does "
            "this automatically)."
        )
    tb = _as_t(t, i0f.shape[0], dev)
    cd = compute_dtype
    use_packed = (
        bool(packed) and packed_supported(i0f.shape[-3], i0f.shape[-2], cfg)
        and packed_bf16_supported(i0f.shape[-2]))
    if quant_stats is not None and not use_packed:
        raise ValueError(
            "quant_stats (int8) requires the packed fast path: pass packed=True "
            "on a supported shape/config")
    apply_fn = unet_apply_packed if use_packed else unet_apply

    def run_unet(name: str, *feats: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f.to(cd) for f in feats], dim=-1)
        absmax = () if quant_stats is None else (quant_stats[name],)
        return apply_fn(params[name], x, cfg, *absmax).to(f32)

    with torch.no_grad():
        if flows_only:
            return run_unet("flow", i0f, i1f)
        return _cascade(
            run_unet, i0f, i1f, tb, cfg, use_pallas, pairs=_warp_pairs_mode(cd),
            flows=None if flows is None else torch.as_tensor(flows).to(
                device=dev, dtype=f32),
        )


def forward_calibrate(
    params: Params,
    i0: torch.Tensor,
    i1: torch.Tensor,
    t: TimeLike = 0.5,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    quantile=None,
    device: DeviceLike = "cuda",
) -> tuple:
    """:func:`forward` + int8 calibration stats.

    Runs the plain (unpacked) cascade recording every conv operand's |x|
    maximum per U-Net (``models.unet.unet_apply_stats``). Returns ``(out,
    stats)`` with stats as device scalars; fold stats over several
    calibration pairs with :func:`merge_quant_stats`, scale them with
    :func:`scale_quant_stats`, then pass them as ``forward(...,
    quant_stats=...)``. ``quantile`` (percentile clipping) is not ported and
    raises ``NotImplementedError``.
    """
    if quantile is not None:
        raise NotImplementedError(
            f"forward_calibrate(quantile=) is not ported yet: {_PERCENTILE_ITEM}")
    dev = resolve_device(device)
    f32 = torch.float32
    i0f = torch.as_tensor(i0).to(device=dev, dtype=f32).contiguous()
    i1f = torch.as_tensor(i1).to(device=dev, dtype=f32).contiguous()
    tb = _as_t(t, i0f.shape[0], dev)
    cd = compute_dtype
    stats: QuantStats = {}

    def run_unet(name: str, *feats: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f.to(cd) for f in feats], dim=-1)
        out, stats[name] = unet_apply_stats(params[name], x, cfg)
        return out.to(f32)

    with torch.no_grad():
        out = _cascade(run_unet, i0f, i1f, tb, cfg, use_pallas,
                       pairs=_warp_pairs_mode(cd))
    return out, stats


def forward_saturation(*args, **kwargs):
    """int8 saturation telemetry (the fraction of activations the serving
    grid clips): not ported yet."""
    raise NotImplementedError(f"forward_saturation is not ported yet: {_PERCENTILE_ITEM}")


def _map_stats(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_stats(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def merge_quant_stats(a: QuantStats, b: QuantStats) -> QuantStats:
    """Elementwise maximum of two calibration-stats trees."""
    return _map_stats(torch.maximum, a, b)


def scale_quant_stats(stats: QuantStats, margin: float) -> QuantStats:
    """Scale calibration ranges by a safety margin (> 1 guards frames whose
    activations exceed the calibration set's; costs about log2(margin)
    bits)."""
    return _map_stats(lambda v: v * margin, stats)


@dataclasses.dataclass
class RRIN:
    """Convenience object bundling params + config (mirrors the reference
    ``Net.forward(frame0, frame1, t)`` surface); the compute stays in the
    plain function :func:`forward`."""

    params: Params
    cfg: ModelConfig = ModelConfig()
    compute_dtype: torch.dtype = torch.float32
    use_pallas: bool = False
    packed: Optional[bool] = None  # None: follow use_pallas
    device: DeviceLike = "cuda"
    quant_stats: Optional[QuantStats] = None  # set via quantize()

    @classmethod
    def init(
        cls, gen: Optional[torch.Generator] = None,
        cfg: ModelConfig = ModelConfig(), device: DeviceLike = "cuda", **kw,
    ) -> "RRIN":
        return cls(params=init_params(gen, cfg, device=device), cfg=cfg,
                   device=device, **kw)

    def quantize(self, i0, i1, t: TimeLike = 0.5, margin: float = 1.2) -> "RRIN":
        """Calibrate int8 activation ranges on a representative pair and
        return a copy whose calls run the packed int8 path."""
        _, stats = forward_calibrate(
            self.params, i0, i1, t, cfg=self.cfg, compute_dtype=self.compute_dtype,
            use_pallas=self.use_pallas, device=self.device)
        return dataclasses.replace(
            self, packed=True, quant_stats=scale_quant_stats(stats, margin))

    def __call__(self, i0, i1, t: TimeLike = 0.5) -> torch.Tensor:
        return forward(
            self.params, i0, i1, t, cfg=self.cfg,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
            packed=self.packed, quant_stats=self.quant_stats, device=self.device,
        )

    # Alias matching the reference method name.
    forward = __call__
