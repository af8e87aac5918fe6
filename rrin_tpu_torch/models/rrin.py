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

import contextlib
import dataclasses
import functools
import hashlib
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.models.unet import (
    packed_bf16_supported,
    packed_branch_flags,
    packed_supported,
    prepare_sites,
    reference_carry_flags,
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
    """Broadcast t (scalar or per-example (B,)) to (B, 1, 1, 1) float32. A
    Python number is filled on the device (no copy from the host)."""
    if isinstance(t, (int, float)):
        return torch.full((batch, 1, 1, 1), float(t), dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    if t.ndim == 0:
        t = t.expand(batch)
    return t.reshape(-1, 1, 1, 1)


def _project(flows: torch.Tensor, tb: torch.Tensor):
    """Stage 2, linear motion quadratic in t: (Ft0, Ft1) from the flow
    U-Net's (F01 | F10)."""
    f01, f10 = flows[..., :2], flows[..., 2:]
    ft0 = -(1.0 - tb) * tb * f01 + tb * tb * f10
    ft1 = (1.0 - tb) * (1.0 - tb) * f01 - tb * (1.0 - tb) * f10
    return ft0, ft1


def _blend(m: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor, tb: torch.Tensor,
           eps: float, planar: bool = False) -> torch.Tensor:
    """Stage 5's normalized blend of the two warped frames by the weight map
    ``m`` (NHWC). With ``planar`` the warped frames are (B, C, H, W) and the
    blend runs planar; only the result moves back to NHWC. Same math."""
    w0 = (1.0 - tb) * m[..., 0:1]
    w1 = tb * m[..., 1:2]
    if planar:
        w0, w1 = w0.movedim(-1, 1), w1.movedim(-1, 1)  # (B,1,H,W)
        return ((w0 * g0 + w1 * g1) / (w0 + w1 + eps)).movedim(1, -1)
    return (w0 * g0 + w1 * g1) / (w0 + w1 + eps)


def _whole(stage, *xs):
    """``_cascade``'s ``each`` on one device: the stage on the whole frames."""
    return stage(*xs)


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], dim=-1)


def _refined(ft0: torch.Tensor, ft1: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    return torch.cat([ft0, ft1], dim=-1) + res


def _finish(coarse: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    return (coarse + res).clamp(0.0, 1.0)


def _cascade(
    run_unet,
    i0f: torch.Tensor,
    i1f: torch.Tensor,
    tb: torch.Tensor,
    cfg: ModelConfig,
    use_pallas: bool = False,
    pairs=False,
    flows: Optional[torch.Tensor] = None,
    planar: bool = False,
    warp=None,
    each=_whole,
) -> torch.Tensor:
    """The shared 4-U-Net dataflow; ``run_unet(name, *feats)`` applies one
    U-Net to the channel-concat of ``feats``. ``each(stage, *xs)`` applies
    a stage that is local in H and W to the frames, and ``warp(ftc)`` gives
    the two warped frames: on one device the whole frames and
    ``ops.warp.warp_pair``; ``parallel.spatial`` passes its row shards, a
    map over them and its own warp."""
    # 1. coarse bidirectional flow: the only t-independent stage, so callers
    # that want m times of one pair compute it once (``flows_only``) and pass
    # it back in.
    if flows is None:
        flows = run_unet("flow", i0f, i1f)

    # 2. flow-to-time projection (float32)
    ft0, ft1 = each(_project, flows, tb)

    # 3. residual flow refinement; I0|I1 and Ft0|Ft1 are carried as single
    # tensors so no U-Net entry concatenates more than four operands.
    i01 = each(_cat, i0f, i1f)
    ftc = each(_refined, ft0, ft1, run_unet("refine", ft0, ft1, i01))

    # 4. backward bilinear warp of both frames (float32 accumulation). With
    # ``planar`` the warps return (B, C, H, W): the blend runs planar and
    # the mask U-Net takes them as NHWC views.
    planar = use_pallas and planar
    if warp is None:
        g0, g1 = warp_pair(
            i0f, i1f, ftc[..., :2], ftc[..., 2:], align_corners=cfg.align_corners,
            use_pallas=use_pallas, pairs=pairs, planar_out=planar,
        )
    else:
        g0, g1 = warp(ftc)
    g0n, g1n = (g0.movedim(1, -1), g1.movedim(1, -1)) if planar else (g0, g1)

    # 5. adaptive weight map + normalized blend (float32)
    m = each(torch.sigmoid, run_unet("mask", ftc, i01, g0n, g1n))
    coarse = each(functools.partial(_blend, eps=cfg.blend_eps, planar=planar), m, g0, g1, tb)

    # 6. residue refinement
    return each(_finish, coarse, run_unet("final", i01, coarse))


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
    packed_params: Optional["PackedParams"] = None,
    flows: Optional[torch.Tensor] = None,
    flows_only: bool = False,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Interpolate the frame at time t between i0 and i1.

    The plain U-Net path runs in the caller's grad mode and is differentiable
    (training): the kernels' wrappers are autograd Functions whose backward is
    the reference's VJP formulation. The serving entry points (``pipeline``,
    :class:`RRIN`, the eval and image tools) call it under
    ``torch.no_grad()``, so they build no graph. The packed path is
    inference-only and runs under ``torch.no_grad()``.

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
      remat: rematerialize each U-Net under autograd
        (``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``):
        its activations are recomputed in the backward instead of kept, so
        larger training crops fit device memory. Same values and gradients.
      packed: run the U-Nets through the packed-path kernels
        (``models.unet.unet_apply_packed``): the serving path, inference
        only (raises ``ValueError`` with ``remat``, and when grad is enabled
        and a param or input requires grad). ``None`` follows
        ``use_pallas``. A shape or config that ``packed_supported`` rejects
        takes the plain path (routing by shape, as in the JAX package). On
        the card the packed kernels run in bfloat16 and in float32
        (split-TF32 products that keep float32 accuracy), as the JAX package
        serves both dtypes packed.
      quant_stats: calibration stats from :func:`forward_calibrate` (per
        U-Net |x| maxima, on ``device``). Requires the packed path (raises
        ``ValueError`` without it); every packed conv but the heads then runs
        int8 x int8 -> int32. Quality bar: > 35 dB PSNR against the float32
        output (the JAX package's).
      packed_params: the packed convs' weight-side constants from
        :func:`prepare_packed_params` (built with the same ``compute_dtype``
        and ``quant_stats``); on the packed path no conv then prepares its
        weights per call. Raises ``ValueError`` where the prep's shape
        routes the U-Net otherwise than this call's, where one of the prep
        and the call has int8 stats and the other not, or where the stats'
        values differ from the prep's (checked by a host-side hash only
        when ``quant_stats`` is another object than the one the prep was
        built with: the same object costs no sync).
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
    if use_packed and torch.is_grad_enabled() and (
            i0f.requires_grad or i1f.requires_grad or _any_requires_grad(params)):
        raise ValueError(
            "packed=True is inference-only (no VJP): run it under torch.no_grad() "
            "or pass packed=False to train")
    prep = packed_params if use_packed else None
    if isinstance(prep, PackedParams):
        _check_packed_params(prep, i0f.shape[-3], i0f.shape[-2], cfg, quant_stats)
        prep = prep.tree

    def apply_plain(p: Params, x: torch.Tensor) -> torch.Tensor:
        if remat:
            return checkpoint(unet_apply, p, x, cfg, use_reentrant=False)
        return unet_apply(p, x, cfg)

    def run_unet(name: str, *feats: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f.to(cd) for f in feats], dim=-1)
        if not use_packed:
            return apply_plain(params[name], x).to(f32)
        return unet_apply_packed(
            params[name], x, cfg, None if quant_stats is None else quant_stats[name],
            None if prep is None else prep[name]).to(f32)

    with torch.no_grad() if use_packed else contextlib.nullcontext():
        if flows_only:
            return run_unet("flow", i0f, i1f)
        return _cascade(
            run_unet, i0f, i1f, tb, cfg, use_pallas, pairs=_warp_pairs_mode(cd),
            flows=None if flows is None else torch.as_tensor(flows).to(
                device=dev, dtype=f32),
        )


def _any_requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_requires_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


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
    quant_stats=...)``. ``quantile`` (in (0, 1]) records the q-quantile of
    |x| instead of the maximum: percentile clipping, whose clip rate
    :func:`forward_saturation` measures.
    """
    return _plain_stats(params, i0, i1, t, cfg, compute_dtype, use_pallas, device,
                        quantile=quantile)


def forward_saturation(
    params: Params,
    i0: torch.Tensor,
    i1: torch.Tensor,
    quant_stats: QuantStats,
    t: TimeLike = 0.5,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    device: DeviceLike = "cuda",
) -> QuantStats:
    """int8 saturation telemetry: per U-Net and site, the share of
    activation values that the serving grid clips on this input,
    ``mean(|x| > range)`` against ``quant_stats`` (pass the serving stats,
    margin applied). Runs the plain cascade as :func:`forward_calibrate`
    does; the rates stay on the device. Absmax calibration with a margin
    reads 0 everywhere on its own calibration input; percentile clipping
    trades a bounded rate for a finer grid."""
    return _plain_stats(params, i0, i1, t, cfg, compute_dtype, use_pallas, device,
                        ranges=quant_stats)[1]


def _plain_stats(params, i0, i1, t, cfg, compute_dtype, use_pallas, device, quantile=None,
                 ranges=None) -> tuple:
    """The plain cascade with ``unet_apply_stats`` in every U-Net: (out,
    per-U-Net stats)."""
    dev = resolve_device(device)
    f32 = torch.float32
    i0f = torch.as_tensor(i0).to(device=dev, dtype=f32).contiguous()
    i1f = torch.as_tensor(i1).to(device=dev, dtype=f32).contiguous()
    tb = _as_t(t, i0f.shape[0], dev)
    cd = compute_dtype
    stats: QuantStats = {}

    def run_unet(name: str, *feats: torch.Tensor) -> torch.Tensor:
        x = torch.cat([f.to(cd) for f in feats], dim=-1)
        out, stats[name] = unet_apply_stats(
            params[name], x, cfg, quantile=quantile,
            ranges=None if ranges is None else ranges[name])
        return out.to(f32)

    with torch.no_grad():
        out = _cascade(run_unet, i0f, i1f, tb, cfg, use_pallas,
                       pairs=_warp_pairs_mode(cd))
    return out, stats


# --------------------------------------------------------------- prepare once

def _stats_fingerprint(stats: QuantStats) -> str:
    """A hash of the names and float32 values of a stats tree: one copy of
    every value to the host, so it is not for the served path."""
    names = sorted((u, k) for u, sites in stats.items() for k in sites)
    h = hashlib.sha1(repr(names).encode())
    h.update(np.array([float(stats[u][k]) for u, k in names], np.float32).tobytes())
    return h.hexdigest()


def _prep_flags(h: int, w: int, cfg: ModelConfig) -> tuple:
    """What a prep's validity depends on at (h, w): the port's routing of
    the sites and the JAX package's branch flags that set the int8 carry
    plan (together, the JAX package's own branch flags)."""
    return packed_branch_flags(h, w, cfg), reference_carry_flags(h, w, cfg)


@dataclasses.dataclass(eq=False)
class PackedParams:
    """The packed convs' weight-side constants (U-Net -> site -> the
    ``prepared=`` of its wrapper), the shape whose routing they were
    prepared under, the fingerprint of the int8 stats folded into them
    (None without int8) and those stats themselves, so that :func:`forward`
    recognises the same object without hashing it."""

    tree: Dict[str, Dict[str, dict]]
    hw: tuple
    quant_fp: Optional[str] = None
    quant_stats: Optional[QuantStats] = None


def _check_packed_params(prep: PackedParams, h: int, w: int, cfg: ModelConfig,
                         quant_stats: Optional[QuantStats]) -> None:
    """The JAX package's three checks of ``forward(packed_params=)``."""
    if _prep_flags(*prep.hw, cfg) != _prep_flags(h, w, cfg):
        raise ValueError(
            f"packed_params were prepared for shape {prep.hw}, whose kernel-branch "
            f"configuration differs from {h}x{w}: re-run prepare_packed_params with "
            "hw matching the serving shape")
    if (quant_stats is None) != (prep.quant_fp is None):
        raise ValueError(
            "packed_params/quant_stats mismatch: the prep was built "
            + ("with" if prep.quant_fp else "without")
            + " int8 calibration but forward was called "
            + ("without" if prep.quant_fp else "with")
            + " quant_stats; re-run prepare_packed_params with the serving quant_stats")
    if (quant_stats is not None and quant_stats is not prep.quant_stats
            and _stats_fingerprint(quant_stats) != prep.quant_fp):
        raise ValueError(
            "packed_params were prepared under other quant_stats values than those "
            "passed to forward: re-run prepare_packed_params with the serving stats")


def _prepare_packed_collect(
    params: Params, cfg: ModelConfig, compute_dtype: torch.dtype,
    quant_stats: Optional[QuantStats], hw: tuple,
) -> Dict[str, Dict[str, dict]]:
    """Every packed site's weight-side constants, U-Net by U-Net
    (``models.unet.prepare_sites`` at ``hw``), on the device of the
    weights."""
    return {
        name: prepare_sites(params[name], hw[0], hw[1], cfg,
                            None if quant_stats is None else quant_stats[name],
                            compute_dtype)
        for name in UNET_SIGNATURES
    }


def prepare_packed_params(
    params: Params,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.bfloat16,
    quant_stats: Optional[QuantStats] = None,
    hw: tuple = (320, 64),
    device: DeviceLike = "cuda",
) -> PackedParams:
    """Prepare every packed conv's weight-side constants once: the weight
    layouts of the Hopper core (bfloat16 or float32 by ``compute_dtype``,
    laid out on the card by its prep kernel) or, with ``quant_stats``, the
    int8 codes with their scales and biases folded with the serving ranges.
    The constants do not depend on the shape, but which kernel serves a site
    and which sites carry int8 follow the branch flags of ``hw``: prepare
    with the serving shape (or one with the same flags; the default enables
    every branch). Pass the result as ``forward(..., packed_params=...)``,
    with the same ``compute_dtype`` and the same ``quant_stats``. ``params``
    lie on ``device`` (default: the card)."""
    dev = resolve_device(device)
    for name in UNET_SIGNATURES:
        w = params[name]["conv1"]["w"]
        if w.device.type != dev.type:
            raise ValueError(f"params lie on {w.device}, not on {dev}")
    with torch.no_grad():
        tree = _prepare_packed_collect(params, cfg, compute_dtype, quant_stats, hw)
    return PackedParams(
        tree, tuple(hw), None if quant_stats is None else _stats_fingerprint(quant_stats),
        quant_stats)


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
    plain function :func:`forward`. Inference: its calls build no autograd
    graph (train through :mod:`rrin_tpu_torch.train`)."""

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

    @torch.no_grad()
    def __call__(self, i0, i1, t: TimeLike = 0.5) -> torch.Tensor:
        return forward(
            self.params, i0, i1, t, cfg=self.cfg,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
            packed=self.packed, quant_stats=self.quant_stats, device=self.device,
        )

    # Alias matching the reference method name.
    forward = __call__
