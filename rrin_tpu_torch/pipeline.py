"""Streaming video interpolation engine of the port.

decode -> normalize -> pad16 -> interpolate -> unpad -> quantize -> encode:

  * uint8 crosses the host/device boundary in both directions; normalize,
    pad and quantize run on the device inside :func:`device_step`.
  * One device step expands a batch of frame pairs to all 2^k - 1
    intermediate times (direct mode), or runs the cascaded midpoint recursion
    entirely in device memory (cascade mode), or interpolates at arbitrary
    per-pair times (times mode, the retiming step).
  * Host decode and encode run on their own threads (io/video.py); CUDA work
    is asynchronous already, so dispatch returns at once and the bounded
    in-flight window blocks only at the device-to-host copy of a result.
  * Per-stage wall-clock timers are collected into a structured JSON report.

Serves the packed path (``packed=None`` follows ``use_pallas``, whatever
the ``compute_dtype``, as in the JAX package), in bfloat16, float32 or
calibrated int8 (``int8=True``, absmax or percentile calibration, with
saturation telemetry), its weights prepared once per resolution, or the
plain path; on one device, data-parallel over several (each runs the
one-device step on its shard of the batch) or with each frame's rows cut
over several (``parallel.spatial``).
"""

from __future__ import annotations

import collections
import fractions
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rrin_tpu_torch import native
from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.models.rrin import (
    PackedParams,
    QuantStats,
    _map_stats,
    forward,
    forward_calibrate,
    forward_saturation,
    merge_quant_stats,
    prepare_packed_params,
    scale_quant_stats,
)
from rrin_tpu_torch.models.unet import packed_bf16_supported, packed_supported
from rrin_tpu_torch.ops.pad import _edge_pad_hw, padded_size
from rrin_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    Sharded,
    make_mesh,
    replicate_params,
    shard_pairs,
)


def _dtype_from_name(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _normalize_pad(pairs_u8: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """uint8 (B, 2, H, W, 3) -> float32 [0, 1], edge-padded to the /16 grid."""
    x = pairs_u8.to(torch.float32) * (1.0 / 255.0)
    if ph or pw:
        x = _edge_pad_hw(x, ph, pw)
    return x


@torch.no_grad()
def _step_body(
    params: Dict[str, Any],
    pairs_u8: torch.Tensor,
    exp: int = 1,
    mode: str = "direct",
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_pallas: bool = False,
    pad_hw: Optional[Tuple[int, int]] = None,
    packed: Optional[bool] = None,
    ts: Optional[torch.Tensor] = None,
    quant_stats: Optional[QuantStats] = None,
    packed_params: Optional[PackedParams] = None,
    spatial: Optional[List[torch.device]] = None,
) -> torch.Tensor:
    """One device step: (B, 2, H, W, 3) uint8 -> (B, m, H, W, 3) uint8 with
    m = 2^exp - 1 (direct/cascade) or ts.shape[1] (times). ``pairs_u8`` (and
    ``ts``) already lie on the device the step runs on.

    ``spatial`` lists the devices each frame's rows are cut over: the cascade
    then runs ``parallel.spatial.forward_spatial`` (the plain path),
    ``params`` maps each of those devices to its copy of the params, and the
    step's result lies on the first of them.

    ``pad_hw`` is the (pad_h, pad_w) bottom/right padding to /16.
    ``mode="times"`` interpolates each pair at the times ``ts`` ((B, m)
    floats in (0, 1)) instead of the 2^k midpoint grid: the arbitrary-fps
    retiming step. ``packed=None`` follows ``use_pallas``: the packed serving
    path is the inference configuration (``models.unet.unet_apply_packed``).
    ``quant_stats`` (from :func:`device_calibrate`) runs it in int8;
    ``packed_params`` (``models.rrin.prepare_packed_params``) hands every
    packed conv its weight-side constants. Runs under ``torch.no_grad()``:
    serving builds no autograd graph, whatever the params' ``requires_grad``
    (an Interpolator built on a ``Trainer``'s params).
    """
    dev = pairs_u8.device
    b, _, h, w, _ = pairs_u8.shape
    ph, pw = pad_hw if pad_hw is not None else (
        padded_size(h, cfg.pad_multiple) - h,
        padded_size(w, cfg.pad_multiple) - w,
    )
    x = _normalize_pad(pairs_u8, ph, pw)
    i0, i1 = x[:, 0].contiguous(), x[:, 1].contiguous()
    m = (1 << exp) - 1

    def run(a, c, t, **kw):
        if spatial is not None:
            from rrin_tpu_torch.parallel.spatial import forward_spatial

            return forward_spatial(params, a, c, t, spatial, cfg=cfg,
                                   compute_dtype=compute_dtype, **kw)
        return forward(
            params, a, c, t, cfg=cfg, compute_dtype=compute_dtype,
            use_pallas=use_pallas,
            packed=use_pallas if packed is None else packed,
            quant_stats=quant_stats, packed_params=packed_params, device=dev, **kw)

    def _run_times(tm: torch.Tensor) -> torch.Tensor:
        """Interpolate every pair at its (B, m) times -> (B, m, H, W, 3)
        float mids: the m times run one after the other at batch B, and the
        t-independent flow U-Net runs once per pair before the loop."""
        mm = tm.shape[1]
        if mm == 1:
            return run(i0, i1, tm[:, 0])[:, None]
        fl = run(i0, i1, 0.5, flows_only=True)
        return torch.stack(
            [run(i0, i1, tm[:, j], flows=fl) for j in range(mm)], dim=1)

    if mode == "times":
        if ts is None or ts.ndim != 2 or ts.shape[0] != b:
            raise ValueError(f"mode='times' needs ts of shape ({b}, m), got {ts}")
        mids = _run_times(ts.to(device=dev, dtype=torch.float32))
    elif mode == "direct" or exp == 1:
        # Pair j gets t = (j+1)/2^exp.
        tg = torch.arange(1, m + 1, dtype=torch.float32, device=dev) / (1 << exp)
        mids = _run_times(tg.expand(b, m))
    elif mode == "cascade":
        # Midpoint recursion: level l interpolates the midpoints of all 2^l
        # consecutive pairs in one batched forward; intermediates stay float
        # on the device.
        frames = [i0, i1]  # ordered timeline
        for _level in range(exp):
            lhs = torch.cat(frames[:-1], dim=0)
            rhs = torch.cat(frames[1:], dim=0)
            new_mids = run(lhs, rhs, 0.5)
            merged: List[torch.Tensor] = []
            for i, f in enumerate(frames[:-1]):
                merged.append(f)
                merged.append(new_mids[i * b : (i + 1) * b])
            merged.append(frames[-1])
            frames = merged
        mids = torch.stack(frames[1:-1], dim=1)  # (B, m, H, W, 3)
    else:
        raise ValueError(
            f"unknown mode: {mode!r} (use 'direct', 'cascade' or 'times')"
        )

    if ph or pw:
        mids = mids[:, :, :h, :w, :]
    # torch.round rounds half to even, as jnp.round does.
    return torch.round(mids.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def device_step(
    params: Dict[str, Any],
    pairs_u8,
    exp: int = 1,
    mode: str = "direct",
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_pallas: bool = False,
    pad_hw: Optional[Tuple[int, int]] = None,
    packed: Optional[bool] = None,
    ts=None,
    quant_stats: Optional[QuantStats] = None,
    packed_params: Optional[PackedParams] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """:func:`_step_body` on ``device`` (default: the card): moves the uint8
    pair batch (numpy or tensor) and ``ts`` there and returns the uint8
    result on that device without waiting for it."""
    dev = resolve_device(device)
    pairs = _pairs_on(pairs_u8, dev)
    if ts is not None:
        ts = torch.as_tensor(ts, dtype=torch.float32).to(dev)
    return _step_body(
        params, pairs, exp=exp, mode=mode, cfg=cfg,
        compute_dtype=compute_dtype, use_pallas=use_pallas, pad_hw=pad_hw,
        packed=packed, ts=ts, quant_stats=quant_stats, packed_params=packed_params,
    )


def _as_pairs(pairs_u8) -> torch.Tensor:
    pairs = torch.as_tensor(pairs_u8)
    if pairs.dtype != torch.uint8 or pairs.ndim != 5 or pairs.shape[1] != 2:
        raise ValueError(
            "pairs_u8 must be uint8 (B, 2, H, W, 3), got "
            f"{pairs.dtype} {tuple(pairs.shape)}")
    return pairs


def _pairs_on(pairs_u8, dev: torch.device) -> torch.Tensor:
    return _as_pairs(pairs_u8).to(dev, non_blocking=True)


@torch.no_grad()
def _calibrate_body(
    params: Dict[str, Any],
    pairs_u8: torch.Tensor,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_pallas: bool = False,
    pad_hw: Optional[Tuple[int, int]] = None,
    quantile=None,
) -> QuantStats:
    """int8 calibration pass: (B, 2, H, W, 3) uint8 on the device -> the
    activation stats. The preprocessing of :func:`_step_body`, then the plain
    cascade at t = 0.5 (where the flow-projection magnitudes peak) recording
    every U-Net's activation |x| maxima, or with ``quantile`` their
    q-quantiles (``models.unet.unet_apply_stats``)."""
    _, _, h, w, _ = pairs_u8.shape
    ph, pw = pad_hw if pad_hw is not None else (
        padded_size(h, cfg.pad_multiple) - h,
        padded_size(w, cfg.pad_multiple) - w,
    )
    x = _normalize_pad(pairs_u8, ph, pw)
    _, stats = forward_calibrate(
        params, x[:, 0].contiguous(), x[:, 1].contiguous(), 0.5, cfg=cfg,
        compute_dtype=compute_dtype, use_pallas=use_pallas, quantile=quantile,
        device=pairs_u8.device)
    return stats


def device_calibrate(
    params: Dict[str, Any],
    pairs_u8,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.bfloat16,
    use_pallas: bool = False,
    pad_hw: Optional[Tuple[int, int]] = None,
    quantile=None,
    device: DeviceLike = "cuda",
) -> QuantStats:
    """:func:`_calibrate_body` on ``device`` (default: the card); the stats
    stay there as float32 scalars."""
    return _calibrate_body(
        params, _pairs_on(pairs_u8, resolve_device(device)), cfg=cfg,
        compute_dtype=compute_dtype, use_pallas=use_pallas, pad_hw=pad_hw,
        quantile=quantile)


@dataclass(frozen=True)
class PairPlan:
    """Retiming schedule of ONE source pair (see :func:`retime_plan`)."""

    emit_copy: bool          # an output lands exactly on the left frame
    ts: Tuple[float, ...]    # strictly increasing mid times in (0, 1)


def retime_plan(
    factor: fractions.Fraction, start_pair: int, n_pairs: int
) -> List[PairPlan]:
    """Map output frames to source pairs for fps retiming.

    Output frame j plays at source time T = j / factor (in source-frame
    units), so it belongs to pair p = floor(T) with t = T - p; integer T
    is the source frame itself (a host-side copy — the model is only
    asked for strictly interior times). Exact Fraction arithmetic: no
    float drift over long videos, and the per-pair schedule depends only
    on the ABSOLUTE pair index, so resumable segments reproduce it from
    ``start_pair`` alone.
    """
    assert isinstance(factor, fractions.Fraction) and factor > 0
    plans = []
    for p in range(start_pair, start_pair + n_pairs):
        j0 = -((-p * factor) // 1)              # ceil(p * factor)
        j1 = -((-(p + 1) * factor) // 1)        # ceil((p+1) * factor)
        ts, emit_copy = [], False
        for j in range(int(j0), int(j1)):
            t = fractions.Fraction(j, 1) / factor - p
            if t == 0:
                emit_copy = True
            else:
                ts.append(float(t))
        plans.append(PairPlan(emit_copy, tuple(ts)))
    return plans


def retime_slots(factor: fractions.Fraction) -> int:
    """Exact max mids any pair needs under ``factor``.

    Closed form, not a period scan (a scan capped below the denominator
    underestimates — e.g. 10001/9999 first needs its 2nd slot at pair
    4999). With factor a/q in lowest terms and x = frac(p*factor) = k/q,
    a pair has ceil((a+k)/q) - ceil(k/q) outputs of which [k == 0] is a
    copy, so mids(k) = ceil((a+k)/q) - 1 for k > 0 and ceil(a/q) - 1 for
    k = 0; the max over k in [0, q) is at k = q-1 (and equals a-1 when
    q == 1, where every pair is the k=0 case)."""
    a, q = factor.numerator, factor.denominator
    if q == 1:
        return a - 1
    return (a + 2 * q - 2) // q - 1


@dataclass
class StageTimers:
    decode: float = 0.0
    pack: float = 0.0  # BGR->RGB + batch pack
    dispatch: float = 0.0  # host->device copy + enqueueing the step
    d2h: float = 0.0  # blocking device->host result fetch
    encode_wait: float = 0.0  # time the main loop stalled on the encode queue
    total: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.__dict__.items()}


@dataclass
class PipelineReport:
    """Structured per-run report."""

    input: str
    output: str
    exp: int
    mode: str
    frames_in: int = 0
    frames_out: int = 0
    fps_in: float = 0.0
    fps_out: float = 0.0
    interp_fps: float = 0.0  # interpolated frames produced per second
    output_fps_rate: float = 0.0  # total output frames per second of wall clock
    # First dispatch: kernel build + library warm-up (the JAX package's
    # compile time sits in the same field).
    compile_seconds: float = 0.0
    timers: Dict[str, float] = field(default_factory=dict)
    # int8 clip telemetry ("unet/site" -> clip rate) of the first batch,
    # filled only by interpolate_video(int8_saturation=True): see
    # Interpolator.saturation_rates.
    int8_saturation: Optional[Dict[str, float]] = None

    def to_json(self) -> str:
        return json.dumps(self.__dict__, indent=2)


class Interpolator:
    """Holds params + step configuration for one video job on one device.

    ``int8=True`` serves the packed path in int8: the first batch at each
    padded resolution runs a calibration pass (:func:`device_calibrate`)
    whose ranges, scaled by ``int8_margin``, quantise every later batch of
    that resolution; preset ``quant_stats`` (e.g. from
    ``params.load_calibration``, margin already applied) skip it.
    ``int8_percentile`` (in (50, 100]) calibrates on that percentile of |x|
    instead of its maximum; :meth:`saturation_rates` says what the grid
    clips.

    On the packed path the first batch at each padded resolution also
    prepares every conv's weight-side constants for it and its calibration
    (``models.rrin.prepare_packed_params``); later batches make no weight
    work at all. ``packed=None`` follows ``use_pallas``.

    With ``data_parallel > 1`` (or 0 = every device), frame-pair batches are
    cut over the ``data`` axis of a mesh (``parallel.sharding``) and each
    device runs the one-device step on its shard, the full fast path:
    packed kernels, int8 with its own copy of the stats, its own prepared
    constants. The batch must divide over the axis (``interpolate_video``
    rounds its batch up). The result is gathered on the mesh's first device.
    int8 calibration runs per shard and folds by elementwise max.

    ``spatial > 1`` also cuts each frame's height over a ``spatial`` axis
    (``parallel.spatial``): that path is the plain path (no packed kernels
    across cut rows; K1 at the bf16 convs on the card, the plain warp) and
    refuses int8, as in the JAX package. ``mesh`` (``make_mesh``) replaces
    ``data_parallel``/``spatial`` and ``device`` (its first device is the
    Interpolator's); a mesh of one device is dropped. Without one, the mesh
    is built of the CUDA devices, or, for ``device="cpu"``, of the CPU
    listed once per shard.
    """

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig = ModelConfig(),
        exp: int = 1,
        mode: str = "direct",
        compute_dtype: str = "bfloat16",
        use_pallas: bool = False,
        data_parallel: int = 1,
        packed: Optional[bool] = None,
        spatial: int = 1,
        int8: bool = False,
        int8_margin: float = 1.2,
        int8_percentile: Optional[float] = None,
        quant_stats: Optional[QuantStats] = None,
        mesh: Optional[Mesh] = None,
        device: DeviceLike = "cuda",
    ):
        if mode not in ("direct", "cascade", "times"):
            raise ValueError(f"unknown mode: {mode!r}")
        if exp < 1:
            raise ValueError("exp must be >= 1")
        if spatial < 1:
            raise ValueError("spatial must be >= 1")
        if int8 and spatial > 1:
            raise ValueError(
                "int8 composes with data_parallel but not with spatial sharding: "
                "the spatial path is the plain path by design, where int8 would "
                "only add fake-quant noise")
        if int8_percentile is not None:
            if not int8:
                raise ValueError("int8_percentile requires int8=True")
            if quant_stats is not None:
                raise ValueError(
                    "int8_percentile shapes calibration: it cannot apply to preset "
                    "quant_stats (ranges already calibrated)")
            if not 50.0 < int8_percentile <= 100.0:
                raise ValueError(
                    "int8_percentile must be in (50, 100] (percent of |activation| "
                    "mass kept inside the grid; 100 = absmax)")
        # a mesh of more than one device, else None (the one-device route)
        self.mesh: Optional[Mesh] = None
        self.spatial = spatial
        if mesh is not None:
            self.device = mesh.devices[0, 0]
        else:
            self.device = resolve_device(device)
            if data_parallel != 1 or spatial > 1:
                n = data_parallel if data_parallel > 0 else 0
                devices = None if self.device.type == "cuda" else (
                    [self.device] * (max(n, 1) * spatial))
                mesh = make_mesh(n_data=n, n_spatial=spatial, devices=devices)
        if mesh is not None and mesh.devices.size > 1:
            n_sp = mesh.shape[SPATIAL_AXIS]
            if int8 and n_sp > 1:
                raise ValueError(
                    "int8 composes with data_parallel but not with spatial "
                    f"sharding (mesh has a {n_sp}-way '{SPATIAL_AXIS}' axis)")
            self.mesh = mesh
        # device -> its copy of the params (one device: the caller's params)
        self._replicas = (replicate_params(self.mesh, params) if self.mesh is not None
                          else {self.device: params})
        if mode == "cascade" and exp >= 3:
            import warnings

            warnings.warn(
                f"exp={exp} (cascade mode) runs up to {1 << (exp - 1)}x-batch "
                "forwards per frame pair; direct mode runs the 2^exp - 1 "
                "times one after the other at batch B instead",
                stacklevel=2,
            )
        self.params = self._replicas[self.device]
        self.cfg = cfg
        self.exp = exp
        self.mode = mode
        self.compute_dtype = _dtype_from_name(compute_dtype)
        self.use_pallas = use_pallas
        self.packed = True if int8 else packed
        self.int8 = int8
        self.int8_margin = int8_margin
        # None: absmax calibration
        self._calib_quantile = None if int8_percentile is None else int8_percentile / 100.0
        self._preset_stats = quant_stats
        # padded (H, W) -> the stats that serve it
        self._quant_stats: Dict[Tuple[int, int], QuantStats] = {}
        # padded (H, W) -> its prepared constants (None: not on the packed path)
        self._packed_params: Dict[Tuple[int, int], Optional[PackedParams]] = {}
        # (device, padded (H, W)) -> (stats, prepared constants) on a mesh's
        # other devices
        self._replica_state: Dict[tuple, tuple] = {}

    @property
    def _dp_fast(self) -> bool:
        """True when the mesh step is the one-device fast path per data
        shard (no spatial axis in use), derived from the mesh as in the JAX
        package."""
        return (self.mesh is not None and self.spatial == 1
                and self.mesh.shape[SPATIAL_AXIS] == 1)

    def _ensure_quant_stats(self, pairs_u8, pad_hw, hw_key) -> None:
        """Calibrate (or install the preset) for this padded resolution if
        not done yet; calibrated ranges get the margin, preset ones do not."""
        if hw_key in self._quant_stats:
            return
        if not packed_supported(hw_key[0], hw_key[1], self.cfg):
            raise ValueError(
                f"int8 mode needs the packed fast path, which does not support "
                f"{pairs_u8.shape[2]}x{pairs_u8.shape[3]} with this config")
        if self._preset_stats is not None:
            stats = {u: {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                         for k, v in sites.items()}
                     for u, sites in self._preset_stats.items()}
        elif self.mesh is not None:
            stats = scale_quant_stats(self._dp_calibrate(pairs_u8, pad_hw), self.int8_margin)
        else:
            stats = scale_quant_stats(device_calibrate(
                self.params, pairs_u8, cfg=self.cfg, compute_dtype=self.compute_dtype,
                use_pallas=self.use_pallas, pad_hw=pad_hw, quantile=self._calib_quantile,
                device=self.device),
                self.int8_margin)
        self._quant_stats[hw_key] = stats

    def _dp_calibrate(self, pairs_u8, pad_hw) -> QuantStats:
        """int8 calibration over the data axis: each device runs the
        one-device calibration pass on its batch shard, and the per-site
        statistics fold by elementwise max on the first device. For absmax
        that is the full-batch calibration; for a percentile, the largest of
        the per-shard quantiles (as the JAX package's ``pmax``)."""
        batch = pairs_u8 if isinstance(pairs_u8, Sharded) else shard_pairs(self.mesh, pairs_u8)
        folded = None
        for shard in batch.data_shards():
            stats = _calibrate_body(
                self._replicas[shard.device], shard, cfg=self.cfg,
                compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
                pad_hw=pad_hw, quantile=self._calib_quantile)
            stats = _map_stats(lambda v: v.to(self.device), stats)
            folded = stats if folded is None else merge_quant_stats(folded, stats)
        return folded

    def _prepared(self, hw_key) -> Optional[PackedParams]:
        """The prepared constants of this padded resolution and its
        calibration, built at its first batch; None where ``forward`` would
        take the plain path (the routing of ``forward`` exactly)."""
        if hw_key not in self._packed_params:
            prep = None
            stats = self._quant_stats.get(hw_key)
            use_packed = self.use_pallas if self.packed is None else self.packed
            if use_packed and packed_supported(hw_key[0], hw_key[1], self.cfg) and (
                    stats is not None or packed_bf16_supported(hw_key[1])):
                prep = prepare_packed_params(
                    self.params, self.cfg, self.compute_dtype, quant_stats=stats, hw=hw_key,
                    device=self.device)
            self._packed_params[hw_key] = prep
        return self._packed_params[hw_key]

    def _state_on(self, dev: torch.device, hw_key) -> tuple:
        """(stats, prepared constants) of this padded resolution on ``dev``:
        the first device's own, or copies of the stats and constants
        prepared from ``dev``'s params, made at its first batch there."""
        if dev == self.device:
            return self._quant_stats.get(hw_key), self._prepared(hw_key)
        key = (dev, hw_key)
        if key not in self._replica_state:
            stats = self._quant_stats.get(hw_key)
            if stats is not None:
                stats = _map_stats(lambda v: v.to(dev), stats)
            prep = None
            if self._prepared(hw_key) is not None:
                prep = prepare_packed_params(
                    self._replicas[dev], self.cfg, self.compute_dtype, quant_stats=stats,
                    hw=hw_key, device=dev)
            self._replica_state[key] = (stats, prep)
        return self._replica_state[key]

    def _pad(self, pairs_u8) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """((pad_h, pad_w), padded (H, W)) of a (B, 2, H, W, 3) batch."""
        _, _, h, w, _ = pairs_u8.shape
        pad_hw = (
            padded_size(h, self.cfg.pad_multiple) - h,
            padded_size(w, self.cfg.pad_multiple) - w,
        )
        return pad_hw, (h + pad_hw[0], w + pad_hw[1])

    def saturation_rates(self, pairs_u8: np.ndarray) -> Dict[str, float]:
        """int8 clip telemetry: the share of |activation| values this batch
        puts above the serving ranges, per site (``"unet/site"`` keys in
        sorted order, e.g. ``"flow/d1c1"``). Calibrates first if this
        resolution has not been seen, so the rates are those of the grid the
        requests are served on (margin applied). Absmax calibration reads
        0.0 everywhere on its own batch; ``int8_percentile=P`` about
        ``1 - P/100``. Runs the plain cascade once: telemetry, not the served
        path; under a mesh it runs on the mesh's first device."""
        if not self.int8:
            raise ValueError("saturation_rates requires int8=True")
        pad_hw, hw_key = self._pad(pairs_u8)
        pairs = _pairs_on(pairs_u8, self.device)
        self._ensure_quant_stats(pairs, pad_hw, hw_key)
        x = _normalize_pad(pairs, *pad_hw)
        rates = forward_saturation(
            self.params, x[:, 0].contiguous(), x[:, 1].contiguous(),
            self._quant_stats[hw_key], 0.5, cfg=self.cfg, compute_dtype=self.compute_dtype,
            use_pallas=self.use_pallas, device=self.device)
        keys = [(u, k) for u in sorted(rates) for k in sorted(rates[u])]
        vals = torch.stack([rates[u][k] for u, k in keys]).cpu().tolist()
        return {f"{u}/{k}": v for (u, k), v in zip(keys, vals)}

    @property
    def mids_per_pair(self) -> int:
        return (1 << self.exp) - 1

    @property
    def shard_count(self) -> int:
        """Devices the batch dim shards over (the data axis only: the
        spatial axis cuts H, not B)."""
        return 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

    def step(
        self, pairs_u8: np.ndarray, ts: Optional[np.ndarray] = None
    ) -> torch.Tensor:
        """Enqueue one device step; returns the uint8 result on the device
        (CUDA work is asynchronous: copy it to the host to wait for it).

        ``mode="times"`` requires ``ts``: a (B, m) float array of per-pair
        interpolation times in (0, 1) (padded slots are computed and
        host-dropped, see :func:`retime_plan`).

        The first batch at each padded resolution also runs the calibration
        pass (int8) and prepares the packed convs' constants (see the class
        docstring). Under a mesh the result is gathered on its first
        device."""
        if (ts is not None) != (self.mode == "times"):
            raise ValueError("ts is required (exactly) when mode='times'")
        pad_hw, hw_key = self._pad(pairs_u8)
        if self.mesh is not None:
            return self._mesh_step(pairs_u8, pad_hw, hw_key, ts)
        pairs = _pairs_on(pairs_u8, self.device)
        if self.int8:
            self._ensure_quant_stats(pairs, pad_hw, hw_key)
        return device_step(
            self.params, pairs, exp=self.exp, mode=self.mode, cfg=self.cfg,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
            pad_hw=pad_hw, packed=self.packed, ts=ts,
            quant_stats=self._quant_stats.get(hw_key),
            packed_params=self._prepared(hw_key), device=self.device,
        )

    def _mesh_step(self, pairs_u8, pad_hw, hw_key, ts) -> torch.Tensor:
        """:meth:`step` under a mesh: every shard is copied to its device
        first, then each data shard's step is enqueued (one after the other
        from the host, with no sync between them), then the results are
        gathered on the first device."""
        batch = shard_pairs(self.mesh, _as_pairs(pairs_u8))
        tss = None if ts is None else shard_pairs(
            self.mesh, torch.as_tensor(np.asarray(ts, np.float32))).data_shards()
        kw = dict(exp=self.exp, mode=self.mode, cfg=self.cfg,
                  compute_dtype=self.compute_dtype, pad_hw=pad_hw)
        outs = []
        if self._dp_fast:
            if self.int8:
                self._ensure_quant_stats(batch, pad_hw, hw_key)
            for d, shard in enumerate(batch.data_shards()):
                stats, prep = self._state_on(shard.device, hw_key)
                outs.append(_step_body(
                    self._replicas[shard.device], shard, use_pallas=self.use_pallas,
                    packed=self.packed, ts=None if tss is None else tss[d],
                    quant_stats=stats, packed_params=prep, **kw))
        else:
            # the spatial path: the plain path, each frame's rows cut over the
            # devices of its row of the mesh
            for d, shard in enumerate(batch.data_shards()):
                outs.append(_step_body(
                    self._replicas, shard, use_pallas=False, packed=False,
                    ts=None if tss is None else tss[d],
                    spatial=list(self.mesh.devices[d]), **kw))
        return torch.cat([o.to(self.device) for o in outs])


def interpolate_video(
    input_path: str,
    output_path: str,
    params: Dict[str, Any],
    cfg: ModelConfig = ModelConfig(),
    exp: int = 1,
    mode: str = "direct",
    batch_size: int = 1,
    compute_dtype: str = "bfloat16",
    use_pallas: bool = False,
    fps_out: Optional[float] = None,
    fourcc: str = "mp4v",
    queue_depth: int = 8,
    max_in_flight: int = 2,
    progress: bool = False,
    start_frame: int = 0,
    max_pairs: Optional[int] = None,
    write_trailing_frame: bool = True,
    data_parallel: int = 1,
    spatial: int = 1,
    int8: bool = False,
    int8_margin: float = 1.2,
    int8_percentile: Optional[float] = None,
    int8_saturation: bool = False,
    quant_stats: Optional[QuantStats] = None,
    save_calib: Optional[str] = None,
    retime_fps: Optional[float] = None,
    slowmo: Optional[float] = None,
    packed: Optional[bool] = None,
    device: DeviceLike = "cuda",
) -> PipelineReport:
    """2^exp-upsample ``input_path``'s frame rate into ``output_path``.

    Output frame count = 2^exp * (N - 1) + 1 for N input frames
    (original frames interleaved with interpolated ones).

    ``retime_fps`` switches to arbitrary-ratio retiming instead: output
    frame j plays at source time j*fps_in/retime_fps, so any conversion
    (24→60, 30→24, NTSC rates, slowdowns) runs through the times-mode step
    (see :func:`retime_plan`; ``exp``/``mode`` are ignored). Output frame count = floor((N-1) * retime_fps/fps_in) + 1 —
    timestamps never extrapolate past the last source frame.

    ``slowmo`` is the same times-mode machinery with the output CLOCK kept
    at the input rate: ``slowmo=2.5`` interpolates 2.5x the frames and
    plays them at fps_in, i.e. arbitrary-ratio (non-power-of-two) slow
    motion. ``fps_out`` may override the playback rate; mutually exclusive
    with ``retime_fps``.

    ``start_frame``/``max_pairs``/``write_trailing_frame`` carve out a
    contiguous sub-range of source pairs, the building block of segmented
    resumable jobs: consecutive segments concatenate seamlessly when only
    the last one writes the trailing source frame.

    ``packed`` selects the U-Net path (``None`` follows ``use_pallas``).
    ``int8``, ``int8_margin``, ``int8_percentile`` and ``quant_stats`` are
    the :class:`Interpolator`'s; ``save_calib`` writes the ranges the run
    calibrated (``params.save_calibration``) for later runs to pass back as
    ``quant_stats``. ``int8_saturation`` (with ``int8``) puts the clip rates
    of the first batch (:meth:`Interpolator.saturation_rates`) into the
    report's ``int8_saturation``. ``device`` defaults to the card and raises
    without one.
    """
    from rrin_tpu_torch.io.video import VideoReader, VideoWriter

    if retime_fps is not None and slowmo is not None:
        raise ValueError("retime_fps and slowmo are mutually exclusive")
    if retime_fps is not None:
        if retime_fps <= 0:
            raise ValueError("retime_fps must be > 0")
        mode = "times"
    if slowmo is not None:
        if slowmo <= 0:
            raise ValueError("slowmo must be > 0")
        mode = "times"
    if mode == "times" and retime_fps is None and slowmo is None:
        # Interpolator itself accepts mode='times' (per-step ts), but at
        # the video level the times come from a retime/slowmo factor —
        # fail here, not mid-run after the output file exists.
        raise ValueError(
            "mode='times' at the video level requires retime_fps or slowmo"
        )

    # Interpolator validation (mode/exp/sharding/int8 conflicts) runs
    # BEFORE any file handle or decode thread exists.
    interp = Interpolator(
        params, cfg, exp=exp, mode=mode, compute_dtype=compute_dtype,
        use_pallas=use_pallas, data_parallel=data_parallel, spatial=spatial,
        int8=int8, int8_margin=int8_margin, int8_percentile=int8_percentile,
        quant_stats=quant_stats, packed=packed, device=device,
    )
    # Sharded batches must divide evenly over the data mesh axis.
    batch_size = -(-batch_size // interp.shard_count) * interp.shard_count

    # Host frames stay BGR end-to-end: original frames are written back
    # with no swap pass, and the one swap the device input needs happens
    # while the pair batch is packed.
    reader = VideoReader(input_path, queue_depth=queue_depth,
                         start_frame=start_frame, rgb=False)
    meta = reader.meta

    factor = None
    try:
        if retime_fps is not None:
            if meta.fps_assumed:
                raise ValueError(
                    f"{input_path} has no fps metadata — retiming needs "
                    "the true input rate (pass a container with fps, or "
                    "remux first)"
                )
            # Exact rational ratio (limit_denominator absorbs NTSC-style
            # float fps like 29.97002997 -> 30000/1001).
            factor = (
                fractions.Fraction(retime_fps).limit_denominator(100_000)
                / fractions.Fraction(meta.fps).limit_denominator(100_000)
            )
        elif slowmo is not None:
            # Slow motion IS the factor (fps-independent: timestamps
            # stretch, the playback clock stays at fps_in).
            factor = fractions.Fraction(slowmo).limit_denominator(100_000)
    except Exception:
        reader.close()
        raise

    # m sizes the writer queue: exact max mids per pair under retiming
    # (dispatch uses the per-BATCH max, which never exceeds it).
    m = retime_slots(factor) if factor is not None else interp.mids_per_pair

    out_fps = (
        retime_fps if retime_fps is not None
        else fps_out if fps_out is not None
        else meta.fps if slowmo is not None
        else meta.fps * (1 << exp)
    )
    writer = VideoWriter(
        output_path, out_fps, (meta.height, meta.width), fourcc=fourcc,
        queue_depth=queue_depth * (m + 1), input_rgb=False,
    )

    timers = StageTimers()
    report = PipelineReport(
        input=input_path, output=output_path, exp=exp, mode=mode,
        fps_in=meta.fps, fps_out=out_fps,
    )
    t_start = time.perf_counter()

    # In-flight window: (lefts, plans, device result) per step.
    inflight: "collections.deque" = collections.deque()
    pending_pairs: List[tuple] = []  # (prev, frame) BGR uint8 pairs
    pending_lefts: List[np.ndarray] = []
    pending_plans: List[PairPlan] = []  # retime mode only
    prev: Optional[np.ndarray] = None
    last_frame: Optional[np.ndarray] = None
    frames_in = 0
    n_mids_written = 0
    first_dispatch = True

    def drain_one() -> None:
        nonlocal timers, n_mids_written
        lefts, plans, dev = inflight.popleft()
        t0 = time.perf_counter()
        # blocks until the step is done; uint8 host copy
        mids = None if dev is None else dev.cpu().numpy()
        timers.d2h += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, left in enumerate(lefts):
            if plans is None:
                writer.write(left)  # BGR passthrough, no swap
                for j in range(m):
                    writer.write(mids[i, j], rgb=True)  # device RGB
                n_mids_written += m
            else:
                if plans[i].emit_copy:
                    writer.write(left)
                for j in range(len(plans[i].ts)):
                    writer.write(mids[i, j], rgb=True)
                n_mids_written += len(plans[i].ts)
        timers.encode_wait += time.perf_counter() - t0

    def dispatch(
        pairs: List[tuple],
        lefts: List[np.ndarray],
        plans: Optional[List[PairPlan]] = None,
    ) -> None:
        nonlocal first_dispatch, timers, report
        n = len(pairs)
        if n < batch_size:
            # Pad the tail batch to the full batch size; the padded rows
            # are computed then dropped (lefts is shorter).
            pairs = pairs + [pairs[-1]] * (batch_size - n)
        mb = m if plans is None else max(len(p_.ts) for p_ in plans)
        if plans is not None and mb == 0:
            # No mids in this batch (pure-copy outputs, or none at all —
            # e.g. divisor-rate downsampling): no device work.
            inflight.append((lefts, plans, None))
            while len(inflight) > max_in_flight:
                drain_one()
            return
        t0 = time.perf_counter()
        # Fused BGR->RGB + pack into the batch buffer (threaded C++; numpy
        # fallback). A fresh buffer per dispatch: the previous one may still
        # be staging for an in-flight device transfer.
        batch = np.empty((batch_size, 2) + pairs[0][0].shape, np.uint8)
        for i, (a, b) in enumerate(pairs):
            if not native.pack_pair_bgr(a, b, batch, i):
                batch[i, 0] = a[..., ::-1]
                batch[i, 1] = b[..., ::-1]
        timers.pack += time.perf_counter() - t0
        t0 = time.perf_counter()
        if plans is not None:
            # Per-pair times padded to the BATCH max slot count (padded
            # slots compute a midpoint that drain_one never writes). The
            # batch max, not the global max: for two-count factors like
            # 1200/1001 most batches stay at the low count, so batch-1
            # serving pays zero padded forwards.
            ts = np.full((batch_size, mb), 0.5, np.float32)
            for i, pl_ in enumerate(plans):
                ts[i, : len(pl_.ts)] = pl_.ts
            dev = interp.step(batch, ts)[: len(lefts)]
        else:
            dev = interp.step(batch)[: len(lefts)]
        dt = time.perf_counter() - t0
        if first_dispatch:
            report.compile_seconds = round(dt, 3)
            first_dispatch = False
            if int8_saturation and int8:
                # the calibrated grid on its own first batch: 0.0 everywhere
                # with absmax and a margin, the served clip rates with
                # int8_percentile
                report.int8_saturation = {
                    k: round(v, 6) for k, v in interp.saturation_rates(batch).items()}
        else:
            timers.dispatch += dt
        inflight.append((lefts, plans, dev))
        while len(inflight) > max_in_flight:
            drain_one()

    pairs_done = 0
    try:
        t_dec = time.perf_counter()
        for frame in reader:
            timers.decode += time.perf_counter() - t_dec
            frames_in += 1
            last_frame = frame
            if prev is not None:
                pending_pairs.append((prev, frame))
                pending_lefts.append(prev)
                if factor is not None:
                    # Schedule from the ABSOLUTE pair index — segments of
                    # a resumable retime job reproduce the same timeline.
                    pending_plans.append(
                        retime_plan(factor, start_frame + pairs_done, 1)[0]
                    )
                pairs_done += 1
                if len(pending_pairs) == batch_size:
                    dispatch(pending_pairs, pending_lefts,
                             pending_plans if factor is not None else None)
                    pending_pairs, pending_lefts, pending_plans = [], [], []
            prev = frame
            if progress and frames_in % 100 == 0:
                print(f"\r[rrin-tpu-torch] {frames_in} frames decoded",
                      end="", flush=True)
            if max_pairs is not None and pairs_done >= max_pairs:
                break
            t_dec = time.perf_counter()
        if pending_pairs:
            dispatch(pending_pairs, pending_lefts,
                     pending_plans if factor is not None else None)
        while inflight:
            drain_one()
        if write_trailing_frame and last_frame is not None:
            if factor is None:
                writer.write(last_frame)
            elif (
                (start_frame + frames_in - 1) * factor
            ).denominator == 1:
                # Retiming writes the trailing source frame only when an
                # output timestamp lands exactly on it.
                writer.write(last_frame)
        if frames_in == 0:
            raise ValueError(f"no frames decoded from {input_path}")
    finally:
        reader.close()
        writer.close()
        if progress:
            print()

    if save_calib and interp._quant_stats:
        # The (margin-scaled) ranges this run calibrated: later runs pass
        # them back as quant_stats and skip calibration.
        from rrin_tpu_torch.params import save_calibration

        save_calibration(save_calib, next(iter(interp._quant_stats.values())))

    timers.total = time.perf_counter() - t_start
    report.frames_in = frames_in
    report.frames_out = writer.frames_written
    n_interp = (
        n_mids_written if factor is not None else max(frames_in - 1, 0) * m
    )
    report.interp_fps = round(n_interp / timers.total, 2) if timers.total else 0.0
    report.output_fps_rate = (
        round(report.frames_out / timers.total, 2) if timers.total else 0.0
    )
    report.timers = timers.as_dict()
    return report
