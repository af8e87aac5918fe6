#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

needs one CUDA GPU (written for an H100, sm_90a), `nvcc`, PyTorch with CUDA
and numpy; nothing else and no network. It builds the CUDA kernels of
``rrin_tpu_torch/csrc`` and runs six phases, each printing one JSON line:

  device      the card's name and power limit
  build       nvcc over every kernel source, in parallel
  kernels     every kernel against its plain PyTorch version on the card at
              the shapes of the 1080p main path, with times and bounds
  serve       the main path: an Interpolator (bfloat16, kernels, plain U-Net
              path, full model width) answering 1080p requests
  serve_fp32  the float32 path (float32 warp kernel) and the bf16-source warp
  agreement   card (kernels) against CPU (plain versions) on one request

Any failed check raises, so the exit code is non-zero and the closing lines
are not printed. The closing lines are: the card's name and power limit, one
``{"kernels": [...]}`` object (launch counts from the served paths, times
measured in this run), and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` adds one phase after ``serve``: a
``torch.profiler`` trace of two 1080p requests, printed as device time by
kernel (where the time of a request goes).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from rrin_tpu_torch import ModelConfig, _build, init_params
from rrin_tpu_torch.ops import conv_phase, warp_kernel
from rrin_tpu_torch.ops.warp import warp_pair
from rrin_tpu_torch.params.checkpoint import (
    flatten_params,
    params_from_numpy,
    unflatten_params,
)
from rrin_tpu_torch.pipeline import Interpolator

# Published peaks of one H100 SXM (dense): the bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# Tolerances, fixed before any run.
# K1: kernel rounds once to bf16 from a float32 sum; the plain version is a
# bf16 library conv plus a bf16 bias add (two roundings, another summation
# order): they may differ by one bf16 step (2^-8 relative) of the larger value.
CONV_ATOL = CONV_RTOL = 2e-2
# Warps: float32 weights and accumulation on the same source values; the
# byte-packed variant folds 1/255 into its weights (float32 rounding only).
WARP_ATOL = 1e-5
# Large |sx| puts floor() on 1-ulp boundaries; a flipped tap has weight ~0.
WARP_ATOL_LARGE = 5e-5
# bf16 card vs bf16 CPU on one request: both round 76 convs to bf16 at other
# places (tensor-core kernel and cuDNN against oneDNN).
BF16_PSNR_DB = 40.0

H1080, W1080 = 1080, 1920
HP, WP = 1088, 1920            # 1080p padded to the /16 grid
SMALL_HW = (256, 448)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- kernels: K1

def conv_case(rng, dev, name, h, w, cin, cout, k, slope):
    x = torch.from_numpy(
        rng.standard_normal((1, h, w, cin)).astype(np.float32)).to(dev).to(torch.bfloat16)
    bound = 1.0 / np.sqrt(k * k * cin)  # the init bound of the model's convs
    wt = torch.from_numpy(
        rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-bound, bound, (cout,)).astype(np.float32)).to(dev)

    before = _build.launch_counts()["conv_phase"]
    got = conv_phase.conv2d_fused(x, wt, bias, slope)
    torch.cuda.synchronize()
    check(_build.launch_counts()["conv_phase"] == before + 1,
          f"{name}: conv2d_fused did not launch the kernel")
    want = conv_phase._conv_plain(x, wt, bias, slope)
    check(got.shape == want.shape and got.dtype == torch.bfloat16, f"{name}: shape/dtype")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= CONV_ATOL + CONV_RTOL * want.float().abs()).all())
    check(ok and bool(torch.isfinite(got.float()).all()),
          f"{name}: kernel disagrees with plain version, max abs err {err}")

    # The library yardstick: one F.conv2d call, bf16 channels-last with bias
    # (no activation); timed here and used nowhere in the port.
    xn = x.permute(0, 3, 1, 2)
    wn = wt.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bn = bias.to(torch.bfloat16)
    pad = (k - 1) // 2
    ms = time_ms(lambda: conv_phase.conv2d_fused(x, wt, bias, slope))
    plain_ms = time_ms(lambda: conv_phase._conv_plain(x, wt, bias, slope))
    library_ms = time_ms(lambda: F.conv2d(xn, wn, bn, padding=pad))

    flops = 2.0 * h * w * k * k * cin * cout
    nbytes = x.numel() * 2 + wt.numel() * 4 + bias.numel() * 4 + got.numel() * 2
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "site": name, "shape": [1, h, w, cin], "cout": cout, "k": k,
        "slope": slope, "max_abs_err": err, "atol": CONV_ATOL, "rtol": CONV_RTOL,
        "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def conv_cases(rng, dev):
    s = ModelConfig().leaky_slope
    h2, w2 = HP // 2, WP // 2
    specs = [
        # (name, h, w, cin, cout, k, slope, launches of this class in the flow U-Net)
        ("conv1_flow_cin6", HP, WP, 6, 32, 7, s, 1),
        ("conv1_refine_cin10", HP, WP, 10, 32, 7, s, 0),
        ("conv1_mask_cin16", HP, WP, 16, 32, 7, s, 0),
        ("conv1_final_cin9", HP, WP, 9, 32, 7, s, 0),
        ("conv2", HP, WP, 32, 32, 7, s, 1),
        ("up4_conv", HP, WP, 64, 32, 3, s, 2),
        ("head_cout4", HP, WP, 32, 4, 3, None, 1),
        ("head_cout2", HP, WP, 32, 2, 3, None, 0),
        ("head_cout3", HP, WP, 32, 3, 3, None, 0),
        ("down1_conv1", h2, w2, 32, 64, 5, s, 1),
        ("down1_conv2", h2, w2, 64, 64, 5, s, 1),
        ("up3_conv", h2, w2, 128, 64, 3, s, 2),
        ("ragged_width_485", 270, 485, 32, 32, 7, s, 0),
    ]
    cases = []
    for name, h, w, cin, cout, k, slope, mult in specs:
        check(conv_phase.supports((1, h, w, cin), (k, k, cin, cout)) is not None,
              f"{name} is not routed to the kernel")
        c = conv_case(rng, dev, name, h, w, cin, cout, k, slope)
        c["per_flow_unet"] = mult
        cases.append(c)
    return cases


# ------------------------------------------------------------ kernels: K2-K4

def grid_for_grid_sample(flow: torch.Tensor) -> torch.Tensor:
    """The reference's grid: pixel mesh + flow, normalized with 2p/(S-1)-1."""
    _, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    gx = 2.0 * (xs + flow[..., 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys + flow[..., 1]) / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def warp_case(rng, dev, pairs, h, w, align_corners, scale, bias, atol, timed):
    img = torch.from_numpy(rng.random((1, h, w, 3), dtype=np.float32)).to(dev)
    fl = (rng.standard_normal((1, h, w, 4)) * scale).astype(np.float32)
    fl[..., 0] += bias[0]
    fl[..., 1] += bias[1]
    # As on the main path: a 2-channel slice of the concatenated flows.
    flow = torch.from_numpy(fl).to(dev)[..., :2]
    kernel, _ = warp_kernel._variant(pairs)

    before = _build.launch_counts()[kernel]
    got = warp_kernel.warp_one(img, flow, align_corners, pairs)
    torch.cuda.synchronize()
    check(_build.launch_counts()[kernel] == before + 1, f"{kernel}: no launch")
    want = warp_kernel._warp_plain(img, flow, align_corners, pairs, False)
    err = float((got - want).abs().max())
    case = f"{kernel} {h}x{w} ac={align_corners} flow~{scale}+{bias}"
    check(err <= atol and bool(torch.isfinite(got).all()),
          f"{case}: kernel disagrees with plain version, max abs err {err} > {atol}")
    planar = warp_kernel.warp_one(img, flow, align_corners, pairs, True)
    check(torch.equal(planar.movedim(1, -1), got), f"{case}: planar output differs")

    out = {"kernel": kernel, "shape": [1, h, w, 3], "align_corners": align_corners,
           "flow_sigma": scale, "flow_bias": list(bias), "max_abs_err": err, "atol": atol}
    if timed:
        grid = grid_for_grid_sample(flow)
        src = warp_kernel._rounded_source(img, pairs).permute(0, 3, 1, 2)
        lib = lambda: F.grid_sample(  # noqa: E731
            src, grid, mode="bilinear", padding_mode="zeros", align_corners=align_corners)
        out["library_max_abs_diff"] = float((lib().permute(0, 2, 3, 1) - got).abs().max())
        nbytes = img.numel() * 4 + flow.numel() * 4 + got.numel() * 4
        flops = 40.0 * h * w  # coordinates, 4 weights, 12 multiply-adds, per pixel
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out.update({
            "kernel_ms": time_ms(lambda: warp_kernel.warp_one(img, flow, align_corners, pairs)),
            "plain_ms": time_ms(
                lambda: warp_kernel._warp_plain(img, flow, align_corners, pairs, False), iters=3),
            "library_ms": time_ms(lib),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
        })
    return out


def warp_cases(rng, dev):
    cases = []
    for pairs in ("u8", False, True):
        for ac in (False, True):
            # main-path shape, flow as a refined 1080p flow would be
            cases.append(warp_case(rng, dev, pairs, HP, WP, ac, 3.0, (0.0, 0.0),
                                   WARP_ATOL, timed=not ac))
            # a width that is not a multiple of 128, flow leaving the image
            cases.append(warp_case(rng, dev, pairs, 272, 200, ac, 4.0, (9.0, -7.0),
                                   WARP_ATOL, timed=False))
        # beyond the TPU kernel's window (|dx| > 126, |dy| > 30): same kernel here
        cases.append(warp_case(rng, dev, pairs, HP, WP, False, 1.0, (200.0, 50.0),
                               WARP_ATOL_LARGE, timed=False))
    return cases


# ------------------------------------------------------------------- serving

def moving_squares(seed: int, h: int, w: int) -> np.ndarray:
    """One uint8 frame pair (1, 2, h, w, 3): squares moving over a gradient."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, 0.5 + 0.0 * xx], axis=-1) * 160.0 + 40.0
    base += rng.normal(0.0, 2.0, base.shape)
    pair = []
    for shift in (0, 1):
        f = base.copy()
        sq = np.random.default_rng(seed + 1)
        for _ in range(8):
            size = int(sq.integers(h // 16, h // 5))
            y0 = int(sq.integers(0, h - size))
            x0 = int(sq.integers(0, w - size))
            dy, dx = (int(v) for v in sq.integers(-h // 60 - 2, h // 60 + 3, 2))
            color = sq.integers(0, 256, 3)
            ys, xs = y0 + shift * dy, x0 + shift * dx
            f[max(ys, 0):max(ys + size, 0), max(xs, 0):max(xs + size, 0)] = color
        pair.append(np.clip(np.round(f), 0, 255).astype(np.uint8))
    return np.stack(pair)[None]


def serve_request(interp, pairs):
    """One request: host uint8 in, host uint8 out; returns (mids, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mids = interp.step(pairs).cpu().numpy()
    return mids, (time.perf_counter() - t0) * 1e3


def phase_serve(params, dev):
    pairs = moving_squares(0, H1080, W1080)
    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True,
                          packed=False, exp=1, device=dev)
    serve_request(interp, pairs)  # warm-up
    _build.reset_launch_counts()
    times = []
    for i in range(4):
        before = _build.launch_counts()
        mids, ms = serve_request(interp, moving_squares(i, H1080, W1080))
        after = _build.launch_counts()
        times.append(ms)
        check(mids.shape == (1, 1, H1080, W1080, 3) and mids.dtype == np.uint8,
              f"serve: output {mids.dtype} {mids.shape}")
        check(after["conv_phase"] - before["conv_phase"] == 36,
              f"serve: {after['conv_phase'] - before['conv_phase']} conv launches, want 36")
        check(after["warp_u8"] - before["warp_u8"] == 2, "serve: want 2 warp_u8 launches")
        check(mids.std() > 1.0, "serve: output frame is constant")
    exp1_counts = _build.launch_counts()
    per_request = {k: after[k] - before[k] for k in after}
    check(exp1_counts["warp_f32"] == 0 and exp1_counts["warp_bf16"] == 0,
          "serve: the bf16 path launched another warp variant")

    interp2 = Interpolator(params, compute_dtype="bfloat16", use_pallas=True,
                           packed=False, exp=2, device=dev)
    mids2, ms2 = serve_request(interp2, pairs)
    counts = _build.launch_counts()
    check(mids2.shape == (1, 3, H1080, W1080, 3) and mids2.dtype == np.uint8,
          f"serve exp=2: output {mids2.dtype} {mids2.shape}")
    # the flow U-Net runs once, the other three once per time
    check(counts["conv_phase"] - exp1_counts["conv_phase"] == 9 + 3 * 27,
          "serve exp=2: want 90 conv launches")
    check(counts["warp_u8"] - exp1_counts["warp_u8"] == 6, "serve exp=2: want 6 warp_u8 launches")
    emit("serve", requests=4, shape=[1, 2, H1080, W1080, 3], compute_dtype="bfloat16",
         ms_per_request=times, ms_exp2_request=ms2, launches=counts,
         launches_per_exp1_request=per_request,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return counts


def phase_profile(params, dev, top: int = 12):
    """Device time of two served 1080p requests by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True,
                          packed=False, exp=1, device=dev)
    pairs = moving_squares(0, H1080, W1080)
    serve_request(interp, pairs)
    n = 2
    plain_ms = sum(serve_request(interp, pairs)[1] for _ in range(n)) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            serve_request(interp, pairs)
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(rows) > 0, "profile: the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    def group(name: str) -> str:
        low = name.lower()
        if "conv_phase_kernel" in low:
            return "conv_phase (K1)"
        if "warp_kernel" in low or "pack_u8" in low or "pack_bf16" in low:
            return "warp (K2-K4) + packing"
        if "memcpy" in low or "memset" in low:
            return "copies host<->device"
        if any(t in low for t in ("xmma", "cudnn", "gemm", "cutlass", "nchwtonhwc", "nhwctonchw")):
            return "library convs (cout >= 128)"
        if "catarray" in low:
            return "torch.cat"
        return "elementwise PyTorch"

    groups: dict = {}
    for key, ms, _ in rows:
        groups[group(key)] = groups.get(group(key), 0.0) + ms
    # The profiler slows the host, so the idle share is taken against the
    # requests timed just before it was switched on.
    emit("profile", requests=n, ms_per_request_unprofiled=plain_ms,
         device_busy_ms_per_request=busy,
         device_idle_share=max(0.0, 1.0 - busy / plain_ms),
         kernels_per_request=sum(r[2] for r in rows), by_group=groups,
         top=[{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in rows[:top]])


def phase_serve_fp32(params, dev):
    # The JAX package's float32 path runs its convs at full float32 precision,
    # so TF32 is switched off for the float32 convs and matrix products here.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = SMALL_HW
    pairs = moving_squares(5, h, w)
    interp = Interpolator(params, compute_dtype="float32", use_pallas=True,
                          packed=False, device=dev)
    serve_request(interp, pairs)  # warm-up
    _build.reset_launch_counts()
    mids, ms = serve_request(interp, pairs)
    check(mids.shape == (1, 1, h, w, 3) and mids.dtype == np.uint8, "serve_fp32: output")
    x = torch.from_numpy(pairs).to(dev).float() * (1.0 / 255.0)
    fl = torch.from_numpy(
        np.random.default_rng(6).standard_normal((1, h, w, 4)).astype(np.float32) * 3).to(dev)
    g0, g1 = warp_pair(x[:, 0].contiguous(), x[:, 1].contiguous(), fl[..., :2], fl[..., 2:],
                       use_pallas=True, pairs=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g0).all() and torch.isfinite(g1).all()), "serve_fp32: warp_pair")
    counts = _build.launch_counts()
    check(counts["warp_f32"] == 2, f"serve_fp32: {counts['warp_f32']} warp_f32 launches, want 2")
    check(counts["warp_bf16"] == 2, f"serve_fp32: {counts['warp_bf16']} warp_bf16 launches, want 2")
    check(counts["conv_phase"] == 0 and counts["warp_u8"] == 0,
          "serve_fp32: float32 inputs reached a bf16 kernel")
    emit("serve_fp32", shape=[1, 2, h, w, 3], compute_dtype="float32", tf32=False,
         ms_per_request=ms, launches=counts)
    return counts


def phase_agreement(params, dev):
    h, w = SMALL_HW
    pairs = moving_squares(9, h, w)
    cpu_params = params_from_numpy(
        unflatten_params(flatten_params(params)), device="cpu")
    out = {}
    for dtype in ("float32", "bfloat16"):
        kw = dict(compute_dtype=dtype, use_pallas=True, packed=False)
        card = Interpolator(params, device=dev, **kw).step(pairs).cpu().numpy()
        host = Interpolator(cpu_params, device="cpu", **kw).step(pairs).numpy()
        check(card.shape == host.shape == (1, 1, h, w, 3), "agreement: shapes")
        d = np.abs(card.astype(np.int32) - host.astype(np.int32))
        mse = float(np.mean(d.astype(np.float64) ** 2)) / 255.0 ** 2
        out[dtype] = {"max_u8_steps": int(d.max()), "share_differing": float((d > 0).mean()),
                      "psnr_db": float(10 * np.log10(1.0 / max(mse, 1e-12)))}
    f32, b16 = out["float32"], out["bfloat16"]
    # the JAX package's bar between two programs computing the same frames
    check(f32["max_u8_steps"] <= 1 and f32["share_differing"] < 1e-3,
          f"agreement float32: {f32}")
    check(b16["psnr_db"] >= BF16_PSNR_DB, f"agreement bfloat16: {b16}")
    emit("agreement", shape=[1, 2, h, w, 3], bf16_psnr_bar_db=BF16_PSNR_DB, **out)


# ------------------------------------------------------------------- summary

def kernels_summary(conv, warps, serve_counts, fp32_counts):
    """The per-kernel closing object: launches from the served paths, every
    other number measured above in this run."""
    per_unet = [c for c in conv if c["per_flow_unet"]]

    def total(key):
        return sum(c[key] * c["per_flow_unet"] for c in per_unet)

    t_ops = total("flops") / BF16_FLOPS * 1e3
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    entries = [{
        "name": "conv_phase", "route": "cuda",
        "source": "rrin_tpu_torch/csrc/conv_phase.cu",
        "replaces": "rrin_tpu/ops/conv_phase.py:164",
        "launches": serve_counts["conv_phase"],
        "max_abs_err": max(c["max_abs_err"] for c in conv),
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"),
        "what": "sum over the 9 launches of one flow U-Net at 1088x1920",
    }]
    lines = {"warp_u8": "350", "warp_f32": "481", "warp_bf16": "211"}
    for name in ("warp_u8", "warp_f32", "warp_bf16"):
        timed = next(c for c in warps if c["kernel"] == name and "kernel_ms" in c)
        counts = serve_counts if name == "warp_u8" else fp32_counts
        entries.append({
            "name": name, "route": "cuda", "source": "rrin_tpu_torch/csrc/warp.cu",
            "replaces": f"rrin_tpu/ops/warp_pallas.py:{lines[name]}",
            "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in warps if c["kernel"] == name),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "what": "one warp at 1088x1920 (source packing pass included)",
        })
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was never launched by the path it belongs to")
    return {"kernels": entries}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    dev = torch.device("cuda:0")
    smi = smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.sources():
        _build.library(name)
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-2:]
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         nvcc=nvcc, flags=_build.NVCC_FLAGS, ptxas=regs)

    rng = np.random.default_rng(0)
    conv = conv_cases(rng, dev)
    warps = warp_cases(rng, dev)
    emit("kernels", conv_phase=conv, warp=warps,
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S, "bf16_flops": BF16_FLOPS,
                "fp32_flops": FP32_FLOPS})

    params = init_params(torch.Generator().manual_seed(0), ModelConfig(), device=dev)
    serve_counts = phase_serve(params, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(params, dev)
    fp32_counts = phase_serve_fp32(params, dev)
    phase_agreement(params, dev)

    summary = kernels_summary(conv, warps, serve_counts, fp32_counts)
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
