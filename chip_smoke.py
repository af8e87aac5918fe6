#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

needs one CUDA GPU (written for an H100, sm_90a), `nvcc`, PyTorch with CUDA
and numpy; nothing else and no network. It builds the CUDA kernels of
``rrin_tpu_torch/csrc`` and runs these phases, each printing one JSON line:

  device       the card's name and power limit
  build        nvcc over every kernel source, in parallel
  kernels      every kernel against its plain PyTorch version on the card at
               the shapes of the 1080p paths, with times and bounds
  serve        the main path: the default Interpolator (bfloat16, kernels,
               packed U-Net path, full model width) answering 1080p requests
  serve_plain  one 1080p request on the plain U-Net path (``packed=False``)
  serve_fp32   the float32 path (float32 warp kernel) and the bf16-source warp
  agreement    card (kernels) against CPU (plain versions), and packed against
               plain path on the card, on one request

Any failed check raises, so the exit code is non-zero and the closing lines
are not printed. The closing lines are: the card's name and power limit, one
``{"kernels": [...], "not_ported": [...]}`` object (launch counts from the
served paths, times measured in this run), and ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --profile`` adds one phase after ``serve_plain``:
``torch.profiler`` traces of two 1080p requests on each U-Net path, printed
as device time by group of kernels (where the time of a request goes).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from rrin_tpu_torch import ModelConfig, _build, init_params
from rrin_tpu_torch.ops import conv_packed, conv_phase, warp_kernel
from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear
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
# K5, K7, K8 round where their plain versions round (pooled and upsampled
# values are built in float32 and rounded once to bf16 on both sides), so
# they are held to K1's bar. K9 contracts folded weights that were rounded to
# bf16 after the fold, which its plain version (upsample, then conv with the
# unfolded bf16 weights) does not: against that it is held to a PSNR bar and
# four bf16 steps (4 * 2^-8) of the largest output value; against the fold
# written out in PyTorch with the same rounding points, to K1's bar.
UPF_PSNR_DB = 55.0
UPF_STEPS = 4
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


# ------------------------------------------------- kernels: K5, K7, K8, K9

def _upsampled(xs):
    return upsample_2x_bilinear(xs[0].float()).to(torch.bfloat16)


# kernel name -> (wrapper, plain version, how the input of the conv is
# materialised for the plain version and the library yardstick, the host-side
# weight layout that prepared= takes).
PACKED_KERNELS = {
    "conv_packed": (
        conv_packed.conv_packed, conv_packed._conv_packed_plain,
        lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1),
        conv_packed.prep_conv),
    "conv_pool_packed": (
        conv_packed.conv_pool_packed, conv_packed._conv_pool_plain,
        lambda xs: avg_pool_2x(xs[0].float()).to(torch.bfloat16),
        lambda w, b, cins: conv_packed.prep_conv_pool(w, b)),
    "conv_up_m_packed": (
        conv_packed.conv_up_m_packed, conv_packed._conv_up_plain, _upsampled,
        lambda w, b, cins: conv_packed.prep_conv_up_m(w, b)),
    "conv_up_f_packed": (
        conv_packed.conv_up_f_packed, conv_packed._conv_up_plain, _upsampled,
        lambda w, b, cins: conv_packed.prep_conv_up_f(w, b)),
}


def packed_case(rng, dev, kernel, name, h, w, cins, cout, k, slope):
    """One site of a packed-path kernel; (h, w) is the resolution the conv
    runs at, i.e. of its output. The stored input is (2h, 2w) for the pool
    kernel and (h/2, w/2) for the upsampling kernels."""
    wrapper, plain, materialise, prepare = PACKED_KERNELS[kernel]
    hs, ws = {"conv_packed": (h, w), "conv_pool_packed": (2 * h, 2 * w)}.get(
        kernel, (h // 2, w // 2))
    xs = [torch.from_numpy(rng.standard_normal((1, hs, ws, c)).astype(np.float32))
          .to(dev).to(torch.bfloat16) for c in cins]
    cin = sum(cins)
    bound = 1.0 / np.sqrt(k * k * cin)  # the init bound of the model's convs
    wt = torch.from_numpy(
        rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-bound, bound, (cout,)).astype(np.float32)).to(dev)
    arg = xs if kernel == "conv_packed" else xs[0]

    before = _build.launch_counts()[kernel]
    got = wrapper(arg, wt, bias, slope)
    torch.cuda.synchronize()
    check(_build.launch_counts()[kernel] == before + 1,
          f"{name}: {kernel} did not launch its kernel")
    want = plain(arg, wt, bias, slope)
    check(got.shape == want.shape == (1, h, w, cout) and got.dtype == torch.bfloat16,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    out = {"site": name, "kernel": kernel, "out_shape": [1, h, w, cout], "cins": list(cins),
           "k": k, "slope": slope, "max_abs_err": err}
    if kernel == "conv_up_f_packed":
        peak = float(want.float().abs().max())
        psnr = 10 * np.log10(peak * peak / max(float((diff.double() ** 2).mean()), 1e-20))
        atol = UPF_STEPS * 2.0 ** -8 * peak
        check(psnr >= UPF_PSNR_DB and err <= atol,
              f"{name}: folded kernel vs plain version: {psnr} dB, max abs err {err} > {atol}")
        folded = conv_packed._conv_up_f_folded(xs[0], wt, bias, slope)
        fdiff = (got.float() - folded.float()).abs()
        check(bool((fdiff <= CONV_ATOL + CONV_RTOL * folded.float().abs()).all()),
              f"{name}: kernel disagrees with the fold in PyTorch, max abs err {float(fdiff.max())}")
        out.update({"psnr_db": psnr, "psnr_bar_db": UPF_PSNR_DB, "atol": atol,
                    "max_abs_err_vs_fold": float(fdiff.max()), "fold_atol": CONV_ATOL})
    else:
        check(bool((diff <= CONV_ATOL + CONV_RTOL * want.float().abs()).all()),
              f"{name}: kernel disagrees with plain version, max abs err {err}")
        out.update({"atol": CONV_ATOL, "rtol": CONV_RTOL})

    # The library yardstick: one F.conv2d call on the materialised input
    # (concatenated, pooled or upsampled beforehand, outside the timing), bf16
    # channels-last with bias, no activation; used nowhere in the port.
    xn = materialise(xs).permute(0, 3, 1, 2)
    wn = wt.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bn = bias.to(torch.bfloat16)
    pad = (k - 1) // 2
    out["kernel_ms"] = time_ms(lambda: wrapper(arg, wt, bias, slope))
    out["plain_ms"] = time_ms(lambda: plain(arg, wt, bias, slope))
    out["library_ms"] = time_ms(lambda: F.conv2d(xn, wn, bn, padding=pad))
    # The kernel without the per-call weight re-layout (prepared= given).
    prep = prepare(wt, bias, cins)
    check(torch.equal(wrapper(arg, wt, bias, slope, prepared=prep), got),
          f"{name}: prepared= changes the result")
    out["kernel_prepared_ms"] = time_ms(lambda: wrapper(arg, wt, bias, slope, prepared=prep))

    # The bytes the fused kernel must move: each stored operand once (no
    # pooled, upsampled or concatenated tensor), weights, bias, the output.
    flops = 2.0 * h * w * k * k * cin * cout
    nbytes = sum(x.numel() for x in xs) * 2 + wt.numel() * 4 + bias.numel() * 4 + got.numel() * 2
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    out.update({"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes})
    return out


def packed_cases(rng, dev):
    s = ModelConfig().leaky_slope
    specs = [
        # (kernel, name, h, w, cins, cout, k, slope, launches of this site in
        #  the flow U-Net at 1088x1920)
        ("conv_packed", "c1_flow_cin6", HP, WP, (6,), 32, 7, s, 1),
        ("conv_packed", "c1_refine_cin10", HP, WP, (10,), 32, 7, s, 0),
        ("conv_packed", "c1_mask_cin16", HP, WP, (16,), 32, 7, s, 0),
        ("conv_packed", "c1_final_cin9", HP, WP, (9,), 32, 7, s, 0),
        ("conv_packed", "c2", HP, WP, (32,), 32, 7, s, 1),
        ("conv_packed", "d1c2", HP // 2, WP // 2, (64,), 64, 5, s, 1),
        ("conv_packed", "d2c2", HP // 4, WP // 4, (128,), 128, 3, s, 1),
        ("conv_packed", "d3c1", HP // 8, WP // 8, (128,), 256, 3, s, 1),
        ("conv_packed", "d3c2", HP // 8, WP // 8, (256,), 256, 3, s, 1),
        ("conv_packed", "d4c1", HP // 16, WP // 16, (256,), 512, 3, s, 1),
        ("conv_packed", "d4c2", HP // 16, WP // 16, (512,), 512, 3, s, 1),
        ("conv_packed", "u1c1", HP // 8, WP // 8, (512,), 256, 3, s, 1),
        ("conv_packed", "u1c2", HP // 8, WP // 8, (256, 256), 256, 3, s, 1),
        ("conv_packed", "u2c2", HP // 4, WP // 4, (128, 128), 128, 3, s, 1),
        ("conv_packed", "u3c2", HP // 2, WP // 2, (64, 64), 64, 3, s, 1),
        ("conv_packed", "u4c2", HP, WP, (32, 32), 32, 3, s, 1),
        ("conv_packed", "head_cout4", HP, WP, (32,), 4, 3, None, 1),
        ("conv_packed", "head_cout2", HP, WP, (32,), 2, 3, None, 0),
        ("conv_packed", "head_cout3", HP, WP, (32,), 3, 3, None, 0),
        ("conv_packed", "ragged_270x485", 270, 485, (32, 32), 32, 3, s, 0),
        ("conv_pool_packed", "d1c1", HP // 2, WP // 2, (32,), 64, 5, s, 1),
        ("conv_pool_packed", "d2c1", HP // 4, WP // 4, (64,), 128, 3, s, 1),
        ("conv_pool_packed", "ragged_135x243", 135, 243, (32,), 64, 5, s, 0),
        ("conv_up_m_packed", "u2c1", HP // 4, WP // 4, (256,), 128, 3, s, 1),
        ("conv_up_m_packed", "ragged_270x486", 270, 486, (64,), 64, 3, s, 0),
        ("conv_up_f_packed", "u3c1", HP // 2, WP // 2, (128,), 64, 3, s, 1),
        ("conv_up_f_packed", "u4c1", HP, WP, (64,), 32, 3, s, 1),
        ("conv_up_f_packed", "ragged_270x486", 270, 486, (64,), 32, 3, s, 0),
    ]
    cases = []
    for kernel, name, h, w, cins, cout, k, slope, mult in specs:
        c = packed_case(rng, dev, kernel, name, h, w, cins, cout, k, slope)
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


# Launches of one 1080p exp=1 request (4 U-Nets, 2 warps) on each U-Net path.
PACKED_PER_REQUEST = {"conv_packed": 56, "conv_pool_packed": 8, "conv_up_m_packed": 4,
                      "conv_up_f_packed": 8, "warp_u8": 2}
PLAIN_PER_REQUEST = {"conv_phase": 36, "warp_u8": 2}


def check_launches(what, before, after, want, times=1):
    """Every kernel's count moved by ``times * want`` (0 where not named)."""
    for name in after:
        moved = after[name] - before[name]
        check(moved == times * want.get(name, 0),
              f"{what}: {moved} {name} launches, want {times * want.get(name, 0)}")


def phase_serve(params, dev):
    """The main path: the default Interpolator, i.e. ``packed=None`` following
    ``use_pallas``, so every U-Net runs ``unet_apply_packed``."""
    pairs = moving_squares(0, H1080, W1080)
    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, exp=1,
                          device=dev)
    check(interp.packed is None, "serve: the Interpolator's packed default is not None")
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
        check_launches("serve", before, after, PACKED_PER_REQUEST)
        check(mids.std() > 1.0, "serve: output frame is constant")
    exp1_counts = _build.launch_counts()
    per_request = {k: after[k] - before[k] for k in after}

    interp2 = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, exp=2,
                           device=dev)
    mids2, ms2 = serve_request(interp2, pairs)
    counts = _build.launch_counts()
    check(mids2.shape == (1, 3, H1080, W1080, 3) and mids2.dtype == np.uint8,
          f"serve exp=2: output {mids2.dtype} {mids2.shape}")
    # the flow U-Net runs once, the other three once per time: 10 U-Nets, 6 warps
    check_launches("serve exp=2", exp1_counts, counts,
                   {k: (v // 4 * 10 if k != "warp_u8" else 6)
                    for k, v in PACKED_PER_REQUEST.items()})
    emit("serve", path="packed", requests=4, shape=[1, 2, H1080, W1080, 3],
         compute_dtype="bfloat16", ms_per_request=times, ms_exp2_request=ms2,
         launches=counts, launches_per_exp1_request=per_request,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return counts


def phase_serve_plain(params, dev):
    """One request on the plain U-Net path, which K1 serves."""
    pairs = moving_squares(0, H1080, W1080)
    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True,
                          packed=False, exp=1, device=dev)
    serve_request(interp, pairs)  # warm-up
    _build.reset_launch_counts()
    times = []
    for i in range(2):
        before = _build.launch_counts()
        mids, ms = serve_request(interp, moving_squares(i, H1080, W1080))
        times.append(ms)
        check(mids.shape == (1, 1, H1080, W1080, 3) and mids.dtype == np.uint8,
              f"serve_plain: output {mids.dtype} {mids.shape}")
        check_launches("serve_plain", before, _build.launch_counts(), PLAIN_PER_REQUEST)
        check(mids.std() > 1.0, "serve_plain: output frame is constant")
    counts = _build.launch_counts()
    emit("serve_plain", path="plain", requests=2, shape=[1, 2, H1080, W1080, 3],
         compute_dtype="bfloat16", ms_per_request=times, launches=counts)
    return counts


_PACKED_MODES = {"0": "conv_packed (K5)", "1": "conv_pool_packed (K7)",
                 "2": "conv_up_m_packed (K8)", "3": "conv_up_f_packed (K9)"}


def _profile_group(name: str) -> str:
    low = name.lower()
    packed = re.search(r"conv_packed_kernel<\s*\d+,\s*(?:\(.*?\))?(\d+)\s*>", low)
    if packed:  # conv_packed_kernel<NT, MODE>: the mode is the entry point
        return _PACKED_MODES[packed.group(1)]
    if "conv_phase_kernel" in low:
        return "conv_phase (K1)"
    if "warp_kernel" in low or "pack_u8" in low or "pack_bf16" in low:
        return "warp (K2-K4) + packing"
    if "memcpy" in low or "memset" in low:
        return "copies host<->device"
    if any(t in low for t in ("xmma", "cudnn", "gemm", "cutlass", "nchwtonhwc", "nhwctonchw")):
        return "library convs"
    if "catarray" in low:
        return "torch.cat"
    return "elementwise PyTorch"


def phase_profile(params, dev, packed, top: int = 12):
    """Device time of two served 1080p requests by group of kernels, on the
    packed (``packed=None``) or the plain (``packed=False``) U-Net path."""
    from torch.profiler import ProfilerActivity, profile

    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True,
                          packed=packed, exp=1, device=dev)
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
    groups: dict = {}
    for key, ms, _ in rows:
        groups[_profile_group(key)] = groups.get(_profile_group(key), 0.0) + ms
    # The profiler slows the host, so the idle share is taken against the
    # requests timed just before it was switched on.
    emit("profile", path="plain" if packed is False else "packed", requests=n,
         ms_per_request_unprofiled=plain_ms, device_busy_ms_per_request=busy,
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
    check(all(n == 0 for k, n in counts.items() if k not in ("warp_f32", "warp_bf16")),
          f"serve_fp32: float32 inputs reached a bf16 kernel: {counts}")
    emit("serve_fp32", shape=[1, 2, h, w, 3], compute_dtype="float32", tf32=False,
         ms_per_request=ms, launches=counts)
    return counts


def _u8_agreement(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    mse = float(np.mean(d.astype(np.float64) ** 2)) / 255.0 ** 2
    return {"max_u8_steps": int(d.max()), "share_differing": float((d > 0).mean()),
            "psnr_db": float(10 * np.log10(1.0 / max(mse, 1e-12)))}


def phase_agreement(params, dev):
    h, w = SMALL_HW
    pairs = moving_squares(9, h, w)
    cpu_params = params_from_numpy(
        unflatten_params(flatten_params(params)), device="cpu")

    def run(dtype, packed, device, prm):
        mids = Interpolator(prm, compute_dtype=dtype, use_pallas=True, packed=packed,
                            device=device).step(pairs).cpu().numpy()
        check(mids.shape == (1, 1, h, w, 3), "agreement: shapes")
        return mids

    card = {(dt, pk): run(dt, pk, dev, params)
            for dt, pk in (("float32", False), ("bfloat16", False), ("bfloat16", True))}
    out = {
        "float32": _u8_agreement(card["float32", False],
                                 run("float32", False, "cpu", cpu_params)),
        "bfloat16": _u8_agreement(card["bfloat16", False],
                                  run("bfloat16", False, "cpu", cpu_params)),
        "bfloat16_packed": _u8_agreement(card["bfloat16", True],
                                         run("bfloat16", True, "cpu", cpu_params)),
        "packed_vs_plain_on_card": _u8_agreement(card["bfloat16", True],
                                                 card["bfloat16", False]),
    }
    f32 = out["float32"]
    # the JAX package's bar between two programs computing the same frames
    check(f32["max_u8_steps"] <= 1 and f32["share_differing"] < 1e-3,
          f"agreement float32: {f32}")
    for key in ("bfloat16", "bfloat16_packed", "packed_vs_plain_on_card"):
        check(out[key]["psnr_db"] >= BF16_PSNR_DB, f"agreement {key}: {out[key]}")
    emit("agreement", shape=[1, 2, h, w, 3], bf16_psnr_bar_db=BF16_PSNR_DB, **out)


# ------------------------------------------------------------------- summary

TPU_KERNEL_LINES = {
    "conv_phase": "rrin_tpu/ops/conv_phase.py:164",
    "warp_u8": "rrin_tpu/ops/warp_pallas.py:350",
    "warp_f32": "rrin_tpu/ops/warp_pallas.py:481",
    "warp_bf16": "rrin_tpu/ops/warp_pallas.py:211",
    "conv_packed": "rrin_tpu/ops/conv_packed.py:506",
    "conv_pool_packed": "rrin_tpu/ops/conv_packed.py:1115",
    "conv_up_m_packed": "rrin_tpu/ops/conv_packed.py:1845",
    "conv_up_f_packed": "rrin_tpu/ops/conv_packed.py:2373",
}


def _conv_entry(name, source, cases, launches, what):
    """One closing entry for a conv kernel: sums over its sites in one flow
    U-Net at 1088x1920, weighted by how often each site occurs there."""
    per_unet = [c for c in cases if c["per_flow_unet"]]

    def total(key):
        return sum(c[key] * c["per_flow_unet"] for c in per_unet)

    t_ops = total("flops") / BF16_FLOPS * 1e3
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": TPU_KERNEL_LINES[name], "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"), "what": what,
    }


def kernels_summary(conv, packed, warps, serve_counts, plain_counts, fp32_counts):
    """The per-kernel closing object: launches from the served paths (each
    kernel from the path it belongs to), every other number measured above
    in this run."""
    entries = [_conv_entry(
        "conv_phase", "rrin_tpu_torch/csrc/conv_phase.cu", conv,
        plain_counts["conv_phase"],
        "sum over the 9 launches of one flow U-Net at 1088x1920 (plain path)")]
    for name in ("warp_u8", "warp_f32", "warp_bf16"):
        timed = next(c for c in warps if c["kernel"] == name and "kernel_ms" in c)
        counts = serve_counts if name == "warp_u8" else fp32_counts
        entries.append({
            "name": name, "route": "cuda", "source": "rrin_tpu_torch/csrc/warp.cu",
            "replaces": TPU_KERNEL_LINES[name],
            "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in warps if c["kernel"] == name),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "what": "one warp at 1088x1920 (source packing pass included)",
        })
    for name in ("conv_packed", "conv_pool_packed", "conv_up_m_packed", "conv_up_f_packed"):
        cases = [c for c in packed if c["kernel"] == name]
        n = sum(c["per_flow_unet"] for c in cases)
        entries.append(_conv_entry(
            name, "rrin_tpu_torch/csrc/conv_packed.cu", cases, serve_counts[name],
            f"sum over the {n} launches of one flow U-Net at 1088x1920 (packed path)"))
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was never launched by the path it belongs to")
    not_ported = [{
        "name": "conv_up_packed", "replaces": "rrin_tpu/ops/conv_packed.py:824",
        "status": "not ported: no site of a 1080p request takes it (ROADMAP.md Queue B)",
    }]
    return {"kernels": entries, "not_ported": not_ported}


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
    packed = packed_cases(rng, dev)
    warps = warp_cases(rng, dev)
    emit("kernels", conv_phase=conv, conv_packed=packed, warp=warps,
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S, "bf16_flops": BF16_FLOPS,
                "fp32_flops": FP32_FLOPS})

    params = init_params(torch.Generator().manual_seed(0), ModelConfig(), device=dev)
    serve_counts = phase_serve(params, dev)
    plain_counts = phase_serve_plain(params, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(params, dev, packed=None)
        phase_profile(params, dev, packed=False)
    fp32_counts = phase_serve_fp32(params, dev)
    phase_agreement(params, dev)

    summary = kernels_summary(conv, packed, warps, serve_counts, plain_counts, fp32_counts)
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
