#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

needs one CUDA GPU (written for an H100, sm_90a), `nvcc`, PyTorch with CUDA
and numpy; nothing else and no network. It builds the CUDA kernels of
``rrin_tpu_torch/csrc`` and runs these phases, each printing one JSON line:

  device       the card's name and power limit
  build        nvcc over every kernel source, in parallel
  kernels      every kernel against its plain PyTorch version on the card at
               the shapes of the 1080p paths (K6 and K9 also at the 4K up
               sites), in bfloat16 and in int8, with times and bounds
  serve        the main path: the default Interpolator (bfloat16, kernels,
               packed U-Net path, full model width) answering 1080p requests
  serve_4k     the same Interpolator answering 2160x3840 requests, whose up
               sites u3c1 and u4c1 take K6 (conv_up_packed)
  serve_int8   ``Interpolator(int8=True)``: calibration, then int8 requests
               at 1080p (beside bfloat16 ones) and one at 2160x3840
  serve_plain  one 1080p request on the plain U-Net path (``packed=False``)
  serve_fp32   the float32 path (float32 warp kernel) and the bf16-source warp
  agreement    card (kernels) against CPU (plain versions), packed against
               plain path on the card, int8 card against int8 CPU, and the K6
               route at a 4K width, on one request each

Any failed check raises, so the exit code is non-zero and the closing lines
are not printed. The closing lines are: the card's name and power limit, one
``{"kernels": [...], "not_ported": [...]}`` object (launch counts from the
served paths, times measured in this run), and ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --profile`` adds one phase after ``serve_plain``:
``torch.profiler`` traces of two 1080p requests on each U-Net path, of one
int8 1080p request and of one bfloat16 4K request, printed as device time by
group of kernels (where the time of a request goes).
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
from rrin_tpu_torch.models.rrin import scale_quant_stats
from rrin_tpu_torch.ops import conv_packed, conv_phase, warp_kernel
from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear
from rrin_tpu_torch.ops.warp import warp_pair
from rrin_tpu_torch.params.checkpoint import (
    flatten_params,
    params_from_numpy,
    unflatten_params,
)
from rrin_tpu_torch.pipeline import Interpolator, device_calibrate

# Published peaks of one H100 SXM (dense): the bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
NO_INT8_LIBRARY = "no PyTorch call computes an int8 conv on CUDA"

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
# int8 kernels: the int32 sum is exact and the plain version's float32
# fake-quant sum is not, so an output rounded to the int8 grid may land one
# step away where it sits near a tie; a bf16 output is held to K1's bar.
INT8_STEPS = 1
# int8 request against the bf16 one: the JAX package's bar for its int8
# cascade against float32 (tests/test_int8.py); int8 card against int8 CPU
# with the same stats: the bf16 card-vs-CPU bar.
INT8_VS_BF16_PSNR_DB = 35.0
INT8_CARD_CPU_PSNR_DB = 40.0

H1080, W1080 = 1080, 1920
HP, WP = 1088, 1920            # 1080p padded to the /16 grid
H4K, W4K = 2160, 3840          # on the /16 grid already
SMALL_HW = (256, 448)
K6_ROUTE_HW = (64, 3200)       # the narrowest width the reference sends to K6


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


# kernel name -> (wrapper, plain version, int8 plain version, how the input of
# the conv is materialised for the plain version and the library yardstick,
# the host-side weight layout that prepared= takes).
PACKED_KERNELS = {
    "conv_packed": (
        conv_packed.conv_packed, conv_packed._conv_packed_plain,
        conv_packed._conv_packed_q_plain,
        lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1),
        conv_packed.prep_conv),
    "conv_pool_packed": (
        conv_packed.conv_pool_packed, conv_packed._conv_pool_plain,
        conv_packed._conv_pool_q_plain,
        lambda xs: avg_pool_2x(xs[0].float()).to(torch.bfloat16),
        lambda w, b, cins, *q: conv_packed.prep_conv_pool(w, b, *q)),
    "conv_up_packed": (
        conv_packed.conv_up_packed, conv_packed._conv_up_wh_plain,
        conv_packed._conv_up_q_plain, _upsampled,
        lambda w, b, cins, *q: conv_packed.prep_conv_up(w, b, *q)),
    "conv_up_m_packed": (
        conv_packed.conv_up_m_packed, conv_packed._conv_up_plain,
        conv_packed._conv_up_m_q_plain, _upsampled,
        lambda w, b, cins, *q: conv_packed.prep_conv_up_m(w, b, *q)),
    "conv_up_f_packed": (
        conv_packed.conv_up_f_packed, conv_packed._conv_up_plain,
        conv_packed._conv_up_f_q_plain, _upsampled,
        lambda w, b, cins, *q: conv_packed.prep_conv_up_f(w, b, *q)),
}


def packed_case(rng, dev, kernel, name, h, w, cins, cout, k, slope, int8=None):
    """One site of a packed-path kernel; (h, w) is the resolution the conv
    runs at, i.e. of its output. The stored input is (2h, 2w) for the pool
    kernel and (h/2, w/2) for the upsampling kernels. ``int8``: None for
    bfloat16, else (which operands arrive as int8 already, int8 output)."""
    wrapper, plain, plain_q, materialise, prepare = PACKED_KERNELS[kernel]
    hs, ws = {"conv_packed": (h, w), "conv_pool_packed": (2 * h, 2 * w)}.get(
        kernel, (h // 2, w // 2))
    xs = [torch.from_numpy(rng.standard_normal((1, hs, ws, c)).astype(np.float32))
          .to(dev).to(torch.bfloat16) for c in cins]
    cin = sum(cins)
    bound = 1.0 / np.sqrt(k * k * cin)  # the init bound of the model's convs
    wt = torch.from_numpy(
        rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-bound, bound, (cout,)).astype(np.float32)).to(dev)
    single = kernel != "conv_packed"
    if int8 is not None:
        in_i8, out_q = int8
        axs = [x.float().abs().amax() for x in xs]
        xs = [conv_packed._quantize_act(x, a) if q else x for x, a, q in zip(xs, axs, in_i8)]
        qarg = axs[0] if single else axs
        oax = None
        if out_q:  # the output's own range, as calibration would find it
            oax = 1.2 * plain_q(xs[0] if single else xs, wt, bias, slope, qarg, None,
                                torch.float32).abs().amax()
        qkw = dict(in_absmax=qarg, out_absmax=oax)
        prep_q = (qarg, oax)
    else:
        qkw, prep_q = {}, ()
    arg = xs[0] if single else xs
    count = kernel + ("_int8" if int8 is not None else "")

    before = _build.launch_counts()[count]
    got = wrapper(arg, wt, bias, slope, **qkw)
    torch.cuda.synchronize()
    check(_build.launch_counts()[count] == before + 1,
          f"{name}: {kernel} did not launch its {'int8 ' if int8 else ''}kernel")
    if int8 is None:
        run_plain = lambda: plain(arg, wt, bias, slope)  # noqa: E731
    else:
        run_plain = lambda: plain_q(arg, wt, bias, slope, qarg, oax, None)  # noqa: E731
    want = run_plain()
    check(got.shape == want.shape == (1, h, w, cout) and got.dtype == want.dtype,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    out = {"site": name, "kernel": kernel, "out_shape": [1, h, w, cout], "cins": list(cins),
           "k": k, "slope": slope, "max_abs_err": err,
           "dtype": "bfloat16" if int8 is None else "int8"}
    if int8 is not None:
        out.update({"int8_inputs": list(int8[0]), "int8_output": int8[1]})
        if got.dtype == torch.int8:
            check(err <= INT8_STEPS, f"{name}: {err} int8 steps from the plain version")
            out.update({"max_int8_steps": int(err), "int8_steps_bar": INT8_STEPS,
                        "share_differing": float((diff > 0).float().mean())})
        else:
            check(bool((diff <= CONV_ATOL + CONV_RTOL * want.float().abs()).all()),
                  f"{name}: int8 kernel disagrees with plain version, max abs err {err}")
            out.update({"atol": CONV_ATOL, "rtol": CONV_RTOL})
    elif kernel == "conv_up_f_packed":
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

    out["kernel_ms"] = time_ms(lambda: wrapper(arg, wt, bias, slope, **qkw))
    out["plain_ms"] = time_ms(run_plain)
    if int8 is None:
        # The library yardstick: one F.conv2d call on the materialised input
        # (concatenated, pooled or upsampled beforehand, outside the timing),
        # bf16 channels-last with bias, no activation; used nowhere in the port.
        xn = materialise(xs).permute(0, 3, 1, 2)
        wn = wt.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bn = bias.to(torch.bfloat16)
        pad = (k - 1) // 2
        out["library_ms"] = time_ms(lambda: F.conv2d(xn, wn, bn, padding=pad))
    else:
        out.update({"library_ms": None, "library_null_reason": NO_INT8_LIBRARY})
    # The kernel without the per-call weight re-layout (prepared= given).
    prep = prepare(wt, bias, cins, *prep_q)
    check(torch.equal(wrapper(arg, wt, bias, slope, prepared=prep, **qkw), got),
          f"{name}: prepared= changes the result")
    out["kernel_prepared_ms"] = time_ms(
        lambda: wrapper(arg, wt, bias, slope, prepared=prep, **qkw))

    # The bytes the fused kernel must move: each stored operand once (no
    # pooled, upsampled or concatenated tensor; an int8 one at one byte an
    # element), weights, bias, the output; int8 operations at the int8 peak.
    flops = 2.0 * h * w * k * k * cin * cout
    nbytes = (sum(x.numel() * x.element_size() for x in xs) + wt.numel() * 4
              + bias.numel() * 4 + got.numel() * got.element_size())
    peak_ops = BF16_FLOPS if int8 is None else INT8_OPS
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    out.update({"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes})
    return out


def packed_cases(rng, dev):
    s = ModelConfig().leaky_slope
    specs = [
        # (kernel, name, h, w, cins, cout, k, slope, launches of this site in
        #  the flow U-Net at 1088x1920, or at 2160x3840 for the 4K rows)
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
        # K6 where the 4K request takes it, and K9 at the same sites beside it
        ("conv_up_packed", "u3c1_4k", H4K // 2, W4K // 2, (128,), 64, 3, s, 1),
        ("conv_up_packed", "u4c1_4k", H4K, W4K, (64,), 32, 3, s, 1),
        ("conv_up_packed", "k5_270x480", 270, 480, (64,), 32, 5, s, 0),
        ("conv_up_packed", "k1_ragged_270x486", 270, 486, (32,), 16, 1, s, 0),
        ("conv_up_f_packed", "u3c1_4k", H4K // 2, W4K // 2, (128,), 64, 3, s, 0),
        ("conv_up_f_packed", "u4c1_4k", H4K, W4K, (64,), 32, 3, s, 0),
    ]
    cases = []
    for kernel, name, h, w, cins, cout, k, slope, mult in specs:
        c = packed_case(rng, dev, kernel, name, h, w, cins, cout, k, slope)
        c["per_flow_unet"] = mult
        cases.append(c)
    return cases


def int8_cases(rng, dev):
    """One int8 site or more of each packed kernel, at the shapes of the int8
    requests: (which operands arrive as int8, int8 output) as the carry plan
    of ``models.unet.carry_plan`` has them there."""
    s = ModelConfig().leaky_slope
    specs = [
        ("conv_packed", "c1_flow_cin6", HP, WP, (6,), 32, 7, ((False,), True)),
        ("conv_packed", "d4c2", HP // 16, WP // 16, (512,), 512, 3, ((True,), False)),
        ("conv_packed", "u1c2", HP // 8, WP // 8, (256, 256), 256, 3, ((True, False), True)),
        ("conv_pool_packed", "d1c1", HP // 2, WP // 2, (32,), 64, 5, ((True,), True)),
        ("conv_up_m_packed", "u2c1", HP // 4, WP // 4, (256,), 128, 3, ((True,), True)),
        ("conv_up_f_packed", "u3c1", HP // 2, WP // 2, (128,), 64, 3, ((True,), True)),
        ("conv_up_f_packed", "u4c1", HP, WP, (64,), 32, 3, ((True,), True)),
        ("conv_up_packed", "u3c1_4k", H4K // 2, W4K // 2, (128,), 64, 3, ((True,), True)),
        ("conv_up_packed", "u4c1_4k", H4K, W4K, (64,), 32, 3, ((True,), True)),
        ("conv_up_packed", "k5_bf16_in_out", 270, 480, (64,), 32, 5, ((False,), False)),
    ]
    return [packed_case(rng, dev, kernel, name, h, w, cins, cout, k, s, int8=q)
            for kernel, name, h, w, cins, cout, k, q in specs]


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


# Launches of one exp=1 request (4 U-Nets, 2 warps) on each U-Net path: 1080p
# and 4K differ at u3c1 and u4c1 (K9 below width 3200, K6 from there on); in
# int8 every conv but the four heads is int8; the int8 calibration pass runs
# the plain path.
PACKED_PER_REQUEST = {"conv_packed": 56, "conv_pool_packed": 8, "conv_up_m_packed": 4,
                      "conv_up_f_packed": 8, "warp_u8": 2}
PACKED_4K_PER_REQUEST = {"conv_packed": 56, "conv_pool_packed": 8, "conv_up_m_packed": 4,
                         "conv_up_packed": 8, "warp_u8": 2}
INT8_PER_REQUEST = {"conv_packed_int8": 52, "conv_packed": 4, "conv_pool_packed_int8": 8,
                    "conv_up_m_packed_int8": 4, "conv_up_f_packed_int8": 8, "warp_u8": 2}
INT8_4K_PER_REQUEST = {"conv_packed_int8": 52, "conv_packed": 4, "conv_pool_packed_int8": 8,
                       "conv_up_m_packed_int8": 4, "conv_up_packed_int8": 8, "warp_u8": 2}
PLAIN_PER_REQUEST = {"conv_phase": 36, "warp_u8": 2}
CALIBRATION_LAUNCHES = PLAIN_PER_REQUEST


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
    torch.cuda.reset_peak_memory_stats()
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


def phase_serve_4k(params, dev):
    """The default Interpolator on 2160x3840 requests: the reference routes
    u3c1 and u4c1 to K6 at this width, and so does the port."""
    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, exp=1,
                          device=dev)
    serve_request(interp, moving_squares(0, H4K, W4K))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = []
    for i in range(3):
        before = _build.launch_counts()
        mids, ms = serve_request(interp, moving_squares(i, H4K, W4K))
        times.append(ms)
        check(mids.shape == (1, 1, H4K, W4K, 3) and mids.dtype == np.uint8,
              f"serve_4k: output {mids.dtype} {mids.shape}")
        check_launches("serve_4k", before, _build.launch_counts(), PACKED_4K_PER_REQUEST)
        check(mids.std() > 1.0, "serve_4k: output frame is constant")
    counts = _build.launch_counts()
    emit("serve_4k", path="packed", requests=3, shape=[1, 2, H4K, W4K, 3],
         compute_dtype="bfloat16", ms_per_request=times, launches=counts,
         launches_per_request=PACKED_4K_PER_REQUEST,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return counts


def phase_serve_int8(params, dev):
    """``Interpolator(int8=True)``: the first request at each resolution
    calibrates on the plain path, the others serve int8 on K5-K9 (K6 at 4K).
    bfloat16 requests of the default Interpolator run beside them, in turns."""
    pairs = [moving_squares(i, H1080, W1080) for i in range(3)]
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = device_calibrate(params, pairs[0], compute_dtype=torch.bfloat16,
                             use_pallas=True, pad_hw=(HP - H1080, 0), device=dev)
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    check_launches("int8 calibration", {k: 0 for k in _build.LAUNCHES},
                   _build.launch_counts(), CALIBRATION_LAUNCHES)
    check(all(bool(torch.isfinite(v) and v > 0) for st in stats.values() for v in st.values()),
          "int8 calibration: a range is not finite and positive")

    q8 = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, int8=True,
                      device=dev)
    bf = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, device=dev)
    _, first_ms = serve_request(q8, pairs[0])  # calibrates, then serves
    serve_request(bf, pairs[0])  # warm-up
    _build.reset_launch_counts()
    ms8, ms16, agree = [], [], []
    for p in pairs:
        before = _build.launch_counts()
        m8, t8 = serve_request(q8, p)
        check_launches("serve_int8", before, _build.launch_counts(), INT8_PER_REQUEST)
        m16, t16 = serve_request(bf, p)
        ms8.append(t8)
        ms16.append(t16)
        check(m8.shape == (1, 1, H1080, W1080, 3) and m8.std() > 1.0, "serve_int8: output")
        agree.append(_u8_agreement(m8, m16))
    counts = _build.launch_counts()
    for a in agree:
        check(a["psnr_db"] >= INT8_VS_BF16_PSNR_DB, f"serve_int8: int8 vs bf16 {a}")

    # One int8 request at 4K: its own calibration, then K6 in int8.
    q8.step(moving_squares(0, H4K, W4K)).cpu()
    before = _build.launch_counts()
    m4k, ms4k = serve_request(q8, moving_squares(1, H4K, W4K))
    check_launches("serve_int8 4K", before, _build.launch_counts(), INT8_4K_PER_REQUEST)
    check(m4k.shape == (1, 1, H4K, W4K, 3) and m4k.std() > 1.0, "serve_int8 4K: output")
    emit("serve_int8", shape=[1, 2, H1080, W1080, 3], calibration_ms=calib_ms,
         first_request_ms_with_calibration=first_ms, int8_ms_per_request=ms8,
         bf16_ms_per_request_same_run=ms16, int8_vs_bf16=agree,
         int8_vs_bf16_psnr_bar_db=INT8_VS_BF16_PSNR_DB,
         launches_per_request=INT8_PER_REQUEST, launches=counts,
         ms_4k_int8_request=ms4k, launches_per_4k_request=INT8_4K_PER_REQUEST,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return _build.launch_counts()


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
                 "2": "conv_up_m_packed (K8)", "3": "conv_up_f_packed (K9)",
                 "4": "conv_up_packed (K6)"}


def _profile_group(name: str) -> str:
    low = name.lower()
    packed = re.search(
        r"conv_packed_kernel<\s*\d+,\s*(?:\(.*?\))?(\d+),\s*(true|false)\s*>", low)
    if packed:  # conv_packed_kernel<NT, MODE, Q>: the mode is the entry point
        return _PACKED_MODES[packed.group(1)] + (" int8" if packed.group(2) == "true" else "")
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


def phase_profile(params, dev, path, top: int = 12, hw=(H1080, W1080), n=2, **kw):
    """Device time of ``n`` served requests by group of kernels, on the path
    the Interpolator's keywords ``kw`` select (named ``path``)."""
    from torch.profiler import ProfilerActivity, profile

    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, exp=1,
                          device=dev, **kw)
    pairs = moving_squares(0, *hw)
    serve_request(interp, pairs)
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
    emit("profile", path=path, shape=[1, 2, *hw, 3], requests=n,
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
    # int8 with the same stats on both sides (calibrated on the card, margin
    # applied, handed to each Interpolator as preset stats)
    stats = scale_quant_stats(device_calibrate(
        params, pairs, compute_dtype=torch.bfloat16, use_pallas=True, device=dev), 1.2)
    card_int8 = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, int8=True,
                             quant_stats=stats, device=dev).step(pairs).cpu().numpy()
    cpu_int8 = Interpolator(
        cpu_params, compute_dtype="bfloat16", use_pallas=True, int8=True, device="cpu",
        quant_stats={u: {k: v.cpu() for k, v in st.items()} for u, st in stats.items()},
    ).step(pairs).cpu().numpy()
    out["int8"] = _u8_agreement(card_int8, cpu_int8)
    # the K6 route (a width the reference sends to conv_up_packed), bfloat16
    hk, wk = K6_ROUTE_HW
    wide = moving_squares(10, hk, wk)
    before = _build.launch_counts()
    card_k6 = Interpolator(params, compute_dtype="bfloat16", use_pallas=True,
                           device=dev).step(wide).cpu().numpy()
    moved = _build.launch_counts()["conv_up_packed"] - before["conv_up_packed"]
    check(moved == 8, f"agreement: {moved} conv_up_packed launches at {hk}x{wk}, want 8")
    out["bfloat16_k6_route"] = _u8_agreement(card_k6, Interpolator(
        cpu_params, compute_dtype="bfloat16", use_pallas=True,
        device="cpu").step(wide).cpu().numpy())
    f32 = out["float32"]
    # the JAX package's bar between two programs computing the same frames
    check(f32["max_u8_steps"] <= 1 and f32["share_differing"] < 1e-3,
          f"agreement float32: {f32}")
    for key in ("bfloat16", "bfloat16_packed", "packed_vs_plain_on_card", "bfloat16_k6_route"):
        check(out[key]["psnr_db"] >= BF16_PSNR_DB, f"agreement {key}: {out[key]}")
    check(out["int8"]["psnr_db"] >= INT8_CARD_CPU_PSNR_DB, f"agreement int8: {out['int8']}")
    emit("agreement", shape=[1, 2, h, w, 3], bf16_psnr_bar_db=BF16_PSNR_DB,
         int8_psnr_bar_db=INT8_CARD_CPU_PSNR_DB, k6_route_shape=[1, 2, hk, wk, 3], **out)


# ------------------------------------------------------------------- summary

TPU_KERNEL_LINES = {
    "conv_phase": "rrin_tpu/ops/conv_phase.py:164",
    "warp_u8": "rrin_tpu/ops/warp_pallas.py:350",
    "warp_f32": "rrin_tpu/ops/warp_pallas.py:481",
    "warp_bf16": "rrin_tpu/ops/warp_pallas.py:211",
    "conv_packed": "rrin_tpu/ops/conv_packed.py:506",
    "conv_pool_packed": "rrin_tpu/ops/conv_packed.py:1115",
    "conv_up_packed": "rrin_tpu/ops/conv_packed.py:824",
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


def _int8_entry(cases, launches):
    """The int8 mode of one packed kernel: its sites as timed above and its
    launches on the int8 path."""
    keep = ("site", "out_shape", "cins", "k", "int8_inputs", "int8_output", "max_abs_err",
            "kernel_ms", "kernel_prepared_ms", "plain_ms", "bound_ms", "bound_by")
    return {"launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "library_ms": None, "library_null_reason": NO_INT8_LIBRARY,
            "sites": [{k: c[k] for k in keep} for c in cases]}


def kernels_summary(conv, packed, int8, warps, serve_counts, counts_4k, int8_counts,
                    plain_counts, fp32_counts):
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
    for name in ("conv_packed", "conv_pool_packed", "conv_up_packed", "conv_up_m_packed",
                 "conv_up_f_packed"):
        cases = [c for c in packed if c["kernel"] == name]
        n = sum(c["per_flow_unet"] for c in cases)
        if name == "conv_up_packed":
            entry = _conv_entry(
                name, "rrin_tpu_torch/csrc/conv_packed.cu", cases, counts_4k[name],
                f"sum over the {n} launches of one flow U-Net at 2160x3840 (packed path, "
                "launches from serve_4k)")
            entry["k9_same_sites_ms"] = sum(
                c["kernel_ms"] for c in packed
                if c["kernel"] == "conv_up_f_packed" and c["site"].endswith("_4k"))
        else:
            entry = _conv_entry(
                name, "rrin_tpu_torch/csrc/conv_packed.cu", cases, serve_counts[name],
                f"sum over the {n} launches of one flow U-Net at 1088x1920 (packed path)")
        entry["int8"] = _int8_entry([c for c in int8 if c["kernel"] == name],
                                    int8_counts[f"{name}_int8"])
        check(entry["int8"]["launches"] > 0, f"{name}: no int8 launch on the int8 path")
        entries.append(entry)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was never launched by the path it belongs to")
    check(len(entries) == len(TPU_KERNEL_LINES) == 9, "the closing line lists nine kernels")
    return {"kernels": entries, "not_ported": []}


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
    int8 = int8_cases(rng, dev)
    warps = warp_cases(rng, dev)
    emit("kernels", conv_phase=conv, conv_packed=packed, conv_packed_int8=int8, warp=warps,
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S, "bf16_flops": BF16_FLOPS,
                "int8_ops": INT8_OPS, "fp32_flops": FP32_FLOPS})

    params = init_params(torch.Generator().manual_seed(0), ModelConfig(), device=dev)
    serve_counts = phase_serve(params, dev)
    counts_4k = phase_serve_4k(params, dev)
    int8_counts = phase_serve_int8(params, dev)
    plain_counts = phase_serve_plain(params, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(params, dev, "packed")
        phase_profile(params, dev, "plain", packed=False)
        phase_profile(params, dev, "int8", n=1, int8=True)
        phase_profile(params, dev, "packed 4K", hw=(H4K, W4K), n=1)
    fp32_counts = phase_serve_fp32(params, dev)
    phase_agreement(params, dev)

    summary = kernels_summary(conv, packed, int8, warps, serve_counts, counts_4k,
                              int8_counts, plain_counts, fp32_counts)
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
