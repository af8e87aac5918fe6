#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

needs one CUDA GPU (written for an H100, sm_90a), `nvcc`, PyTorch with CUDA
and numpy; nothing else and no network. It builds the CUDA kernels of
``rrin_tpu_torch/csrc`` and runs these phases, each printing one JSON line:

  device       the card's name and power limit
  build        nvcc over every kernel source, in parallel
  kernels      every kernel against its plain PyTorch version on the card at
               the shapes of the 1080p paths (K6, K8 and K9 also at the 4K up
               sites, K7 at the 4K d1c1 site), in bfloat16, in int8 and in
               float32, with times and bounds; K1 on the Hopper core at
               its sites (mode DIRECT, k 3/5/7) and at other odd k (the
               streamed mode, its stencil split into blocks of at most 13
               taps a side from k 15 on: k 1, 9, 11, 13 at cin 32, k 37
               and 39 at cout 64, k 49 and 51 at cout 8, k 65 at cout 32,
               k 99 at cin 16 and cout 64, a cin-6 stem at k 9, all at
               272x480; small and ragged frames; k 9 at 1088x1920); the
               weight-prep kernel of the Hopper core (K5-K9 in bfloat16 and
               float32) bit-equal to its plain version; the float32
               promotion interval against its error at d4c2, u1c2 (K5),
               u2c1 (K8) and u3c1 (K9); the warps through warp_one and as
               one launch per pair
  serve        the main path: the default Interpolator (bfloat16, kernels,
               packed U-Net path, full model width) answering 1080p requests,
               its weights prepared once at the first (76 prep launches,
               none a request)
  serve_4k     the same Interpolator answering 2160x3840 requests, whose up
               sites u3c1 and u4c1 take K6 (conv_up_packed)
  serve_int8   ``Interpolator(int8=True)``: calibration by absmax and by the
               99.9th percentile at 1080p and 4K (ms, peak memory), the
               saturation rates of both, then int8 requests of both at
               1080p (beside bfloat16 ones) and one at 2160x3840
  prepare_once a request through the preparing Interpolator bit-equal to
               ``device_step`` without ``packed_params`` (bf16 1080p and 4K,
               float32, int8 absmax and 99.9th percentile), with the prepare
               time and the memory the prep holds; a 1080p prep refused by a
               4K request, an int8 prep by stats of other values
  serve_plain  one 1080p request on the plain U-Net path (``packed=False``:
               K1 on the Hopper core, its weights prepared on the card)
  serve_stem9  1080p bf16 requests of a ``ModelConfig(stem_kernel=9)``
               cascade (random weights, seed 0), which the packed path
               refuses: the plain path's launches, 8 K1 a request at k 9 on
               the streamed mode; card against the CPU at 272x480
  serve_stem45 272x480 bf16 requests of a ``ModelConfig(stem_kernel=45)``
               cascade, past the streamed mode's former reach: 8 K1 a
               request at k 45 (each stencil split into 4 x 4 blocks),
               none of those sites on ``F.conv2d``; against the same
               requests through the plain versions on the card
  serve_fp32   the float32 plain path (float32 warp kernel) at 256x448 and the
               bf16-source warp
  serve_fp32_packed  the default float32 Interpolator (packed: the float32
               modes of K5, K7, K8 and K9, all on the Hopper core) against
               the float32 plain path at 1080p, in turns, and one float32
               request at 2160x3840 (K6)
  int8_trained the trained checkpoint ``benchmarks/trained_synth_f16.npz``
               at 1080p: bf16, int8 absmax and int8 at the 99.9th percentile
               against the float32 packed output (int8 absmax > 35 dB)
  agreement    card (kernels) against CPU (plain versions), packed against
               plain path on the card, int8 card against int8 CPU, float32
               packed card against CPU, and the K6 route at a 4K width, on
               one request each
  tools        the user-facing tools through their ``main`` with the
               trained checkpoint (needs OpenCV): the CLI on a 9-frame
               1080p clip (bf16 ``--exp 1`` and ``2``, int8 ``--save-calib``
               and ``--calib``, ``--segment-pairs 3`` and ``--status``,
               ``--retime 60``; frame counts, fps, launches per source pair,
               stage timers), bf16 ``--exp 1`` on a 241-frame clip (the
               loop's steady state: the encode queue fills), the pair
               packer (native and numpy) alone, the image tool with
               ``--gt``, the eval harness on synthesized triplets in bf16,
               int8 and float32
  quality      the trained checkpoint on two synthetic 1088x1920 triplets:
               float32, bf16, int8 absmax and p99.9 against the ground
               truth and float32 (int8 absmax > 35 dB, bf16 >= 40 dB), ssim
               and the triplets on the card against the CPU
  train        training at full width on the synthetic feed (crop 256x448,
               batch 4, Adamax 1e-4, Charbonnier): bf16 (K1), bf16 with
               use_pallas (K1 + K2), float32 with use_pallas (K3) and bf16
               with remat, each 3 warm-up and 10 timed steps (ms per step,
               peak memory, launches per step, no host sync in a step; bf16
               to 20 steps, a held-out batch's loss falls); then
               ``train_checks``: one step on the card against the CPU (loss
               and gradient per U-Net, float32 and bf16) and
               ``rrin-tpu-torch-train --synthetic --steps 5`` through its
               ``main``, its checkpoint loaded back
  parallel     ``parallel/`` on two shards of the one card: (a)
               ``Interpolator(data_parallel=0)`` is the one-device route;
               (b) data-parallel bf16, int8 and float32 requests of two
               1080p pairs against the one-device request on the same batch
               (frames, ms, launches), the absmax calibration fold bit-equal
               to the full batch's, the 99.9th percentile's fold beside the
               full batch's; (c) spatial requests (rows cut over two shards)
               at 2176x3840 bf16 and 1088x1920 float32 against the
               one-device plain request; (d) one data-parallel and one
               spatial training step at 4x256x448, bf16 and float32, and
               one data-parallel bf16 use_pallas step (a warp pair, K2, per
               shard), against the one-device step (loss, gradients, largest
               parameter difference, ms); (e) (b) and (d) again on two
               distinct cards where the machine has them. Two shards of one
               card show what sharding costs, not a speedup
  k1_device    each K1 case of phase kernels again, by its kernel's and its
               weight prep's device time from one torch.profiler trace of
               five calls (from CUDA events around each launch, queued
               behind a spin kernel, where the trace misses a launch; both
               are reported), in a process of its own (``--k1-device``)

Any failed check raises, so the exit code is non-zero and the closing lines
are not printed. The closing lines are: the card's name and power limit, one
``{"kernels": [...], "not_ported": [...]}`` object (launch counts from the
served paths, times measured in this run), and ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --profile`` adds one phase after ``serve_plain``:
``torch.profiler`` traces of two 1080p requests on each U-Net path, of one
int8 1080p request (fewer than 600 kernels), of one int8 and one bfloat16
4K request, of one float32 1080p request on each U-Net path and of one
float32 4K request, printed as device time by group of kernels (where the
time of a request goes); and after ``train`` traces of one bf16 training
step with use_pallas and of one float32 step with use_pallas at batch 4 and
at batch 2, by kind of work (K1 forward and prep, cuDNN forward convs, conv
dgrad and wgrad, warp forward and backward, elementwise, optimizer), with
the kernels that took the most time by name.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from rrin_tpu_torch import ModelConfig, _build, forward, init_params
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.models.rrin import scale_quant_stats
from rrin_tpu_torch.ops import conv_packed, conv_phase, warp_kernel
from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear
from rrin_tpu_torch.ops.warp import warp_pair
from rrin_tpu_torch.params.checkpoint import (
    flatten_params,
    load_params,
    params_from_numpy,
    unflatten_params,
)
from rrin_tpu_torch.pipeline import Interpolator, device_calibrate, device_step

# Published peaks of one H100 SXM (dense): the bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
# float32-accurate products on the tensor cores: three TF32 products each
# (the float32 modes of K5-K9), a third of the 495 TFLOP/s TF32 peak.
F32_TENSOR_FLOPS = 495e12 / 3
NO_INT8_LIBRARY = "no PyTorch call computes an int8 conv on CUDA"

# Tolerances, fixed before any run.
# K1 (on either kernel): rounds once to bf16 from a float32 sum; the plain version is a
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
# cascade against float32 (tests/test_int8.py); also int8 absmax against
# float32 with the trained weights; int8 card against int8 CPU with the same
# stats: the bf16 card-vs-CPU bar.
INT8_VS_BF16_PSNR_DB = 35.0
# A prepared 1080p int8 request launches fewer kernels than this (its
# weights quantised once, not per call).
INT8_KERNELS_MAX = 600
INT8_CARD_CPU_PSNR_DB = 40.0
# float32 kernels against their plain versions (float32 convs without TF32 on
# the same inputs): the reference's bar between its packed and plain float32
# U-Nets (tests/test_unet_packed.py).
F32_ATOL = F32_RTOL = 1e-5
# float32 cascades against each other (packed against plain on the card,
# card against CPU): the reference's float32 port-vs-JAX bar on the cascade
# (tests/test_parity.py), max abs over the frame.
F32_CASCADE_ATOL = 2e-4

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

# Calls of a K1 case in its one torch.profiler trace (after a warm-up), and
# in its one queue of calls timed by CUDA events.
K1_TRACED_CALLS = 5
# The spin kernel in front of that queue (torch.cuda._sleep cycles, 20 ms at
# 2 GHz): doubled until it outlasts the host's queuing of the calls.
K1_SPIN_CYCLES = 40_000_000


def _k1_profiler_ms(fn) -> dict:
    """The device ms a call of ``fn`` spends in K1's kernel and in its
    weight prep, from one torch.profiler trace of ``K1_TRACED_CALLS`` calls,
    and how many launches of each the trace recorded."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(K1_TRACED_CALLS):
            fn()
        torch.cuda.synchronize()
    got = {"kernel_device_ms": 0.0, "prep_device_ms": 0.0,
           "kernel_traced_launches": 0, "prep_traced_launches": 0}
    for e in prof.key_averages():  # the kernels, by name (a CUDA-only trace)
        if e.device_time_total <= 0:
            continue
        group = _profile_group(e.key, plain=True)
        key = ("kernel" if group.startswith("conv_phase") else
               "prep" if group == "K5-K9 weight prep" else None)
        if key:
            got[f"{key}_device_ms"] += e.device_time_total / 1e3 / K1_TRACED_CALLS
            got[f"{key}_traced_launches"] += e.count
    return got


def _k1_event_ms(fn) -> dict:
    """The same two times by CUDA events recorded on the stream just before
    and just after each launch of K1's kernel and of its prep (a shim on
    ``_build.launch``), for ``K1_TRACED_CALLS`` calls queued behind a spin
    kernel that keeps the card busy until the host has queued them all, so
    that no wait for the host lies inside an event pair."""
    real = _build.launch
    spin = K1_SPIN_CYCLES
    for _ in range(6):
        pairs = {"conv_phase": [], "conv_up_prep": []}

        def timed(kernel, f, *args, pairs=pairs):
            if kernel not in pairs:
                return real(kernel, f, *args)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            real(kernel, f, *args)
            b.record()
            pairs[kernel].append((a, b))
            return None

        spun = torch.cuda.Event()
        _build.launch = timed
        try:
            torch.cuda._sleep(spin)
            spun.record()
            for _ in range(K1_TRACED_CALLS):
                fn()
            queued_in_time = not spun.query()
        finally:
            _build.launch = real
        torch.cuda.synchronize()
        if queued_in_time:
            check(all(len(v) == K1_TRACED_CALLS for v in pairs.values()),
                  f"a K1 call did not launch its kernel and its prep once: {pairs}")
            return {"kernel_event_ms": sum(a.elapsed_time(b) for a, b in pairs["conv_phase"])
                    / K1_TRACED_CALLS,
                    "prep_event_ms": sum(a.elapsed_time(b) for a, b in pairs["conv_up_prep"])
                    / K1_TRACED_CALLS}
        spin *= 2
    raise RuntimeError("chip_smoke check failed: the spin kernel never outlasted the host's "
                       "queuing of the K1 calls")


def k1_device_ms(fn) -> dict:
    """The device ms a call of ``fn`` (one K1 call through its wrapper)
    spends in K1's kernel and in its weight prep: the kernels' own time,
    without the host's schedule that ``kernel_ms`` includes (run in the
    process of ``k1_device_times``). Both ways are measured: the CUDA
    events of ``_k1_event_ms`` always, and one torch.profiler trace
    (``_k1_profiler_ms``). ``kernel_device_ms`` / ``prep_device_ms`` are the
    trace's where it recorded every launch of both kernels, else the
    events' (traces on the H100 have recorded no launch, or some of them);
    ``device_time_by`` says which."""
    fn()
    torch.cuda.synchronize()
    got = _k1_event_ms(fn)
    check(got["kernel_event_ms"] > 0 and got["prep_event_ms"] > 0,
          f"the CUDA events timed no K1 kernel or prep: {got}")
    traced = _k1_profiler_ms(fn)
    got.update(kernel_traced_launches=traced["kernel_traced_launches"],
               prep_traced_launches=traced["prep_traced_launches"])
    if traced["kernel_traced_launches"] == traced["prep_traced_launches"] == K1_TRACED_CALLS:
        got.update(kernel_device_ms=traced["kernel_device_ms"],
                   prep_device_ms=traced["prep_device_ms"], device_time_by="profiler")
    else:
        got.update(kernel_device_ms=got["kernel_event_ms"],
                   prep_device_ms=got["prep_event_ms"], device_time_by="cuda_events")
    return got


def conv_case(rng, dev, name, h, w, cin, cout, k, slope, batch=1, train=False):
    """One K1 site through ``conv2d_fused``, on the Hopper core (mode DIRECT
    at k 3/5/7, the streamed mode at the other odd k) with one weight-prep
    launch beside it, held to its plain version and timed with its prep
    alone. ``train``: inputs that require grad, as a training step hands
    them over, and no timing."""
    x, wt, bias = k1_inputs(rng, dev, batch, h, w, cin, cout, k)
    mode = "DIRECT" if k in conv_packed._K_CONV else "streamed"
    for t in (x, wt, bias):
        t.requires_grad_(train)

    before = _build.launch_counts()
    got = conv_phase.conv2d_fused(x, wt, bias, slope)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    check(after["conv_phase"] == before["conv_phase"] + 1,
          f"{name}: conv2d_fused did not launch the kernel")
    check(after["conv_up_prep"] - before["conv_up_prep"] == 1,
          f"{name}: conv2d_fused did not lay out its weights on the card")
    check(got.requires_grad == train, f"{name}: the output's requires_grad is not {train}")
    x, wt, bias, got = x.detach(), wt.detach(), bias.detach(), got.detach()
    want = conv_phase._conv_plain(x, wt, bias, slope)
    check(got.shape == want.shape and got.dtype == torch.bfloat16, f"{name}: shape/dtype")
    diff = (got.float() - want.float()).abs()
    check(bool((diff <= CONV_ATOL + CONV_RTOL * want.float().abs()).all())
          and bool(torch.isfinite(got.float()).all()),
          f"{name}: kernel disagrees with plain version, max abs err {float(diff.max())}")
    err = float(diff.max())
    if train:
        return {"site": name, "shape": [batch, h, w, cin], "cout": cout, "k": k,
                "route": "wgmma", "mode": mode, "slope": slope,
                "max_abs_err": err, "atol": CONV_ATOL, "rtol": CONV_RTOL}

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
    plan = conv_phase._sm90_plan(k, cin, cout)
    return {
        "site": name, "shape": [1, h, w, cin], "cout": cout, "k": k,
        "route": "wgmma", "mode": mode, "plan": list(plan),
        "stencil_blocks": len(conv_packed._stream_blocks(k)) ** 2 if mode == "streamed" else 1,
        "slope": slope, "max_abs_err": err, "atol": CONV_ATOL, "rtol": CONV_RTOL,
        "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
        # the core's weight prep alone (part of kernel_ms)
        "prep_ms": time_ms(lambda: conv_packed._prep_on_card("conv_packed", wt, bias, (cin,),
                                                              plan=plan)),
    }


def k1_inputs(rng, dev, batch, h, w, cin, cout, k):
    """A K1 site's bf16 input, float32 weights and bias on the card."""
    x = torch.from_numpy(
        rng.standard_normal((batch, h, w, cin)).astype(np.float32)).to(dev).to(torch.bfloat16)
    bound = 1.0 / np.sqrt(k * k * cin)  # the init bound of the model's convs
    wt = torch.from_numpy(
        rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-bound, bound, (cout,)).astype(np.float32)).to(dev)
    return x, wt, bias


def k1_device_times(conv) -> None:
    """Add each timed K1 case's device times (``k1_device_ms``) to it, on
    fresh inputs of its shapes, traced after every other phase, so that no
    profiler session runs before a phase whose times are compared with
    another tree's, and by a process of its own (``chip_smoke.py
    --k1-device``): on the H100 a session in this process after phase
    ``parallel`` recorded no kernel. Emits phase ``k1_device``."""
    specs = [{"shape": c["shape"], "cout": c["cout"], "k": c["k"], "slope": c["slope"]}
             for c in conv]
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--k1-device"],
                         input=json.dumps(specs), capture_output=True, text=True,
                         timeout=600, check=False)
    check(out.returncode == 0, f"k1_device: the tracing process failed: {out.stderr[-3000:]}")
    for c, got in zip(conv, json.loads(out.stdout.strip().splitlines()[-1]), strict=True):
        c.update(got)
    emit("k1_device", traced_calls=K1_TRACED_CALLS, cases=[
        {k: c[k] for k in ("site", "k", "kernel_ms", "kernel_device_ms", "prep_device_ms",
                           "device_time_by", "kernel_event_ms", "prep_event_ms",
                           "kernel_traced_launches", "prep_traced_launches")}
        for c in conv])


def k1_device_main() -> int:
    """``--k1-device``: the K1 cases that stdin lists (JSON), each traced
    by ``k1_device_ms``; prints their device times as one JSON list."""
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1)
    times = []
    for spec in json.loads(sys.stdin.read()):
        x, wt, bias = k1_inputs(rng, dev, *spec["shape"], spec["cout"], spec["k"])
        times.append(k1_device_ms(
            lambda: conv_phase.conv2d_fused(x, wt, bias, spec["slope"])))  # noqa: B023
    print(json.dumps(times), flush=True)
    return 0


def _k1_sites(h, w):
    """The K1 sites of the model's U-Nets at an h x w frame: (name, h, w,
    cin, cout, k, slope, launches of this class in the flow U-Net)."""
    s = ModelConfig().leaky_slope
    h2, w2 = h // 2, w // 2
    return [
        ("conv1_flow_cin6", h, w, 6, 32, 7, s, 1),
        ("conv1_refine_cin10", h, w, 10, 32, 7, s, 0),
        ("conv1_mask_cin16", h, w, 16, 32, 7, s, 0),
        ("conv1_final_cin9", h, w, 9, 32, 7, s, 0),
        ("conv2", h, w, 32, 32, 7, s, 1),
        ("up4_conv", h, w, 64, 32, 3, s, 2),
        ("head_cout4", h, w, 32, 4, 3, None, 1),
        ("head_cout2", h, w, 32, 2, 3, None, 0),
        ("head_cout3", h, w, 32, 3, 3, None, 0),
        ("down1_conv1", h2, w2, 32, 64, 5, s, 1),
        ("down1_conv2", h2, w2, 64, 64, 5, s, 1),
        ("up3_conv", h2, w2, 128, 64, 3, s, 2),
    ]


# K1 at odd k off DIRECT's 3/5/7, on the core's streamed mode (no site of
# the default configuration; a stem_kernel=9 cascade's stems are k 9, cin 6
# and 32): k 1, 9, 11 and 13 at cin 32, cout 32 (one stencil block); k 37
# and 39 at cout 64, k 49 and 51 at cout 8 (the port's former reach and one
# step past it); k 65 at cout 32 (past a 64-column halo row); k 99 at cin
# 16, cout 64 (8 x 8 blocks); a stem at k 9. 272x480, as the stem_kernel=9
# agreement. Then small and ragged frames (tiles cut by the image's edges,
# k 3 on DIRECT beside them; k 15, 27, 39, 65 and 99 split, some blocks'
# halos wholly outside the image), k 13 at cin 33 / cout 20 (padded
# channels) and k 11 at cin 64 / cout 64 (two chunks), and k 9 at
# 1088x1920.
_S = ModelConfig().leaky_slope
STREAMED_K1_CASES = [
    (f"k{k}_272x480", 272, 480, 32, 32, k, _S, 0) for k in (1, 9, 11, 13)
] + [
    ("k37_cout64_272x480", 272, 480, 32, 64, 37, _S, 0),
    ("k39_cout64_272x480", 272, 480, 32, 64, 39, _S, 0),
    ("k49_cout8_272x480", 272, 480, 32, 8, 49, _S, 0),
    ("k51_cout8_272x480", 272, 480, 32, 8, 51, _S, 0),
    ("k65_cout32_272x480", 272, 480, 32, 32, 65, _S, 0),
    ("k99_cin16_cout64_272x480", 272, 480, 16, 64, 99, _S, 0),
    ("stem9_cin6_272x480", 272, 480, 6, 32, 9, _S, 0),
] + [
    (f"k{k}_cin{cin}_cout{cout}_{h}x{w}", h, w, cin, cout, k, _S, 0)
    for k, cin, cout, h, w in (
        (1, 32, 32, 64, 96), (9, 32, 32, 64, 96), (9, 6, 32, 64, 96), (13, 33, 20, 40, 70),
        (37, 32, 64, 48, 80), (49, 32, 8, 48, 80), (11, 64, 64, 64, 130), (3, 32, 32, 64, 96),
        (15, 32, 32, 40, 70), (27, 6, 32, 30, 57), (39, 32, 64, 33, 45), (65, 32, 32, 20, 130),
        (99, 16, 64, 48, 80), (9, 32, 32, 1088, 1920))
]


def conv_cases(rng, dev):
    s = ModelConfig().leaky_slope
    specs = _k1_sites(HP, WP) + [
        ("ragged_width_485", 270, 485, 32, 32, 7, s, 0),
    ] + STREAMED_K1_CASES
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
    return upsample_2x_bilinear(xs[0].float()).to(xs[0].dtype)


# kernel name -> (wrapper, plain version, int8 plain version, how the input of
# the conv is materialised for the library yardstick, the host-side weight
# layout that prepared= takes).
PACKED_KERNELS = {
    "conv_packed": (
        conv_packed.conv_packed, conv_packed._conv_packed_plain,
        conv_packed._conv_packed_q_plain,
        lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1),
        conv_packed.prep_conv),
    "conv_pool_packed": (
        conv_packed.conv_pool_packed, conv_packed._conv_pool_plain,
        conv_packed._conv_pool_q_plain,
        lambda xs: avg_pool_2x(xs[0].float()).to(xs[0].dtype),
        lambda w, b, cins, *q, **kw: conv_packed.prep_conv_pool(w, b, *q, **kw)),
    "conv_up_packed": (
        conv_packed.conv_up_packed, conv_packed._conv_up_wh_plain,
        conv_packed._conv_up_q_plain, _upsampled,
        lambda w, b, cins, *q, **kw: conv_packed.prep_conv_up(w, b, *q, **kw)),
    "conv_up_m_packed": (
        conv_packed.conv_up_m_packed, conv_packed._conv_up_plain,
        conv_packed._conv_up_m_q_plain, _upsampled,
        lambda w, b, cins, *q, **kw: conv_packed.prep_conv_up_m(w, b, *q, **kw)),
    "conv_up_f_packed": (
        conv_packed.conv_up_f_packed, conv_packed._conv_up_plain,
        conv_packed._conv_up_f_q_plain, _upsampled,
        lambda w, b, cins, *q, **kw: conv_packed.prep_conv_up_f(w, b, *q, **kw)),
}


# The kernels on the Hopper core (csrc/conv_sm90.cuh) in bfloat16, int8 and
# float32, whose bf16 and float32 wrappers lay out (and fold) their weights on
# the card, and the source of their entry points.
SM90 = {"conv_packed": "conv_packed_sm90.cu", "conv_up_packed": "conv_packed_sm90.cu",
        "conv_pool_packed": "conv_up_sm90.cu", "conv_up_m_packed": "conv_up_sm90.cu",
        "conv_up_f_packed": "conv_up_sm90.cu"}
SM90_MODE = {"conv_packed": "DIRECT", "conv_up_packed": "UPW", "conv_pool_packed": "POOL",
             "conv_up_m_packed": "UP", "conv_up_f_packed": "UPF"}


def packed_case(rng, dev, kernel, name, h, w, cins, cout, k, slope, int8=None, f32=False):
    """One site of a packed-path kernel; (h, w) is the resolution the conv
    runs at, i.e. of its output. The stored input is (2h, 2w) for the pool
    kernel and (h/2, w/2) for the upsampling kernels. ``int8``: None for
    bfloat16 (``f32``: float32), else (which operands arrive as int8 already,
    int8 output)."""
    wrapper, plain, plain_q, materialise, prepare = PACKED_KERNELS[kernel]
    hs, ws = {"conv_packed": (h, w), "conv_pool_packed": (2 * h, 2 * w)}.get(
        kernel, (h // 2, w // 2))
    xdt = torch.float32 if f32 else torch.bfloat16
    xs = [torch.from_numpy(rng.standard_normal((1, hs, ws, c)).astype(np.float32))
          .to(dev).to(xdt) for c in cins]
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
    pkw = {"dtype": torch.float32} if f32 else {}
    arg = xs[0] if single else xs
    mode = "int8" if int8 is not None else ("f32" if f32 else "")
    count = kernel + (f"_{mode}" if mode else "")

    before = _build.launch_counts()[count]
    got = wrapper(arg, wt, bias, slope, **qkw)
    torch.cuda.synchronize()
    check(_build.launch_counts()[count] == before + 1,
          f"{name}: {kernel} did not launch its {mode or 'bf16'} kernel")
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
           "dtype": "int8" if int8 is not None else ("float32" if f32 else "bfloat16")}
    if f32:
        # every float32 kernel, K9's fold included, against its plain version
        bar = F32_ATOL + F32_RTOL * want.abs()
        check(bool((diff <= bar).all()),
              f"{name}: float32 kernel disagrees with plain version, max abs err {err}")
        out.update({"atol": F32_ATOL, "rtol": F32_RTOL,
                    "max_err_over_bar": float((diff / bar).max())})
        if kernel == "conv_up_f_packed":
            folded = conv_packed._conv_up_f_folded(xs[0], wt, bias, slope)
            fdiff = (got - folded).abs()
            check(bool((fdiff <= F32_ATOL + F32_RTOL * folded.abs()).all()),
                  f"{name}: kernel disagrees with the fold in PyTorch, max abs err "
                  f"{float(fdiff.max())}")
            out["max_abs_err_vs_fold"] = float(fdiff.max())
    elif int8 is not None:
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
        # channels-last with bias, no activation, bf16 or float32 without
        # TF32; used nowhere in the port.
        xn = materialise(xs).permute(0, 3, 1, 2)
        wn = wt.to(xdt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bn = bias.to(xdt)
        pad = (k - 1) // 2
        with conv_phase.no_tf32():
            out["library_ms"] = time_ms(lambda: F.conv2d(xn, wn, bn, padding=pad))
    else:
        out.update({"library_ms": None, "library_null_reason": NO_INT8_LIBRARY})
    # The kernel without the per-call weight re-layout (prepared= given).
    prep = prepare(wt, bias, cins, *prep_q, **pkw)
    check(torch.equal(wrapper(arg, wt, bias, slope, prepared=prep, **qkw), got),
          f"{name}: prepared= changes the result")
    out["kernel_prepared_ms"] = time_ms(
        lambda: wrapper(arg, wt, bias, slope, prepared=prep, **qkw))
    if int8 is None:
        # The weight prep that the wrapper runs on the card without
        # prepared=, against prep_* (its plain version): bit-equal (float32:
        # both TF32 planes, in the Hopper core's layout).
        on_card = conv_packed._prep_on_card(kernel, wt, bias, cins, f32)
        check(torch.equal(on_card["wfrag"], prep["wfrag"])
              and on_card["wfrag"].dtype == prep["wfrag"].dtype
              and torch.equal(on_card["bias"], prep["bias"]) and on_card["plan"] == prep["plan"],
              f"{name}: the weight-prep kernel differs from prep_*")
        prep_err = (on_card["wfrag"].float() - prep["wfrag"].float()).abs().max()
        wf = on_card["wfrag"]
        out.update({
            "prep_bit_equal": True,
            "prep_max_abs_err": float(prep_err),
            "prep_ms": time_ms(lambda: conv_packed._prep_on_card(kernel, wt, bias, cins, f32)),
            "prep_plain_ms": time_ms(lambda: prepare(wt, bias, cins, **pkw)),
            "prep_bytes": wt.numel() * 4 + bias.numel() * 4 + wf.numel() * wf.element_size()
                          + on_card["bias"].numel() * 4,
        })

    # The bytes the fused kernel must move: each stored operand once (no
    # pooled, upsampled or concatenated tensor; an int8 one at one byte an
    # element), weights, bias, the output; int8 operations at the int8 peak,
    # float32 ones at the float32-accurate tensor rate.
    flops = 2.0 * h * w * k * k * cin * cout
    nbytes = (sum(x.numel() * x.element_size() for x in xs) + wt.numel() * 4
              + bias.numel() * 4 + got.numel() * got.element_size())
    peak_ops = INT8_OPS if int8 is not None else (F32_TENSOR_FLOPS if f32 else BF16_FLOPS)
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    out.update({"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes})
    return out


def packed_cases(rng, dev, f32=False):
    """Every site of the packed kernels in bfloat16, or (``f32``) the same
    sites in float32."""
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
        # k 7 with a width that is no multiple of a k7 tile's 58 columns
        ("conv_packed", "k7_ragged_270x485", 270, 485, (32,), 32, 7, s, 0),
        # four operands, one of them gathered a channel at a time (cin 10)
        ("conv_packed", "four_operands_136x240", 136, 240, (64, 24, 16, 10), 48, 3, s, 0),
        ("conv_pool_packed", "d1c1", HP // 2, WP // 2, (32,), 64, 5, s, 1),
        ("conv_pool_packed", "d2c1", HP // 4, WP // 4, (64,), 128, 3, s, 1),
        ("conv_pool_packed", "ragged_135x243", 135, 243, (32,), 64, 5, s, 0),
        # the last output column inside a tile of 60 (k 5) and of 62 (k 3)
        ("conv_pool_packed", "edge_in_tile_68x150", 68, 150, (32,), 64, 5, s, 0),
        ("conv_pool_packed", "edge_in_tile_k3_68x100", 68, 100, (64,), 128, 3, s, 0),
        # K7 where the 4K request takes it (d1c1 reading 2160x3840x32)
        ("conv_pool_packed", "d1c1_4k", H4K // 2, W4K // 2, (32,), 64, 5, s, 0),
        ("conv_up_m_packed", "u2c1", HP // 4, WP // 4, (256,), 128, 3, s, 1),
        ("conv_up_m_packed", "ragged_270x486", 270, 486, (64,), 64, 3, s, 0),
        # a width that is no multiple of 64, its last column inside a tile
        ("conv_up_m_packed", "edge_in_tile_272x300", 272, 300, (128,), 64, 3, s, 0),
        ("conv_up_m_packed", "k5_136x200", 136, 200, (64,), 32, 5, s, 0),
        ("conv_up_f_packed", "u3c1", HP // 2, WP // 2, (128,), 64, 3, s, 1),
        ("conv_up_f_packed", "u4c1", HP, WP, (64,), 32, 3, s, 1),
        ("conv_up_f_packed", "ragged_270x486", 270, 486, (64,), 32, 3, s, 0),
        ("conv_up_f_packed", "edge_in_tile_272x300", 272, 300, (64,), 32, 3, s, 0),
        # K8 where the 4K request takes it (u2c1 at 2160x3840)
        ("conv_up_m_packed", "u2c1_4k", H4K // 4, W4K // 4, (256,), 128, 3, s, 0),
        # K6 where the 4K request takes it, and K9 at the same sites beside it
        ("conv_up_packed", "u3c1_4k", H4K // 2, W4K // 2, (128,), 64, 3, s, 1),
        ("conv_up_packed", "u4c1_4k", H4K, W4K, (64,), 32, 3, s, 1),
        ("conv_up_packed", "k5_270x480", 270, 480, (64,), 32, 5, s, 0),
        ("conv_up_packed", "k1_ragged_270x486", 270, 486, (32,), 16, 1, s, 0),
        ("conv_up_f_packed", "u3c1_4k", H4K // 2, W4K // 2, (128,), 64, 3, s, 0),
        ("conv_up_f_packed", "u4c1_4k", H4K, W4K, (64,), 32, 3, s, 0),
    ]
    if f32:
        # Every float32 kernel is on the Hopper core: no other source holds
        # one, and K7's and K8's entry points are conv_up_sm90.cu's.
        lib = conv_packed._lib_sm90("conv_up_sm90")
        check("conv_packed" not in _build.sources()
              and all(hasattr(lib, f"rrin_{k}_f32_launch")
                      for k in ("conv_pool_packed", "conv_up_m_packed")),
              "float32 K7 or K8 is not on the Hopper core")
        # K7 where its one chunk of float32 weights stays resident in shared
        # memory beside three halo buffers (two buffers with weights do not fit)
        plan = conv_packed._sm90_plan(5, (8,), 64, conv_packed.F32, resident=True)
        check(conv_packed._sm90_res_chunks((8,), plan, True) == 1,
              f"K7 cin 8 -> 64, k 5, float32: plan {plan} keeps no weights resident")
        specs.append(("conv_pool_packed", "resident_cin8_136x240", 136, 240, (8,), 64, 5, s, 0))
    cases = []
    for kernel, name, h, w, cins, cout, k, slope, mult in specs:
        c = packed_case(rng, dev, kernel, name, h, w, cins, cout, k, slope, f32=f32)
        c["per_flow_unet"] = mult
        cases.append(c)
    return cases


def promotion_probe(rng, dev):
    """The float32 K5 on the Hopper core at d4c2 (K = 4608, the deepest sum)
    and u1c2 (two operands), the float32 K8 at u2c1 (K = 2304, the upsample
    in the producers) and the float32 K9 at u3c1 (K = 1152 of folded taps,
    the edge sums beside), for promotion intervals of 1 k-step (8
    channels of one tap), 3 (one (dx, k-step) slab at k 3), 6, 9 (a whole
    chunk of 8 channels at k 3) and the whole tile (products never leave
    the tensor cores before the end): max abs error against the plain
    version (float32 conv without TF32) and ms, with prepared weights. The
    default interval is put back after."""
    s = ModelConfig().leaky_slope
    default = conv_packed._f32_promotion(1)
    out = []
    try:
        for name, hs, ws, cins, cout in (("d4c2", HP // 16, WP // 16, (512,), 512),
                                         ("u1c2", HP // 8, WP // 8, (256, 256), 256),
                                         ("k8_u2c1", HP // 8, WP // 8, (256,), 128),
                                         ("k9_u3c1", HP // 4, WP // 4, (128,), 64)):
            xs = [torch.from_numpy(rng.standard_normal((1, hs, ws, c)).astype(np.float32)).to(dev)
                  for c in cins]
            bound = 1.0 / np.sqrt(9 * sum(cins))
            wt = torch.from_numpy(
                rng.uniform(-bound, bound, (3, 3, sum(cins), cout)).astype(np.float32)).to(dev)
            bias = torch.from_numpy(rng.uniform(-bound, bound, (cout,)).astype(np.float32)).to(dev)
            if name.startswith("k8"):
                want = conv_packed._conv_up_plain(xs[0], wt, bias, s)
                prep = conv_packed.prep_conv_up_m(wt, bias, dtype=torch.float32)
                run = lambda: conv_packed.conv_up_m_packed(  # noqa: E731
                    xs[0], wt, bias, s, prepared=prep)
            elif name.startswith("k9"):
                want = conv_packed._conv_up_plain(xs[0], wt, bias, s)
                prep = conv_packed.prep_conv_up_f(wt, bias, dtype=torch.float32)
                run = lambda: conv_packed.conv_up_f_packed(  # noqa: E731
                    xs[0], wt, bias, s, prepared=prep)
            else:
                want = conv_packed._conv_packed_plain(xs, wt, bias, s)
                prep = conv_packed.prep_conv(wt, bias, cins, dtype=torch.float32)
                run = lambda: conv_packed.conv_packed(xs, wt, bias, s, prepared=prep)  # noqa: E731
            for k_steps in (1, 3, 6, 9, 1 << 20):
                conv_packed._f32_promotion(k_steps)
                diff = (run() - want).abs()
                bar = F32_ATOL + F32_RTOL * want.abs()
                out.append({"site": name, "k_steps": k_steps if k_steps < 1 << 20 else "all",
                            "max_abs_err": float(diff.max()),
                            "max_err_over_bar": float((diff / bar).max()),
                            "ms": time_ms(run)})
    finally:
        conv_packed._f32_promotion(default)
    return {"default_k_steps": default, "runs": out}


# The 18 int8 sites of one flow U-Net at 1088x1920 (the head is bf16):
# (kernel, site, h, w, cins, cout, k).
FLOW_INT8_SITES = [
    ("conv_packed", "c1", HP, WP, (6,), 32, 7),
    ("conv_packed", "c2", HP, WP, (32,), 32, 7),
    ("conv_pool_packed", "d1c1", HP // 2, WP // 2, (32,), 64, 5),
    ("conv_packed", "d1c2", HP // 2, WP // 2, (64,), 64, 5),
    ("conv_pool_packed", "d2c1", HP // 4, WP // 4, (64,), 128, 3),
    ("conv_packed", "d2c2", HP // 4, WP // 4, (128,), 128, 3),
    ("conv_packed", "d3c1", HP // 8, WP // 8, (128,), 256, 3),
    ("conv_packed", "d3c2", HP // 8, WP // 8, (256,), 256, 3),
    ("conv_packed", "d4c1", HP // 16, WP // 16, (256,), 512, 3),
    ("conv_packed", "d4c2", HP // 16, WP // 16, (512,), 512, 3),
    ("conv_packed", "u1c1", HP // 8, WP // 8, (512,), 256, 3),
    ("conv_packed", "u1c2", HP // 8, WP // 8, (256, 256), 256, 3),
    ("conv_up_m_packed", "u2c1", HP // 4, WP // 4, (256,), 128, 3),
    ("conv_packed", "u2c2", HP // 4, WP // 4, (128, 128), 128, 3),
    ("conv_up_f_packed", "u3c1", HP // 2, WP // 2, (128,), 64, 3),
    ("conv_packed", "u3c2", HP // 2, WP // 2, (64, 64), 64, 3),
    ("conv_up_f_packed", "u4c1", HP, WP, (64,), 32, 3),
    ("conv_packed", "u4c2", HP, WP, (32, 32), 32, 3),
]


def int8_cases(rng, dev):
    """Every int8 site of one flow U-Net at the shapes of the 1080p int8
    request, with (which operands arrive as int8, int8 output) as the carry
    plan of ``models.unet.int8_carry`` has them there (an operand is int8
    where its producer is carried), and other int8 cases of each packed
    kernel: K6 at the 4K up sites (its sites of one 4K flow U-Net), where
    K7 and K8 quantise a bf16 input in their load, mixed operands."""
    s = ModelConfig().leaky_slope
    carry = tunet.int8_carry(HP, WP, ModelConfig())
    specs = [(kernel, site, h, w, cins, cout, k,
              (tuple(src in carry for src in tunet.QUANT_SITES[site]), site in carry), 1)
             for kernel, site, h, w, cins, cout, k in FLOW_INT8_SITES]
    specs += [
        # int8 and bf16 operands mixed, one gathered a channel at a time
        ("conv_packed", "four_operands_136x240", 136, 240, (64, 24, 16, 10), 48, 3,
         ((True, False, True, True), True), 0),
        ("conv_pool_packed", "d1c1_bf16_in_out", HP // 2, WP // 2, (32,), 64, 5,
         ((False,), False), 0),
        # where h // 4 is no multiple of 8 (2160x3840), d1c2 and u1c2 are not
        # carried: K7 and K8 quantise a bf16 input in their load
        ("conv_pool_packed", "d2c1_4k_bf16_in", H4K // 4, W4K // 4, (64,), 128, 3,
         ((False,), True), 0),
        ("conv_up_m_packed", "u2c1_4k_bf16_in", H4K // 4, W4K // 4, (256,), 128, 3,
         ((False,), True), 0),
        ("conv_up_packed", "u3c1_4k", H4K // 2, W4K // 2, (128,), 64, 3, ((True,), True), 1),
        ("conv_up_packed", "u4c1_4k", H4K, W4K, (64,), 32, 3, ((True,), True), 1),
        ("conv_up_packed", "k5_bf16_in_out", 270, 480, (64,), 32, 5, ((False,), False), 0),
        ("conv_up_packed", "k1_ragged_270x486", 270, 486, (32,), 16, 1, ((True,), True), 0),
    ]
    cases = []
    for kernel, name, h, w, cins, cout, k, q, mult in specs:
        c = packed_case(rng, dev, kernel, name, h, w, cins, cout, k, s, int8=q)
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


def warp_case(rng, dev, pairs, h, w, align_corners, scale, bias, atol, timed, batch=1,
              train=False):
    """One warp case, through ``warp_one`` and through the pair launch with
    both flow layouts: the halves of one 4-channel tensor, as the cascade
    hands them over, and two separate tensors; NHWC and planar. ``train``: a
    flow that requires grad, as a training step hands it over."""
    imgs = [torch.from_numpy(rng.random((batch, h, w, 3), dtype=np.float32)).to(dev)
            for _ in range(2)]
    fl = (rng.standard_normal((batch, h, w, 4)) * scale).astype(np.float32)
    fl[..., 0::2] += bias[0]
    fl[..., 1::2] += bias[1]
    ftc = torch.from_numpy(fl).to(dev).requires_grad_(train)
    halves = [ftc[..., :2], ftc[..., 2:]]
    separate = [f.contiguous() for f in halves]
    check(warp_kernel._flow_halves(*halves) and not warp_kernel._flow_halves(*separate),
          "the flow halves are not recognised as one 4-channel tensor")
    kernel, _ = warp_kernel._variant(pairs)
    case = f"{kernel} {batch}x{h}x{w} ac={align_corners} flow~{scale}+{bias}"
    with torch.no_grad():
        want = [warp_kernel._warp_plain(i, f, align_corners, pairs, False)
                for i, f in zip(imgs, halves)]

    def launched(fn, n_kernel):
        before = _build.launch_counts()
        got = fn()
        torch.cuda.synchronize()
        after = _build.launch_counts()
        check(after[kernel] - before[kernel] == n_kernel,
              f"{case}: {after[kernel] - before[kernel]} {kernel} launches, want {n_kernel}")
        outs = got if isinstance(got, (list, tuple)) else [got]
        check(all(o.requires_grad == train for o in outs),
              f"{case}: the output's requires_grad is not {train}")
        return [o.detach() for o in outs] if isinstance(got, (list, tuple)) else got.detach()

    errs = {}
    one = launched(lambda: warp_kernel.warp_one(imgs[0], halves[0], align_corners, pairs), 1)
    routes = {
        "warp_one": [one],
        "pair_flow_halves": launched(lambda: warp_kernel.warp_pair_kernel(
            *imgs, *halves, align_corners, pairs), 1),
        "pair_separate_flows": launched(lambda: warp_kernel.warp_pair_kernel(
            *imgs, *separate, align_corners, pairs), 1),
    }
    for route, outs in routes.items():
        err = max(float((g - wt).abs().max()) for g, wt in zip(outs, want))
        check(err <= atol and all(bool(torch.isfinite(g).all()) for g in outs),
              f"{case} {route}: kernel disagrees with plain version, max abs err {err} > {atol}")
        errs[route] = err
    planar_one = warp_kernel.warp_one(imgs[0], halves[0], align_corners, pairs, True)
    planar_pair = warp_kernel.warp_pair_kernel(*imgs, *halves, align_corners, pairs, True)
    check(torch.equal(planar_one.movedim(1, -1), one)
          and all(torch.equal(p.movedim(1, -1), g)
                  for p, g in zip(planar_pair, routes["pair_flow_halves"])),
          f"{case}: planar output differs")

    out = {"kernel": kernel, "shape": [batch, h, w, 3], "align_corners": align_corners,
           "flow_sigma": scale, "flow_bias": list(bias), "max_abs_err": max(errs.values()),
           "max_abs_err_by_route": errs, "atol": atol}
    if timed:
        # Per warp: a pair's time over two, its bytes over two (two frames,
        # the 4-channel flow tensor read once, two outputs).
        srcs = [warp_kernel._rounded_source(i, pairs).permute(0, 3, 1, 2) for i in imgs]
        grids = [grid_for_grid_sample(f) for f in halves]
        lib = lambda: [F.grid_sample(  # noqa: E731
            sr, g, mode="bilinear", padding_mode="zeros", align_corners=align_corners)
            for sr, g in zip(srcs, grids)]
        out["library_max_abs_diff"] = max(
            float((y.permute(0, 2, 3, 1) - g).abs().max())
            for y, g in zip(lib(), routes["pair_flow_halves"]))
        nbytes = (2 * imgs[0].numel() + ftc.numel() + 2 * one.numel()) * 4 / 2
        flops = 40.0 * h * w  # coordinates, 4 weights, 12 multiply-adds, per pixel
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        pair = lambda: warp_kernel.warp_pair_kernel(  # noqa: E731
            *imgs, *halves, align_corners, pairs)
        # A pair takes tens of microseconds: 50 calls a timing, so that one
        # slow call moves the mean little.
        out.update({
            "kernel_ms": time_ms(pair, iters=50) / 2,
            "warp_one_ms": time_ms(
                lambda: warp_kernel.warp_one(imgs[0], halves[0], align_corners, pairs), iters=50),
            "plain_ms": time_ms(lambda: [warp_kernel._warp_plain(
                i, f, align_corners, pairs, False) for i, f in zip(imgs, halves)], iters=3) / 2,
            "library_ms": time_ms(lib, iters=50) / 2,
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
            # a width that is not a multiple of 32, flow leaving the image
            cases.append(warp_case(rng, dev, pairs, 272, 200, ac, 4.0, (9.0, -7.0),
                                   WARP_ATOL, timed=False))
        # beyond the TPU kernel's window (|dx| > 126, |dy| > 30): same kernel here
        cases.append(warp_case(rng, dev, pairs, HP, WP, False, 1.0, (200.0, 50.0),
                               WARP_ATOL_LARGE, timed=False))
    return cases


# ------------------------------------------------------------------- serving

def moving_squares(seed: int, h: int, w: int, shifts=(0, 1)) -> np.ndarray:
    """One uint8 frame pair (1, 2, h, w, 3): squares moving over a gradient;
    with ``shifts`` the frames of a clip (1, len(shifts), h, w, 3), the
    squares moved by ``shift`` steps in each."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, 0.5 + 0.0 * xx], axis=-1) * 160.0 + 40.0
    base += rng.normal(0.0, 2.0, base.shape)
    pair = []
    for shift in shifts:
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


# Launches of one exp=1 request (4 U-Nets, one warp pair) on each U-Net
# path: 1080p and 4K differ at u3c1 and u4c1 (K9 below width 3200, K6 from
# there on); in int8 every conv but the four heads is int8; both warps of a
# pair are one launch, with no packing pass. The packed path prepares its
# weights once per resolution (the Interpolator's first request there):
# in bf16 and float32 one launch of the weight prep per conv, in int8 the
# codes in PyTorch and the bf16 heads on the card; a prepared request makes
# no prep launch. The plain path's K1 (on the Hopper core at its k 3/5/7)
# prepares its weights on the card per call, one launch each, as the
# reference has no prepare-once for it; the int8 calibration pass runs the
# plain path.
WARP_PAIR = {"warp_u8": 1}
PREPARE = {"conv_up_prep": 76}
PREPARE_INT8 = {"conv_up_prep": 4}
PACKED_PER_REQUEST = {"conv_packed": 56, "conv_pool_packed": 8, "conv_up_m_packed": 4,
                      "conv_up_f_packed": 8, **WARP_PAIR}
PACKED_4K_PER_REQUEST = {"conv_packed": 56, "conv_pool_packed": 8, "conv_up_m_packed": 4,
                         "conv_up_packed": 8, **WARP_PAIR}
INT8_PER_REQUEST = {"conv_packed_int8": 52, "conv_packed": 4, "conv_pool_packed_int8": 8,
                    "conv_up_m_packed_int8": 4, "conv_up_f_packed_int8": 8, **WARP_PAIR}
INT8_4K_PER_REQUEST = {"conv_packed_int8": 52, "conv_packed": 4, "conv_pool_packed_int8": 8,
                       "conv_up_m_packed_int8": 4, "conv_up_packed_int8": 8, **WARP_PAIR}
PLAIN_PER_REQUEST = {"conv_phase": 36, "conv_up_prep": 36, **WARP_PAIR}
CALIBRATION_LAUNCHES = PLAIN_PER_REQUEST
# float32: the float32 modes of the same kernels (each laid out, K9's
# folded, on the card once), the float32 warp pair; on the plain path every
# conv is F.conv2d (K1 is bfloat16 only, as in the reference).
F32_WARP_PAIR = {"warp_f32": 1}
FP32_PACKED_PER_REQUEST = {"conv_packed_f32": 56, "conv_pool_packed_f32": 8,
                           "conv_up_m_packed_f32": 4, "conv_up_f_packed_f32": 8,
                           **F32_WARP_PAIR}
FP32_PACKED_4K_PER_REQUEST = {"conv_packed_f32": 56, "conv_pool_packed_f32": 8,
                              "conv_up_m_packed_f32": 4, "conv_up_packed_f32": 8,
                              **F32_WARP_PAIR}
FP32_PLAIN_PER_REQUEST = F32_WARP_PAIR


NO_LAUNCHES = dict.fromkeys(_build.LAUNCHES, 0)


def counted(fn):
    """``fn()`` with every launch count set to 0 just before it: its result
    and the launches it made."""
    _build.reset_launch_counts()
    out = fn()
    return out, _build.launch_counts()


def summed(*ds: dict) -> dict:
    """Counts added key by key (a missing key counts 0)."""
    return {k: sum(d.get(k, 0) for d in ds) for k in {k for d in ds for k in d}}


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
    _build.reset_launch_counts()
    (_, first_ms), first = counted(lambda: serve_request(interp, pairs))  # prepares
    check_launches("serve first request", NO_LAUNCHES, first, summed(PACKED_PER_REQUEST,
                                                                      PREPARE))
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
    # the flow U-Net runs once, the other three once per time: 10 U-Nets, 3
    # warp pairs; a new Interpolator prepares once
    check_launches("serve exp=2", exp1_counts, counts, summed(
        {k: (v // 4 * 10 if k not in WARP_PAIR else 3 * v)
         for k, v in PACKED_PER_REQUEST.items()}, PREPARE))
    emit("serve", path="packed", requests=4, shape=[1, 2, H1080, W1080, 3],
         compute_dtype="bfloat16", ms_first_request_with_prepare=first_ms,
         ms_per_request=times, ms_exp2_request_with_prepare=ms2,
         launches=counts, launches_per_exp1_request=per_request,
         launches_prepare=PREPARE,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return counts


def phase_serve_4k(params, dev):
    """The default Interpolator on 2160x3840 requests: the reference routes
    u3c1 and u4c1 to K6 at this width, and so does the port."""
    interp = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, exp=1,
                          device=dev)
    _build.reset_launch_counts()
    serve_request(interp, moving_squares(0, H4K, W4K))  # prepares
    check_launches("serve_4k first request", NO_LAUNCHES, _build.launch_counts(),
                   summed(PACKED_4K_PER_REQUEST, PREPARE))
    torch.cuda.reset_peak_memory_stats()
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


def _calibrate(params, dev, pairs, pad_h, quantile):
    """One calibration pass: its ms on the host clock after a sync and its
    peak device memory; its launches and ranges checked."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats, got = counted(lambda: device_calibrate(
        params, pairs, compute_dtype=torch.bfloat16, use_pallas=True, pad_hw=(pad_h, 0),
        quantile=quantile, device=dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check_launches("int8 calibration", NO_LAUNCHES, got, CALIBRATION_LAUNCHES)
    check(all(bool(torch.isfinite(v) and v > 0) for st in stats.values() for v in st.values()),
          "int8 calibration: a range is not finite and positive")
    return {"calibration_ms": ms, "peak_device_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _rates_summary(rates: dict) -> dict:
    vals = np.array(list(rates.values()), np.float64)
    check(bool(np.isfinite(vals).all()) and bool(((vals >= 0) & (vals <= 1)).all()),
          "saturation rates are not finite and in [0, 1]")
    return {"sites": len(vals), "max": float(vals.max()), "mean": float(vals.mean()),
            "max_site": max(rates, key=rates.get)}


def phase_serve_int8(params, dev):
    """``Interpolator(int8=True)``: the first request at each resolution
    calibrates on the plain path and prepares the int8 weights, the others
    serve int8 on K5-K9 (K6 at 4K) with no weight work. Calibration by
    absmax and by the 99.9th percentile at 1080p and 4K, the saturation
    rates of both on the calibration batch, and requests of both modes with
    bfloat16 requests of the default Interpolator beside them, in turns."""
    pairs = [moving_squares(i, H1080, W1080) for i in range(3)]
    wide = [moving_squares(i, H4K, W4K) for i in range(2)]
    calibration = {}
    for name, q in (("absmax", None), ("p99.9", 0.999)):
        for res, p, pad_h in (("1080p", pairs[0], HP - H1080), ("4k", wide[0], 0)):
            calibration[f"{name}_{res}"] = _calibrate(params, dev, p, pad_h, q)

    q8 = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, int8=True,
                      device=dev)
    q8p = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, int8=True,
                       int8_percentile=99.9, device=dev)
    bf = Interpolator(params, compute_dtype="bfloat16", use_pallas=True, device=dev)
    # The first requests calibrate, prepare and serve.
    (_, first_ms), first = counted(lambda: serve_request(q8, pairs[0]))
    check_launches("serve_int8 first request", NO_LAUNCHES, first,
                   summed(CALIBRATION_LAUNCHES, PREPARE_INT8, INT8_PER_REQUEST))
    (_, first_p_ms), first_p = counted(lambda: serve_request(q8p, pairs[0]))
    check_launches("serve_int8 p99.9 first request", NO_LAUNCHES, first_p,
                   summed(CALIBRATION_LAUNCHES, PREPARE_INT8, INT8_PER_REQUEST))
    serve_request(bf, pairs[0])  # warm-up
    # Telemetry on the calibration batch: absmax with its margin clips
    # nothing by construction; the percentile grid clips its tail.
    rates = q8.saturation_rates(pairs[0])
    check(all(v == 0.0 for v in rates.values()),
          f"saturation: absmax with margin clips {_rates_summary(rates)}")
    rates_p = q8p.saturation_rates(pairs[0])
    saturation = {"absmax": _rates_summary(rates), "p99.9": _rates_summary(rates_p),
                  "p99.9_rates": rates_p}
    # Launches of the int8 requests alone, each counted from 0.
    counts = summed(first, first_p)
    ms8, ms8p, ms16, agree, agree_p, peaks = [], [], [], [], [], []
    for p in pairs:
        torch.cuda.reset_peak_memory_stats()
        (m8, t8), got = counted(lambda: serve_request(q8, p))
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        check_launches("serve_int8", NO_LAUNCHES, got, INT8_PER_REQUEST)
        (m8p, t8p), got_p = counted(lambda: serve_request(q8p, p))
        check_launches("serve_int8 p99.9", NO_LAUNCHES, got_p, INT8_PER_REQUEST)
        counts = summed(counts, got, got_p)
        m16, t16 = serve_request(bf, p)
        ms8.append(t8)
        ms8p.append(t8p)
        ms16.append(t16)
        for m in (m8, m8p):
            check(m.shape == (1, 1, H1080, W1080, 3) and m.std() > 1.0, "serve_int8: output")
        agree.append(_u8_agreement(m8, m16))
        agree_p.append(_u8_agreement(m8p, m16))
    for a in agree + agree_p:
        check(a["psnr_db"] >= INT8_VS_BF16_PSNR_DB, f"serve_int8: int8 vs bf16 {a}")

    # One int8 request at 4K: its own calibration and prep, then K6 in int8.
    (_, first_4k_ms), got = counted(lambda: serve_request(q8, wide[0]))
    check_launches("serve_int8 4K first request", NO_LAUNCHES, got,
                   summed(CALIBRATION_LAUNCHES, PREPARE_INT8, INT8_4K_PER_REQUEST))
    counts = summed(counts, got)
    torch.cuda.reset_peak_memory_stats()
    (m4k, ms4k), got = counted(lambda: serve_request(q8, wide[1]))
    peak4k = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches("serve_int8 4K", NO_LAUNCHES, got, INT8_4K_PER_REQUEST)
    counts = summed(counts, got)
    check(m4k.shape == (1, 1, H4K, W4K, 3) and m4k.std() > 1.0, "serve_int8 4K: output")
    emit("serve_int8", shape=[1, 2, H1080, W1080, 3], calibration=calibration,
         first_request_ms_with_calibration_and_prepare={"absmax": first_ms, "p99.9": first_p_ms,
                                                        "absmax_4k": first_4k_ms},
         int8_ms_per_request=ms8, int8_p99_9_ms_per_request=ms8p,
         bf16_ms_per_request_same_run=ms16, int8_vs_bf16=agree, int8_p99_9_vs_bf16=agree_p,
         int8_vs_bf16_psnr_bar_db=INT8_VS_BF16_PSNR_DB, saturation=saturation,
         launches_per_request=INT8_PER_REQUEST, launches_prepare=PREPARE_INT8, launches=counts,
         ms_4k_int8_request=ms4k, launches_per_4k_request=INT8_4K_PER_REQUEST,
         peak_device_gib_per_int8_request=peaks, peak_device_gib_4k_int8_request=peak4k)
    return counts


def _held_bytes(tree) -> int:
    """Bytes of the distinct tensors a prep holds."""
    seen = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            seen[v.data_ptr()] = v.untyped_storage().nbytes()
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
    walk(tree)
    return sum(seen.values())


def phase_prepare_once(params, dev):
    """Each path through the preparing Interpolator: its prepare alone (host
    clock after a sync, launches, the memory the prep holds), then a request
    bit-equal (u8 frames) to ``device_step`` with the same stats and no
    ``packed_params``, which prepares per call. A 1080p prep given to a 4K
    request and an int8 prep given stats of other values raise."""
    paths = [
        # (name, (h, w), compute dtype, int8, percentile, launches of the prepare)
        ("bf16_1080p", (H1080, W1080), "bfloat16", False, None, PREPARE),
        ("bf16_4k", (H4K, W4K), "bfloat16", False, None, PREPARE),
        ("float32_1080p", (H1080, W1080), "float32", False, None, PREPARE),
        ("int8_absmax_1080p", (H1080, W1080), "bfloat16", True, None, PREPARE_INT8),
        ("int8_p99.9_1080p", (H1080, W1080), "bfloat16", True, 99.9, PREPARE_INT8),
    ]
    out, keep = [], {}
    for i, (name, hw, dt, int8, pct, want_prep) in enumerate(paths):
        interp = Interpolator(params, compute_dtype=dt, use_pallas=True, int8=int8,
                              int8_percentile=pct, device=dev)
        pairs = moving_squares(40 + i, *hw)
        pad_hw, key = interp._pad(pairs)
        if int8:
            interp._ensure_quant_stats(torch.from_numpy(pairs).to(dev), pad_hw, key)
        stats = interp._quant_stats.get(key)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        prep, prep_launches = counted(lambda: interp._prepared(key))
        torch.cuda.synchronize()
        prep_ms = (time.perf_counter() - t0) * 1e3
        held = torch.cuda.memory_allocated() - base
        check_launches(f"prepare_once {name}: prepare", NO_LAUNCHES, prep_launches, want_prep)
        check(prep is not None and prep.hw == key and prep.quant_stats is stats,
              f"prepare_once {name}: the Interpolator did not prepare")
        got, launches = counted(lambda: interp.step(pairs).cpu().numpy())
        check(launches["conv_up_prep"] == 0,
              f"prepare_once {name}: a prepared request made {launches['conv_up_prep']} preps")
        want, unprepared = counted(lambda: device_step(
            params, pairs, compute_dtype=interp.compute_dtype, use_pallas=True, pad_hw=pad_hw,
            quant_stats=stats, device=dev).cpu().numpy())
        check(unprepared["conv_up_prep"] == want_prep["conv_up_prep"],
              f"prepare_once {name}: the unprepared request made "
              f"{unprepared['conv_up_prep']} preps")
        check(got.shape == want.shape and np.array_equal(got, want),
              f"prepare_once {name}: prepared and unprepared requests differ "
              f"{_u8_agreement(got, want)}")
        out.append({"path": name, "shape": [1, 2, *hw, 3], "bit_equal": True,
                    "prepare_ms": prep_ms,
                    "prepare_launches": {k: v for k, v in prep_launches.items() if v},
                    "held_bytes": _held_bytes(prep.tree), "allocated_delta_bytes": held,
                    "prepared_request_preps": launches["conv_up_prep"],
                    "unprepared_request_preps": unprepared["conv_up_prep"]})
        keep[name] = (prep, stats)
    # The checks of forward(packed_params=): a 1080p prep on a 4K request
    # (K6 in place of K9 at u3c1/u4c1), an int8 prep with other stats.
    z = torch.zeros((1, H4K, W4K, 3), device=dev)
    refused = {}
    for name, call in (
        ("flags", lambda: forward(params, z, z, 0.5, compute_dtype=torch.bfloat16,
                                  use_pallas=True, packed=True,
                                  packed_params=keep["bf16_1080p"][0], device=dev)),
        ("fingerprint", lambda: forward(
            params, z[:, :HP, :WP], z[:, :HP, :WP], 0.5, compute_dtype=torch.bfloat16,
            use_pallas=True, packed=True, packed_params=keep["int8_absmax_1080p"][0],
            quant_stats=scale_quant_stats(keep["int8_absmax_1080p"][1], 1.01), device=dev)),
    ):
        try:
            call()
        except ValueError as e:
            refused[name] = str(e)[:120]
            continue
        check(False, f"prepare_once: a mismatched prep ({name}) was not refused")
    emit("prepare_once", paths=out, refused=refused)


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


# A stem_kernel=9 configuration (the port's tests build it; nothing cut):
# the packed path refuses it, so its requests run the plain path, whose K1
# launches and preps are those of the default configuration's plain
# request, 8 of the 36 K1 (conv1 and conv2 of each U-Net) at k 9 on the
# core's streamed mode. Card against the port's CPU plain versions at
# STEM9_CPU_HW, held to the bf16 card-vs-CPU bar.
STEM9 = ModelConfig(stem_kernel=9)
STEM9_CPU_HW = (272, 480)
STEM9_K9_PER_REQUEST = 8


def phase_serve_stem9(dev):
    """1080p bf16 requests of a ``ModelConfig(stem_kernel=9)`` cascade,
    random weights from seed 0, through the default Interpolator."""
    params = init_params(torch.Generator().manual_seed(0), STEM9, device=dev)
    interp = Interpolator(params, STEM9, compute_dtype="bfloat16", use_pallas=True, exp=1,
                          device=dev)
    check(interp.packed is None, "serve_stem9: the Interpolator's packed default is not None")
    by_k = {}
    real = conv_phase._conv_sm90

    def counting(x, w, bias, slope):  # K1's launches by k (the route's one entry)
        by_k[int(w.shape[0])] = by_k.get(int(w.shape[0]), 0) + 1
        return real(x, w, bias, slope)

    conv_phase._conv_sm90 = counting
    try:
        serve_request(interp, moving_squares(0, H1080, W1080))  # warm-up
        _build.reset_launch_counts()
        by_k.clear()
        times = []
        for i in range(2):
            before, k9 = _build.launch_counts(), by_k.get(9, 0)
            mids, ms = serve_request(interp, moving_squares(i, H1080, W1080))
            times.append(ms)
            check(mids.shape == (1, 1, H1080, W1080, 3) and mids.dtype == np.uint8,
                  f"serve_stem9: output {mids.dtype} {mids.shape}")
            check_launches("serve_stem9", before, _build.launch_counts(), PLAIN_PER_REQUEST)
            check(by_k.get(9, 0) - k9 == STEM9_K9_PER_REQUEST,
                  f"serve_stem9: {by_k.get(9, 0) - k9} K1 launches at k 9, want "
                  f"{STEM9_K9_PER_REQUEST}")
            check(mids.std() > 1.0, "serve_stem9: output frame is constant")
    finally:
        conv_phase._conv_sm90 = real
    counts = _build.launch_counts()
    h, w = STEM9_CPU_HW
    pairs = moving_squares(9, h, w)
    cpu_params = params_from_numpy(unflatten_params(flatten_params(params)), device="cpu")
    card = Interpolator(params, STEM9, compute_dtype="bfloat16", use_pallas=True,
                        device=dev).step(pairs).cpu().numpy()
    cpu = Interpolator(cpu_params, STEM9, compute_dtype="bfloat16", use_pallas=True,
                       device="cpu").step(pairs).cpu().numpy()
    check(card.shape == cpu.shape == (1, 1, h, w, 3), "serve_stem9: agreement shapes")
    agreement = _u8_agreement(card, cpu)
    check(agreement["psnr_db"] >= BF16_PSNR_DB, f"serve_stem9 card vs CPU: {agreement}")
    emit("serve_stem9", config={"stem_kernel": 9}, path="plain", requests=2,
         shape=[1, 2, H1080, W1080, 3], compute_dtype="bfloat16", ms_per_request=times,
         launches=counts, k1_launches_by_k=by_k, card_vs_cpu=agreement,
         card_vs_cpu_shape=[1, 2, h, w, 3], psnr_bar_db=BF16_PSNR_DB)
    return counts


# A stem_kernel=45 configuration, past the streamed mode's former reach at
# cout 32 (k 43): its stems (conv1 cin 6/10/16/9 -> 32 and conv2 32 -> 32 of
# each U-Net) are 8 of the 36 K1 launches of a plain request, each stencil
# split into 4 x 4 blocks. Served at 272x480 and held to the bf16
# card-vs-CPU bar against the same requests through the plain versions on
# the card (``use_pallas=False`` and K1's plain version, ``F.conv2d``, at
# every site): the card's host ran a bf16 k 45 conv of 32 channels at
# 68x120 on the CPU in 24.7 s (H100 machine, 8 threads), so the CPU's two
# requests at 272x480 would take hours.
STEM45 = ModelConfig(stem_kernel=45)
STEM45_HW = (272, 480)
STEM45_K45_PER_REQUEST = 8


def phase_serve_stem45(dev):
    """Two 272x480 bf16 requests of a ``ModelConfig(stem_kernel=45)``
    cascade, random weights from seed 0, through the default Interpolator:
    K1's launches by k, and no k 45 site on ``F.conv2d`` (the plain
    version); then the same two requests through the plain versions."""
    params = init_params(torch.Generator().manual_seed(0), STEM45, device=dev)
    interp = Interpolator(params, STEM45, compute_dtype="bfloat16", use_pallas=True, exp=1,
                          device=dev)
    check(interp.packed is None, "serve_stem45: the Interpolator's packed default is not None")
    h, w = STEM45_HW
    by_k, plain_by_k = {}, {}
    real, real_plain = conv_phase._conv_sm90, conv_phase._conv_plain

    def counting(x, wt, bias, slope):  # K1's launches by k (the route's one entry)
        by_k[int(wt.shape[0])] = by_k.get(int(wt.shape[0]), 0) + 1
        return real(x, wt, bias, slope)

    def counting_plain(x, wt, bias, slope):  # the sites that take F.conv2d, by k
        plain_by_k[int(wt.shape[0])] = plain_by_k.get(int(wt.shape[0]), 0) + 1
        return real_plain(x, wt, bias, slope)

    conv_phase._conv_sm90, conv_phase._conv_plain = counting, counting_plain
    try:
        serve_request(interp, moving_squares(0, h, w))  # warm-up
        _build.reset_launch_counts()
        by_k.clear()
        plain_by_k.clear()
        times, frames = [], []
        for i in range(2):
            before, k45 = _build.launch_counts(), by_k.get(45, 0)
            mids, ms = serve_request(interp, moving_squares(i, h, w))
            times.append(ms)
            frames.append(mids)
            check(mids.shape == (1, 1, h, w, 3) and mids.dtype == np.uint8,
                  f"serve_stem45: output {mids.dtype} {mids.shape}")
            check_launches("serve_stem45", before, _build.launch_counts(), PLAIN_PER_REQUEST)
            check(by_k.get(45, 0) - k45 == STEM45_K45_PER_REQUEST,
                  f"serve_stem45: {by_k.get(45, 0) - k45} K1 launches at k 45, want "
                  f"{STEM45_K45_PER_REQUEST}")
            check(mids.std() > 1.0, "serve_stem45: output frame is constant")
        check(plain_by_k.get(45, 0) == 0,
              f"serve_stem45: {plain_by_k.get(45, 0)} k 45 convs took F.conv2d")
    finally:
        conv_phase._conv_sm90, conv_phase._conv_plain = real, real_plain
    counts = _build.launch_counts()
    ref = Interpolator(params, STEM45, compute_dtype="bfloat16", use_pallas=False, exp=1,
                       device=dev)
    conv_phase._conv_sm90 = real_plain  # every K1 site on its plain version
    try:
        before = _build.launch_counts()
        want, ref_ms = zip(*(serve_request(ref, moving_squares(i, h, w)) for i in range(2)))
        check(_build.launch_counts() == before, "serve_stem45: the reference launched a kernel")
    finally:
        conv_phase._conv_sm90 = real
    agreement = _u8_agreement(np.concatenate(frames), np.concatenate(want))
    check(agreement["psnr_db"] >= BF16_PSNR_DB, f"serve_stem45 kernels vs plain: {agreement}")
    emit("serve_stem45", config={"stem_kernel": 45}, path="plain", requests=2,
         shape=[1, 2, h, w, 3], compute_dtype="bfloat16", ms_per_request=times,
         launches=counts, k1_launches_by_k=by_k, plain_convs_by_k=plain_by_k,
         stencil_blocks=len(conv_packed._stream_blocks(45)) ** 2,
         reference="the plain versions on the card (use_pallas=False, K1 on F.conv2d)",
         reference_ms_per_request=list(ref_ms), kernels_vs_plain=agreement,
         psnr_bar_db=BF16_PSNR_DB)
    return counts


_SM90_MODES = {"0": "conv_up_m_packed (K8)", "1": "conv_up_f_packed (K9)",
               "2": "conv_pool_packed (K7)", "3": "conv_up_packed (K6)",
               "4": "conv_packed (K5)"}


def _profile_group(name: str, plain: bool = False) -> str:
    """The group of a kernel's name; on the plain path (``plain``) the Hopper
    core's bf16 DIRECT mode is K1."""
    low = name.lower()
    sm90 = re.search(
        r"conv_up_sm90_kernel<\s*\d+,\s*(?:\(.*?\))?(\d+),\s*(?:\(.*?\))?(\d+)", low)
    if sm90:  # conv_up_sm90_kernel<N, MODE, ET, K>, ET: 0 bf16, 1 int8, 2 float32
        if plain and sm90.group(1) == "4" and sm90.group(2) == "0":
            return "conv_phase (K1, Hopper core)"
        return _SM90_MODES[sm90.group(1)] + {"0": "", "1": " int8", "2": " float32"}[
            sm90.group(2)]
    if "conv_up_prep_kernel" in low:
        return "K5-K9 weight prep"
    if "conv_stream_sm90_kernel" in low:
        return "conv_phase (K1, Hopper core, streamed mode)"
    if "warp_kernel" in low:
        return "warp (K2-K4)"
    if "memcpy" in low or "memset" in low:
        return "copies host<->device"
    if any(t in low for t in ("xmma", "cudnn", "gemm", "cutlass", "nchwtonhwc", "nhwctonchw")):
        return "library convs"
    if "catarray" in low:
        return "torch.cat"
    return "elementwise PyTorch"


def phase_profile(params, dev, path, top: int = 12, hw=(H1080, W1080), n=2,
                  compute_dtype="bfloat16", **kw):
    """Device time of ``n`` served requests by group of kernels, on the path
    the Interpolator's keywords ``kw`` select (named ``path``), after a
    first request that prepares (and in int8 calibrates)."""
    from torch.profiler import ProfilerActivity, profile

    interp = Interpolator(params, compute_dtype=compute_dtype, use_pallas=True, exp=1,
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
    plain = kw.get("packed") is False
    for key, ms, _ in rows:
        group = _profile_group(key, plain)
        groups[group] = groups.get(group, 0.0) + ms
    torch.cuda.reset_peak_memory_stats()
    serve_request(interp, pairs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_kernels = sum(r[2] for r in rows)
    if kw.get("int8") and hw == (H1080, W1080):
        check(n_kernels < INT8_KERNELS_MAX,
              f"profile {path}: {n_kernels} kernels a prepared int8 request")
    # The profiler slows the host, so the idle share is taken against the
    # requests timed just before it was switched on.
    emit("profile", path=path, shape=[1, 2, *hw, 3], requests=n, compute_dtype=compute_dtype,
         peak_device_gib_one_request=peak,
         ms_per_request_unprofiled=plain_ms, device_busy_ms_per_request=busy,
         device_idle_share=max(0.0, 1.0 - busy / plain_ms),
         kernels_per_request=n_kernels, by_group=groups,
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
    # one warp pair each: one launch, no packing pass
    check(counts["warp_f32"] == 1, f"serve_fp32: {counts['warp_f32']} warp_f32 launches, want 1")
    check(counts["warp_bf16"] == 1, f"serve_fp32: {counts['warp_bf16']} warp_bf16 launches, want 1")
    check(all(n == 0 for k, n in counts.items() if k not in ("warp_f32", "warp_bf16")),
          f"serve_fp32: float32 inputs reached a bf16 kernel: {counts}")
    emit("serve_fp32", shape=[1, 2, h, w, 3], compute_dtype="float32", tf32=False,
         ms_per_request=ms, launches=counts)
    return counts


def phase_serve_fp32_packed(params, dev):
    """The float32 serving path as the reference has it: the default float32
    Interpolator (``packed=None`` following ``use_pallas``) runs every U-Net
    on the float32 modes of K5, K7, K8 and K9; the float32 plain path beside
    it, in turns, on the same pairs; then one float32 request at 2160x3840
    (K6 at u3c1 and u4c1). Runs after ``serve_fp32``, with TF32 off."""
    packed = Interpolator(params, compute_dtype="float32", use_pallas=True, device=dev)
    plain = Interpolator(params, compute_dtype="float32", use_pallas=True, packed=False,
                         device=dev)
    check(packed.packed is None, "serve_fp32_packed: the packed default is not None")
    pairs = [moving_squares(20 + i, H1080, W1080) for i in range(3)]
    _, first = counted(lambda: serve_request(packed, pairs[0]))  # prepares
    check_launches("serve_fp32_packed first request", NO_LAUNCHES, first,
                   summed(FP32_PACKED_PER_REQUEST, PREPARE))
    serve_request(plain, pairs[0])  # warm-up
    # Each request's launches counted from 0, summed by path (the prepare's
    # with the packed path's).
    counts = {"packed": first, "plain": dict(NO_LAUNCHES)}
    ms = {"packed": [], "plain": []}
    peaks = {"packed": [], "plain": []}
    agree = []
    for p in pairs:
        outs = {}
        for path, interp, want in (("packed", packed, FP32_PACKED_PER_REQUEST),
                                   ("plain", plain, FP32_PLAIN_PER_REQUEST)):
            torch.cuda.reset_peak_memory_stats()
            (outs[path], t), got = counted(lambda: serve_request(interp, p))
            peaks[path].append(torch.cuda.max_memory_allocated() / 2 ** 30)
            ms[path].append(t)
            check_launches(f"serve_fp32_packed {path}", NO_LAUNCHES, got, want)
            counts[path] = summed(counts[path], got)
            check(outs[path].shape == (1, 1, H1080, W1080, 3) and outs[path].std() > 1.0,
                  f"serve_fp32_packed {path}: output")
        agree.append(_u8_agreement(outs["packed"], outs["plain"]))
    for a in agree:
        check(a["max_u8_steps"] <= 1 and a["share_differing"] < 1e-3,
              f"serve_fp32_packed: packed against plain u8 frames {a}")
    # The frames before rounding: forward on both U-Net paths, one pair.
    x = torch.from_numpy(pairs[0]).to(dev).float() * (1.0 / 255.0)
    x = F.pad(x[0].permute(0, 3, 1, 2), (0, 0, 0, HP - H1080), mode="replicate").permute(
        0, 2, 3, 1)
    fwd = {pk: forward(params, x[:1], x[1:], 0.5, compute_dtype=torch.float32,
                       use_pallas=True, packed=pk, device=dev) for pk in (True, False)}
    err = float((fwd[True] - fwd[False]).abs().max())
    check(bool(torch.isfinite(fwd[True]).all()) and err <= F32_CASCADE_ATOL,
          f"serve_fp32_packed: forward packed against plain max abs {err} > {F32_CASCADE_ATOL}")
    # One float32 request at 4K: K6 in place of K9.
    wide = moving_squares(0, H4K, W4K)
    _, first_4k = counted(lambda: serve_request(packed, wide))  # prepares
    check_launches("serve_fp32_packed 4K first request", NO_LAUNCHES, first_4k,
                   summed(FP32_PACKED_4K_PER_REQUEST, PREPARE))
    torch.cuda.reset_peak_memory_stats()
    (m4k, ms4k), counts_4k = counted(lambda: serve_request(packed, wide))
    peak4k = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches("serve_fp32_packed 4K", NO_LAUNCHES, counts_4k, FP32_PACKED_4K_PER_REQUEST)
    counts_4k = summed(first_4k, counts_4k)
    check(m4k.shape == (1, 1, H4K, W4K, 3) and m4k.std() > 1.0, "serve_fp32_packed 4K: output")
    emit("serve_fp32_packed", shape=[1, 2, H1080, W1080, 3], compute_dtype="float32",
         tf32=False, requests=len(pairs), ms_per_request=ms, peak_device_gib_per_request=peaks,
         packed_vs_plain_u8=agree, forward_packed_vs_plain_max_abs=err,
         forward_atol=F32_CASCADE_ATOL, launches_per_request=FP32_PACKED_PER_REQUEST,
         launches_prepare=PREPARE, launches=counts, ms_4k_request=ms4k,
         peak_device_gib_4k_request=peak4k,
         launches_4k_request=FP32_PACKED_4K_PER_REQUEST)
    return counts["packed"], counts_4k


TRAINED = "benchmarks/trained_synth_f16.npz"


def phase_int8_trained(dev):
    """int8 quality with the trained checkpoint of the repo: on two 1080p
    pairs, bf16, int8 absmax and int8 at the 99.9th percentile (each
    Interpolator calibrating on the first pair) against the float32 packed
    output. The JAX package's bar for int8 against float32 (> 35 dB,
    tests/test_int8.py) holds absmax; it sets none for the percentile."""
    import os

    params = load_params(os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAINED),
                         device=dev)
    modes = {
        "float32": dict(compute_dtype="float32"),
        "bf16": dict(compute_dtype="bfloat16"),
        "int8_absmax": dict(compute_dtype="bfloat16", int8=True),
        "int8_p99.9": dict(compute_dtype="bfloat16", int8=True, int8_percentile=99.9),
    }
    interps = {m: Interpolator(params, use_pallas=True, device=dev, **kw)
               for m, kw in modes.items()}
    scores = {m: [] for m in modes if m != "float32"}
    for seed in (50, 51):
        pairs = moving_squares(seed, H1080, W1080)
        outs = {m: it.step(pairs).cpu().numpy() for m, it in interps.items()}
        check(outs["float32"].std() > 1.0, "int8_trained: float32 output is constant")
        for m in scores:
            scores[m].append(_u8_agreement(outs[m], outs["float32"]))
    for a in scores["int8_absmax"]:
        check(a["psnr_db"] > INT8_VS_BF16_PSNR_DB, f"int8_trained: int8 absmax vs float32 {a}")
    emit("int8_trained", checkpoint=TRAINED, shape=[1, 2, H1080, W1080, 3],
         against="float32 packed", bar_int8_absmax_db=INT8_VS_BF16_PSNR_DB, **scores,
         saturation_p99_9=_rates_summary(interps["int8_p99.9"].saturation_rates(
             moving_squares(50, H1080, W1080))))
    del interps, params
    torch.cuda.empty_cache()


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
    # float32 packed (the float32 kernels) against the CPU port's plain
    # versions: u8 frames, and the frames before rounding
    out["float32_packed"] = _u8_agreement(run("float32", None, dev, params),
                                          run("float32", None, "cpu", cpu_params))
    x = torch.from_numpy(pairs).float() * (1.0 / 255.0)
    before = _build.launch_counts()["conv_packed_f32"]
    fwd = [forward(prm, x[:, 0], x[:, 1], 0.5, compute_dtype=torch.float32, use_pallas=True,
                   packed=True, device=d).cpu() for prm, d in ((params, dev), (cpu_params, "cpu"))]
    check(_build.launch_counts()["conv_packed_f32"] - before == 56,
          "agreement: the float32 packed forward on the card did not run the float32 K5")
    out["float32_packed"]["forward_max_abs"] = float((fwd[0] - fwd[1]).abs().max())
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
    # the JAX package's bars between two programs computing the same frames
    for key in ("float32", "float32_packed"):
        f32 = out[key]
        check(f32["max_u8_steps"] <= 1 and f32["share_differing"] < 1e-3,
              f"agreement {key}: {f32}")
    check(out["float32_packed"]["forward_max_abs"] <= F32_CASCADE_ATOL,
          f"agreement float32_packed: {out['float32_packed']}")
    for key in ("bfloat16", "bfloat16_packed", "packed_vs_plain_on_card", "bfloat16_k6_route"):
        check(out[key]["psnr_db"] >= BF16_PSNR_DB, f"agreement {key}: {out[key]}")
    check(out["int8"]["psnr_db"] >= INT8_CARD_CPU_PSNR_DB, f"agreement int8: {out['int8']}")
    emit("agreement", shape=[1, 2, h, w, 3], bf16_psnr_bar_db=BF16_PSNR_DB,
         int8_psnr_bar_db=INT8_CARD_CPU_PSNR_DB, float32_forward_atol=F32_CASCADE_ATOL,
         k6_route_shape=[1, 2, hk, wk, 3], **out)


# --------------------------------------------------------- tools, quality

CLIP_FRAMES, CLIP_FPS = 9, 30.0
# Long enough that the writer's queue (16 frames) fills many times over: the
# loop's steady state, not its ramp and the encoder's final drain.
LONG_CLIP_FRAMES = 241
RETIME_FPS = 60.0
SEGMENT_PAIRS = 3
EVAL_TRIPLETS = 4
# ssim and the synthetic triplets on the card against the CPU on the same
# inputs: float32 on both sides, TF32 off for ssim's blur (with TF32 its
# variance cancellation breaks at the scale of C2).
QUALITY_CPU_ATOL = 1e-5


def _repo_path(rel: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def _times(d: dict, k: int) -> dict:
    return {key: v * k for key, v in d.items()}


def _per_pair(exp: int) -> dict:
    """Launches of one source pair at ``exp``: the flow U-Net once, the other
    three and the warp pair once per time (as phase serve's exp=2 request)."""
    m = (1 << exp) - 1
    return {k: (v // 4 * (1 + 3 * m) if k not in WARP_PAIR else m * v)
            for k, v in PACKED_PER_REQUEST.items()}


def _stdout_json(fn):
    """``fn()``'s return value and the JSON object it printed last."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    text = buf.getvalue()
    return rc, json.loads(text[text.index("{"):]) if "{" in text else None


def _write_clip(cv2, path, frames, fps) -> None:
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()


def _frames_and_fps(path):
    """Frames decoded from ``path`` by the port's reader, and its fps."""
    from rrin_tpu_torch.io import video as tvideo

    reader = tvideo.VideoReader(path)
    try:
        return sum(1 for _ in reader), reader.meta.fps
    finally:
        reader.close()


def _time_pack(frames, use_native: bool) -> float:
    """ms per source pair to swap and pack the clip's pairs into fresh batch
    buffers, as ``interpolate_video``'s dispatch does."""
    from rrin_tpu_torch import native

    t0 = time.perf_counter()
    for a, b in zip(frames[:-1], frames[1:]):
        batch = np.empty((1, 2) + a.shape, np.uint8)
        if not (use_native and native.pack_pair_bgr(a, b, batch, 0)):
            batch[0, 0] = a[..., ::-1]
            batch[0, 1] = b[..., ::-1]
    return (time.perf_counter() - t0) * 1e3 / (len(frames) - 1)


def phase_tools(dev, hw=(H1080, W1080)):
    """The user-facing tools on the card, each through its ``main``: the CLI
    (``rrin-tpu-torch``) on a 9-frame 30 fps clip with the trained checkpoint
    in bf16 at ``--exp 1`` and ``--exp 2``, in int8 (``--save-calib``, then
    ``--calib``), as a segmented job (``--segment-pairs 3``, then
    ``--status``) and retimed to 60 fps: frame counts, fps, launches per
    source pair and the report's stage timers; bf16 ``--exp 1`` on a
    241-frame clip, the ping-pong of 24 positions of the same squares; the
    pair packer with and without the native library over the same pairs;
    the image tool with
    ``--gt``; the eval harness on synthesized triplets in bf16, int8 and
    float32."""
    import os
    import tempfile

    from rrin_tpu_torch import cli, interp_image, native
    from rrin_tpu_torch import eval as teval

    check(native.available(), "tools: the native pair packer did not build")
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("chip_smoke check failed: tools needs OpenCV (cv2) for the "
                           "clip, the image tool and the eval triplets") from e

    h, w = hw
    ckpt = _repo_path(TRAINED)
    # 24 positions of the squares: the short clip is the first 9, the long
    # one sweeps them back and forth.
    sweep = moving_squares(60, h, w, shifts=range(24))[0]
    clip = list(sweep[:CLIP_FRAMES])
    n = CLIP_FRAMES - 1
    out: dict = {"codec": "cv2", "shape": [CLIP_FRAMES, h, w, 3], "fps_in": CLIP_FPS,
                 "checkpoint": TRAINED}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.mp4")
        _write_clip(cv2, src, clip, CLIP_FPS)

        def run(name, extra, want, frames, fps, src=src):
            dst, rep = os.path.join(tmp, f"{name}.mp4"), os.path.join(tmp, f"{name}.json")
            rc, got = counted(lambda: cli.main(
                ["-i", src, "-o", dst, "--ckpt", ckpt, "-q", "--report", rep,
                 "--device", str(dev), *extra]))
            check(rc == 0, f"tools {name}: exit {rc}")
            check_launches(f"tools {name}", NO_LAUNCHES, got, want)
            n_out, fps_out = _frames_and_fps(dst)
            check(n_out == frames and abs(fps_out - fps) < 1e-3,
                  f"tools {name}: {n_out} frames at {fps_out} fps, want {frames} at {fps}")
            with open(rep) as f:
                report = json.load(f)
            keep = ("frames_out", "interp_fps", "output_fps_rate", "compile_seconds", "timers")
            out[name] = {"argv": extra, "frames": n_out, "fps": fps_out,
                         "launches": {k: v for k, v in got.items() if v},
                         **{k: report[k] for k in keep if k in report}}
            return dst, report

        run("bf16_exp1", [], summed(PREPARE, _times(_per_pair(1), n)), 2 * n + 1,
            2 * CLIP_FPS)
        run("bf16_exp2", ["--exp", "2"], summed(PREPARE, _times(_per_pair(2), n)), 4 * n + 1,
            4 * CLIP_FPS)
        calib = os.path.join(tmp, "calib.npz")
        run("int8_save_calib", ["--int8", "--save-calib", calib],
            summed(CALIBRATION_LAUNCHES, PREPARE_INT8, _times(INT8_PER_REQUEST, n)),
            2 * n + 1, 2 * CLIP_FPS)
        run("int8_calib", ["--int8", "--calib", calib],
            summed(PREPARE_INT8, _times(INT8_PER_REQUEST, n)), 2 * n + 1, 2 * CLIP_FPS)
        segs = -(-n // SEGMENT_PAIRS)
        seg_out, manifest = run(
            "segments", ["--segment-pairs", str(SEGMENT_PAIRS)],
            summed(_times(PREPARE, segs), _times(PACKED_PER_REQUEST, n)), 2 * n + 1,
            2 * CLIP_FPS)
        check(manifest["finished"] and manifest["n_segments"] == segs,
              f"tools segments: manifest {manifest}")
        out["segments"]["segment_frames"] = [s["frames"] for s in manifest["segments"]]
        out["segments"]["segment_interp_fps"] = [s["interp_fps"] for s in manifest["segments"]]
        rc, status = _stdout_json(lambda: cli.main(["-i", src, "-o", seg_out, "--status"]))
        check(rc == 0 and status["finished"] and status["segments_done"] == segs,
              f"tools --status: {rc} {status}")
        out["segments"]["status"] = status
        run("retime_60", ["--retime", str(RETIME_FPS)],
            summed(PREPARE, _times(PACKED_PER_REQUEST, n)),
            int(n * RETIME_FPS / CLIP_FPS) + 1, RETIME_FPS)

        # The loop's steady state: a clip long enough that the encode queue
        # fills, so a slow encoder shows as encode_wait.
        long_src = os.path.join(tmp, "long.mp4")
        _write_clip(cv2, long_src, [sweep[abs((i + 23) % 46 - 23)]
                                    for i in range(LONG_CLIP_FRAMES)], CLIP_FPS)
        nl = LONG_CLIP_FRAMES - 1
        run("bf16_exp1_long", [], summed(PREPARE, _times(_per_pair(1), nl)), 2 * nl + 1,
            2 * CLIP_FPS, src=long_src)

        # The packer alone over the clip's pairs, in turns.
        bgr = [np.ascontiguousarray(f) for f in clip]
        a, b = np.empty((1, 2, h, w, 3), np.uint8), np.empty((1, 2, h, w, 3), np.uint8)
        check(native.pack_pair_bgr(bgr[0], bgr[1], a, 0), "tools: native pack refused")
        b[0, 0], b[0, 1] = bgr[0][..., ::-1], bgr[1][..., ::-1]
        check(np.array_equal(a, b), "tools: the native packer differs from numpy")
        out["pack_ms_per_pair"] = {"native": [], "numpy": []}
        for name, use in (("native", True), ("numpy", False), ("numpy", False),
                          ("native", True)):
            out["pack_ms_per_pair"][name].append(_time_pack(bgr, use))

        # The image tool on one pair, its middle frame as ground truth.
        ims = [os.path.join(tmp, f"im{j + 1}.png") for j in range(3)]
        for path, frame in zip(ims, clip):
            cv2.imwrite(path, frame)
        (rc, scores), got = counted(lambda: _stdout_json(lambda: interp_image.main(
            ["--im1", ims[0], "--im3", ims[2], "--gt", ims[1], "-o",
             os.path.join(tmp, "mid.png"), "--ckpt", ckpt, "--device", str(dev)])))
        check(rc == 0 and np.isfinite(scores["psnr"]) and 0.0 < scores["ssim"] <= 1.0,
              f"tools image: exit {rc}, {scores}")
        check(all(got[k] > 0 for k in PACKED_PER_REQUEST), f"tools image: launches {got}")
        out["image"] = {**scores, "launches": {k: v for k, v in got.items() if v}}

        # The eval harness: synthesize, then score in bf16, int8 and float32.
        data = os.path.join(tmp, "trips")
        rc, _ = _stdout_json(lambda: teval.main(
            ["--synthesize", str(EVAL_TRIPLETS), "--data", data]))
        check(rc == 0, "tools eval --synthesize")
        out["eval"] = {}
        for name, extra in (("bf16", []), ("int8", ["--int8"]), ("fp32", ["--fp32"])):
            rc, summary = _stdout_json(lambda: teval.main(
                ["--data", data, "--ckpt", ckpt, "--device", str(dev), *extra]))
            check(rc == 0 and summary["count"] == EVAL_TRIPLETS
                  and np.isfinite(summary["psnr_mean"]), f"tools eval {name}: {summary}")
            out["eval"][name] = summary
    emit("tools", **out)


def phase_quality(dev, hw=(HP, WP)):
    """The trained checkpoint on the port's synthetic 1080p triplets
    (``data.synthetic_triplet_batch``, made on the card): float32 packed,
    bf16, int8 absmax and int8 at the 99.9th percentile, each calibrating on
    the batch, scored by the port's metrics on the card against the ground
    truth and against the float32 output; ``ssim`` and the triplets on the
    card against the CPU on the same inputs."""
    from rrin_tpu_torch.data import synthetic_triplet_batch
    from rrin_tpu_torch.metrics import psnr, ssim
    from rrin_tpu_torch.models.rrin import forward_calibrate

    params = load_params(_repo_path(TRAINED), device=dev)
    i0, gt, i1 = synthetic_triplet_batch(torch.Generator().manual_seed(0), 2, hw, device=dev)
    cpu = synthetic_triplet_batch(torch.Generator().manual_seed(0), 2, hw, device="cpu")
    trip_err = max(float((a.cpu() - b).abs().max()) for a, b in zip((i0, gt, i1), cpu))

    def run(cd, quantile=False):
        stats = None
        if quantile is not False:
            _, st = forward_calibrate(params, i0, i1, 0.5, compute_dtype=cd, use_pallas=True,
                                      quantile=quantile, device=dev)
            stats = scale_quant_stats(st, 1.2)
        return forward(params, i0, i1, 0.5, compute_dtype=cd, use_pallas=True, packed=True,
                       quant_stats=stats, device=dev).clamp(0.0, 1.0)

    outs = {"float32": run(torch.float32), "bf16": run(torch.bfloat16),
            "int8_absmax": run(torch.bfloat16, None),
            "int8_p99.9": run(torch.bfloat16, 0.999)}
    f32 = outs["float32"]
    table = {}
    for name, y in outs.items():
        check(bool(torch.isfinite(y).all()) and y.shape == gt.shape, f"quality {name}: output")
        table[name] = {"psnr_vs_gt": psnr(y, gt).tolist(), "ssim_vs_gt": ssim(y, gt).tolist()}
        if name != "float32":
            table[name]["psnr_vs_float32"] = psnr(y, f32).tolist()
            table[name]["ssim_vs_float32"] = ssim(y, f32).tolist()
    table["naive_average"] = {"psnr_vs_gt": psnr(0.5 * (i0 + i1), gt).tolist()}
    ssim_err = float((ssim(f32, gt).cpu() - ssim(f32.cpu(), gt.cpu())).abs().max())
    for v in table["int8_absmax"]["psnr_vs_float32"]:
        check(v > INT8_VS_BF16_PSNR_DB, f"quality: int8 absmax vs float32 {v} dB")
    for v in table["bf16"]["psnr_vs_float32"]:
        check(v >= BF16_PSNR_DB, f"quality: bf16 vs float32 {v} dB")
    check(ssim_err <= QUALITY_CPU_ATOL, f"quality: ssim card vs CPU {ssim_err}")
    check(trip_err <= QUALITY_CPU_ATOL, f"quality: triplets card vs CPU {trip_err}")
    emit("quality", checkpoint=TRAINED, shape=list(gt.shape), seed=0, table=table,
         bars={"int8_absmax_vs_float32_db": INT8_VS_BF16_PSNR_DB,
               "bf16_vs_float32_db": BF16_PSNR_DB, "card_vs_cpu_atol": QUALITY_CPU_ATOL},
         ssim_card_vs_cpu_max_abs=ssim_err, triplets_card_vs_cpu_max_abs=trip_err)
    del params, outs
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ training

# The reference CLI's defaults: crop 256x448, batch 4, Adamax at lr 1e-4,
# Charbonnier loss; each variant 3 warm-up steps (the third under PyTorch's
# sync debug mode: a step makes no host sync), then 10 timed; the bf16
# default variant goes on to 20 steps. Each step's loss is of another batch
# of the feed and varies by batch, so the fall is read on one held-out
# batch: its loss after the 20 steps must lie below its loss before them.
TRAIN_HW, TRAIN_BATCH = (256, 448), 4
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_FALL_STEPS = 3, 10, 20
# name: (compute dtype, use_pallas, remat). The CLI trains with
# use_pallas=False (K1 at the bf16 conv sites); use_pallas adds the warp
# pair (K2 in bf16, K3 in float32); remat recomputes each U-Net's forward in
# the backward, K1 included.
TRAIN_VARIANTS = {
    "bf16": (torch.bfloat16, False, False),
    "bf16_pallas": (torch.bfloat16, True, False),
    "fp32_pallas": (torch.float32, True, False),
    "bf16_remat": (torch.bfloat16, False, True),
}
# Launches of one step: K1 and its weight prep at the 36 bf16 sites it takes
# (weights change every step, so each call prepares them), the warp pair
# once, nothing in the backward (cuDNN and PyTorch) but remat's recompute.
_K1_STEP = {"conv_phase": 36, "conv_up_prep": 36}
TRAIN_PER_STEP = {
    "bf16": _K1_STEP,
    "bf16_pallas": {**_K1_STEP, **WARP_PAIR},
    "fp32_pallas": F32_WARP_PAIR,
    "bf16_remat": _times(_K1_STEP, 2),
}
# One step's loss and gradients on the card against the CPU (kernels against
# plain versions, cuDNN against oneDNN) from the same numpy params and batch,
# full width at 1x64x96; the gradient as its relative norm error per U-Net.
# Fixed before any run.
TRAIN_CPU_HW = (64, 96)
TRAIN_CPU_BARS = {"float32": {"loss_rel": 1e-5, "grad_rel": 1e-4},
                  "bfloat16": {"loss_rel": 1e-3, "grad_rel": 5e-2}}
TRAIN_CLI_STEPS = 5


def _train_step_fn(trainer):
    from rrin_tpu_torch.train import train_step

    def step(batch):
        return train_step(trainer.params, trainer.optimizer, *batch, 0.5, cfg=trainer.cfg,
                          compute_dtype=trainer.compute_dtype, use_pallas=trainer.use_pallas,
                          remat=trainer.remat, device=trainer.device)
    return step


def _host_syncs(fn) -> list:
    """Where ``fn()`` made a synchronising CUDA call (file:line of the
    Python caller), by PyTorch's sync debug mode."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}: {str(w.message)[:80]}" for w in seen
            if "called a synchronizing CUDA operation" in str(w.message)]


def _train_variant(dev, name, steps):
    """A full-width ``Trainer`` on the synthetic feed: ms per step (CUDA
    events over the timed steps), peak memory, launches per step, the losses,
    host syncs in a step, and a held-out batch's loss before and after."""
    from rrin_tpu_torch.data import synthetic_triplet_batch
    from rrin_tpu_torch.train import Trainer, loss_fn

    cd, use_pallas, remat = TRAIN_VARIANTS[name]
    trainer = Trainer.create(torch.Generator().manual_seed(0), compute_dtype=cd,
                             use_pallas=use_pallas, remat=remat, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    held = synthetic_triplet_batch(gen, TRAIN_BATCH, TRAIN_HW, device=dev)
    batches = [synthetic_triplet_batch(gen, TRAIN_BATCH, TRAIN_HW, device=dev)
               for _ in range(steps)]

    def held_loss():
        with torch.no_grad():
            return float(loss_fn(trainer.params, *held, 0.5, compute_dtype=cd,
                                 use_pallas=use_pallas, device=dev))

    step = _train_step_fn(trainer)
    held_before = held_loss()
    losses = [step(b) for b in batches[:TRAIN_WARMUP - 1]]
    syncs = _host_syncs(lambda: losses.append(step(batches[TRAIN_WARMUP - 1])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _build.reset_launch_counts()
    start.record()
    losses += [step(b) for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]]
    stop.record()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    check_launches(f"train {name}", NO_LAUNCHES, counts, TRAIN_PER_STEP[name], TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses += [step(b) for b in batches[TRAIN_WARMUP + TRAIN_TIMED:]]
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"train {name}: non-finite loss {losses}")
    out = {"variant": name, "compute_dtype": str(cd).replace("torch.", ""),
           "use_pallas": use_pallas, "remat": remat, "steps": len(losses),
           "ms_per_step": start.elapsed_time(stop) / TRAIN_TIMED, "peak_device_gib": peak,
           "launches_per_step": {k: v // TRAIN_TIMED for k, v in counts.items() if v},
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "host_syncs_in_a_step": syncs, "held_out_loss_before": held_before,
           "held_out_loss_after": held_loss()}
    del trainer, batches
    torch.cuda.empty_cache()
    return out, counts


def _train_card_vs_cpu(dev):
    """One step's loss and gradients from the same numpy params and batch on
    the card and on the CPU, float32 and bf16, both with use_pallas."""
    from rrin_tpu_torch.train import Trainer, loss_fn, param_leaves

    tree = unflatten_params(flatten_params(
        init_params(torch.Generator().manual_seed(0), device="cpu")))
    rng = np.random.default_rng(0)
    h, w = TRAIN_CPU_HW
    i0 = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32) / np.float32(255)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    gt = ((i0 + i1) / 2).astype(np.float32)
    out = {}
    for cd in (torch.float32, torch.bfloat16):
        got = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            params = Trainer.create(params=params_from_numpy(tree, device=device),
                                    device=device).params
            loss = loss_fn(params, *(torch.from_numpy(a) for a in (i0, gt, i1)), 0.5,
                           compute_dtype=cd, use_pallas=True, device=device)
            loss.backward()
            got[where] = (float(loss.detach()), {
                name: torch.cat([t.grad.double().cpu().flatten()
                                 for t in param_leaves(params[name])])
                for name in params})
        (lc, gc), (lh, gh) = got["card"], got["cpu"]
        key = str(cd).replace("torch.", "")
        bars = TRAIN_CPU_BARS[key]
        res = {"loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
               "grad_rel_norm": {n: float((gc[n] - gh[n]).norm() / gh[n].norm()) for n in gh}}
        check(res["loss_rel"] <= bars["loss_rel"], f"train {key} card vs CPU loss {res}")
        for n, e in res["grad_rel_norm"].items():
            check(e <= bars["grad_rel"], f"train {key} card vs CPU gradient of {n}: {e}")
        out[key] = res
    return out


def _train_cli(dev):
    """``rrin-tpu-torch-train --synthetic --steps 5`` through its ``main`` at
    the defaults; the checkpoint loads again with ``load_params``."""
    import os
    import tempfile

    from rrin_tpu_torch import train

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "trained.npz")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(["--synthetic", "--steps", str(TRAIN_CLI_STEPS), "--log-every", "1",
                             "--ckpt-out", ckpt, "--device", str(dev)])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"train CLI: exit {rc}")
        back = flatten_params(load_params(ckpt, device=dev))
    lines = buf.getvalue().splitlines()
    check(len(back) == 152 and all(np.isfinite(v).all() for v in back.values()),
          "train CLI: the checkpoint does not load back whole and finite")
    check(f"after {TRAIN_CLI_STEPS} steps" in lines[-1], f"train CLI: {lines[-1:]}")
    return {"argv": ["--synthetic", "--steps", str(TRAIN_CLI_STEPS)], "exit": rc,
            "seconds": seconds, "log": lines, "checkpoint_leaves": len(back)}


def train_kernel_cases(rng, dev):
    """K1 at every site it takes in a training step's U-Nets and the warp
    pair of the use_pallas variants (K2 in bf16, K3 in float32), each at the
    step's batch and crop, on inputs that require grad, against its plain
    version."""
    b, (h, w) = TRAIN_BATCH, TRAIN_HW
    conv = []
    for name, ch, cw, cin, cout, k, slope, _ in _k1_sites(h, w):
        check(conv_phase.supports((b, ch, cw, cin), (k, k, cin, cout)) is not None,
              f"train {name} is not routed to the kernel")
        conv.append(conv_case(rng, dev, name, ch, cw, cin, cout, k, slope, batch=b, train=True))
    warps = [warp_case(rng, dev, pairs, h, w, ac, 3.0, (0.0, 0.0), WARP_ATOL, timed=False,
                       batch=b, train=True)
             for pairs in ("u8", False) for ac in (False, True)]
    emit("train_kernels", conv_phase=conv, warp=warps)
    return conv, warps


def phase_train(dev):
    """Training on the card: four full-width variants on the synthetic feed,
    one step on the card against the CPU, the CLI."""
    variants, counts = [], {}
    for name in TRAIN_VARIANTS:
        steps = TRAIN_FALL_STEPS if name == "bf16" else TRAIN_WARMUP + TRAIN_TIMED
        v, counts[name] = _train_variant(dev, name, steps)
        variants.append(v)
    probe = _host_syncs(lambda: torch.ones(1, device=dev).item())
    emit("train", shape=[TRAIN_BATCH, *TRAIN_HW, 3], optimizer="adamax", lr=1e-4,
         loss="charbonnier", variants=variants, sync_probe=probe)
    check(len(probe) == 1, f"train: the sync detector missed an .item(): {probe}")
    fall = variants[0]
    check(fall["held_out_loss_after"] < fall["held_out_loss_before"],
          f"train: the bf16 loss did not fall over {TRAIN_FALL_STEPS} steps")
    for v in variants:
        check(not v["host_syncs_in_a_step"],
              f"train {v['variant']}: host syncs in a step: {v['host_syncs_in_a_step']}")
    emit("train_checks", card_vs_cpu=_train_card_vs_cpu(dev), card_vs_cpu_bars=TRAIN_CPU_BARS,
         cli=_train_cli(dev))
    return counts


def _train_profile_group(name: str, ancestors) -> str:
    """A training step's kernel by kind of work, from its name and the names
    of the CPU ops it was launched under."""
    low = name.lower()
    backward = any(a.startswith("autograd::engine::evaluate_function") for a in ancestors)
    if any(a.startswith("Optimizer.step") for a in ancestors):
        return "optimizer"
    group = _profile_group(name, plain=True)
    if group.startswith("conv_phase"):
        return "K1 forward (remat recompute)" if backward else "K1 forward"
    if group == "K5-K9 weight prep":
        return "K1 prep"
    if group == "warp (K2-K4)":
        return "warp forward"
    if any("_WarpBackward" in a for a in ancestors):
        return "warp backward"
    if "dgrad" in low:
        return "conv dgrad"
    if "wgrad" in low:
        return "conv wgrad"
    if any("convolution_backward" in a for a in ancestors):
        return "conv backward, other kernels"
    if group == "library convs":
        return ("cuDNN forward convs (recomputed in the backward)" if backward
                else "cuDNN forward convs")
    if group == "copies host<->device":
        return group
    return "elementwise backward" if backward else "elementwise forward"


def phase_profile_train(dev, name="bf16_pallas", batch_size=TRAIN_BATCH, top=16):
    """Device time of one training step of a variant by kind of work, after
    warm-up steps, with the kernels that took the most of it by name."""
    from torch.profiler import ProfilerActivity, profile

    from rrin_tpu_torch.data import synthetic_triplet_batch
    from rrin_tpu_torch.train import Trainer

    cd, use_pallas, remat = TRAIN_VARIANTS[name]
    trainer = Trainer.create(torch.Generator().manual_seed(0), compute_dtype=cd,
                             use_pallas=use_pallas, remat=remat, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = synthetic_triplet_batch(gen, batch_size, TRAIN_HW, device=dev)
    step = _train_step_fn(trainer)
    for _ in range(TRAIN_WARMUP):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    kernels: dict = {}
    for e in prof.events():
        if not e.kernels:
            continue
        ancestors, p = [e.name], e.cpu_parent
        while p is not None:
            ancestors.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            g = _train_profile_group(k.name, ancestors)
            groups[g] = groups.get(g, 0.0) + k.duration / 1e3
            key = (g, k.name[:90])
            ms, n = kernels.get(key, (0.0, 0))
            kernels[key] = (ms + k.duration / 1e3, n + 1)
    check(len(groups) > 0, "profile train: the profiler recorded no device time")
    busy = sum(groups.values())
    tops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    # The idle share is read against the profiled step's own wall time (the
    # profiler slows the step), unclamped: kernels of one stream cannot sum
    # to more than the wall, so a negative share would show overlapping
    # streams or a profiler fault.
    emit("profile_train", variant=name, shape=[batch_size, *TRAIN_HW, 3],
         ms_per_step_unprofiled=plain_ms, ms_per_step_profiled=profiled_ms,
         device_busy_ms=busy, device_idle_share=1.0 - busy / profiled_ms,
         kernels=sum(n for _, n in kernels.values()),
         by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
         top=[{"group": g, "kernel": k, "ms": ms, "calls": n} for (g, k), (ms, n) in tops])
    del trainer
    torch.cuda.empty_cache()


# --------------------------------------------------------------- parallel

PAR_BATCH = 2
PAR_TIMED = 3
# Bars of phase parallel, fixed before any run. A data-parallel request on
# two shards against the one-device request on the same batch: equal frames
# (each kernel computes one image alone), or else the bf16 card-vs-card bar
# (BF16_PSNR_DB), its largest difference stated. Data-parallel absmax
# calibration: the full batch's, bit for bit. The spatial requests against
# the one-device plain request (the plain warp on both sides): bf16 >= 40 dB
# with its largest difference stated; float32 frames within one u8 step on
# < 1e-3 of the values and the float32 forward within F32_CASCADE_ATOL. A
# mesh training step against the one-device step on the same batch: the
# loss and every U-Net's gradient within the card-vs-CPU bars
# (TRAIN_CPU_BARS).
PAR_U8_SHARE = 1e-3


def _requests_ms(interp, pairs, n=PAR_TIMED):
    """``n`` requests after the one already made: ms each (host clock), the
    last frames, and the launches of the last request."""
    times = []
    for _ in range(n):
        (mids, ms), launches = counted(lambda: serve_request(interp, pairs))
        times.append(ms)
    return mids, times, launches


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _same_or_bf16(what, got, want):
    agree = _u8_agreement(got, want)
    agree["bit_equal"] = bool(np.array_equal(got, want))
    check(got.shape == want.shape, f"{what}: shapes {got.shape} {want.shape}")
    check(agree["bit_equal"] or agree["psnr_db"] >= BF16_PSNR_DB, f"{what}: {agree}")
    return agree


def _dp_serve(params, devices):
    """(b): bf16 packed, int8 (absmax; the 99.9th percentile's fold printed)
    and float32 packed batches of two 1080p pairs, on two shards against one
    device; the calibration folds against the full batch's."""
    from rrin_tpu_torch.parallel.sharding import make_mesh

    dev = devices[0]
    mesh = make_mesh(n_data=2, devices=devices)
    pairs = np.concatenate([moving_squares(i, H1080, W1080) for i in range(PAR_BATCH)])
    per_shard = {"bfloat16": PACKED_PER_REQUEST, "int8": INT8_PER_REQUEST,
                 "float32": FP32_PACKED_PER_REQUEST}
    out = {}
    for name, kw in (("bfloat16", {}), ("int8", {"int8": True}),
                     ("float32", {"compute_dtype": "float32"})):
        kw = {"compute_dtype": "bfloat16", "use_pallas": True, **kw}
        one = Interpolator(params, device=dev, **kw)
        dp = Interpolator(params, mesh=mesh, **kw)
        check(dp.shard_count == 2 and dp._dp_fast, f"parallel {name}: not the DP route")
        serve_request(one, pairs)  # calibrates and prepares
        _, first = counted(lambda: serve_request(dp, pairs))
        want, one_ms, one_launch = _requests_ms(one, pairs)
        got, dp_ms, dp_launch = _requests_ms(dp, pairs)
        check_launches(f"parallel one-device {name}", NO_LAUNCHES, one_launch, per_shard[name])
        check_launches(f"parallel DP {name}", NO_LAUNCHES, dp_launch, per_shard[name], times=2)
        if name == "bfloat16":  # one prepare: both shards lie on one device
            check_launches("parallel DP first request", NO_LAUNCHES, first,
                           summed(_times(PACKED_PER_REQUEST, 2), PREPARE))
        res = {"ms_one_device": one_ms, "ms_dp": dp_ms,
               "launches_one_device": _nonzero(one_launch), "launches_dp": _nonzero(dp_launch),
               "launches_dp_first_request": _nonzero(first),
               "agreement": _same_or_bf16(f"parallel DP {name}", got, want)}
        if name == "int8":
            full = device_calibrate(params, pairs, compute_dtype=torch.bfloat16,
                                    use_pallas=True, pad_hw=(HP - H1080, 0), device=dev)
            folded = dp._dp_calibrate(pairs, (HP - H1080, 0))
            res["absmax_fold_bit_equal"] = all(
                torch.equal(folded[u][k].to(dev), full[u][k]) for u in full for k in full[u])
            check(res["absmax_fold_bit_equal"],
                  "parallel: DP absmax calibration differs from the full batch's")
            q = 0.999
            fullq = device_calibrate(params, pairs, compute_dtype=torch.bfloat16,
                                     use_pallas=True, pad_hw=(HP - H1080, 0), quantile=q,
                                     device=dev)
            dpq = Interpolator(params, mesh=mesh, int8_percentile=q * 100, **kw)
            foldq = dpq._dp_calibrate(pairs, (HP - H1080, 0))
            ratio = np.array([float(foldq[u][k]) / float(fullq[u][k])
                              for u in fullq for k in fullq[u]])
            res["p99.9_fold_over_full_batch"] = {"min": float(ratio.min()),
                                                 "max": float(ratio.max()),
                                                 "mean": float(ratio.mean())}
        out[name] = res
        del one, dp
        torch.cuda.empty_cache()
    return out


def _spatial_serve(params, devices):
    """(c): a 2176x3840 bf16 request and a 1088x1920 float32 request with the
    rows cut over two shards, against the one-device plain request."""
    from rrin_tpu_torch.parallel.sharding import make_mesh
    from rrin_tpu_torch.parallel.spatial import forward_spatial

    dev = devices[0]
    mesh = make_mesh(n_data=1, n_spatial=2, devices=devices)
    out = {}
    for name, (h, w), cd in (("bfloat16_4k", (H4K + 16, W4K), "bfloat16"),
                             ("float32_1080p", (HP, WP), "float32")):
        pairs = moving_squares(3, h, w)
        one = Interpolator(params, compute_dtype=cd, packed=False, device=dev)
        sp = Interpolator(params, compute_dtype=cd, use_pallas=True, mesh=mesh)
        check(not sp._dp_fast, f"parallel spatial {name}: not the spatial route")
        want, first = counted(lambda: serve_request(one, pairs)[0])
        got, sp_first = counted(lambda: serve_request(sp, pairs)[0])
        want2, one_ms, one_launch = _requests_ms(one, pairs, 2)
        got2, sp_ms, sp_launch = _requests_ms(sp, pairs, 2)
        check(np.array_equal(got, got2) and np.array_equal(want, want2),
              f"parallel spatial {name}: requests not repeatable")
        k1 = {"conv_phase": 36, "conv_up_prep": 36} if cd == "bfloat16" else {}
        check_launches(f"parallel spatial one-device {name}", NO_LAUNCHES, first, k1)
        check_launches(f"parallel spatial {name}", NO_LAUNCHES, sp_first, k1, times=2)
        agree = _u8_agreement(got, want)
        res = {"shape": [1, 2, h, w, 3], "ms_one_device_plain": one_ms, "ms_spatial": sp_ms,
               "launches_one_device": _nonzero(one_launch),
               "launches_spatial": _nonzero(sp_launch), "agreement": agree}
        if cd == "bfloat16":
            check(agree["psnr_db"] >= BF16_PSNR_DB, f"parallel spatial {name}: {agree}")
        else:
            check(agree["max_u8_steps"] <= 1 and agree["share_differing"] < PAR_U8_SHARE,
                  f"parallel spatial {name}: {agree}")
            x = torch.from_numpy(pairs).to(dev).float() * (1.0 / 255.0)
            with torch.no_grad():
                a = forward(params, x[:, 0], x[:, 1], 0.5, device=dev)
                b = forward_spatial({dev: params}, x[:, 0], x[:, 1], 0.5, list(devices))
            res["forward_max_abs"] = float((a - b).abs().max())
            check(res["forward_max_abs"] <= F32_CASCADE_ATOL,
                  f"parallel spatial {name}: forward {res['forward_max_abs']}")
        out[name] = res
        del one, sp
        torch.cuda.empty_cache()
    return out


def _mesh_train(params, devices):
    """(d): one data-parallel and one spatial training step at 4x256x448, bf16
    and float32, and one data-parallel bf16 ``use_pallas`` step (the warp
    pair, K2, on each shard), against the one-device step of the same
    variant on the same batch; then the ms of two more steps of each."""
    from rrin_tpu_torch.data import synthetic_triplet_batch
    from rrin_tpu_torch.parallel.sharding import make_mesh
    from rrin_tpu_torch.train import Trainer, mesh_train_step, param_leaves

    dev = devices[0]
    meshes = {"data_parallel": (make_mesh(n_data=2, devices=devices), None),
              "spatial": (make_mesh(n_data=1, n_spatial=2, devices=devices), 1)}
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [synthetic_triplet_batch(gen, TRAIN_BATCH, TRAIN_HW, device=dev)
               for _ in range(3)]

    def grads(tr):
        return {u: torch.cat([t.grad.double().flatten() for t in param_leaves(tr.params[u])])
                for u in tr.params}

    def steps_ms(tr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[1:]:
            tr.step(*b)
        return (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)

    # (key, compute dtype, use_pallas, meshes): the spatial step takes the
    # plain warp whatever use_pallas says, so use_pallas runs on DP only
    variants = (("bfloat16", torch.bfloat16, False, ("data_parallel", "spatial")),
                ("bfloat16_pallas", torch.bfloat16, True, ("data_parallel",)),
                ("float32", torch.float32, False, ("data_parallel", "spatial")))
    out = {}
    for key, cd, use_pallas, names in variants:
        bars = TRAIN_CPU_BARS[str(cd).replace("torch.", "")]
        one = Trainer.create(params=params, compute_dtype=cd, use_pallas=use_pallas, device=dev)
        loss_one = one.step(*batches[0])
        g_one = grads(one)
        p_one = torch.cat([t.detach().flatten() for t in param_leaves(one.params)])
        one_ms = steps_ms(one)
        del one
        for name in names:
            mesh, sd = meshes[name]
            tr = Trainer.create(params=params, compute_dtype=cd, use_pallas=use_pallas,
                                mesh=mesh, spatial_dim=sd)
            loss, launches = counted(lambda: tr.step(*batches[0]))
            g = grads(tr)
            p = torch.cat([t.detach().flatten() for t in param_leaves(tr.params)])
            res = {"loss_one_device": loss_one, "loss": loss,
                   "loss_rel": abs(loss - loss_one) / abs(loss_one),
                   "grad_rel_norm": {u: float((g[u] - g_one[u]).norm() / g_one[u].norm())
                                     for u in g},
                   "max_param_diff_after_step": float((p - p_one).abs().max()),
                   "launches_per_step": _nonzero(launches)}
            check(res["loss_rel"] <= bars["loss_rel"], f"parallel train {name} {key}: {res}")
            for u, e in res["grad_rel_norm"].items():
                check(e <= bars["grad_rel"], f"parallel train {name} {key} gradient {u}: {e}")
            # per shard: K1 and its prep at the 36 bf16 sites, the warp pair
            # with use_pallas
            per_shard = summed(_K1_STEP if cd == torch.bfloat16 else {},
                               WARP_PAIR if use_pallas else {})
            check_launches(f"parallel train {name} {key}", NO_LAUNCHES, launches, per_shard,
                           times=2)
            if name == "data_parallel":
                gen_b = batches[0]
                res["host_syncs_in_a_step"] = _host_syncs(lambda: mesh_train_step(
                    tr.params, tr.optimizer, mesh, *gen_b, compute_dtype=cd,
                    use_pallas=use_pallas))
                check(not res["host_syncs_in_a_step"],
                      f"parallel train: host syncs in a DP step {res['host_syncs_in_a_step']}")
            res["ms_per_step"], res["ms_per_step_one_device"] = steps_ms(tr), one_ms
            out[f"{name}_{key}"] = res
            del tr
        torch.cuda.empty_cache()
    return out


def phase_parallel(params, dev):
    """``parallel/`` on the card: (a) data_parallel=0 on one card is the
    one-device route; (b) data-parallel serving and (d) mesh training on two
    shards of one card, (c) spatial serving; (e) (b) and (d) on two cards
    where there are two. Two shards on one card show the cost of sharding,
    not a speedup."""
    pairs = moving_squares(0, H1080, W1080)
    base = Interpolator(params, use_pallas=True, device=dev)
    dp0 = Interpolator(params, use_pallas=True, data_parallel=0, device=dev)
    one_card = torch.cuda.device_count() == 1
    check(dp0.mesh is None or not one_card, "parallel: data_parallel=0 on one card built a mesh")
    serve_request(base, pairs)
    serve_request(dp0, pairs)
    (want, _), a = counted(lambda: serve_request(base, pairs))
    (got, _), b = counted(lambda: serve_request(dp0, pairs))
    check(np.array_equal(got, want) and a == b,
          "parallel: data_parallel=0 differs from the default Interpolator")
    check_launches("parallel data_parallel=0", NO_LAUNCHES, b, PACKED_PER_REQUEST)
    del base, dp0
    same_card = [dev, dev]
    res = {"one_device_route": {"bit_equal": True, "launches": _nonzero(b)},
           "dp_serve_two_shards_one_card": _dp_serve(params, same_card),
           "spatial_serve_two_shards_one_card": _spatial_serve(params, same_card),
           "train_two_shards_one_card": _mesh_train(params, same_card)}
    if one_card:
        res["two_cards"] = "not run: torch.cuda.device_count() is 1"
    else:
        two = [torch.device("cuda", 0), torch.device("cuda", 1)]
        res["dp_serve_two_cards"] = _dp_serve(params, two)
        res["train_two_cards"] = _mesh_train(params, two)
    emit("parallel", batch=PAR_BATCH, train_shape=[TRAIN_BATCH, *TRAIN_HW, 3],
         bars={"bf16_psnr_db": BF16_PSNR_DB, "float32_forward_atol": F32_CASCADE_ATOL,
               "u8_one_step_share": PAR_U8_SHARE, "train": TRAIN_CPU_BARS}, **res)


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


def _conv_entry(name, source, cases, launches, what, peak_ops=BF16_FLOPS, mode=""):
    """One closing entry for a conv kernel (``mode``: "" or "_f32"): sums
    over its sites in one flow U-Net at 1088x1920, weighted by how often
    each site occurs there."""
    per_unet = [c for c in cases if c["per_flow_unet"]]

    def total(key):
        return sum(c[key] * c["per_flow_unet"] for c in per_unet)

    t_ops = total("flops") / peak_ops * 1e3
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    library = any(c["library_ms"] is not None for c in per_unet)
    entry = {
        "name": name + mode, "route": "cuda", "source": source,
        "replaces": TPU_KERNEL_LINES[name], "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms") if library else None, "what": what,
    }
    if not library:
        entry["library_null_reason"] = NO_INT8_LIBRARY
    return entry


def _train_launches(train_counts, kernel) -> dict:
    """A kernel's launches in each training variant's timed steps."""
    return {v: c[kernel] for v, c in train_counts.items() if c.get(kernel)}


def kernels_summary(conv, packed, int8, packed_f32, warps, serve_counts, counts_4k,
                    int8_counts, plain_counts, stem9_counts, stem45_counts, fp32_counts,
                    f32_counts, f32_counts_4k, train_counts, train_conv, train_warps):
    """The per-kernel closing object: launches from the served paths and the
    training path (each kernel from the paths it belongs to, counted from 0
    over each path's requests or timed steps alone), every other number
    measured above in this run; each entry names its core and the source of
    its entry point. ``max_abs_err`` covers the served and the training
    shapes."""
    k1_train = _train_launches(train_counts, "conv_phase")
    k1 = _conv_entry(
        "conv_phase", "rrin_tpu_torch/csrc/conv_packed_sm90.cu", conv,
        plain_counts["conv_phase"] + stem9_counts["conv_phase"] + stem45_counts["conv_phase"]
        + sum(k1_train.values()),
        "sum over the 9 launches of one flow U-Net at 1088x1920 (plain path), each with its "
        "weight prep on the card; launches from serve_plain, serve_stem9, serve_stem45 and "
        "the training steps")
    k1["launches_by_path"] = {"serve_plain": plain_counts["conv_phase"],
                              "serve_stem9": stem9_counts["conv_phase"],
                              "serve_stem45": stem45_counts["conv_phase"],
                              f"train ({TRAIN_TIMED} steps)": k1_train}
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [c["max_abs_err"] for c in train_conv])
    k1["max_abs_err_train_shapes"] = max(c["max_abs_err"] for c in train_conv)
    keys = ("site", "shape", "cout", "k", "mode", "plan", "stencil_blocks", "max_abs_err",
            "kernel_ms", "kernel_device_ms", "prep_ms", "prep_device_ms", "device_time_by",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "per_flow_unet")
    k1.update({
        "core": "wgmma of conv_sm90.cuh with one bf16 operand (rrin_conv_phase_sm90_launch): "
                "mode DIRECT at k 3/5/7, the streamed mode at the other odd k (its stencil "
                "split into blocks of at most 13 x 13 taps)",
        "device_ms": sum(c["kernel_device_ms"] * c["per_flow_unet"] for c in conv),
        "k": sorted({c["k"] for c in conv}),
        "prep_ms": sum(c["prep_ms"] * c["per_flow_unet"] for c in conv),
        "sites": [{k: c[k] for k in keys} for c in conv if c["mode"] == "DIRECT"],
        "streamed_sites": [{k: c[k] for k in keys} for c in conv if c["mode"] == "streamed"],
    })
    entries = [k1]
    for name in ("warp_u8", "warp_f32", "warp_bf16"):
        timed = next(c for c in warps if c["kernel"] == name and "kernel_ms" in c)
        counts = {"warp_u8": serve_counts, "warp_f32": f32_counts}.get(name, fp32_counts)
        trained = _train_launches(train_counts, name)
        entries.append({
            "name": name, "route": "cuda", "source": "rrin_tpu_torch/csrc/warp.cu",
            "core": "CUDA cores, one launch a pair",
            "replaces": TPU_KERNEL_LINES[name],
            "launches": counts[name] + sum(trained.values()),
            "launches_by_path": {"served": counts[name], f"train ({TRAIN_TIMED} steps)": trained},
            "max_abs_err": max(c["max_abs_err"] for c in warps + train_warps
                               if c["kernel"] == name),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "warp_one_ms": timed["warp_one_ms"],
            "what": "one warp of a pair at 1088x1920: the pair's one launch over two, "
                    "library two F.grid_sample calls over two",
        })
    for name in ("conv_packed", "conv_pool_packed", "conv_up_packed", "conv_up_m_packed",
                 "conv_up_f_packed"):
        cases = [c for c in packed if c["kernel"] == name]
        n = sum(c["per_flow_unet"] for c in cases)
        source = "rrin_tpu_torch/csrc/" + SM90[name]
        if name == "conv_up_packed":
            entry = _conv_entry(
                name, source, cases, counts_4k[name],
                f"sum over the {n} launches of one flow U-Net at 2160x3840 (packed path, "
                "launches from serve_4k)")
            entry["k9_same_sites_ms"] = sum(
                c["kernel_ms"] for c in packed
                if c["kernel"] == "conv_up_f_packed" and c["site"].endswith("_4k"))
        else:
            entry = _conv_entry(
                name, source, cases, serve_counts[name],
                f"sum over the {n} launches of one flow U-Net at 1088x1920 (packed path)")
        entry["prepared_ms"] = sum(c["kernel_prepared_ms"] * c["per_flow_unet"]
                                   for c in cases if c["per_flow_unet"])
        entry["core"] = f"wgmma, mode {SM90_MODE[name]} of conv_sm90.cuh"
        entries.append(entry)
    check(sorted(e["name"] for e in entries) == sorted(TPU_KERNEL_LINES),
          "the closing line lists the nine TPU kernels")
    for name in ("conv_packed", "conv_pool_packed", "conv_up_packed", "conv_up_m_packed",
                 "conv_up_f_packed"):
        # the int8 mode, launches from serve_int8 (its first requests
        # calibrate and prepare)
        cases = [c for c in int8 if c["kernel"] == name]
        k6 = name == "conv_up_packed"
        entry = _conv_entry(
            name, "rrin_tpu_torch/csrc/" + SM90[name], cases, int8_counts[f"{name}_int8"],
            "int8 mode (s8 wgmma, int32 sums): sum over the "
            f"{sum(c['per_flow_unet'] for c in cases)} int8 launches of one flow U-Net at "
            f"{'2160x3840' if k6 else '1088x1920'} with the carry plan's int8 operands and "
            "outputs; launches from serve_int8", INT8_OPS, "_int8")
        entry["prepared_ms"] = sum(c["kernel_prepared_ms"] * c["per_flow_unet"]
                                   for c in cases if c["per_flow_unet"])
        entry["core"] = f"wgmma m64nNk32.s32.s8.s8, mode {SM90_MODE[name]} of conv_sm90.cuh"
        entry["sites"] = [{k: c[k] for k in (
            "site", "out_shape", "cins", "k", "int8_inputs", "int8_output", "max_abs_err",
            "kernel_ms", "kernel_prepared_ms", "plain_ms", "bound_ms", "bound_by",
            "per_flow_unet")} for c in cases]
        entries.append(entry)
    for name in ("conv_packed", "conv_pool_packed", "conv_up_packed", "conv_up_m_packed",
                 "conv_up_f_packed"):
        # the float32 mode on the Hopper core, launches from serve_fp32_packed
        cases = [c for c in packed_f32 if c["kernel"] == name]
        k6 = name == "conv_up_packed"
        where = "2160x3840 (its 4K request)" if k6 else "1088x1920"
        entry = _conv_entry(
            name, "rrin_tpu_torch/csrc/" + SM90[name],
            cases, (f32_counts_4k if k6 else f32_counts)[f"{name}_f32"],
            "float32 mode (3xTF32 on wgmma): sum over the "
            f"{sum(c['per_flow_unet'] for c in cases)} launches of one flow U-Net at "
            f"{where}; launches from serve_fp32_packed; library F.conv2d float32 without TF32",
            F32_TENSOR_FLOPS, "_f32")
        entry["prepared_ms"] = sum(c["kernel_prepared_ms"] * c["per_flow_unet"]
                                   for c in cases if c["per_flow_unet"])
        entry["core"] = f"wgmma m64nNk8.tf32, mode {SM90_MODE[name]} of conv_sm90.cuh"
        entry["sites"] = [{k: c[k] for k in ("site", "out_shape", "cins", "k", "max_abs_err",
                                             "max_err_over_bar", "kernel_ms",
                                             "kernel_prepared_ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")} for c in cases]
        entries.append(entry)
    entries.append(_prep_entry(packed, packed_f32, conv, serve_counts, f32_counts,
                               plain_counts))
    entries[-1]["plain_path"]["train_launches"] = _train_launches(train_counts, "conv_up_prep")
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was never launched by the path it belongs to")
    return {"kernels": entries, "not_ported": []}


def _prep_entry(packed, packed_f32, conv, serve_counts, f32_counts, plain_counts):
    """The weight prep of the Hopper core on the card: not a TPU kernel (the
    reference lays out, and for K9 folds, these weights with XLA ops in
    ``prep_conv``, ``prep_conv_up_f``, ``prep_conv_up_m`` and
    ``prep_conv_pool``); its sites as K5, K7, K8 and K9 have them in one flow
    U-Net at 1088x1920 (K6's sites are 4K ones), bytes-bound (fp32 weights
    in, the bf16 layout out); its float32 mode (the same sites, the two TF32
    planes out) and K1's launches on the plain path beside it."""
    cases = [c for c in packed
             if c["kernel"] != "conv_up_packed" and c["per_flow_unet"]]
    f32 = [c for c in packed_f32
           if c["kernel"] != "conv_up_packed" and c["per_flow_unet"]]

    def total(key, sites=cases):
        return sum(c[key] * c["per_flow_unet"] for c in sites)

    return {
        "name": "conv_up_prep", "route": "cuda", "source": "rrin_tpu_torch/csrc/conv_up_sm90.cu",
        "replaces": "rrin_tpu/ops/conv_packed.py:2106",
        "replaces_what": "prep_conv_up_f (and prep_conv, :345, prep_conv_up, :711, "
                         "prep_conv_pool, :1010, prep_conv_up_m, :1642): XLA weight fold "
                         "and layout, not a Pallas kernel",
        "launches": serve_counts["conv_up_prep"],
        "launches_are": "the prepares of phase serve (once per Interpolator and "
                        "resolution: 76 each); a prepared request makes none",
        "max_abs_err": max(c["prep_max_abs_err"] for c in cases),
        "ms": total("prep_ms"), "plain_ms": total("prep_plain_ms"),
        "bound_ms": total("prep_bytes") / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_null_reason": "no PyTorch call folds these weights",
        "what": f"sum over the {sum(c['per_flow_unet'] for c in cases)} K5, K7-K9 launches of "
                "one flow U-Net at 1088x1920, bit-equal to prep_conv / prep_conv_pool / "
                "prep_conv_up_m / prep_conv_up_f (and to prep_conv_up at K6's sites)",
        "float32": {
            "launches": f32_counts["conv_up_prep"],
            "launches_are": "the prepare of phase serve_fp32_packed's 1080p Interpolator",
            "max_abs_err": max(c["prep_max_abs_err"] for c in f32),
            "ms": total("prep_ms", f32), "plain_ms": total("prep_plain_ms", f32),
            "bound_ms": total("prep_bytes", f32) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "what": f"sum over the {sum(c['per_flow_unet'] for c in f32)} K5, K7-K9 launches "
                    "of one flow U-Net at 1088x1920, float32 (two TF32 planes; K9 folded "
                    "first), bit-equal to prep_conv / prep_conv_pool / prep_conv_up_m / "
                    "prep_conv_up_f (dtype=float32) (and prep_conv_up at K6's sites); "
                    "launches from serve_fp32_packed",
        },
        "plain_path": {
            "launches": plain_counts["conv_up_prep"],
            "ms": sum(c["prep_ms"] * c["per_flow_unet"] for c in conv if "prep_ms" in c),
            "what": "K1's weight prep on the card (prep_conv's one-operand layout), sum over "
                    "the 9 launches of one flow U-Net at 1088x1920; launches from serve_plain",
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    if "--k1-device" in sys.argv[1:]:
        return k1_device_main()
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
    # what ptxas reports for the streamed mode's kernels, one line each
    stream_ptxas = [" ".join(x.strip() for x in lines[i:i + 3])
                    for lines in (log.splitlines() for log in logs.values())
                    for i, ln in enumerate(lines)
                    if "Function properties" in ln and "conv_stream_sm90_kernel" in ln]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-2:]
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         nvcc=nvcc, flags=_build.NVCC_FLAGS, ptxas=regs, stream_ptxas=stream_ptxas)

    rng = np.random.default_rng(0)
    conv = conv_cases(rng, dev)
    packed = packed_cases(rng, dev)
    int8 = int8_cases(rng, dev)
    packed_f32 = packed_cases(rng, dev, f32=True)
    promotion = promotion_probe(rng, dev)
    warps = warp_cases(rng, dev)
    emit("kernels", conv_phase=conv, conv_packed=packed, conv_packed_int8=int8,
         conv_packed_f32=packed_f32, f32_promotion=promotion, warp=warps,
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S, "bf16_flops": BF16_FLOPS,
                "int8_ops": INT8_OPS, "fp32_flops": FP32_FLOPS,
                "f32_tensor_flops_3xtf32": F32_TENSOR_FLOPS})

    params = init_params(torch.Generator().manual_seed(0), ModelConfig(), device=dev)
    serve_counts = phase_serve(params, dev)
    counts_4k = phase_serve_4k(params, dev)
    int8_counts = phase_serve_int8(params, dev)
    phase_prepare_once(params, dev)
    plain_counts = phase_serve_plain(params, dev)
    stem9_counts = phase_serve_stem9(dev)
    stem45_counts = phase_serve_stem45(dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(params, dev, "packed")
        phase_profile(params, dev, "plain", packed=False)
        phase_profile(params, dev, "int8", n=1, int8=True)
        phase_profile(params, dev, "packed 4K", hw=(H4K, W4K), n=1)
        phase_profile(params, dev, "int8 4K", hw=(H4K, W4K), n=1, int8=True)
    fp32_counts = phase_serve_fp32(params, dev)
    f32_counts, f32_counts_4k = phase_serve_fp32_packed(params, dev)
    if "--profile" in sys.argv[1:]:
        phase_profile(params, dev, "float32 packed", compute_dtype="float32", n=1)
        phase_profile(params, dev, "float32 plain", compute_dtype="float32", n=1,
                      packed=False)
        phase_profile(params, dev, "float32 packed 4K", compute_dtype="float32", n=1,
                      hw=(H4K, W4K))
    phase_int8_trained(dev)
    phase_agreement(params, dev)
    phase_tools(dev)
    phase_quality(dev)
    train_conv, train_warps = train_kernel_cases(rng, dev)
    train_counts = phase_train(dev)
    if "--profile" in sys.argv[1:]:
        phase_profile_train(dev)
        # the float32 step at the batch of phase train and at half of it,
        # the shard of a data-parallel step on two devices
        phase_profile_train(dev, "fp32_pallas", TRAIN_BATCH)
        phase_profile_train(dev, "fp32_pallas", TRAIN_BATCH // 2)
    phase_parallel(params, dev)
    k1_device_times(conv)

    summary = kernels_summary(conv, packed, int8, packed_f32, warps, serve_counts, counts_4k,
                              int8_counts, plain_counts, stem9_counts, stem45_counts,
                              fp32_counts, f32_counts, f32_counts_4k, train_counts, train_conv,
                              train_warps)
    next(e for e in summary["kernels"] if e["name"] == "conv_packed_f32")["promotion"] = promotion
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
