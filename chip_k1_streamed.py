#!/usr/bin/env python3
"""A short first check of K1's streamed mode on the Hopper core.

    python3 chip_k1_streamed.py

needs one CUDA GPU (written for an H100, sm_90a), `nvcc`, PyTorch with CUDA
and numpy, like ``chip_smoke.py``. It builds ``csrc/conv_packed_sm90.cu`` (K1's
entry point) and ``csrc/conv_up_sm90.cu`` (the weight prep), prints what
``ptxas`` reports for ``conv_stream_sm90_kernel<N>``, then sends one bf16
``conv2d_fused`` call per case through the wrapper (odd k 1 to 49, cin 6 to
64, cout 8 to 64, small frames first, then 272x480 and one 1088x1920 stem at
k 9; k 3 on DIRECT beside them) and holds each against its plain version at
``chip_smoke.py``'s K1 bar. The cases from 272x480 on are timed through the
wrapper (its weight prep included), 5 calls after 2. A watchdog ends the
process with exit code 7 if a launch hangs. Prints one JSON line per case
and, last, ``{"all_ok": ...}``; exits 1 unless every case holds.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from chip_smoke import BF16_FLOPS, CONV_ATOL, CONV_RTOL, smi_line, time_ms
from rrin_tpu_torch import _build
from rrin_tpu_torch.ops import conv_phase

# (k, cin, cout, h, w)
CASES = [(1, 32, 32, 64, 96), (9, 32, 32, 64, 96), (9, 6, 32, 64, 96), (13, 33, 20, 40, 70),
         (37, 32, 64, 48, 80), (49, 32, 8, 48, 80), (11, 64, 64, 64, 130), (3, 32, 32, 64, 96),
         (9, 32, 32, 272, 480), (9, 6, 32, 272, 480), (37, 32, 64, 272, 480),
         (49, 32, 8, 272, 480), (1, 32, 32, 272, 480), (11, 32, 32, 272, 480),
         (13, 32, 32, 272, 480), (9, 32, 32, 1088, 1920)]
WATCHDOG_S = 240


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_k1_streamed.py needs a CUDA GPU")
    t0 = time.perf_counter()
    logs = _build.build_all(["conv_packed_sm90", "conv_up_sm90"])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for log in logs.values():
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Function properties" in ln and "conv_stream_sm90_kernel" in ln:
                print(" ".join(x.strip() for x in lines[i:i + 3]), flush=True)
    dog = threading.Timer(WATCHDOG_S, lambda: os._exit(7))
    dog.daemon = True
    dog.start()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    ok = True
    for k, cin, cout, h, w in CASES:
        x = torch.from_numpy(rng.standard_normal((1, h, w, cin)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        bound = 1.0 / np.sqrt(k * k * cin)
        wt = torch.from_numpy(rng.uniform(-bound, bound, (k, k, cin, cout)).astype(
            np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(-bound, bound, cout).astype(np.float32)).to(dev)
        before = _build.launch_counts()["conv_phase"]
        got = conv_phase.conv2d_fused(x, wt, b, 0.1)
        torch.cuda.synchronize()
        want = conv_phase._conv_plain(x, wt, b, 0.1)
        diff = (got.float() - want.float()).abs()
        held = bool((diff <= CONV_ATOL + CONV_RTOL * want.float().abs()).all()) and bool(
            torch.isfinite(got.float()).all())
        rec = {"k": k, "cin": cin, "cout": cout, "hw": [h, w],
               "plan": conv_phase._sm90_plan(k, cin, cout),
               "launched": _build.launch_counts()["conv_phase"] - before,
               "max_abs_err": float(diff.max()), "ok": held}
        if h >= 272:
            rec["ms"] = time_ms(lambda: conv_phase.conv2d_fused(x, wt, b, 0.1), iters=5)
            rec["bound_ms"] = 2.0 * h * w * k * k * cin * cout / BF16_FLOPS * 1e3
        print(json.dumps(rec), flush=True)
        ok = ok and held and rec["launched"] == 1
    dog.cancel()
    print(smi_line(), flush=True)
    print(json.dumps({"all_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
