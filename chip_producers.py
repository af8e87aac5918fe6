#!/usr/bin/env python3
"""Which side bounds the float32 resampling kernels on the Hopper core.

    python3 chip_producers.py

needs one CUDA GPU (written for an H100, sm_90a), `nvcc`, PyTorch with CUDA
and numpy, like ``chip_smoke.py``. It builds ``csrc/conv_up_sm90.cu`` (K7, K8
and K9) as it is and in two variants made from the checkout's sources by a
text substitution in ``conv_sm90.cuh``:

  skip     the float32 producers of K7 and K8 build no halo tile (the
           consumers then run on whatever the buffers hold): the time left is
           the consumers' and the weight copies', so the difference to the
           real kernel is what the producers add;
  cb_outer the channel block as the outermost tile index (the order of the
           bf16, int8, K5 and K6 kernels), against which ``cb_inner`` is
           measured.

Each float32 site of K7, K8 and K9 in one flow U-Net at 1088x1920, and K7's
and K8's 4K sites, is timed through its wrapper with ``prepared=`` weights,
the real library and a variant in turns (real, variant, variant, real).
Prints one JSON line per site and, last, the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from rrin_tpu_torch import ModelConfig, _build
from rrin_tpu_torch.ops import conv_packed

HP, WP, H4K, W4K = 1088, 1920, 2160, 3840
POOL_CALL = "build_halo_pool_f32<N, K>(a, L, halo, xf, T, gch * a.cchunk, p);"
UPM_CALL = "build_halo_upm_f32<N, K>(a, L, halo, xf, T, gch * a.cchunk, p);"
CB_INNER = "return ET == F32 && (MODE == POOL || MODE == UP || MODE == UPF);"
# (kernel, site, output h, w, cin, cout, k)
SITES = [
    ("conv_pool_packed", "d1c1", HP // 2, WP // 2, 32, 64, 5),
    ("conv_pool_packed", "d2c1", HP // 4, WP // 4, 64, 128, 3),
    ("conv_up_m_packed", "u2c1", HP // 4, WP // 4, 256, 128, 3),
    ("conv_up_f_packed", "u3c1", HP // 2, WP // 2, 128, 64, 3),
    ("conv_up_f_packed", "u4c1", HP, WP, 64, 32, 3),
    ("conv_pool_packed", "d1c1_4k", H4K // 2, W4K // 2, 32, 64, 5),
    ("conv_up_m_packed", "u2c1_4k", H4K // 4, W4K // 4, 256, 128, 3),
]


def variant_sources(header: str) -> dict:
    for text in (POOL_CALL, UPM_CALL, CB_INNER):
        if header.count(text) != 1:
            raise RuntimeError(f"conv_sm90.cuh no longer holds {text!r} once")
    return {"skip": header.replace(POOL_CALL, "{}").replace(UPM_CALL, "{}"),
            "cb_outer": header.replace(CB_INNER, "return false;")}


def build_variants() -> dict:
    """One library per variant, all ``nvcc`` processes started together."""
    procs = {}
    for name, header in variant_sources((_build.CSRC / "conv_sm90.cuh").read_text()).items():
        d = _build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("conv_prologue.cuh", "conv_up_sm90.cu"):
            (d / f).write_text((_build.CSRC / f).read_text())
        (d / "conv_sm90.cuh").write_text(header)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "conv_up_sm90.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build_all(["conv_up_sm90"])
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
    return libs


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_producers.py needs a CUDA GPU")
    dev = torch.device("cuda:0")
    libs = build_variants()
    real = _build.library("conv_up_sm90")
    rng = np.random.default_rng(0)
    s = ModelConfig().leaky_slope
    prep = {"conv_pool_packed": conv_packed.prep_conv_pool,
            "conv_up_m_packed": conv_packed.prep_conv_up_m,
            "conv_up_f_packed": conv_packed.prep_conv_up_f}
    try:
        for kernel, site, h, w, cin, cout, k in SITES:
            hs, ws = (2 * h, 2 * w) if kernel == "conv_pool_packed" else (h // 2, w // 2)
            x = torch.from_numpy(rng.standard_normal((1, hs, ws, cin)).astype(np.float32)).to(dev)
            bound = 1.0 / np.sqrt(k * k * cin)
            wt = torch.from_numpy(
                rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)).to(dev)
            b = torch.from_numpy(rng.uniform(-bound, bound, (cout,)).astype(np.float32)).to(dev)
            pr = prep[kernel](wt, b, dtype=torch.float32)
            fn = getattr(conv_packed, kernel)

            def run():
                return fn(x, wt, b, s, prepared=pr)

            want = run()
            out = {"kernel": kernel, "site": site, "plan": list(pr["plan"])}
            for name, lib in libs.items():
                ms = []
                for which in ("real", name, name, "real"):
                    _build._LIBS["conv_up_sm90"] = real if which == "real" else lib
                    if name != "skip" and not torch.equal(run(), want):
                        raise RuntimeError(f"{site}: the {name} variant changes the result")
                    ms.append(time_ms(run))
                out[name] = {"real_ms": (ms[0] + ms[3]) / 2, "variant_ms": (ms[1] + ms[2]) / 2}
            print(json.dumps(out), flush=True)
    finally:
        _build._LIBS["conv_up_sm90"] = real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
