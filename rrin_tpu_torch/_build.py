"""Builds the hand-written CUDA kernels of ``csrc/`` and counts launches.

Each ``csrc/<name>.cu`` exposes plain C entry points. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``rrin_tpu_torch/_build/`` (keyed
by a hash of the source and the flags) and loaded with ``ctypes``. Nothing is
built when the package is imported, a failed build raises, and there is no
fallback: a wrapper whose tensor lies on the card launches its kernel or
raises.

Every entry point returns ``cudaGetLastError()`` right after its launch;
:func:`launch` turns a non-zero code into an exception and adds one to the
kernel's launch count, the only place a count changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel name -> launches since the last reset_launch_counts(). The packed
# convs count their int8 launches under "<name>_int8" and their float32 ones
# under "<name>_f32"; "conv_up_prep" is the Hopper core's weight prep on the
# card (bf16 and float32, every packed kernel and K1).
_PACKED = ("conv_packed", "conv_pool_packed", "conv_up_packed", "conv_up_m_packed",
           "conv_up_f_packed")
LAUNCHES: Dict[str, int] = {
    "conv_phase": 0, "warp_u8": 0, "warp_f32": 0, "warp_bf16": 0,
    "conv_up_prep": 0,
    **{f"{name}{mode}": 0 for name in _PACKED for mode in ("", "_int8", "_f32")},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda): "
        "the CUDA kernels of rrin_tpu_torch cannot be built"
    )


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every missing library, all ``nvcc`` processes started together.

    Returns ``{name: compiler log}`` (the log holds ``ptxas -v``'s register
    and shared-memory report) for the libraries built by this call.
    """
    pending = []
    for name in (sources() if names is None else names):
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((name, out, tmp, cmd, proc))
    logs, errors = {}, []
    for name, out, tmp, cmd, proc in pending:  # reap every compiler
        log, _ = proc.communicate()
        if proc.returncode != 0 or not tmp.exists():
            errors.append(
                f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log or ""
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib


def launch(kernel: str, fn, *args) -> None:
    """Call one launching C entry point; raise on a CUDA error code."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel!r} failed to launch: cudaError {err}")
    LAUNCHES[kernel] += 1
