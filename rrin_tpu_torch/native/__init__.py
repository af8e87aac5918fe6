"""ctypes bindings for the native host-path library (framepack.cpp).

Builds ``libframepack`` with g++ on first use into ``rrin_tpu_torch/_build/``
(keyed by a hash of the source and the flags; never next to the source) and
binds its plain C entry points with ctypes. Falls back to numpy when no
toolchain exists: these are host bytes, not device work, so the pipeline
never hard-depends on the native path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from rrin_tpu_torch._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "framepack.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libframepack-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
            lib.rrin_swap_rb_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.rrin_swap_rb_u8.restype = None
            lib.rrin_pack_pair_bgr.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.rrin_pack_pair_bgr.restype = None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def swap_rb(frame: np.ndarray, threads: int = 4) -> np.ndarray:
    """BGR<->RGB for a contiguous uint8 HWC image (returns a new array)."""
    lib = _load()
    if lib is None or frame.dtype != np.uint8 or not frame.flags.c_contiguous \
            or frame.ndim != 3 or frame.shape[2] != 3:
        return np.ascontiguousarray(frame[:, :, ::-1])
    out = np.empty_like(frame)
    lib.rrin_swap_rb_u8(
        frame.ctypes.data, out.ctypes.data,
        frame.shape[0] * frame.shape[1], threads,
    )
    return out


def pack_pair_bgr(
    prev_bgr: np.ndarray, cur_bgr: np.ndarray, batch: np.ndarray, slot: int,
    threads: int = 4,
) -> bool:
    """Pack a BGR pair into batch[slot] (a (B,2,H,W,3) uint8 buffer) as RGB.

    Returns False (caller should use the numpy path) when unavailable or when
    the arrays are not contiguous uint8 frames of the batch's frame shape.
    """
    lib = _load()
    if (
        lib is None
        or prev_bgr.dtype != np.uint8
        or cur_bgr.dtype != np.uint8
        or batch.dtype != np.uint8
        or not (prev_bgr.flags.c_contiguous and cur_bgr.flags.c_contiguous
                and batch.flags.c_contiguous)
        or prev_bgr.shape != cur_bgr.shape
        or batch.ndim != 5
        or batch.shape[1:] != (2,) + prev_bgr.shape
        or not 0 <= slot < batch.shape[0]
    ):
        return False
    frame_bytes = prev_bgr.nbytes
    lib.rrin_pack_pair_bgr(
        prev_bgr.ctypes.data, cur_bgr.ctypes.data, batch.ctypes.data,
        slot, frame_bytes, threads,
    )
    return True
