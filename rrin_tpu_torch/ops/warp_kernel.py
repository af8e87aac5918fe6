"""Hand-written CUDA backward warp (csrc/warp.cu) and its wrapper.

Replaces the three Pallas warp kernels of the JAX package's
``ops/warp_pallas.py``: ``_warp_kernel`` (float32 planes, ``pairs=False``),
``_warp_kernel_pairs`` (bf16 channel pairs, ``pairs=True``) and
``_warp_kernel_u8`` (byte-packed single plane, ``pairs="u8"``).

What bounds it on an H100: bytes. A warp reads 3 source channels and a
2-channel flow and writes 3 channels per pixel and does some 40 float
operations for them, far below the card's operations-per-byte line, and the
four taps of a pixel are a data-dependent gather. The design therefore does
what moves the fewest bytes: one thread per output pixel gathers straight
from global memory (neighbouring pixels hit neighbouring cache lines for
smooth flow; L2 holds a whole 1080p source), the bf16 and byte-packed
sources make a tap one 8- or 4-byte load for all three channels instead of
three 4-byte loads, and the result is stored once, NHWC or planar. There is
no row window, hence no bound on the flow and no second path for large
displacements. The source rounding/packing is a small preceding pass in the
same CUDA file.

The plain version of all three is :func:`rrin_tpu_torch.ops.warp.warp_bilinear`
on the equally rounded source (:func:`_rounded_source`); the wrapper takes it
only for CPU tensors. Forward only: inputs that require grad are refused on
the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rrin_tpu_torch import _build
from rrin_tpu_torch.ops.warp import warp_bilinear

# pairs argument -> (launch-count name, src_kind of rrin_warp_launch)
_VARIANTS = {False: ("warp_f32", 0), True: ("warp_bf16", 1), "u8": ("warp_u8", 2)}


def _variant(pairs) -> Tuple[str, int]:
    if isinstance(pairs, str):
        if pairs != "u8":
            raise ValueError(f"pairs must be False, True or 'u8', got {pairs!r}")
        return _VARIANTS["u8"]
    return _VARIANTS[bool(pairs)]


def _lib() -> ctypes.CDLL:
    lib = _build.library("warp")
    if not getattr(lib, "_rrin_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rrin_warp_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, cf, ci, ci, ci, vp]
        lib.rrin_warp_launch.restype = ci
        for fn in (lib.rrin_pack_u8_launch, lib.rrin_pack_bf16_launch):
            fn.argtypes = [vp, vp, ctypes.c_longlong, vp]
            fn.restype = ci
        lib._rrin_typed = True
    return lib


def _rounded_source(img: torch.Tensor, pairs) -> torch.Tensor:
    """The float32 source values each kernel variant actually samples."""
    img = img.to(torch.float32)
    if isinstance(pairs, str):  # "u8"
        return torch.round(img.clamp(0.0, 1.0) * 255.0) * (1.0 / 255.0)
    if pairs:
        return img.to(torch.bfloat16).to(torch.float32)
    return img


def _warp_plain(img, flow, align_corners, pairs, planar_out):
    out = warp_bilinear(_rounded_source(img, pairs), flow, align_corners=align_corners)
    return out.movedim(-1, 1) if planar_out else out


def _check_cuda_inputs(img: torch.Tensor, flow: torch.Tensor) -> int:
    """Raise on what the kernel does not take; return the flow's pixel stride.

    The flow may be a 2-channel slice of a wider NHWC tensor (the cascade
    slices Ft0 and Ft1 out of their concatenation): any even number of
    floats per pixel with rows and batches packed is read in place.
    """
    if flow.device != img.device:
        raise ValueError(f"img on {img.device} but flow on {flow.device}")
    for name, t in (("img", img), ("flow", flow)):
        if t.dtype != torch.float32:
            raise TypeError(f"the warp kernel takes float32 {name}, got {t.dtype}")
        if t.requires_grad:
            raise RuntimeError(
                "the warp kernel is forward-only; detach its inputs "
                "(or run under torch.no_grad())")
    if not img.is_contiguous():
        raise ValueError("the warp kernel takes an NHWC-contiguous img")
    b, h, w, _ = flow.shape
    s = flow.stride(2) if w > 1 else 2
    packed = (h * w * s, w * s, s, 1)
    if (s < 2 or s % 2 or flow.data_ptr() % 8
            or any(n > 1 and st != ps
                   for n, st, ps in zip(flow.shape, flow.stride(), packed))):
        raise ValueError(
            "the warp kernel takes a flow that is NHWC-contiguous or a "
            f"2-channel slice of an NHWC-contiguous tensor; got strides {flow.stride()}")
    return s


def warp_one(
    img: torch.Tensor, flow: torch.Tensor, align_corners: bool = False,
    pairs=False, planar_out: bool = False,
) -> torch.Tensor:
    """Warp (B,H,W,3) float32 by (B,H,W,2) float32 through the CUDA kernel.

    ``pairs=False`` samples the float32 source; ``pairs=True`` the source
    rounded to bfloat16 (float32 weights and accumulation); ``pairs="u8"``
    the source quantized to ``round(clip(img,0,1)*255)`` bytes, which is
    exact when ``img`` came from uint8 frames scaled by ``1/255``.
    ``planar_out=True`` returns (B, 3, H, W).

    A tensor on the card launches the kernel or raises; a CPU tensor runs the
    plain version (``warp_bilinear`` on the same rounded source).
    """
    kernel, src_kind = _variant(pairs)
    if img.ndim != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (B, H, W, 3), got {tuple(img.shape)}")
    if flow.shape != (*img.shape[:3], 2):
        raise ValueError(
            f"flow must be {(*img.shape[:3], 2)}, got {tuple(flow.shape)}")
    if img.device.type == "cpu":
        return _warp_plain(img, flow, align_corners, pairs, planar_out)
    if img.device.type != "cuda":
        raise RuntimeError(f"no warp kernel for device {img.device}")
    flow_stride = _check_cuda_inputs(img, flow)

    b, h, w, _ = img.shape
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        src = img
        if src_kind == 2:
            src = torch.empty((b, h, w), dtype=torch.int32, device=img.device)
            err = lib.rrin_pack_u8_launch(img.data_ptr(), src.data_ptr(), b * h * w, stream)
        elif src_kind == 1:
            src = torch.empty((b, h, w, 4), dtype=torch.bfloat16, device=img.device)
            err = lib.rrin_pack_bf16_launch(img.data_ptr(), src.data_ptr(), b * h * w, stream)
        else:
            err = 0
        if err != 0:
            raise RuntimeError(f"warp source packing pass failed: cudaError {err}")
        shape = (b, 3, h, w) if planar_out else (b, h, w, 3)
        out = torch.empty(shape, dtype=torch.float32, device=img.device)
        _build.launch(
            kernel, lib.rrin_warp_launch, src.data_ptr(), flow.data_ptr(),
            out.data_ptr(), b, h, w, flow_stride, w / max(w - 1, 1), h / max(h - 1, 1),
            int(bool(align_corners)), int(bool(planar_out)), src_kind, stream,
        )
    return out


def warp_pair_kernel(
    i0: torch.Tensor,
    i1: torch.Tensor,
    flow_t0: torch.Tensor,
    flow_t1: torch.Tensor,
    align_corners: bool = False,
    pairs=False,
    planar_out: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both warps of the cascade through :func:`warp_one` (one launch each)."""
    g0 = warp_one(i0, flow_t0, align_corners, pairs, planar_out)
    g1 = warp_one(i1, flow_t1, align_corners, pairs, planar_out)
    return g0, g1
