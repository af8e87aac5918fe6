"""Hand-written CUDA backward warp (csrc/warp.cu) and its wrappers.

Replaces the three Pallas warp kernels of the JAX package's
``ops/warp_pallas.py``: ``_warp_kernel`` (float32 planes, ``pairs=False``),
``_warp_kernel_pairs`` (bf16 channel pairs, ``pairs=True``) and
``_warp_kernel_u8`` (byte-packed single plane, ``pairs="u8"``), and its pair
entry point ``warp_pair_pallas``.

What bounds it on an H100: bytes. A warp reads 3 source channels and a
2-channel flow and writes 3 channels per pixel and does some 40 float
operations for them, far below the card's operations-per-byte line, and the
four taps of a pixel are a data-dependent gather. The design therefore does
what moves the fewest bytes: :func:`warp_pair_kernel` warps both frames of
the cascade in one launch, and where the two flows are the halves of one
4-channel tensor (the cascade's ``Ft0|Ft1``, :func:`_flow_halves`) a thread
reads its pixel's four flow floats with one 16-byte load; each thread
gathers its pixel's taps straight from global memory (32x8 pixel blocks, so
a block's taps fall in few cache lines for smooth flow; L2 holds both 1080p
sources) and rounds them to bfloat16 or to the byte grid as it reads them,
so no pass writes a rounded copy of the source first; the result is stored
once, NHWC or planar. There is no row window, hence no bound on the flow and
no second path for large displacements.

The plain version of all three is :func:`rrin_tpu_torch.ops.warp.warp_bilinear`
on the equally rounded source (:func:`_rounded_source`); the wrappers take it
only for CPU tensors.

Gradients: :func:`warp_one` and :func:`warp_pair_kernel` are one
``torch.autograd.Function`` (``_Warp``, one launch for the pair), as the JAX
package's ``warp_one_pallas`` is a ``custom_vjp``. Its backward is the JAX
package's ``_warp_one_bwd``: the autograd of ``warp_bilinear`` on the
**unrounded** source and the flow (gather and scatter-add on the card), since
the reference has no backward kernel. The kernel itself is forward-only
(:func:`_check_cuda_inputs` refuses inputs that require grad); the Function
hands it detached tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

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
        lib.rrin_warp_launch.argtypes = [vp] * 6 + [ci] * 7 + [cf, cf, ci, ci, ci, vp]
        lib.rrin_warp_launch.restype = ci
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


def _flow_halves(flow_t0: torch.Tensor, flow_t1: torch.Tensor) -> bool:
    """Whether ``flow_t0`` and ``flow_t1`` are channels 0-1 and 2-3 of one
    NHWC-contiguous (B, H, W, 4) float32 tensor with 16-byte aligned pixels,
    as the cascade slices them out of ``Ft0|Ft1``: the pair kernel then reads
    both with one 16-byte load a pixel."""
    if (flow_t0.dtype != torch.float32 or flow_t1.dtype != torch.float32
            or flow_t0.device != flow_t1.device or flow_t0.shape != flow_t1.shape
            or flow_t0.ndim != 4 or flow_t0.shape[-1] != 2):
        return False
    b, h, w, _ = flow_t0.shape
    packed = (h * w * 4, w * 4, 4, 1)
    return (flow_t0.untyped_storage().data_ptr() == flow_t1.untyped_storage().data_ptr()
            and flow_t1.data_ptr() == flow_t0.data_ptr() + 8 and flow_t0.data_ptr() % 16 == 0
            and all(n == 1 or st0 == st1 == ps for n, st0, st1, ps in
                    zip(flow_t0.shape, flow_t0.stride(), flow_t1.stride(), packed)))


def _check_shapes(img: torch.Tensor, flow: torch.Tensor) -> None:
    if img.ndim != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (B, H, W, 3), got {tuple(img.shape)}")
    if flow.shape != (*img.shape[:3], 2):
        raise ValueError(
            f"flow must be {(*img.shape[:3], 2)}, got {tuple(flow.shape)}")


def _warp_cuda(
    imgs: Sequence[torch.Tensor], flows: Sequence[torch.Tensor], align_corners: bool,
    pairs, planar_out: bool,
) -> List[torch.Tensor]:
    """One launch that warps one frame or both frames of a pair (of one
    shape, on one card)."""
    kernel, src_kind = _variant(pairs)
    strides = [_check_cuda_inputs(img, flow) for img, flow in zip(imgs, flows)]
    flow4 = len(imgs) == 2 and _flow_halves(*flows)
    b, h, w, _ = imgs[0].shape
    dev = imgs[0].device
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        shape = (b, 3, h, w) if planar_out else (b, h, w, 3)
        outs = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in imgs]
        _build.launch(
            kernel, lib.rrin_warp_launch, imgs[0].data_ptr(), imgs[-1].data_ptr(),
            flows[0].data_ptr(), flows[-1].data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
            len(imgs), b, h, w, strides[0], strides[-1], int(flow4),
            w / max(w - 1, 1), h / max(h - 1, 1), int(bool(align_corners)),
            int(bool(planar_out)), src_kind, stream,
        )
    return outs


class _Warp(torch.autograd.Function):
    """Forward: one launch of the kernel for one frame or a pair (CUDA), or
    the plain version of each (CPU), on detached tensors. Backward: the JAX
    package's ``_warp_one_bwd`` for each frame, the autograd of
    ``warp_bilinear`` on the unrounded ``img`` and the flow (a planar
    cotangent is moved back to NHWC first). The flows may be views of one
    tensor (``_flow_halves``); autograd carries their gradients back to it."""

    @staticmethod
    def forward(ctx, align_corners, pairs, planar_out, *imgs_and_flows):
        ctx.align_corners, ctx.planar_out = align_corners, planar_out
        ctx.save_for_backward(*imgs_and_flows)
        imgs = [t.detach() for t in imgs_and_flows[0::2]]
        flows = [t.detach() for t in imgs_and_flows[1::2]]
        if imgs[0].device.type == "cpu":
            return tuple(_warp_plain(img, flow, align_corners, pairs, planar_out)
                         for img, flow in zip(imgs, flows))
        if imgs[0].device.type != "cuda":
            raise RuntimeError(f"no warp kernel for device {imgs[0].device}")
        return tuple(_warp_cuda(imgs, flows, align_corners, pairs, planar_out))

    @staticmethod
    def backward(ctx, *gs):
        needs = ctx.needs_input_grad[3:]
        res = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        grads = []
        with torch.enable_grad():
            for img, flow, g in zip(res[0::2], res[1::2], gs):
                wanted = [t for t in (img, flow) if t.requires_grad]
                if not wanted:
                    grads += [None, None]
                    continue
                if ctx.planar_out:  # the cotangent arrives planar; the math is NHWC
                    g = g.movedim(1, -1)
                out = warp_bilinear(img, flow, align_corners=ctx.align_corners)
                got = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
                grads += [next(got) if t.requires_grad else None for t in (img, flow)]
        return (None, None, None, *grads)


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
    plain version (``warp_bilinear`` on the same rounded source). The
    gradient is that of ``warp_bilinear`` on the unrounded source.
    """
    _variant(pairs)
    _check_shapes(img, flow)
    return _Warp.apply(align_corners, pairs, planar_out, img, flow)[0]


def warp_pair_kernel(
    i0: torch.Tensor,
    i1: torch.Tensor,
    flow_t0: torch.Tensor,
    flow_t1: torch.Tensor,
    align_corners: bool = False,
    pairs=False,
    planar_out: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both warps of the cascade, ``warp_one(i0, flow_t0)`` and
    ``warp_one(i1, flow_t1)``, in one launch of the CUDA kernel (arguments
    as :func:`warp_one`; the frames share one shape and device). A CPU
    tensor runs the plain version of each; gradients as :func:`warp_one`."""
    _variant(pairs)
    _check_shapes(i0, flow_t0)
    _check_shapes(i1, flow_t1)
    if i1.shape != i0.shape or i1.device != i0.device:
        raise ValueError(
            f"the frames of a pair must agree in shape and device, got {tuple(i0.shape)} on "
            f"{i0.device} and {tuple(i1.shape)} on {i1.device}")
    g0, g1 = _Warp.apply(align_corners, pairs, planar_out, i0, flow_t0, i1, flow_t1)
    return g0, g1
