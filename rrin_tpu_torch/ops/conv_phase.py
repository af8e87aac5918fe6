"""Low-channel NHWC convolution (K1): a hand-written CUDA kernel and its
wrapper.

Replaces the phase-packed Pallas kernel of the JAX package
(``ops/conv_phase.py``: ``_phase_kernel`` via ``_conv_phase_impl``, public
``conv2d_fused``): stride-1 SAME conv with odd k, + bias + optional LeakyReLU,
bfloat16 inputs and weights, float32 accumulation and bias, one rounding to
bfloat16 at the store. These are the plain U-Net's sites with few output
channels (stem 7x7 at 32, down/up stages at 32-64, the 2-4 channel heads),
which hold most of the cascade's operations; the plain path is what int8
calibration, training and every shape the packed path rejects run.

What bounds it on an H100: operations, not bytes, at every site but the heads
(the 32->32 7x7 stem does 3,136 multiply-adds for each byte pair it reads and
writes). One kernel, the Hopper core of ``csrc/conv_sm90.cuh`` (entry point
``rrin_conv_phase_sm90_launch`` of ``csrc/conv_packed_sm90.cu``), with
nothing of the TPU's lanes (no packing factor, no block-Toeplitz weights) and
no width or height gates:

  * k in {3, 5, 7} (every site of the repo's default configuration): its
    DIRECT mode with one operand, the function K5 (``conv_packed``)
    computes: a producer warpgroup copies the next channel chunks' halo tiles
    (``cp.async``; the stems' cin 6/9/10 gathered a channel at a time) while
    two consumer warpgroups contract the current one on ``wgmma``,
    persistent blocks, a chunk's whole stencil (or every chunk's, resident)
    in shared memory;
  * any other odd k (1, 9, 11, ...; ``ModelConfig.stem_kernel`` and
    ``down_kernels`` may ask for any): the core's streamed mode, the same
    walk with k a runtime argument over the blocks of at most 13 x 13 taps
    that the stencil is split into (``conv_packed._stream_blocks``; one
    block up to k 13), the weights streamed one dy row of a block (its taps
    x cchunk x N) a pipeline stage while the block's halo tile stays in
    shared memory (``conv_packed._sm90_plan(streamed=True)``). No
    shared-memory extent grows with k beyond the block, so every odd k has
    a plan.

Its weights are laid out on the card by the core's prep kernel in K5's
one-operand layout, one launch per call (count ``conv_up_prep``); its
launches count under ``conv_phase``. cin in {6, 9, 10} and cout in {2, 3, 4}
are zero-padded to the MMA tile and masked at the store, so those sites stay
on the kernel.

Routing (:func:`supports`): a square stencil of odd k, any cin, 1 <= cout
<= 64: a plan of the core (:func:`_sm90_plan`), which every such site has,
bfloat16 only; every site the JAX package's kernel takes. Everything else
(float32, cout > 64) is ``F.conv2d``, as the JAX package leaves those sites
to XLA. The plain version of the kernel is :func:`_conv_plain`; the wrapper
takes it only for CPU tensors, and on the card launches the kernel or
raises.

Gradients: :func:`conv2d_fused` is a ``torch.autograd.Function`` at every
site, as the JAX package's is a ``custom_vjp``. Its backward is the JAX
package's ``_conv_bwd``: the autograd of :func:`_conv_plain`, recomputed from
the saved ``(x, w, bias)`` and run without TF32 (cuDNN's dgrad and wgrad on
the card), since the reference has no backward kernel. The kernel itself
is forward-only: its launcher refuses inputs that require grad, and the
Function hands it detached tensors.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from rrin_tpu_torch import _build

# The output channels K1 takes (one block of the core's streamed mode).
MAX_COUT = 64


def supports(
    x_shape: Tuple[int, ...], w_shape: Tuple[int, ...]
) -> Optional[int]:
    """Return the kernel's input-channel chunk (its plan's) if it applies,
    else None.

    Routes every site the JAX package's ``supports`` routes, and more: any
    cin, and no gate on W or H here (those were DMA alignment rules).
    """
    if len(x_shape) != 4 or len(w_shape) != 4:
        return None
    kh, kw, cin, cout = w_shape
    if x_shape[3] != cin or kh != kw:
        return None
    plan = _sm90_plan(kh, cin, cout)
    return None if plan is None else plan[0]


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """cuDNN's float32 convs without TF32 inside the block, as the JAX
    package's float32 convs run at HIGHEST precision."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _leaky(y: torch.Tensor, slope: Optional[float]) -> torch.Tensor:
    return y if slope is None else torch.where(y >= 0, y, slope * y)


def _conv_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float],
) -> torch.Tensor:
    """conv (stride 1, SAME) + bias + optional LeakyReLU in ``x.dtype`` with
    ``F.conv2d``: the plain version of the kernel and the path of every site
    the kernel does not take. float32 runs without TF32, as the JAX package's
    float32 convs run at HIGHEST precision."""
    pad = (w.shape[0] - 1) // 2
    xn = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
    wn = w.to(x.dtype).permute(3, 2, 0, 1)
    with no_tf32():
        y = F.conv2d(xn, wn, padding=pad)
    y = y.permute(0, 2, 3, 1).contiguous() + bias.to(x.dtype)
    return _leaky(y, slope)


def _check_args(x, w, bias) -> None:
    """What the kernel asks of its tensors."""
    if w.device != x.device or bias.device != x.device:
        raise ValueError("x, w and bias must lie on one device")
    if not x.is_contiguous():
        raise ValueError("the conv kernel takes an NHWC-contiguous input")
    if x.requires_grad or w.requires_grad or bias.requires_grad:
        raise RuntimeError(
            "the conv kernel is forward-only; detach its inputs "
            "(or run under torch.no_grad())")
    cout = w.shape[3]
    if bias.shape != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(bias.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("the conv kernel takes a 16-byte aligned input")


def _sm90_plan(k: int, cin: int, cout: int) -> Optional[Tuple[int, int, int]]:
    """(cchunk, n_tiles, n_cout_blocks) of K1 on the Hopper core, or None
    where K1 does not take the site (even k, cout > 64): at k 3/5/7 K5's
    plan for one bf16 operand (resident weights where they fit), at every
    other odd k that of the streamed mode, whose shared memory is that of
    its widest stencil block (at most 13 taps), so every odd k, cin >= 1 and
    1 <= cout <= 64 has one."""
    from rrin_tpu_torch.ops import conv_packed  # it imports this module
    if k < 1 or k % 2 == 0 or cin < 1 or not 1 <= cout <= MAX_COUT:
        return None
    if k in conv_packed._K_CONV:
        return conv_packed._sm90_plan(k, (cin,), cout, resident=True)
    return conv_packed._sm90_plan(k, (cin,), cout, streamed=True)


def _conv_sm90(x, w, bias, slope) -> torch.Tensor:
    """K1 on the Hopper core: the weights laid out on the card (one launch
    of its prep kernel, K5's one-operand layout, for K1's plan), then one
    launch of the kernel (DIRECT or, at the other odd k, the streamed
    mode)."""
    from rrin_tpu_torch.ops import conv_packed  # it imports this module
    _check_args(x, w, bias)
    b, h, width, cin = x.shape
    k, _, _, cout = w.shape
    plan = _sm90_plan(k, cin, cout)
    if plan is None:
        raise ValueError(f"K1 has no Hopper plan for k {k}, cin {cin}, cout {cout}")
    prepared = conv_packed._prep_on_card("conv_packed", w, bias, (cin,), plan=plan)
    conv_packed._sm90_smem_agrees("conv_packed", k, (cin,), plan, False,
                                  k not in conv_packed._K_CONV)
    lib = conv_packed._lib_sm90("conv_packed_sm90")
    cchunk, n_tiles, _ = plan
    out = torch.empty((b, h, width, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "conv_phase", lib.rrin_conv_phase_sm90_launch,
            x.data_ptr(), cin, cin, prepared["wfrag"].data_ptr(), prepared["bias"].data_ptr(),
            out.data_ptr(), b, h, width, cout, k, cchunk, n_tiles,
            int(slope is not None), 0.0 if slope is None else float(slope),
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def _conv_forward(x, w, bias, slope) -> torch.Tensor:
    """The forward's routing (see :func:`conv2d_fused`)."""
    if supports(tuple(x.shape), tuple(w.shape)) is None or x.dtype != torch.bfloat16:
        return _conv_plain(x, w, bias, slope)
    if x.device.type == "cpu":
        return _conv_plain(x, w, bias, slope)
    if x.device.type != "cuda":
        raise RuntimeError(f"no conv kernel for device {x.device}")
    return _conv_sm90(x, w, bias, slope)


class _ConvFused(torch.autograd.Function):
    """Forward: the kernel or the plain version, on detached tensors.
    Backward: the JAX package's ``_conv_bwd``, the autograd of
    :func:`_conv_plain` recomputed from the saved ``(x, w, bias)``, without
    TF32 (the reference's float32 VJP runs at HIGHEST precision)."""

    @staticmethod
    def forward(ctx, x, w, bias, slope):
        ctx.slope = slope
        ctx.save_for_backward(x, w, bias)
        return _conv_forward(x.detach(), w.detach(), bias.detach(), slope)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        res = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        wanted = [t for t, n in zip(res, needs) if n]
        with torch.enable_grad(), no_tf32():
            y = _conv_plain(*res, ctx.slope)
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if n else None for n in needs), None)


def conv2d_fused(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None,
) -> torch.Tensor:
    """conv2d(stride 1, SAME) + bias + optional LeakyReLU, differentiable.

    x: (B, H, W, cin) NHWC; w: (kh, kw, cin, cout) HWIO; bias: (cout,).
    A bfloat16 input at a site :func:`supports` accepts goes to the Hopper
    core when it lies on the card (launch or raise), to the plain version
    when it lies on the CPU. float32 inputs and the other sites are
    ``F.conv2d``.
    The gradient is that of the plain version, recomputed (``_ConvFused``).
    """
    return _ConvFused.apply(x, w, bias, slope)
