"""Low-channel NHWC convolution (K1): hand-written CUDA kernels and their
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
writes). Two kernels, no width or height gates, nothing of the TPU's lanes
(no packing factor, no block-Toeplitz weights):

  * k in {3, 5, 7} (every site of the repo's configurations): the Hopper
    core of ``csrc/conv_sm90.cuh`` in its DIRECT mode with one operand, the
    function K5 (``conv_packed``) computes, entry point
    ``rrin_conv_phase_sm90_launch`` of ``csrc/conv_packed_sm90.cu``: a
    producer warpgroup copies the next channel chunks' halo tiles (``cp.async``;
    the stems' cin 6/9/10 gathered a channel at a time) while two consumer
    warpgroups contract the current one on ``wgmma``, persistent blocks. Its
    weights are laid out on the card by the core's prep kernel in K5's
    one-operand layout, one launch per call (count ``conv_up_prep``);
  * any other odd k (1, 9, ...; ``ModelConfig.stem_kernel`` and
    ``down_kernels`` may ask for them): the kernel of ``csrc/conv_phase.cu``,
    ``mma.sync`` m16n8k16 from a shared-memory halo tile, its weights laid out
    in PyTorch per call (:func:`_weight_fragments`).

Both count their launches under ``conv_phase``. cin in {6, 9, 10} and cout in
{2, 3, 4} are zero-padded to the MMA tile and masked at the store, so those
sites stay on a kernel.

Routing (:func:`supports`): odd k, cout <= 64 and a tile of the ``mma.sync``
kernel that fits shared memory, bfloat16 only. Everything else (float32, cout >=
128) is ``F.conv2d``, as the JAX package leaves those sites to XLA. The plain
version of both kernels is :func:`_conv_plain`; the wrapper takes it only
for CPU tensors, and on the card launches a kernel or raises.

Gradients: :func:`conv2d_fused` is a ``torch.autograd.Function`` at every
site, as the JAX package's is a ``custom_vjp``. Its backward is the JAX
package's ``_conv_bwd``: the autograd of :func:`_conv_plain`, recomputed from
the saved ``(x, w, bias)`` and run without TF32 (cuDNN's dgrad and wgrad on
the card), since the reference has no backward kernel. The kernels themselves
are forward-only: their launchers refuse inputs that require grad, and the
Function hands them detached tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from rrin_tpu_torch import _build

# Tile constants of csrc/conv_phase.cu (kept equal to the kernel's).
_TH, _TW, _CPAD = 8, 32, 8
# Kernel sizes that go to the Hopper core (the k its DIRECT mode is built
# for, conv_packed._K_CONV); the other odd k take csrc/conv_phase.cu.
SM90_K = (3, 5, 7)
# Dynamic shared memory a block may use on sm_90 (227 KB).
_SMEM_MAX = 232448
MAX_COUT = 64


def _n_tiles(cout: int) -> int:
    return next(n for n in (1, 2, 4, 8) if n * 8 >= cout)


def _smem_bytes(k: int, cchunk: int, n_tiles: int) -> int:
    halo = (_TH + k - 1) * (_TW + k - 1) * (cchunk + _CPAD) * 2
    wrow = k * (cchunk // 16) * n_tiles * 32 * 8
    return halo + wrow


def _plan(k: int, cin: int, cout: int) -> Optional[Tuple[int, int, int]]:
    """(cchunk, n_chunks, n_tiles) of the kernel for this site, or None."""
    if k % 2 == 0 or k < 1 or cin < 1 or not 1 <= cout <= MAX_COUT:
        return None
    n_tiles = _n_tiles(cout)
    cin16 = -(-cin // 16) * 16
    for cchunk in (64, 48, 32, 16):
        if cchunk > cin16:
            continue
        if _smem_bytes(k, cchunk, n_tiles) <= _SMEM_MAX:
            return cchunk, -(-cin // cchunk), n_tiles
    return None


def supports(
    x_shape: Tuple[int, ...], w_shape: Tuple[int, ...]
) -> Optional[int]:
    """Return the kernel's input-channel chunk if it applies, else None.

    Routes every site the JAX package's ``supports`` routes and more: there
    is no gate on W or H here (those were DMA alignment rules).
    """
    if len(x_shape) != 4 or len(w_shape) != 4:
        return None
    kh, kw, cin, cout = w_shape
    if x_shape[3] != cin or kh != kw:
        return None
    plan = _plan(kh, cin, cout)
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


def _lib() -> ctypes.CDLL:
    lib = _build.library("conv_phase")
    if not getattr(lib, "_rrin_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rrin_conv_phase_launch.argtypes = (
            [vp] * 4 + [ci] * 10 + [ctypes.c_float, vp])
        lib.rrin_conv_phase_launch.restype = ci
        lib.rrin_conv_phase_smem.argtypes = [ci, ci, ci]
        lib.rrin_conv_phase_smem.restype = ctypes.c_longlong
        lib._rrin_typed = True
    return lib


def _weight_fragments(
    w: torch.Tensor, cchunk: int, n_chunks: int, n_tiles: int
) -> torch.Tensor:
    """HWIO weights -> bf16 in the kernel's B-fragment order
    ``[chunk][dy][dx][k16][n-tile][lane = g*4+tig][reg r][pair p]`` where the
    element is ``w[dy, dx, chunk*cchunk + k16*16 + r*8 + tig*2 + p, n-tile*8 + g]``
    (zero where cin or cout is padding)."""
    k, _, cin, cout = w.shape
    wp = torch.zeros(
        (k, k, n_chunks * cchunk, n_tiles * 8), dtype=torch.bfloat16, device=w.device)
    wp[:, :, :cin, :cout] = w.to(torch.bfloat16)
    wp = wp.view(k, k, n_chunks, cchunk // 16, 2, 4, 2, n_tiles, 8)
    #            dy dx ch        k16          r  tig p  nt      g
    return wp.permute(2, 0, 1, 3, 7, 8, 5, 4, 6).contiguous()


def _check_args(x, w, bias) -> None:
    """What both kernels ask of their tensors."""
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
    """(cchunk, n_tiles, n_cout_blocks) of K1 on the Hopper core: K5's plan
    for one bf16 operand, or None where k is not one it is built for."""
    from rrin_tpu_torch.ops import conv_packed  # it imports this module
    if k not in SM90_K:
        return None
    return conv_packed._sm90_plan(k, (cin,), cout, resident=True)


def _conv_sm90(x, w, bias, slope) -> torch.Tensor:
    """K1 on the Hopper core: the weights laid out on the card (one launch
    of its prep kernel, K5's one-operand layout), then one launch of the
    DIRECT mode."""
    from rrin_tpu_torch.ops import conv_packed  # it imports this module
    _check_args(x, w, bias)
    b, h, width, cin = x.shape
    k, _, _, cout = w.shape
    plan = _sm90_plan(k, cin, cout)
    if plan is None:
        raise ValueError(f"K1 has no Hopper plan for k {k}, cin {cin}, cout {cout}")
    prepared = conv_packed._prep_on_card("conv_packed", w, bias, (cin,))
    conv_packed._sm90_smem_agrees("conv_packed", k, (cin,), plan, False)
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


def _conv_kernel(x, w, bias, slope, plan) -> torch.Tensor:
    """K1 on the mma.sync kernel of csrc/conv_phase.cu, for the odd k that
    the Hopper core lacks."""
    cchunk, n_chunks, n_tiles = plan
    _check_args(x, w, bias)
    b, h, width, cin = x.shape
    k, _, _, cout = w.shape
    lib = _lib()
    if lib.rrin_conv_phase_smem(k, cchunk, n_tiles) != _smem_bytes(k, cchunk, n_tiles):
        raise RuntimeError("conv_phase.cu and conv_phase.py disagree on the tile")
    wfrag = _weight_fragments(w, cchunk, n_chunks, n_tiles)
    bias32 = bias.to(torch.float32).contiguous()
    out = torch.empty((b, h, width, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "conv_phase", lib.rrin_conv_phase_launch,
            x.data_ptr(), wfrag.data_ptr(), bias32.data_ptr(), out.data_ptr(),
            b, h, width, cin, cout, k, cchunk, n_chunks, n_tiles,
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
    if w.shape[0] in SM90_K:
        return _conv_sm90(x, w, bias, slope)
    return _conv_kernel(x, w, bias, slope, _plan(w.shape[0], w.shape[2], w.shape[3]))


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
    A bfloat16 input at a site :func:`supports` accepts goes to a CUDA
    kernel when it lies on the card (launch or raise): the Hopper core for k
    in :data:`SM90_K`, else ``csrc/conv_phase.cu``; to the plain version when
    it lies on the CPU. float32 inputs and the other sites are ``F.conv2d``.
    The gradient is that of the plain version, recomputed (``_ConvFused``).
    """
    return _ConvFused.apply(x, w, bias, slope)
