"""The convolutions of the packed serving path: five hand-written CUDA
kernels and their wrappers, in bfloat16, int8 and float32.

Replaces five Pallas kernels of the JAX package's ``ops/conv_packed.py``:

  ``conv_packed``       ``_kernel_body`` via ``_conv_packed_impl``: stride-1
                        SAME conv, k in {3, 5, 7}, over the channel concat of
                        1..4 operands given separately, so a skip concat
                        never exists in device memory; head mode with
                        ``slope=None``;
  ``conv_pool_packed``  ``_kernel_body_pool``: conv(avg_pool_2x(x)) reading
                        the full-resolution tensor;
  ``conv_up_packed``    ``_kernel_body_up``: conv(upsample_2x_bilinear(x))
                        from the half-resolution tensor, k in {1, 3, 5}, rows
                        and columns of the upsampled tile built in shared
                        memory (W first, as the reference);
  ``conv_up_m_packed``  ``_kernel_body_up_m``: the same function, k in {3, 5};
  ``conv_up_f_packed``  ``_kernel_body_up_f``: the same function for k = 3
                        with the W-upsample folded into per-output-parity
                        weights (:func:`_upf_fold`) and the clamped-edge
                        residual added exactly.

In bfloat16, int8 and float32 all five run on one Hopper core on ``wgmma``
(``csrc/conv_sm90.cuh``; entry points of K5 and K6 in
``csrc/conv_packed_sm90.cu``, of K7-K9 in ``csrc/conv_up_sm90.cu``) with a
producer warpgroup that builds the halo tile of the next channel chunk
(copied by ``cp.async`` for K5, pooled or interpolated for K6-K9) while two
consumer warpgroups contract the current one, all of a site's output
channels (up to 128; float32 64) in one block; its planner is
:func:`_sm90_plan`, its weight layout :func:`_sm90_weights` (K5-K8 take the
conv's own weights in it, K5's split per operand, K9 the folded ones). With
one bfloat16 operand its K5 mode (DIRECT) is also K1,
``conv_phase.conv2d_fused`` of the plain path (entry point
``rrin_conv_phase_sm90_launch``), at k 3/5/7; at every other odd k K1 runs
the core's streamed mode (``_sm90_plan(streamed=True)``: the stencil split
into blocks of at most 13 x 13 taps, :func:`_stream_blocks`, whose weights
stream one dy row a pipeline stage). **K6 and K8 compute one function** in NHWC. The two TPU kernels differ only in their lane geometry
(K6 doubles the lane groups P, K8 the sublane groups M at a level boundary),
which is not carried over.
Both entry points exist because each mirrors one reference kernel, with its
own plain version, ``supports_*`` and launch count, and because their
rounding follows their references: ``conv_up_packed`` interpolates along W
first and dequantises an int8 input before interpolating, as
``_conv_up_packed_xla`` does, while ``conv_up_m_packed`` interpolates along H
first and on the int8 codes, as ``_conv_up_m_xla`` does. The JAX package
routes the up sites u3c1 and u4c1 to K6 where the folded kernel's scoped
memory bound rejects them (4K widths); ``models.unet.packed_branch_flags``
repeats that routing.

**bfloat16.** A float32 bias and an optional LeakyReLU are added to a
float32 sum, rounded once to bfloat16.

**float32** (float32 operands on the card; entry points
``rrin_<kernel>_f32_launch``, launches counted under ``"<kernel>_f32"``):
all five on the Hopper core (``wgmma.m64nNk8.tf32``, element type F32 of
``csrc/conv_sm90.cuh``). The reference contracts float32 at full precision;
the kernels split each operand into two TF32 parts (``hi = rna(x)``, ``lo =
rna(x - hi)``, :func:`_tf32`) and sum ``lo_a*hi_b + hi_a*lo_b + hi_a*hi_b``
("3xTF32"): about 2^-22 of each product is lost, against 2^-11 for one TF32
product. The tensor cores add by truncation, so the products are summed
there only over a promotion interval of (dx, k-step) slabs
(``rrin_conv_f32_promotion``) and then added to a float32 accumulator with
round to nearest. The weights are split once (a hi and a lo plane:
:func:`_sm90_weights` with ``q=F32``, on the card by the prep kernel, K9's
after the fold), the activations in the kernel. Pooled and upsampled values
stay float32; the output is float32.

**int8** (``in_absmax`` given, one calibrated |x| maximum per operand, from
``models.unet.unet_apply_stats``): activations are quantised per tensor,
``clip(round(x * 127/ax), +-127)`` rounding half to even
(:func:`_quantize_act`), weights per output channel with operand *i*
pre-scaled by ``ax_i/ax_0`` so that one scale ``ax_0 * sw / 127^2``
dequantises the shared int32 sum (:func:`_quantize_weights`); the kernels
contract int8 x int8 -> int32 (``wgmma...m64nNk32.s32.s8.s8``). An int8-dtyped
operand is taken as already on its grid. With ``out_absmax`` the
``127/ax_out`` step is folded into scale and bias and the kernel emits int8,
otherwise ``out_dtype`` (bfloat16 on the card). The scales reach the kernel
as device tensors: nothing is read back to the host. The plain versions are
the reference's fake-quant ``_xla`` functions in float32.

**Layout.** The JAX package carries activations as ``(B, H, M, P*C)`` lane
groups with guard zeros, an offset plan, ``m_out``/``m_double`` and a dense
entry, all of which exist to feed 128 lanes. None of that is carried over:
the functions here take and return contiguous NHWC tensors, ``parts`` is a
list of tensors or ``(tensor, real_c)`` pairs (the first ``real_c`` channels
enter the conv), and SAME padding is a zero-filled halo load at the
resolution the conv runs at. The dense entry's counterpart is the stem conv
reading its cin <= 16 input directly.

**What bounds them on an H100.** Operations at the wide sites, bytes at the
heads and at the fused-resample sites' stores; the fused prologues exist to
keep the pooled, upsampled or concatenated tensor out of device memory. See
``PERF.md`` for the measured times beside each bound.

**Routing** (:func:`supports` and its siblings) gates only what the kernels
need: odd k in the set each is built for, channel counts that allow 8-channel
loads where a prologue needs them, and a tile that fits shared memory. There
is no gate on H, W or M. Each wrapper launches its kernel for a CUDA tensor
or raises; it takes the plain version beside it only for a CPU tensor.
Forward only. ``prepared=`` takes the result of the matching
``prep_*`` (built with the same absmax and ``dtype``) and skips the per-call
weight re-layout, split and quantisation; ``models.unet.prepare_sites``
builds one for every site of a U-Net, once. Without it, K5-K9 in bfloat16
and float32 lay out (and K9 folds) their weights on the card in one launch
of the Hopper core's prep kernel (launch count ``conv_up_prep``); the
``prep_*`` functions are its plain version. int8 weights are then prepared
in PyTorch on every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from rrin_tpu_torch import _build
from rrin_tpu_torch.ops.conv_phase import _conv_plain, _leaky, no_tf32
from rrin_tpu_torch.ops.resize import (
    _upsample_2x_axis,
    avg_pool_2x,
    upsample_2x_bilinear,
)

# The Hopper core's padding per halo pixel and per staged row (conv_sm90.cuh's
# PAD_BYTES); the operands of one conv_packed call.
_PAD_BYTES, MAX_OPS = 16, 4
# Dynamic shared memory a block may use on sm_90 (227 KB).
_SMEM_MAX = 232448
# Kernel sizes each kernel is built for.
_K_CONV, _K_POOL, _K_UP, _K_UP_M, _K_UP_F = (3, 5, 7), (3, 5), (1, 3, 5), (3, 5), (3,)
# Element types, as the Hopper core numbers them (conv_sm90.cuh's Elem): a
# ``q`` argument below is False (bfloat16), True (int8) or F32.
F32 = 2
# Per element type: bytes an element, channels per mma step (32 bytes).
_ELEM = {False: (2, 16), True: (1, 32), F32: (4, 8)}
# The Hopper core of csrc/conv_sm90.cuh (K5-K9 in bfloat16, int8 and
# float32): pixels per block row, output channels per block (N of its
# wgmma) that it is built for (float32 up to 64: its promotion sums take as
# many registers as its accumulators), consumer warpgroups, channel chunks
# (powers of two: its producer threads split a chunk evenly; float32 ones
# take twice the halo bytes of bf16 and four times the weight bytes).
_SM90_TW, _SM90_N, _SM90_CONSUMERS = 64, (8, 16, 32, 64, 128), 2
_SM90_N_MAX = {False: 128, True: 128, F32: 64}
_SM90_CHUNKS = {False: (64, 32, 16), True: (128, 64, 32), F32: (32, 16, 8)}
# Its kernels -> (folded, resident): K9's weights are folded with its
# W-upsample; K5 and K7 keep every chunk's weights in shared memory where
# that is what fits (the C side's resident_chunks<MODE>), in every element
# type.
_SM90_KERNELS = {"conv_packed": (False, True), "conv_pool_packed": (False, True),
                 "conv_up_packed": (False, False), "conv_up_m_packed": (False, False),
                 "conv_up_f_packed": (True, False)}
# The source of each kernel's entry points (csrc/<name>.cu, one library
# each); the weight prep of all five is in conv_up_sm90.
_SM90_SOURCE = {"conv_packed": "conv_packed_sm90", "conv_up_packed": "conv_packed_sm90",
                "conv_pool_packed": "conv_up_sm90", "conv_up_m_packed": "conv_up_sm90",
                "conv_up_f_packed": "conv_up_sm90"}
# Its weights' memory order against the fragment order of _weight_fragments:
# (cb, chunk, dy, tap, kstep, nt, g, tig, r, p) is stored as
# (cb, chunk, dy, tap, kstep, nt, r, g, tig, p), so that each (r, g) row of
# 16 bytes is a row of a wgmma core matrix.
_SM90_ORDER = (0, 1, 2, 3, 4, 5, 8, 6, 7, 9)
_SM90_VIEW = (0, 1, 2, 3, 4, 5, 7, 8, 6, 9)
# float32: (cb, chunk, dy, tap, kstep, nt, g, tig, plane, r, p) is stored as
# (cb, chunk, dy, tap, kstep, plane, nt, r, g, tig, p): each plane of a
# k-step a whole B tile (n-tiles 256 bytes apart), the lo plane after the hi.
_SM90_F32_ORDER = (0, 1, 2, 3, 4, 8, 5, 9, 6, 7, 10)
_SM90_F32_VIEW = (0, 1, 2, 3, 4, 6, 8, 9, 5, 7, 10)

Part = Union[torch.Tensor, Tuple[torch.Tensor, int]]
Prepared = Dict[str, object]
Absmax = Union[torch.Tensor, float]

# [rho, dx+1, kx]: the coefficient of w[:, kx] in the weight that output
# column 2j+rho applies to half-resolution column j+dx (2x half-pixel
# bilinear upsample followed by a 3-tap conv).
_UPF_A = (
    ((0.75, 0.25, 0.0), (0.25, 0.75, 0.75), (0.0, 0.0, 0.25)),
    ((0.25, 0.0, 0.0), (0.75, 0.75, 0.25), (0.0, 0.25, 0.75)),
)


# --------------------------------------------------------------------- plan

def _sm90_rows(n: int, q: int = False, k: int = 3) -> int:
    """Rows of GEMM pixels per block of the Hopper core for N = ``n``: each
    consumer warpgroup holds 4 rows of accumulators up to N = 64, else 2;
    float32, whose promotion sums double them, 4 up to N = 32 (6 at k = 7,
    N <= 16), else 2 (``mt_of``)."""
    if q == F32:
        return _SM90_CONSUMERS * (6 if n <= 16 and k == 7 else (4 if n <= 32 else 2))
    return _SM90_CONSUMERS * (4 if n <= 64 else 2)


# K1's streamed mode splits a k x k stencil into blocks of at most this
# many taps a side (conv_sm90.cuh's STREAM_D): one block up to k 13.
_STREAM_D = 13


def _stream_blocks(k: int) -> Tuple[Tuple[int, int], ...]:
    """(tap origin, taps) of each block of K1's streamed mode along one axis
    of a k x k stencil (``stream_split`` in conv_sm90.cuh): n = ceil(k /
    13) blocks of k // n taps or one more, the larger first. Block (by, bx) is
    the conv by the taps ``w[oy:oy+ty, ox:ox+tx]`` over the input shifted by
    (oy, ox); the stencil's conv is the sum over its blocks."""
    n = -(-k // _STREAM_D)
    base, rem = divmod(k, n)
    return tuple((i * base + min(i, rem), base + (i < rem)) for i in range(n))


def _sm90_smem_bytes(k: int, cchunk: int, n_tiles: int, q: int = False,
                     folded: bool = False, res_chunks: int = 0,
                     streamed: bool = False) -> int:
    """Shared memory of one block of the Hopper core (``make_layout`` in
    conv_sm90.cuh; K5-K8 share a layout, ``folded`` is K9's): three buffers
    of a halo tile (64 columns) and a chunk's stencil weights where they fit;
    else, for K5 and K7 where the block's tiles share one channel block
    (``res_chunks``, the input's chunks over all operands, is then not 0),
    three halo buffers beside the weights of every chunk, resident; else two
    buffers with their weights (k = 5 and 7 at the wide sites). Besides: a
    staged output row per consumer warpgroup; bias and scale; K9's edge sums
    of two tiles; nine mbarriers. Regions are 128-byte aligned. ``q``:
    False (bfloat16), True (int8) or F32 (a float32 halo, weights in two
    TF32 planes, a float32 staged row). ``streamed``: K1's streamed mode
    (``make_layout_stream``, bf16), sized by the widest block b of k's
    split (:func:`_stream_blocks`), so no larger beyond k 13: two halo
    buffers of ``th + b - 1`` rows where they fit, else one, beside a ring
    of two weight slabs (one dy row of a block, b taps x cchunk x N, each),
    the staged rows, bias, scale and the mbarriers."""
    es, n = _ELEM[q][0], n_tiles * 8
    wes, oes = (8, 4) if q == F32 else (es, 2)
    th = _sm90_rows(n, q, k)
    kb = max(size for _, size in _stream_blocks(k)) if streamed else k

    def up128(b):
        return -(-b // 128) * 128

    halo = up128((th + kb - 1) * _SM90_TW * (cchunk * es + _PAD_BYTES))
    rest = (_SM90_CONSUMERS * up128(_SM90_TW * (oes * n + _PAD_BYTES)) + 2 * n * 4
            + (2 * 2 * th * n * 4 if folded else 0) + 9 * 8)
    if streamed:
        two = 2 * halo + 2 * kb * cchunk * n * wes + rest
        return two if two <= _SMEM_MAX else two - halo
    w = k * k * cchunk * n * wes
    three = 3 * (halo + w) + rest
    if three <= _SMEM_MAX:
        return three
    resident = 3 * halo + res_chunks * w + rest
    if res_chunks and resident <= _SMEM_MAX:
        return resident
    return 2 * (halo + w) + rest


def _cins(cin: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (cin,) if isinstance(cin, int) else tuple(cin)


def _sm90_chunks(cin: Union[int, Sequence[int]], cchunk: int) -> int:
    """Channel chunks of the K-loop: operand by operand, each operand's
    channels padded to whole chunks (no chunk straddles two operands)."""
    return sum(-(-c // cchunk) for c in _cins(cin))


def _sm90_res_chunks(cin: Union[int, Sequence[int]], plan: Tuple[int, int, int],
                     resident: bool) -> int:
    """What the core's layout takes as ``res_chunks`` for ``plan``: where
    weights may be ``resident`` (K5, K7) and all output channels are one
    block, the input's chunks (``cin``: one channel count or the operands'),
    else 0."""
    cchunk, _, n_cb = plan
    return _sm90_chunks(cin, cchunk) if resident and n_cb == 1 else 0


@functools.lru_cache(maxsize=None)
def _sm90_plan(
    k: int, cin: Union[int, Tuple[int, ...]], n_out: int, q: int = False,
    folded: bool = False, resident: bool = False, streamed: bool = False,
) -> Optional[Tuple[int, int, int]]:
    """(cchunk, n_tiles, n_cout_blocks) of the Hopper core, or None: N =
    8*n_tiles is the narrowest width it is built for that covers ``n_out``
    (2*cout when folded), so one block holds every output channel up to 128
    (float32, ``q=F32``: 64; K1's ``streamed`` mode, bf16: 64); the largest
    channel chunk (no wider than the widest operand, ``cin`` being one
    channel count or the operands') that fits shared memory (with its
    weights ``resident``, K5 and K7, where that is what fits), a narrower N
    (more channel blocks) only where none does."""
    cins = _cins(cin)
    if not cins or min(cins) < 1 or n_out < 1:
        return None
    kk = _ELEM[q][1]
    cin_k = -(-max(cins) // kk) * kk
    widths = [n for n in _SM90_N if n <= (64 if streamed else _SM90_N_MAX[q])]
    first = next((n for n in widths if n >= n_out), widths[-1])
    for n in reversed([m for m in _SM90_N if m <= first]):
        for cchunk in _SM90_CHUNKS[q]:
            plan = (cchunk, n // 8, -(-n_out // n))
            res = _sm90_res_chunks(cins, plan, resident)
            if cchunk <= cin_k and _sm90_smem_bytes(k, cchunk, n // 8, q, folded,
                                                     res, streamed) <= _SMEM_MAX:
                return plan
    return None


def _sm90_fits(k: int, cin: Union[int, Tuple[int, ...]], n_out: int, folded: bool,
               resident: bool = False) -> bool:
    """Whether the site has a plan on the Hopper core in bfloat16, int8 and
    float32: the routing does not depend on the dtype."""
    return all(_sm90_plan(k, cin, n_out, q, folded, resident) is not None
               for q in (False, True, F32))


def supports(cins: Sequence[int], k: int, cout: int) -> bool:
    """Whether ``conv_packed`` has a kernel for operands of ``cins`` channels:
    k in {3, 5, 7}, any cin >= 1 and cout >= 1 (cin 6/9/10 and cout 2/3/4
    stay on the kernel), at most four operands."""
    return k in _K_CONV and 1 <= len(cins) <= MAX_OPS and _sm90_fits(
        k, tuple(cins), cout, *_SM90_KERNELS["conv_packed"])


def supports_pool(cin: int, k: int, cout: int) -> bool:
    """``conv_pool_packed``: k in {3, 5}, cin a multiple of 8 (8-channel loads)."""
    return k in _K_POOL and cin % 8 == 0 and _sm90_fits(
        k, cin, cout, *_SM90_KERNELS["conv_pool_packed"])


def supports_up(cin: int, k: int, cout: int) -> bool:
    """``conv_up_packed``: what the JAX package's ``supports_up`` admits once
    its lane geometry is set aside: odd k <= 5 (1, 3, 5), cin a multiple of 8."""
    return k in _K_UP and cin % 8 == 0 and _sm90_fits(
        k, cin, cout, *_SM90_KERNELS["conv_up_packed"])


def supports_up_m(cin: int, k: int, cout: int) -> bool:
    """``conv_up_m_packed``: k in {3, 5}, cin a multiple of 8."""
    return k in _K_UP_M and cin % 8 == 0 and _sm90_fits(
        k, cin, cout, *_SM90_KERNELS["conv_up_m_packed"])


def supports_up_f(cin: int, k: int, cout: int) -> bool:
    """``conv_up_f_packed``: k = 3 (the fold is solved for it), cin a
    multiple of 8."""
    return k in _K_UP_F and cin % 8 == 0 and _sm90_fits(
        3, cin, 2 * cout, *_SM90_KERNELS["conv_up_f_packed"])


# ---------------------------------------------------------------- int8 grid

def _clamp_ax(ax: Absmax, device: torch.device) -> torch.Tensor:
    """A calibrated |x| maximum as a float32 tensor on ``device``, at least
    1e-12 (a tensor already there is not copied)."""
    return torch.as_tensor(ax, dtype=torch.float32, device=device).clamp_min(1e-12)


def _over127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` by a true float32 division on every device, as the
    reference and the kernels (``__fdiv_rn``) divide: PyTorch's CUDA division
    by a Python scalar multiplies by the scalar's rounded reciprocal, which
    is a last bit off for some ``t``, enough to tip the exact ties that a
    dequantised int8 value meets when it is interpolated (ROADMAP Queue C)."""
    return t / torch.full_like(t, 127.0)


def _127_over(t: torch.Tensor) -> torch.Tensor:
    """``127 / t`` by a true float32 division (``127.0 / t`` in PyTorch is
    ``t.reciprocal() * 127``, two roundings)."""
    return torch.full_like(t, 127.0) / t


def _quantize_act(x: torch.Tensor, ax: Absmax) -> torch.Tensor:
    """Symmetric per-tensor int8: ``clip(round(x * 127/max(ax, 1e-12)),
    +-127)``, rounding half to even (``torch.round``, as ``jnp.round``)."""
    inv = _127_over(_clamp_ax(ax, x.device))
    return torch.round(x.float() * inv).clamp(-127.0, 127.0).to(torch.int8)


def _quantize_weights(wis: Sequence[torch.Tensor], absmax: Sequence[Absmax]):
    """Joint per-output-channel int8 weights of a multi-operand conv: operand
    i's rows are pre-scaled by ax_i/ax_0 so that one per-channel scale
    ``ax_0 * sw / 127^2`` dequantises the shared int32 sum. Returns (int8
    weight blocks, sw)."""
    dev = wis[0].device
    a0 = _clamp_ax(absmax[0], dev)
    w_effs = [wi.float() * (_clamp_ax(ax, dev) / a0) for wi, ax in zip(wis, absmax)]
    sw = functools.reduce(
        torch.maximum, [we.abs().amax(dim=(0, 1, 2)) for we in w_effs]).clamp_min(1e-12)
    wqs = [torch.round(we * (127.0 / sw)).clamp(-127.0, 127.0).to(torch.int8)
           for we in w_effs]
    return wqs, sw


def _q_fold(ax0: Absmax, sw: torch.Tensor, bias: torch.Tensor,
            out_absmax: Optional[Absmax]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 epilogue's per-channel (scale, bias): ``ax_0 * sw / 127^2``,
    both times ``127/ax_out`` when the output is int8 (it commutes with the
    LeakyReLU)."""
    scale = _clamp_ax(ax0, sw.device) * sw / (127.0 * 127.0)
    b = bias.to(device=sw.device, dtype=torch.float32)
    if out_absmax is not None:
        inv = 127.0 / _clamp_ax(out_absmax, sw.device)
        scale, b = scale * inv, b * inv
    return scale, b


def _q_out(y: torch.Tensor, out_absmax: Optional[Absmax], dtype: torch.dtype):
    return _quantize_act(y, out_absmax) if out_absmax is not None else y.to(dtype)


def _float_dtype(xs: Sequence[torch.Tensor]) -> torch.dtype:
    """Output dtype of an int8 conv without ``out_dtype``: the first
    floating operand's, else bfloat16."""
    return next((x.dtype for x in xs if x.dtype != torch.int8), torch.bfloat16)


# ----------------------------------------------------------- weight layout

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the
    low 13 bits of the magnitude rounded off, to nearest, ties away from
    zero (10 mantissa bits left)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _weight_fragments(
    wt: torch.Tensor, cins: Sequence[int], cchunk: int, n_tiles: int, q: int = False,
) -> torch.Tensor:
    """(ky, ntaps, sum(cins), n_out) weights -> bf16 (``q``: int8 codes;
    ``q=F32``: float32 split in two TF32 planes) in the B-fragment order of
    an m16n8 tensor-core product ``[cout block][chunk][dy][tap][kstep]
    [n-tile][lane = g*4+tig][reg r][p]``, the element order from which
    :func:`_sm90_weights` lays out the Hopper core's weights.

    Chunks run operand by operand, each operand's channels zero-padded to a
    multiple of ``cchunk``; the element is ``wt[dy, tap, row(chunk) +
    kstep*KK + r*KK/2 + tig*KK/8 + p, block*n_tiles*8 + n-tile*8 + g]`` with
    KK = 16 (bf16, p < 2), 32 (int8, p < 4) or 8 (float32, p < 1), zero where
    cin or cout is padding. ``wt`` is rounded to bfloat16 here, once (int8:
    cast, exact). In float32 a plane dimension comes before r: ``[...][lane]
    [plane][r][p]`` holds ``hi = _tf32(w)`` (plane 0) and ``lo = _tf32(w -
    hi)`` (plane 1)."""
    ky, ntaps, _, n_out = wt.shape
    kk = _ELEM[q][1]
    nb = n_tiles * 8
    n_cb = -(-n_out // nb)
    segs, row = [], 0
    for c in cins:
        pad_c = -(-c // cchunk) * cchunk - c
        segs.append(F.pad(wt[:, :, row:row + c], (0, n_cb * nb - n_out, 0, pad_c)))
        row += c
    dt = torch.float32 if q == F32 else (torch.int8 if q else torch.bfloat16)
    wp = torch.cat(segs, dim=2).to(dt)
    n_chunks = wp.shape[2] // cchunk
    wp = wp.view(ky, ntaps, n_chunks, cchunk // kk, 2, 4, kk // 8, n_cb, n_tiles, 8)
    #            dy  tap    ch        kstep        r  tig p       cb    nt       g
    frag = wp.permute(7, 2, 0, 1, 3, 8, 9, 5, 4, 6)
    if q != F32:
        return frag.contiguous()
    hi = _tf32(frag)
    return torch.stack([hi, _tf32(frag - hi)], dim=-3).contiguous()


def _sm90_order(q: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(storage order, view order) of the Hopper core's weights for ``q``."""
    return (_SM90_F32_ORDER, _SM90_F32_VIEW) if q == F32 else (_SM90_ORDER, _SM90_VIEW)


def _sm90_weights(
    wt: torch.Tensor, cins: Sequence[int], cchunk: int, n_tiles: int, q: int = False,
) -> torch.Tensor:
    """(ky, ntaps, cin, n_out) weights -> the Hopper core's layout: the
    elements of :func:`_weight_fragments`, stored in the order
    ``[cout block][chunk][dy][tap][kstep][n-tile][r][g][tig][p]`` that its
    wgmma B descriptor reads (each ``[r][g]`` row of 16 bytes a core-matrix
    row: channels-in ``kstep*KK + r*KK/2 ..`` of channel-out ``n-tile*8 +
    g``); float32 (``q=F32``) ``[...][kstep][plane][n-tile][r][g][tig][p]``,
    the hi and the lo TF32 plane each a whole B tile. Returned as a view
    whose dimensions are in fragment order, so that it is indexed as
    ``_weight_fragments``' result; the kernel reads the storage behind it.
    Also the plain version of the core's prep kernel."""
    order, view = _sm90_order(q)
    frag = _weight_fragments(wt, cins, cchunk, n_tiles, q)
    return frag.permute(*order).contiguous().permute(*view)


def _prepared(wt, bias, cins, k, cout, plan, scale=None, out_q=False,
              f32=False, absmax=None) -> Prepared:
    """``scale`` is None for bfloat16 (``f32``: float32) weights and the
    per-channel int8 dequantisation for int8 codes ``wt``, which are laid
    out in the Hopper core's layout (:func:`_sm90_weights`); then
    ``absmax`` (one per operand) are kept as the clamped device scalars that
    the launch passes (``axs``). The layout's dtype (``wfrag``) says which
    calls it serves."""
    cchunk, n_tiles, _ = plan
    q = scale is not None
    return {
        "wfrag": _sm90_weights(wt, cins, cchunk, n_tiles, F32 if f32 else q),
        "bias": bias.to(torch.float32).contiguous(),
        "scale": None if scale is None else scale.contiguous(),
        "axs": None if absmax is None else tuple(
            _clamp_ax(a, wt.device).reshape(()) for a in absmax),
        "cins": tuple(cins), "k": k, "cout": cout, "plan": plan,
        "q": q, "out_q": out_q,
    }


def _check_w(w: torch.Tensor, bias: torch.Tensor, cin: int) -> Tuple[int, int]:
    if w.ndim != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"w must be (k, k, cin, cout), got {tuple(w.shape)}")
    k, _, wcin, cout = w.shape
    if wcin != cin:
        raise ValueError(f"w has cin {wcin}, the operands have {cin} channels")
    if bias.shape != (cout,):
        raise ValueError(f"bias must be ({cout},), got {tuple(bias.shape)}")
    return k, cout


def _need(ok: bool, name: str, cins, k: int, cout: int) -> None:
    if not ok:
        raise ValueError(
            f"{name} has no kernel for cin {cins}, k {k}, cout {cout} "
            f"(see supports* in {__name__})")


def _check_q(name: str, xs: Sequence[torch.Tensor], in_absmax, out_absmax) -> bool:
    """Whether the call is int8; what the quantisation arguments ask of it."""
    if in_absmax is None:
        if out_absmax is not None:
            raise ValueError(f"{name}: out_absmax (an int8 output) needs in_absmax")
        if any(x.dtype == torch.int8 for x in xs):
            raise ValueError(
                f"{name}: an int8 operand needs in_absmax, the |x| maximum of its grid")
        return False
    if len(in_absmax) != len(xs):
        raise ValueError(
            f"{name}: in_absmax has {len(in_absmax)} entries for {len(xs)} operands")
    return True


def _is_f32(dtype: torch.dtype) -> bool:
    """Whether a prep without absmax is for float32 operands (else bfloat16)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the packed kernels take bfloat16 or float32 operands, not {dtype}")
    return dtype == torch.float32


def prep_conv(
    w: torch.Tensor, bias: torch.Tensor, real_cs: Sequence[int],
    absmax: Optional[Sequence[Absmax]] = None, out_absmax: Optional[Absmax] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Prepared:
    """Weight-side constants of one ``conv_packed`` site: HWIO weights split
    per operand, each operand's channels padded to whole chunks, in the
    layout of the Hopper core (:func:`_sm90_weights`), and the float32 bias,
    for bfloat16 operands (float32 ones, ``dtype``: split in two TF32 planes,
    ``q=F32``); with ``absmax`` (one per operand) the int8 codes, the
    per-channel scale and the bias, both folded with ``127/out_absmax`` when
    that is given. In bfloat16 and float32 also the plain version of the
    core's prep kernel."""
    real_cs = tuple(int(c) for c in real_cs)
    k, cout = _check_w(w, bias, sum(real_cs))
    _need(supports(real_cs, k, cout), "conv_packed", real_cs, k, cout)
    return _prep_sm90("conv_packed", w, bias, real_cs, absmax, out_absmax, dtype)


def _prep_sm90(name, w, bias, cins, absmax, out_absmax, dtype) -> Prepared:
    """The conv's own weights in the layout of the Hopper core
    (:func:`_sm90_weights`), for operands of ``cins`` channels; int8 with
    ``absmax`` (one per operand) as in :func:`prep_conv`; float32 in two
    TF32 planes."""
    k, cout = w.shape[0], w.shape[3]
    _, res = _SM90_KERNELS[name]
    if absmax is None and _is_f32(dtype):
        return _prepared(w.float(), bias, cins, k, cout,
                         _sm90_plan(k, cins, cout, F32, resident=res), f32=True)
    if absmax is None:
        return _prepared(w.float(), bias, cins, k, cout,
                         _sm90_plan(k, cins, cout, resident=res))
    wqs, sw = _quantize_weights(torch.split(w.float(), cins, dim=2), absmax)
    scale, b = _q_fold(absmax[0], sw, bias, out_absmax)
    return _prepared(torch.cat(wqs, dim=2).float(), b, cins, k, cout,
                     _sm90_plan(k, cins, cout, q=True, resident=res),
                     scale, out_absmax is not None, absmax=absmax)


def _prep_single(name, ok, w, bias, absmax, out_absmax, dtype) -> Prepared:
    """:func:`_prep_sm90` for the one input of a fused-resample kernel."""
    k, cout = _check_w(w, bias, w.shape[2])
    cin = w.shape[2]
    _need(ok(cin, k, cout), name, cin, k, cout)
    return _prep_sm90(name, w, bias, (cin,), None if absmax is None else (absmax,),
                      out_absmax, dtype)


def prep_conv_pool(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                   out_absmax: Optional[Absmax] = None,
                   dtype: torch.dtype = torch.bfloat16) -> Prepared:
    """Weight-side constants of one ``conv_pool_packed`` site (the conv's own
    weights: the pool lives in the kernel's load) in the layout of the Hopper
    core (:func:`_sm90_weights`); int8 and ``dtype`` as in
    :func:`prep_conv`."""
    return _prep_single("conv_pool_packed", supports_pool, w, bias, absmax, out_absmax,
                        dtype)


def prep_conv_up(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                 out_absmax: Optional[Absmax] = None,
                 dtype: torch.dtype = torch.bfloat16) -> Prepared:
    """Weight-side constants of one ``conv_up_packed`` site (the conv's own
    weights: the upsample lives in the kernel's load; the input's absmax
    calibrates the upsampled values, a convex combination of it), as
    :func:`prep_conv_pool`."""
    return _prep_single("conv_up_packed", supports_up, w, bias, absmax, out_absmax, dtype)


def prep_conv_up_m(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                   out_absmax: Optional[Absmax] = None,
                   dtype: torch.dtype = torch.bfloat16) -> Prepared:
    """Weight-side constants of one ``conv_up_m_packed`` site, as
    :func:`prep_conv_up`."""
    return _prep_single("conv_up_m_packed", supports_up_m, w, bias, absmax, out_absmax,
                        dtype)


def _upf_fold(w: torch.Tensor):
    """(3, 3, cin, cout) float32 -> ``weff`` (2, 3, 3, cin, cout) indexed
    [rho, dx+1, dy] and the edge residuals ``(cl0, cl1, cr0, cr1)``, each
    (3, cin, cout) indexed [dy].

    With s the H-interpolated rows at half width and s[-1] = s[Ws] = 0,
    ``out[2j+rho] = sum_dx weff[rho, dx+1] . s[j+dx]`` plus, because the
    upsample clamps where the stencil reads a zero,
    ``out[0] += cl0 . s[0]``, ``out[1] += cl1 . s[0]``,
    ``out[2Ws-2] += cr0 . s[Ws-1]``, ``out[2Ws-1] += cr1 . s[Ws-1]``."""
    # Python scalars times tensors: no constant has to be copied to the device.
    weff = torch.stack([
        torch.stack([sum(a * w[:, kx] for kx, a in enumerate(row) if a) for row in rho])
        for rho in _UPF_A])
    cl0 = 0.25 * (w[:, 1] - w[:, 0])
    cl1 = 0.25 * w[:, 0]
    cr0 = 0.25 * w[:, 2]
    cr1 = 0.25 * (w[:, 1] - w[:, 2])
    return weff, (cl0, cl1, cr0, cr1)


def _upf_taps(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, cin, cout) float32 -> the folded kernel's weights (3, 5, cin,
    2*cout) indexed [dy, tap, ci, rho*cout + co]: taps 0-2 the stencil at
    dx = -1, 0, 1, tap 3 the left-edge and tap 4 the right-edge residual."""
    _, _, cin, cout = w.shape
    weff, (cl0, cl1, cr0, cr1) = _upf_fold(w)
    stencil = weff.permute(2, 1, 3, 0, 4).reshape(3, 3, cin, 2 * cout)
    left = torch.cat([cl0, cl1], dim=-1)[:, None]
    right = torch.cat([cr0, cr1], dim=-1)[:, None]
    return torch.cat([stencil, left, right], dim=1)


def _upf_q_taps(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded weights and both edge residuals quantised on ONE
    per-output-channel grid (their int32 partials share the epilogue's
    scale), as the reference's ``prep_conv_up_f``: (codes (3, 5, cin,
    2*cout) as float32, sw (cout,))."""
    cout = w.shape[3]
    taps = _upf_taps(w.float())
    sw = taps.abs().amax(dim=(0, 1, 2)).view(2, cout).amax(dim=0).clamp_min(1e-12)
    codes = torch.round(taps * (127.0 / torch.cat([sw, sw]))).clamp(-127.0, 127.0)
    return codes, sw


def prep_conv_up_f(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                   out_absmax: Optional[Absmax] = None,
                   dtype: torch.dtype = torch.bfloat16) -> Prepared:
    """Weight-side constants of one ``conv_up_f_packed`` site: the weights
    folded in float32, then rounded to bfloat16 (or quantised to int8 with
    their edge taps on one per-channel grid) in the layout of the Hopper core
    (:func:`_sm90_weights`, five taps per dy row: the stencil, then the two
    edge taps), and the bias (and scale) repeated for both output parities.
    For float32 operands (``dtype``) the folded float32 weights are split in
    two TF32 planes in the same core's float32 layout (``q=F32``). In
    bfloat16 and float32 also the plain version of the core's prep kernel."""
    k, cout = _check_w(w, bias, w.shape[2])
    cin = w.shape[2]
    _need(supports_up_f(cin, k, cout), "conv_up_f_packed", cin, k, cout)
    if absmax is None and _is_f32(dtype):
        return _prepared(_upf_taps(w.float()), torch.cat([bias, bias]), (cin,), k, cout,
                         _sm90_plan(3, cin, 2 * cout, F32, folded=True), f32=True)
    if absmax is None:
        return _prepared(
            _upf_taps(w.float()), torch.cat([bias, bias]), (cin,), k, cout,
            _sm90_plan(3, cin, 2 * cout, folded=True))
    codes, sw = _upf_q_taps(w)
    scale, b = _q_fold(absmax, sw, bias, out_absmax)
    return _prepared(
        codes, torch.cat([b, b]), (cin,), k, cout,
        _sm90_plan(3, cin, 2 * cout, q=True, folded=True),
        torch.cat([scale, scale]), out_absmax is not None, absmax=(absmax,))


# ----------------------------------------------------------- plain versions

def _conv_packed_plain(xs, w, bias, slope) -> torch.Tensor:
    """concat -> conv -> bias -> LeakyReLU in the operands' dtype."""
    x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
    return _conv_plain(x, w, bias, slope)


def _conv_pool_plain(x, w, bias, slope) -> torch.Tensor:
    """Pool in float32, round once to ``x.dtype``, conv."""
    return _conv_plain(avg_pool_2x(x.float()).to(x.dtype), w, bias, slope)


def _conv_up_plain(x, w, bias, slope) -> torch.Tensor:
    """Upsample in float32 from ``x``, round once to ``x.dtype``, conv: the
    function that the three upsampling kernels compute."""
    return _conv_plain(upsample_2x_bilinear(x.float()).to(x.dtype), w, bias, slope)


def _upsample_wh(x: torch.Tensor) -> torch.Tensor:
    """:func:`upsample_2x_bilinear` along W first, then H: the order in which
    the reference's K6 (its ``upsample_2x_packed``) rounds. In int8 the order
    matters: a dequantised int8 input upsamples onto exact ties of the grid,
    which a last-bit difference tips either way."""
    return _upsample_2x_axis(_upsample_2x_axis(x, 2), 1)


def _conv_up_wh_plain(x, w, bias, slope) -> torch.Tensor:
    """:func:`_conv_up_plain` with the upsample of :func:`_upsample_wh`: the
    plain version of ``conv_up_packed``."""
    return _conv_plain(_upsample_wh(x.float()).to(x.dtype), w, bias, slope)


def _fold_apply(rows: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The folded contraction in float32: H-interpolated rows (B, 2Hs, Ws,
    cin) and folded weights (3, 5, cin, 2*cout) -> (B, 2Hs, 2Ws, cout),
    without bias."""
    b, h2, ws, _ = rows.shape
    with no_tf32():
        y = F.conv2d(rows.permute(0, 3, 1, 2), taps[:, :3].permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()                     # (B, 2Hs, Ws, 2*cout)
    for col, tap in ((0, 3), (ws - 1, 4)):
        edge = F.pad(rows[:, :, col], (0, 0, 1, 1))            # zero rows above, below
        y[:, :, col] += sum(edge[:, dy:dy + h2] @ taps[dy, tap] for dy in range(3))
    return y.reshape(b, h2, 2 * ws, taps.shape[3] // 2)


def _conv_up_f_folded(x, w, bias, slope) -> torch.Tensor:
    """The folded kernel's own arithmetic in plain PyTorch: H-interpolated
    rows and folded weights rounded to ``x.dtype``, float32 products and sum,
    edge residuals, one rounding at the end. Equal to :func:`_conv_up_plain`
    in float32 up to summation order; in bfloat16 it rounds where the kernel
    rounds, so the kernel is held to it at one bfloat16 step."""
    dt = x.dtype
    rows = _upsample_2x_axis(x.float(), 1).to(dt).float()      # (B, 2Hs, Ws, cin)
    taps = _upf_taps(w.float()).to(dt).float()                 # (3, 5, cin, 2*cout)
    return _leaky(_fold_apply(rows, taps) + bias.float(), slope).to(dt)


def _conv_q_plain(codes, axs, w, bias, slope, out_absmax, out_dtype) -> torch.Tensor:
    """The int8 conv as the reference's ``_conv_packed_xla`` fake-quantises it:
    operands given as their int8 codes (float32), weights quantised jointly,
    both dequantised, a float32 conv, then int8 on ``out_absmax``'s grid or
    ``out_dtype``."""
    dev = codes[0].device
    wqs, sw = _quantize_weights(
        torch.split(w.float(), [c.shape[-1] for c in codes], dim=2), axs)
    a0 = _clamp_ax(axs[0], dev)
    xs, ws = [], []
    for qx, ax, wq in zip(codes, axs, wqs):
        axc = _clamp_ax(ax, dev)
        xs.append(qx * _over127(axc))
        ws.append(wq.float() * _over127(sw) * (a0 / axc))
    y = _conv_plain(torch.cat(xs, dim=-1), torch.cat(ws, dim=2), bias.float(), slope)
    return _q_out(y, out_absmax, out_dtype)


def _codes(x: torch.Tensor, ax: Absmax) -> torch.Tensor:
    """An operand's int8 codes as float32: as they are when int8, else
    quantised."""
    return x.float() if x.dtype == torch.int8 else _quantize_act(x, ax).float()


def _conv_packed_q_plain(xs, w, bias, slope, axs, out_absmax, out_dtype):
    return _conv_q_plain([_codes(x, a) for x, a in zip(xs, axs)], axs, w, bias, slope,
                         out_absmax, out_dtype or _float_dtype(xs))


def _on_grid(v: torch.Tensor, x: torch.Tensor, ax: Absmax) -> torch.Tensor:
    """Pooled or upsampled values back on the int8 grid: rounded when ``x``
    was int8 (``v`` is then made of codes), else quantised."""
    if x.dtype == torch.int8:
        return torch.round(v).clamp(-127.0, 127.0)
    return _quantize_act(v, ax).float()


def _conv_pool_q_plain(x, w, bias, slope, ax, out_absmax, out_dtype):
    """``_conv_pool_packed_xla``: an int8 input pools on its grid."""
    codes = _on_grid(avg_pool_2x(x.float()), x, ax)
    return _conv_q_plain([codes], [ax], w, bias, slope, out_absmax,
                         out_dtype or _float_dtype([x]))


def _conv_up_m_q_plain(x, w, bias, slope, ax, out_absmax, out_dtype):
    """``_conv_up_m_xla``: an int8 input's codes are interpolated and
    re-rounded."""
    codes = _on_grid(upsample_2x_bilinear(x.float()), x, ax)
    return _conv_q_plain([codes], [ax], w, bias, slope, out_absmax,
                         out_dtype or _float_dtype([x]))


def _conv_up_q_plain(x, w, bias, slope, ax, out_absmax, out_dtype):
    """``_conv_up_packed_xla``: an int8 input is dequantised, upsampled (W
    first) and quantised again."""
    xf = x.float()
    if x.dtype == torch.int8:
        xf = xf * _over127(_clamp_ax(ax, x.device))
    codes = _quantize_act(_upsample_wh(xf), ax).float()
    return _conv_q_plain([codes], [ax], w, bias, slope, out_absmax,
                         out_dtype or _float_dtype([x]))


def _conv_up_f_q_plain(x, w, bias, slope, ax, out_absmax, out_dtype):
    """``_conv_up_f_xla``: H-interpolated rows of the codes (a bf16 input
    scaled by 127/ax first) rounded to the grid, the folded weights and edge
    taps on one per-channel grid, dequantised, a float32 contraction."""
    axc = _clamp_ax(ax, x.device)
    xn = x.float()
    if x.dtype != torch.int8:
        xn = xn * _127_over(axc)
    rows = torch.round(_upsample_2x_axis(xn, 1)).clamp(-127.0, 127.0)
    codes, sw = _upf_q_taps(w)
    y = _fold_apply(rows, codes * _over127(torch.cat([sw, sw])))
    y = _leaky(y * _over127(axc) + bias.float(), slope)
    return _q_out(y, out_absmax, out_dtype or _float_dtype([x]))


# ------------------------------------------------------------------ launch

# The float32 entry points of one input (K6-K8): x, c, wfrag, bias, out, B,
# 2 sizes, cout, k, cchunk, n_tiles, has_slope, slope, stream;
# conv_up_f_packed's has no k.
_F32_ONE = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def _lib_sm90(source: str = "conv_up_sm90") -> ctypes.CDLL:
    """A library of the Hopper core: ``csrc/conv_up_sm90.cu`` (K7-K9 and the
    weight prep) or ``csrc/conv_packed_sm90.cu`` (K5, K6 and K1)."""
    lib = _build.library(source)
    if not getattr(lib, "_rrin_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pv, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
        one = [vp, ci, ci] + [vp] * 5 + [ci] * 9 + [cf, ci, vp]
        if source == "conv_up_sm90":
            lib.rrin_conv_up_sm90_smem.argtypes = [ci] * 6
            lib.rrin_conv_up_sm90_smem.restype = ctypes.c_longlong
            lib.rrin_conv_pool_packed_launch.argtypes = one
            lib.rrin_conv_up_m_packed_launch.argtypes = one
            lib.rrin_conv_up_f_packed_launch.argtypes = one[:-4] + [cf, ci, vp]
            lib.rrin_conv_up_prep_launch.argtypes = [vp] * 4 + [ci, pi] + [ci] * 6 + [vp]
            lib.rrin_conv_up_f_packed_f32_launch.argtypes = _F32_ONE[:5] + [ci] * 7 + _F32_ONE[-2:]
            lib.rrin_conv_pool_packed_f32_launch.argtypes = _F32_ONE
            lib.rrin_conv_up_m_packed_f32_launch.argtypes = _F32_ONE
            names = ("conv_pool_packed", "conv_up_m_packed", "conv_up_f_packed", "conv_up_prep",
                     "conv_pool_packed_f32", "conv_up_m_packed_f32", "conv_up_f_packed_f32")
        else:
            lib.rrin_conv_packed_sm90_smem.argtypes = [ci] * 5
            lib.rrin_conv_packed_sm90_smem.restype = ctypes.c_longlong
            lib.rrin_conv_stream_sm90_smem.argtypes = [ci] * 3
            lib.rrin_conv_stream_sm90_smem.restype = ctypes.c_longlong
            lib.rrin_conv_stream_sm90_blocks.argtypes = [ci, pi, pi, ci]
            lib.rrin_conv_stream_sm90_blocks.restype = ci
            lib.rrin_conv_packed_launch.argtypes = (
                [pv, pi, pi, pi, pv, ci] + [vp] * 4 + [ci] * 9 + [cf, ci, vp])
            lib.rrin_conv_up_packed_launch.argtypes = one
            lib.rrin_conv_packed_f32_launch.argtypes = [pv, pi, pi, ci] + [vp] * 3 + [
                ci] * 8 + [cf, vp]
            lib.rrin_conv_up_packed_f32_launch.argtypes = _F32_ONE
            lib.rrin_conv_phase_sm90_launch.argtypes = [vp, ci, ci] + [vp] * 3 + [ci] * 8 + [
                cf, vp]
            names = ("conv_packed", "conv_up_packed", "conv_packed_f32", "conv_up_packed_f32",
                     "conv_phase_sm90")
        lib.rrin_conv_f32_promotion.argtypes = [ci]
        lib.rrin_conv_f32_promotion.restype = ci
        for name in names:
            getattr(lib, f"rrin_{name}_launch").restype = ci
        lib._rrin_typed = True
    return lib


def _split_parts(parts: Sequence[Part]) -> Tuple[List[torch.Tensor], Tuple[int, ...]]:
    xs, cs = [], []
    for part in parts:
        x, c = part if isinstance(part, tuple) else (part, part.shape[-1])
        if x.ndim != 4 or not 1 <= c <= x.shape[-1]:
            raise ValueError(
                f"an operand must be (B, H, W, C) with 1 <= real_c <= C, got "
                f"{tuple(x.shape)} with real_c {c}")
        xs.append(x)
        cs.append(int(c))
    if not xs:
        raise ValueError("conv_packed needs at least one operand")
    x0 = xs[0]
    for x in xs[1:]:
        if x.shape[:3] != x0.shape[:3] or x.device != x0.device:
            raise ValueError(
                "the operands of one conv must agree in batch, height, width "
                "and device")
        if x.dtype != x0.dtype and torch.int8 not in (x.dtype, x0.dtype):
            raise ValueError("the floating operands of one conv must agree in dtype")
    return xs, tuple(cs)


def _check_cuda(
    name: str, xs, w, bias, prepared, cins, k, cout, q: bool = False, out_q: bool = False,
) -> Optional[Prepared]:
    """What a kernel asks of its tensors and of ``prepared``, which it
    returns: bfloat16 or float32 operands, or (int8, ``q``) bfloat16 and
    int8 ones, and a ``prepared`` built for this call's site and types."""
    f32 = xs[0].dtype == torch.float32
    for x in xs:
        if not (x.dtype == torch.bfloat16 or (q and x.dtype == torch.int8)
                or (not q and x.dtype == torch.float32)):
            raise NotImplementedError(
                f"{name}: the packed kernels take bfloat16 or float32 operands, or in "
                f"int8 mode bfloat16 and int8 ones; got {x.dtype} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"{name} takes NHWC-contiguous, 16-byte aligned operands")
        if x.requires_grad:
            raise RuntimeError(
                f"{name} is forward-only; detach its inputs (or run under "
                "torch.no_grad())")
    if w.device != xs[0].device or bias.device != xs[0].device:
        raise ValueError("the operands, w and bias must lie on one device")
    if prepared is None:
        return None
    if (prepared["cins"], prepared["k"], prepared["cout"]) != (tuple(cins), k, cout):
        raise ValueError(
            f"{name}: prepared= was built for cin {prepared['cins']}, k "
            f"{prepared['k']}, cout {prepared['cout']}, not {tuple(cins)}, {k}, {cout}")
    if (prepared["q"], prepared["out_q"]) != (q, out_q):
        raise ValueError(
            f"{name}: prepared= was built for int8 {prepared['q']}, int8 output "
            f"{prepared['out_q']}; this call has {q}, {out_q}")
    want = torch.int8 if q else (torch.float32 if f32 else torch.bfloat16)
    if prepared["wfrag"].dtype != want:
        raise ValueError(
            f"{name}: prepared= holds {prepared['wfrag'].dtype} weights, this call needs "
            f"{want} (build it with the operands' dtype)")
    if prepared["wfrag"].device != xs[0].device:
        raise ValueError(f"{name}: prepared= lies on another device")
    return prepared


@functools.lru_cache(maxsize=None)
def _sm90_smem_agrees(name, k, cins, plan, q, streamed=False) -> None:
    """Raise unless the C layout of kernel ``name``'s library and
    :func:`_sm90_smem_bytes` agree (checked once per site: every argument is
    hashable); ``streamed``: K1's streamed mode (``conv_packed``'s
    library), whose stencil split must also be :func:`_stream_blocks`'s."""
    cchunk, n_tiles, _ = plan
    folded, resident = _SM90_KERNELS[name]
    res = 0 if streamed else _sm90_res_chunks(cins, plan, resident)
    source = _SM90_SOURCE[name]
    lib = _lib_sm90(source)
    if streamed:
        got = lib.rrin_conv_stream_sm90_smem(k, cchunk, n_tiles)
        want = _stream_blocks(k)
        origins, sizes = (ctypes.c_int * len(want))(), (ctypes.c_int * len(want))()
        n = lib.rrin_conv_stream_sm90_blocks(k, origins, sizes, len(want))
        if n != len(want) or tuple(zip(origins, sizes)) != want:
            raise RuntimeError(f"{source}.cu and conv_packed.py disagree on the split of k {k}")
    elif source == "conv_up_sm90":
        got = lib.rrin_conv_up_sm90_smem(k, cchunk, n_tiles, int(q), int(folded), res)
    else:
        got = lib.rrin_conv_packed_sm90_smem(k, cchunk, n_tiles, int(q), res)
    if got != _sm90_smem_bytes(k, cchunk, n_tiles, q, folded, res, streamed):
        raise RuntimeError(f"{source}.cu and conv_packed.py disagree on the tile")


def _prep_on_card(name: str, w: torch.Tensor, bias: torch.Tensor,
                  cins: Optional[Sequence[int]] = None, f32: bool = False,
                  plan: Optional[Tuple[int, int, int]] = None) -> Prepared:
    """What ``prep_conv`` (operands of ``cins`` channels) / ``prep_conv_up``
    / ``prep_conv_pool`` / ``prep_conv_up_m`` / ``prep_conv_up_f`` return in
    bfloat16 (``f32``: with ``dtype=torch.float32``), from one launch of the
    Hopper core's prep kernel: the layout of :func:`_sm90_weights` (each
    operand's channels padded to whole chunks; K9: the fold of
    :func:`_upf_taps` before the bf16 rounding; float32: the hi and the lo
    TF32 plane) and, folded, the bias repeated for both output parities.
    ``plan``: the kernel's plan where it is not ``name``'s own (K1's
    streamed mode lays out ``conv_packed``'s weights for its plan)."""
    folded, res = _SM90_KERNELS[name]
    q = F32 if f32 else False
    k, _, cin, cout = w.shape
    cins = (cin,) if cins is None else tuple(int(c) for c in cins)
    n_out = 2 * cout if folded else cout
    if plan is None:
        plan = _sm90_plan(k, cins, n_out, q, folded=folded, resident=res)
    cchunk, n_tiles, n_cb = plan
    lead = (n_cb, _sm90_chunks(cins, cchunk), k, 5 if folded else k)
    if f32:  # [kstep][plane][n-tile][r][g][tig][p]
        mem = torch.empty((*lead, cchunk // 8, 2, n_tiles, 2, 8, 4, 1), dtype=torch.float32,
                          device=w.device)
    else:  # [kstep][n-tile][r][g][tig][p]
        mem = torch.empty((*lead, cchunk // 16, n_tiles, 2, 8, 4, 2), dtype=torch.bfloat16,
                          device=w.device)
    wf = w.float().contiguous()
    b = bias.float().contiguous()
    b_out = torch.empty(n_out, dtype=torch.float32, device=w.device) if folded else b
    lib = _lib_sm90()
    with torch.cuda.device(w.device):
        _build.launch(
            "conv_up_prep", lib.rrin_conv_up_prep_launch, wf.data_ptr(), b.data_ptr(),
            mem.data_ptr(), b_out.data_ptr() if folded else None, k,
            (ctypes.c_int * len(cins))(*cins), len(cins), cout, cchunk, n_tiles, int(folded),
            int(f32), torch.cuda.current_stream().cuda_stream)
    return {"wfrag": mem.permute(*_sm90_order(q)[1]), "bias": b_out, "scale": None,
            "cins": cins, "k": k, "cout": cout, "plan": plan, "q": False, "out_q": False}


def _check_sm90_layout(name: str, prepared: Prepared) -> None:
    wfrag = prepared["wfrag"]
    order = _sm90_order(F32 if wfrag.dtype == torch.float32 else False)[0]
    if wfrag.ndim != len(order) or not wfrag.permute(*order).is_contiguous():
        raise ValueError(f"{name}: prepared['wfrag'] is not in the layout of _sm90_weights")


def _f32_promotion(k_steps: int) -> int:
    """Set the float32 promotion interval of the Hopper core's later launches
    (``rrin_conv_f32_promotion`` of both of its libraries: K5 and K6 in
    ``csrc/conv_packed_sm90.cu``, K7-K9 in ``csrc/conv_up_sm90.cu``): at most
    ``k_steps`` k-steps (8 channels of one tap) of an output row, as whole
    (dx, k-step) slabs of k, are summed on the tensor cores before one
    addition with round to nearest (below k: every k-step); returns the one
    it replaces. A measurement's knob: the default (9) is what the float32
    bar allows."""
    old = [_lib_sm90(source).rrin_conv_f32_promotion(k_steps)
           for source in ("conv_packed_sm90", "conv_up_sm90")]
    return old[0]


def _slope_args(slope: Optional[float]) -> Tuple[int, float]:
    return int(slope is not None), 0.0 if slope is None else float(slope)


def _out_tensor(name, shape, dev, f32, out_absmax, out_dtype) -> torch.Tensor:
    """The output of a launch: float32 for float32 operands (``f32``), else
    int8 with ``out_absmax``, else ``out_dtype`` (bfloat16 by default)."""
    if f32:
        if out_dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"{name} stores float32 from float32 operands, not {out_dtype}")
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dt = torch.int8 if out_absmax is not None else (out_dtype or torch.bfloat16)
    if dt not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(f"{name} stores bfloat16 or int8 on the card, not {dt}")
    return torch.empty(shape, dtype=dt, device=dev)


def _counter(name: str, et: int) -> str:
    """The launch count of ``name`` in element type ``et``."""
    return name + {False: "", True: "_int8", F32: "_f32"}[et]


def _q_launch_args(prepared, axs, dev):
    """(ax tensors, scale pointer) of an int8 launch: the clamped scalars
    that ``prepared`` holds (built from the same absmax), so a prepared call
    makes no launch but its kernel's; the tensors are kept alive by the
    caller until the launch has been enqueued."""
    axs = prepared.get("axs") or [_clamp_ax(a, dev).reshape(()) for a in axs]
    return list(axs), prepared["scale"].data_ptr()


# ---------------------------------------------------------------- wrappers

def conv_packed(
    parts: Sequence[Part], w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
    in_absmax: Optional[Sequence[Absmax]] = None, out_absmax: Optional[Absmax] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """conv2d(stride 1, SAME) + bias + optional LeakyReLU over the channel
    concat of ``parts``, which is never materialised on the card.

    parts: tensors (B, H, W, C_i) NHWC or ``(tensor, real_c)`` pairs, whose
    first ``real_c`` channels enter the conv, in order; w: (k, k, sum real_c,
    cout) HWIO; bias: (cout,). ``in_absmax`` (one per operand) selects int8,
    ``out_absmax`` an int8 output (module docstring). Returns (B, H, W, cout)
    in the operands' dtype, int8 or ``out_dtype``.
    """
    xs, cs = _split_parts(parts)
    k, cout = _check_w(w, bias, sum(cs))
    _need(supports(cs, k, cout), "conv_packed", cs, k, cout)
    q = _check_q("conv_packed", xs, in_absmax, out_absmax)
    if xs[0].device.type == "cpu":
        xs = [x[..., :c] for x, c in zip(xs, cs)]
        if q:
            return _conv_packed_q_plain(xs, w, bias, slope, in_absmax, out_absmax, out_dtype)
        y = _conv_packed_plain(xs, w, bias, slope)
        return y if out_dtype is None else y.to(out_dtype)
    if xs[0].device.type != "cuda":
        raise RuntimeError(f"no conv_packed kernel for device {xs[0].device}")
    prepared = _check_cuda("conv_packed", xs, w, bias, prepared, cs, k, cout, q,
                           out_absmax is not None)
    f32 = xs[0].dtype == torch.float32
    et = F32 if f32 else q
    if prepared is None:
        prepared = (prep_conv(w, bias, cs, in_absmax, out_absmax) if q
                    else _prep_on_card("conv_packed", w, bias, cs, f32))
    _check_sm90_layout("conv_packed", prepared)
    _sm90_smem_agrees("conv_packed", k, cs, prepared["plan"], et)
    lib = _lib_sm90("conv_packed_sm90")
    cchunk, n_tiles, _ = prepared["plan"]
    b, h, width, _ = xs[0].shape
    dev = xs[0].device
    out = _out_tensor("conv_packed", (b, h, width, cout), dev, f32, out_absmax, out_dtype)
    n = len(xs)
    ptrs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in xs])
    strides = (ctypes.c_int * n)(*[x.shape[-1] for x in xs])
    wb = (prepared["wfrag"].data_ptr(), prepared["bias"].data_ptr())
    tail = (cchunk, n_tiles, *_slope_args(slope))
    if f32:
        fn = lib.rrin_conv_packed_f32_launch
        args = (ptrs, (ctypes.c_int * n)(*cs), strides, n, *wb, out.data_ptr(), b, h, width,
                cout, k, *tail)
    else:
        fn = lib.rrin_conv_packed_launch
        axs, scale = _q_launch_args(prepared, in_absmax, dev) if q else ([], None)
        args = (ptrs, (ctypes.c_int * n)(*cs), strides,
                (ctypes.c_int * n)(*[int(x.dtype == torch.int8) for x in xs]),
                (ctypes.c_void_p * n)(*([a.data_ptr() for a in axs] or [None] * n)), n,
                *wb, scale, out.data_ptr(), int(out.dtype == torch.int8), b, h, width, cout,
                k, *tail, int(q))
    with torch.cuda.device(dev):
        _build.launch(_counter("conv_packed", et), fn, *args,
                      torch.cuda.current_stream().cuda_stream)
    return out


def _fused(name: str, x, w, bias, slope, prepared, in_absmax, out_absmax,
           out_dtype) -> torch.Tensor:
    """The shared body of the four fused-resample wrappers."""
    ok, prep, plain, plain_q = _FUSED[name]
    pool = name == "conv_pool_packed"
    if x.ndim != 4:
        raise ValueError(f"{name} takes (B, H, W, C), got {tuple(x.shape)}")
    b, h, width, cin = x.shape
    k, cout = _check_w(w, bias, cin)
    _need(ok(cin, k, cout), name, cin, k, cout)
    if pool and (h % 2 or width % 2):
        raise ValueError(f"{name} pools 2x2: H and W must be even, got {h}x{width}")
    q = _check_q(name, [x], None if in_absmax is None else (in_absmax,), out_absmax)
    if x.device.type == "cpu":
        if q:
            return plain_q(x, w, bias, slope, in_absmax, out_absmax, out_dtype)
        y = plain(x, w, bias, slope)
        return y if out_dtype is None else y.to(out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {x.device}")
    prepared = _check_cuda(name, [x], w, bias, prepared, (cin,), k, cout, q,
                           out_absmax is not None)
    f32 = x.dtype == torch.float32
    et = F32 if f32 else q
    folded, _ = _SM90_KERNELS[name]
    if prepared is None:
        prepared = (prep(w, bias, in_absmax, out_absmax) if q
                    else _prep_on_card(name, w, bias, f32=f32))
    cchunk, n_tiles, _ = prepared["plan"]
    _check_sm90_layout(name, prepared)
    _sm90_smem_agrees(name, k, (cin,), prepared["plan"], et)
    lib = _lib_sm90(_SM90_SOURCE[name])
    entry = f"rrin_{name}{'_f32' if f32 else ''}_launch"
    oh, ow = (h // 2, width // 2) if pool else (2 * h, 2 * width)
    out = _out_tensor(name, (b, oh, ow, cout), x.device, f32, out_absmax, out_dtype)
    wb = (prepared["wfrag"].data_ptr(), prepared["bias"].data_ptr())
    # The pool's entry point takes the output's size, the upsamples' the
    # input's; the folded one has k = 3 built in.
    shape = (b, *((oh, ow) if pool else (h, width)), cout, *(() if folded else (k,)),
             cchunk, n_tiles, *_slope_args(slope))
    if f32:  # float32 only: no int8 arguments, no dt
        args = (x.data_ptr(), cin, *wb, out.data_ptr(), *shape)
    else:
        axs, scale = _q_launch_args(prepared, [in_absmax], x.device) if q else ([None], None)
        args = (x.data_ptr(), cin, int(x.dtype == torch.int8),
                None if axs[0] is None else axs[0].data_ptr(), *wb, scale,
                out.data_ptr(), int(out.dtype == torch.int8), *shape, int(et))
    with torch.cuda.device(x.device):
        _build.launch(_counter(name, et), getattr(lib, entry), *args,
                      torch.cuda.current_stream().cuda_stream)
    return out


def conv_pool_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
    in_absmax: Optional[Absmax] = None, out_absmax: Optional[Absmax] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """conv2d(avg_pool_2x(x)) + bias + optional LeakyReLU from the
    full-resolution ``x`` (B, 2H, 2W, cin); the pooled tensor never reaches
    device memory. Zero padding applies at the pooled resolution. Returns
    (B, H, W, cout). int8 as in :func:`conv_packed` (one ``in_absmax``; an
    int8 ``x`` pools on its grid)."""
    return _fused("conv_pool_packed", x, w, bias, slope, prepared, in_absmax, out_absmax,
                  out_dtype)


def conv_up_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
    in_absmax: Optional[Absmax] = None, out_absmax: Optional[Absmax] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """conv2d(upsample_2x_bilinear(x)) + bias + optional LeakyReLU from the
    half-resolution ``x`` (B, Hs, Ws, cin), k in {1, 3, 5}, the upsampled
    tile built in shared memory (source index clamped at all four edges, zero
    padding at the upsampled resolution). Returns (B, 2Hs, 2Ws, cout). int8
    as in :func:`conv_packed` (one ``in_absmax``; an int8 ``x`` is
    dequantised before it is interpolated)."""
    return _fused("conv_up_packed", x, w, bias, slope, prepared, in_absmax, out_absmax,
                  out_dtype)


def conv_up_m_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
    in_absmax: Optional[Absmax] = None, out_absmax: Optional[Absmax] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The function of :func:`conv_up_packed` for k in {3, 5}; an int8 ``x``
    is interpolated on its grid and re-rounded."""
    return _fused("conv_up_m_packed", x, w, bias, slope, prepared, in_absmax, out_absmax,
                  out_dtype)


def conv_up_f_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
    in_absmax: Optional[Absmax] = None, out_absmax: Optional[Absmax] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The function of :func:`conv_up_packed` for k = 3 with the W-upsample
    folded into the weights: the kernel builds the H-interpolated rows only
    and contracts them at half width. On the CPU it computes the plain
    upsample-then-conv; :func:`_conv_up_f_folded` is the fold itself. In int8
    the H-interpolated rows are rounded to the grid and the folded weights
    quantised (:func:`_upf_q_taps`)."""
    return _fused("conv_up_f_packed", x, w, bias, slope, prepared, in_absmax, out_absmax,
                  out_dtype)


# name -> (supports, prep, plain version, int8 plain version) of the
# fused-resample wrappers.
_FUSED = {
    "conv_pool_packed": (supports_pool, prep_conv_pool, _conv_pool_plain, _conv_pool_q_plain),
    "conv_up_packed": (supports_up, prep_conv_up, _conv_up_wh_plain, _conv_up_q_plain),
    "conv_up_m_packed": (supports_up_m, prep_conv_up_m, _conv_up_plain, _conv_up_m_q_plain),
    "conv_up_f_packed": (supports_up_f, prep_conv_up_f, _conv_up_plain, _conv_up_f_q_plain),
}
