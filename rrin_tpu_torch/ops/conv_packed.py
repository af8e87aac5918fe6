"""The convolutions of the packed serving path: five hand-written CUDA
kernels and their wrappers, in bfloat16 and in int8.

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
  ``conv_up_m_packed``  ``_kernel_body_up_m``: the same function;
  ``conv_up_f_packed``  ``_kernel_body_up_f``: the same function for k = 3
                        with the W-upsample folded into per-output-parity
                        weights on the host (:func:`_upf_fold`) and the
                        clamped-edge residual added exactly.

The source of all five is ``csrc/conv_packed.cu``: one implicit-GEMM core on
``mma.sync`` with five load prologues. **K6 and K8 compute one function** in
NHWC. The two TPU kernels differ only in their lane geometry (K6 doubles the
lane groups P, K8 the sublane groups M at a level boundary), which is not
carried over, so in bfloat16 their CUDA kernels are the same prologue. Both
entry points exist because each mirrors one reference kernel, with its own
plain version, ``supports_*`` and launch count, and because their rounding
follows their references: ``conv_up_packed`` interpolates along W first and
dequantises an int8 input before interpolating, as ``_conv_up_packed_xla``
does, while ``conv_up_m_packed`` interpolates along H first and on the int8
codes, as ``_conv_up_m_xla`` does. The JAX package
routes the up sites u3c1 and u4c1 to K6 where the folded kernel's scoped
memory bound rejects them (4K widths); ``models.unet.packed_branch_flags``
repeats that routing.

**bfloat16.** A float32 bias and an optional LeakyReLU are added to a
float32 sum, rounded once to bfloat16.

**int8** (``in_absmax`` given, one calibrated |x| maximum per operand, from
``models.unet.unet_apply_stats``): activations are quantised per tensor,
``clip(round(x * 127/ax), +-127)`` rounding half to even
(:func:`_quantize_act`), weights per output channel with operand *i*
pre-scaled by ``ax_i/ax_0`` so that one scale ``ax_0 * sw / 127^2``
dequantises the shared int32 sum (:func:`_quantize_weights`); the kernels
contract int8 x int8 -> int32 on ``mma.sync.m16n8k32``. An int8-dtyped
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
float32 on the card is refused (the kernels are bfloat16 and int8 only so
far). Forward only. ``prepared=`` takes the result of the matching
``prep_*`` (built with the same absmax) and skips the per-call weight
re-layout and quantisation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from rrin_tpu_torch import _build
from rrin_tpu_torch.ops.conv_phase import _conv_plain, _leaky
from rrin_tpu_torch.ops.resize import (
    _upsample_2x_axis,
    avg_pool_2x,
    upsample_2x_bilinear,
)

# Tile constants of csrc/conv_packed.cu (kept equal to the kernel's).
_TH, _TW, _PAD_BYTES, MAX_OPS = 8, 32, 16, 4
# Dynamic shared memory a block may use on sm_90 (227 KB).
_SMEM_MAX = 232448
# Kernel sizes each kernel is built for.
_K_CONV, _K_POOL, _K_UP, _K_UP_M, _K_UP_F = (3, 5, 7), (3, 5), (1, 3, 5), (3, 5), (3,)
# Channel chunks of the K-loop, largest first: bfloat16 steps 16 channels
# per mma, int8 32.
_CHUNKS = {False: (64, 48, 32, 16), True: (128, 64, 32)}

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

def _n_tiles(n_out: int) -> int:
    return next((n for n in (1, 2, 4, 8) if n * 8 >= n_out), 8)


def _smem_bytes(
    ky: int, kx: int, ntaps: int, cchunk: int, n_tiles: int, q: bool = False,
) -> int:
    es, kk = (1, 32) if q else (2, 16)
    halo = (_TH + ky - 1) * (_TW + kx - 1) * (cchunk * es + _PAD_BYTES)
    wrow = ntaps * (cchunk // kk) * n_tiles * 32 * 8
    return halo + wrow


def _plan(
    ky: int, kx: int, ntaps: int, cins: Sequence[int], n_out: int, q: bool = False,
) -> Optional[Tuple[int, int, int]]:
    """(cchunk, n_tiles, n_cout_blocks) of the kernel for this site, or None.
    ``n_out`` is the number of channels per GEMM pixel (2*cout when folded);
    ``q`` plans the int8 kernel."""
    if not cins or min(cins) < 1 or n_out < 1:
        return None
    n_tiles = _n_tiles(n_out)
    kk = 32 if q else 16
    cin_k = -(-max(cins) // kk) * kk
    for cchunk in _CHUNKS[q]:
        if cchunk > cin_k:
            continue
        if _smem_bytes(ky, kx, ntaps, cchunk, n_tiles, q) <= _SMEM_MAX:
            return cchunk, n_tiles, -(-n_out // (n_tiles * 8))
    return None


def _fits(ky, kx, ntaps, cins, n_out) -> bool:
    return all(_plan(ky, kx, ntaps, cins, n_out, q) is not None for q in (False, True))


def supports(cins: Sequence[int], k: int, cout: int) -> bool:
    """Whether ``conv_packed`` has a kernel for operands of ``cins`` channels:
    k in {3, 5, 7}, any cin >= 1 and cout >= 1 (cin 6/9/10 and cout 2/3/4
    stay on the kernel), at most four operands."""
    return k in _K_CONV and 1 <= len(cins) <= MAX_OPS and _fits(k, k, k, cins, cout)


def supports_pool(cin: int, k: int, cout: int) -> bool:
    """``conv_pool_packed``: k in {3, 5}, cin a multiple of 8 (8-channel loads)."""
    return k in _K_POOL and cin % 8 == 0 and _fits(k, k, k, (cin,), cout)


def supports_up(cin: int, k: int, cout: int) -> bool:
    """``conv_up_packed``: what the JAX package's ``supports_up`` admits once
    its lane geometry is set aside: odd k <= 5 (1, 3, 5), cin a multiple of 8."""
    return k in _K_UP and cin % 8 == 0 and _fits(k, k, k, (cin,), cout)


def supports_up_m(cin: int, k: int, cout: int) -> bool:
    """``conv_up_m_packed``: k in {3, 5}, cin a multiple of 8."""
    return k in _K_UP_M and cin % 8 == 0 and _fits(k, k, k, (cin,), cout)


def supports_up_f(cin: int, k: int, cout: int) -> bool:
    """``conv_up_f_packed``: k = 3 (the fold is solved for it), cin a
    multiple of 8."""
    return k in _K_UP_F and cin % 8 == 0 and _fits(3, 3, 5, (cin,), 2 * cout)


# ---------------------------------------------------------------- int8 grid

def _clamp_ax(ax: Absmax, device: torch.device) -> torch.Tensor:
    """A calibrated |x| maximum as a float32 tensor on ``device``, at least
    1e-12 (a tensor already there is not copied)."""
    return torch.as_tensor(ax, dtype=torch.float32, device=device).clamp_min(1e-12)


def _quantize_act(x: torch.Tensor, ax: Absmax) -> torch.Tensor:
    """Symmetric per-tensor int8: ``clip(round(x * 127/max(ax, 1e-12)),
    +-127)``, rounding half to even (``torch.round``, as ``jnp.round``)."""
    inv = 127.0 / _clamp_ax(ax, x.device)
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

def _weight_fragments(
    wt: torch.Tensor, cins: Sequence[int], cchunk: int, n_tiles: int, q: bool = False,
) -> torch.Tensor:
    """(ky, ntaps, sum(cins), n_out) weights -> bf16 (``q``: int8 codes) in
    the kernel's B-fragment order
    ``[cout block][chunk][dy][tap][kstep][n-tile][lane = g*4+tig][reg r][p]``.

    Chunks run operand by operand, each operand's channels zero-padded to a
    multiple of ``cchunk``; the element is ``wt[dy, tap, row(chunk) +
    kstep*KK + r*KK/2 + tig*KK/8 + p, block*n_tiles*8 + n-tile*8 + g]`` with
    KK = 16 (bf16, p < 2) or 32 (int8, p < 4), zero where cin or cout is
    padding. ``wt`` is rounded to bfloat16 here, once (int8: cast, exact)."""
    ky, ntaps, _, n_out = wt.shape
    kk = 32 if q else 16
    nb = n_tiles * 8
    n_cb = -(-n_out // nb)
    segs, row = [], 0
    for c in cins:
        pad_c = -(-c // cchunk) * cchunk - c
        segs.append(F.pad(wt[:, :, row:row + c], (0, n_cb * nb - n_out, 0, pad_c)))
        row += c
    wp = torch.cat(segs, dim=2).to(torch.int8 if q else torch.bfloat16)
    n_chunks = wp.shape[2] // cchunk
    wp = wp.view(ky, ntaps, n_chunks, cchunk // kk, 2, 4, kk // 8, n_cb, n_tiles, 8)
    #            dy  tap    ch        kstep        r  tig p       cb    nt       g
    return wp.permute(7, 2, 0, 1, 3, 8, 9, 5, 4, 6).contiguous()


def _prepared(wt, bias, cins, k, cout, plan, scale=None, out_q=False) -> Prepared:
    """``scale`` is None for bfloat16 weights and the per-channel int8
    dequantisation for int8 codes ``wt``."""
    cchunk, n_tiles, _ = plan
    q = scale is not None
    return {
        "wfrag": _weight_fragments(wt, cins, cchunk, n_tiles, q),
        "bias": bias.to(torch.float32).contiguous(),
        "scale": None if scale is None else scale.contiguous(),
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


def prep_conv(
    w: torch.Tensor, bias: torch.Tensor, real_cs: Sequence[int],
    absmax: Optional[Sequence[Absmax]] = None, out_absmax: Optional[Absmax] = None,
) -> Prepared:
    """Weight-side constants of one ``conv_packed`` site: HWIO weights in
    fragment order, split per operand, and the float32 bias; with ``absmax``
    (one per operand) the int8 codes, the per-channel scale and the bias, both
    folded with ``127/out_absmax`` when that is given."""
    real_cs = tuple(int(c) for c in real_cs)
    k, cout = _check_w(w, bias, sum(real_cs))
    _need(supports(real_cs, k, cout), "conv_packed", real_cs, k, cout)
    if absmax is None:
        return _prepared(w.float(), bias, real_cs, k, cout, _plan(k, k, k, real_cs, cout))
    wqs, sw = _quantize_weights(torch.split(w.float(), real_cs, dim=2), absmax)
    scale, b = _q_fold(absmax[0], sw, bias, out_absmax)
    return _prepared(
        torch.cat(wqs, dim=2).float(), b, real_cs, k, cout,
        _plan(k, k, k, real_cs, cout, q=True), scale, out_absmax is not None)


def _prep_single(name, ok, w, bias, absmax, out_absmax) -> Prepared:
    k, cout = _check_w(w, bias, w.shape[2])
    cin = w.shape[2]
    _need(ok(cin, k, cout), name, cin, k, cout)
    if absmax is None:
        return _prepared(w.float(), bias, (cin,), k, cout, _plan(k, k, k, (cin,), cout))
    (wq,), sw = _quantize_weights([w.float()], (absmax,))
    scale, b = _q_fold(absmax, sw, bias, out_absmax)
    return _prepared(wq.float(), b, (cin,), k, cout, _plan(k, k, k, (cin,), cout, q=True),
                     scale, out_absmax is not None)


def prep_conv_pool(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                   out_absmax: Optional[Absmax] = None) -> Prepared:
    """Weight-side constants of one ``conv_pool_packed`` site (the conv's own
    weights: the pool lives in the kernel's load); int8 as in :func:`prep_conv`."""
    return _prep_single("conv_pool_packed", supports_pool, w, bias, absmax, out_absmax)


def prep_conv_up(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                 out_absmax: Optional[Absmax] = None) -> Prepared:
    """Weight-side constants of one ``conv_up_packed`` site (the conv's own
    weights: the upsample lives in the kernel's load; the input's absmax
    calibrates the upsampled values, a convex combination of it)."""
    return _prep_single("conv_up_packed", supports_up, w, bias, absmax, out_absmax)


def prep_conv_up_m(w: torch.Tensor, bias: torch.Tensor, absmax: Optional[Absmax] = None,
                   out_absmax: Optional[Absmax] = None) -> Prepared:
    """Weight-side constants of one ``conv_up_m_packed`` site, as
    :func:`prep_conv_up`."""
    return _prep_single("conv_up_m_packed", supports_up_m, w, bias, absmax, out_absmax)


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
                   out_absmax: Optional[Absmax] = None) -> Prepared:
    """Weight-side constants of one ``conv_up_f_packed`` site: the weights
    folded in float32, then rounded to bfloat16 (or quantised to int8 with
    their edge taps on one per-channel grid) in fragment order, and the bias
    (and scale) repeated for both output parities."""
    k, cout = _check_w(w, bias, w.shape[2])
    cin = w.shape[2]
    _need(supports_up_f(cin, k, cout), "conv_up_f_packed", cin, k, cout)
    if absmax is None:
        return _prepared(
            _upf_taps(w.float()), torch.cat([bias, bias]), (cin,), k, cout,
            _plan(3, 3, 5, (cin,), 2 * cout))
    codes, sw = _upf_q_taps(w)
    scale, b = _q_fold(absmax, sw, bias, out_absmax)
    return _prepared(
        codes, torch.cat([b, b]), (cin,), k, cout, _plan(3, 3, 5, (cin,), 2 * cout, q=True),
        torch.cat([scale, scale]), out_absmax is not None)


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
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(rows.permute(0, 3, 1, 2), taps[:, :3].permute(3, 2, 0, 1), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
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
        xs.append(qx * (axc / 127.0))
        ws.append(wq.float() * (sw / 127.0) * (a0 / axc))
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
        xf = xf * (_clamp_ax(ax, x.device) / 127.0)
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
        xn = xn * (127.0 / axc)
    rows = torch.round(_upsample_2x_axis(xn, 1)).clamp(-127.0, 127.0)
    codes, sw = _upf_q_taps(w)
    y = _fold_apply(rows, codes * (torch.cat([sw, sw]) / 127.0))
    y = _leaky(y * (axc / 127.0) + bias.float(), slope)
    return _q_out(y, out_absmax, out_dtype or _float_dtype([x]))


# ------------------------------------------------------------------ launch

def _lib() -> ctypes.CDLL:
    lib = _build.library("conv_packed")
    if not getattr(lib, "_rrin_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rrin_conv_packed_smem.argtypes = [ci] * 6
        lib.rrin_conv_packed_smem.restype = ctypes.c_longlong
        pv, pi = ctypes.POINTER(vp), ctypes.POINTER(ci)
        lib.rrin_conv_packed_launch.argtypes = (
            [pv, pi, pi, pi, pv, ci] + [vp] * 4 + [ci] * 9 + [cf, ci, vp])
        fused = [vp, ci, ci] + [vp] * 5 + [ci] * 9 + [cf, ci, vp]
        for name in ("pool", "up_m", "up"):
            getattr(lib, f"rrin_conv_{name}_packed_launch").argtypes = fused
        lib.rrin_conv_up_f_packed_launch.argtypes = (
            [vp, ci, ci] + [vp] * 5 + [ci] * 8 + [cf, ci, vp])
        for name in _ENTRY:
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
    returns."""
    for x in xs:
        if x.dtype != torch.bfloat16 and not (q and x.dtype == torch.int8):
            raise NotImplementedError(
                f"{name}: the packed kernels are bfloat16 and int8 only so far, got "
                f"{x.dtype} on {x.device}; pass packed=False for float32 "
                "(ROADMAP.md Queue B item 3, 'float32 variants of K5-K9')")
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
    if prepared["wfrag"].device != xs[0].device:
        raise ValueError(f"{name}: prepared= lies on another device")
    return prepared


def _smem_agrees(lib, ky, kx, ntaps, plan, q) -> None:
    cchunk, n_tiles, _ = plan
    if lib.rrin_conv_packed_smem(ky, kx, ntaps, cchunk, n_tiles, int(q)) != _smem_bytes(
            ky, kx, ntaps, cchunk, n_tiles, q):
        raise RuntimeError("conv_packed.cu and conv_packed.py disagree on the tile")


def _slope_args(slope: Optional[float]) -> Tuple[int, float]:
    return int(slope is not None), 0.0 if slope is None else float(slope)


def _out_tensor(name, shape, dev, q, out_absmax, out_dtype) -> torch.Tensor:
    dt = torch.int8 if out_absmax is not None else (out_dtype or torch.bfloat16)
    if dt not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(f"{name} stores bfloat16 or int8 on the card, not {dt}")
    return torch.empty(shape, dtype=dt, device=dev)


def _q_launch_args(prepared, axs, dev):
    """(ax tensors, scale pointer) of an int8 launch; the tensors are kept
    alive by the caller until the launch has been enqueued."""
    axs = [_clamp_ax(a, dev).reshape(()) for a in axs]
    return axs, prepared["scale"].data_ptr()


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
    if prepared is None:
        prepared = prep_conv(w, bias, cs, in_absmax, out_absmax)
    cchunk, n_tiles, _ = prepared["plan"]
    lib = _lib()
    _smem_agrees(lib, k, k, k, prepared["plan"], q)
    b, h, width, _ = xs[0].shape
    dev = xs[0].device
    out = _out_tensor("conv_packed", (b, h, width, cout), dev, q, out_absmax, out_dtype)
    n = len(xs)
    axs, scale = _q_launch_args(prepared, in_absmax, dev) if q else ([], None)
    with torch.cuda.device(dev):
        _build.launch(
            "conv_packed_int8" if q else "conv_packed", lib.rrin_conv_packed_launch,
            (ctypes.c_void_p * n)(*[x.data_ptr() for x in xs]),
            (ctypes.c_int * n)(*cs), (ctypes.c_int * n)(*[x.shape[-1] for x in xs]),
            (ctypes.c_int * n)(*[int(x.dtype == torch.int8) for x in xs]),
            (ctypes.c_void_p * n)(*([a.data_ptr() for a in axs] or [None] * n)), n,
            prepared["wfrag"].data_ptr(), prepared["bias"].data_ptr(), scale,
            out.data_ptr(), int(out.dtype == torch.int8), b, h, width, cout, k,
            cchunk, n_tiles, *_slope_args(slope), int(q),
            torch.cuda.current_stream().cuda_stream,
        )
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
    if prepared is None:
        prepared = prep(w, bias, in_absmax, out_absmax)
    cchunk, n_tiles, _ = prepared["plan"]
    lib = _lib()
    folded = name == "conv_up_f_packed"
    _smem_agrees(lib, *((3, 3, 5) if folded else (k, k, k)), prepared["plan"], q)
    oh, ow = (h // 2, width // 2) if pool else (2 * h, 2 * width)
    out = _out_tensor(name, (b, oh, ow, cout), x.device, q, out_absmax, out_dtype)
    axs, scale = _q_launch_args(prepared, [in_absmax], x.device) if q else ([None], None)
    # The pool's entry point takes the output's size, the upsamples' the
    # input's; the folded one has k = 3 built in.
    dims = (oh, ow) if pool else (h, width)
    with torch.cuda.device(x.device):
        _build.launch(
            f"{name}_int8" if q else name, getattr(lib, f"rrin_{name}_launch"),
            x.data_ptr(), cin, int(x.dtype == torch.int8),
            None if axs[0] is None else axs[0].data_ptr(),
            prepared["wfrag"].data_ptr(), prepared["bias"].data_ptr(), scale,
            out.data_ptr(), int(out.dtype == torch.int8), b, *dims, cout,
            *(() if folded else (k,)), cchunk, n_tiles, *_slope_args(slope), int(q),
            torch.cuda.current_stream().cuda_stream,
        )
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
_ENTRY = ("conv_packed",) + tuple(_FUSED)
