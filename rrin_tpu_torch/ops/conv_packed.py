"""The convolutions of the packed serving path: four hand-written CUDA
kernels and their wrappers.

Replaces four Pallas kernels of the JAX package's ``ops/conv_packed.py``:

  ``conv_packed``       ``_kernel_body`` via ``_conv_packed_impl``: stride-1
                        SAME conv, k in {3, 5, 7}, over the channel concat of
                        1..4 operands given separately, so a skip concat
                        never exists in device memory; head mode with
                        ``slope=None``;
  ``conv_pool_packed``  ``_kernel_body_pool``: conv(avg_pool_2x(x)) reading
                        the full-resolution tensor;
  ``conv_up_m_packed``  ``_kernel_body_up_m``: conv(upsample_2x_bilinear(x))
                        from the half-resolution tensor, rows and columns of
                        the upsampled tile built in shared memory;
  ``conv_up_f_packed``  ``_kernel_body_up_f``: the same function for k = 3
                        with the W-upsample folded into per-output-parity
                        weights on the host (:func:`_upf_fold`) and the
                        clamped-edge residual added exactly.

All add a float32 bias and an optional LeakyReLU to a float32 sum and round
once to bfloat16. The source of all four is ``csrc/conv_packed.cu``: one
implicit-GEMM core on ``mma.sync`` with four load prologues.

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
need: odd k in the set each is built for, channel counts that allow 16-byte
loads where a prologue needs them, and a tile that fits shared memory. There
is no gate on H, W or M. Each wrapper launches its kernel for a bfloat16
CUDA tensor or raises; it takes the plain version beside it only for a CPU
tensor. float32 on the card is refused (the kernels are bfloat16 only so
far). Forward only. ``prepared=`` takes the result of the matching
``prep_*`` and skips the per-call weight re-layout.
"""

from __future__ import annotations

import ctypes
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
_TH, _TW, _CPAD, MAX_OPS = 8, 32, 8, 4
# Dynamic shared memory a block may use on sm_90 (227 KB).
_SMEM_MAX = 232448
# Kernel sizes each kernel is built for.
_K_CONV, _K_POOL, _K_UP_M, _K_UP_F = (3, 5, 7), (3, 5), (3, 5), (3,)

Part = Union[torch.Tensor, Tuple[torch.Tensor, int]]
Prepared = Dict[str, object]

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


def _smem_bytes(ky: int, kx: int, ntaps: int, cchunk: int, n_tiles: int) -> int:
    halo = (_TH + ky - 1) * (_TW + kx - 1) * (cchunk + _CPAD) * 2
    wrow = ntaps * (cchunk // 16) * n_tiles * 32 * 8
    return halo + wrow


def _plan(
    ky: int, kx: int, ntaps: int, cins: Sequence[int], n_out: int
) -> Optional[Tuple[int, int, int]]:
    """(cchunk, n_tiles, n_cout_blocks) of the kernel for this site, or None.
    ``n_out`` is the number of channels per GEMM pixel (2*cout when folded)."""
    if not cins or min(cins) < 1 or n_out < 1:
        return None
    n_tiles = _n_tiles(n_out)
    cin16 = -(-max(cins) // 16) * 16
    for cchunk in (64, 48, 32, 16):
        if cchunk > cin16:
            continue
        if _smem_bytes(ky, kx, ntaps, cchunk, n_tiles) <= _SMEM_MAX:
            return cchunk, n_tiles, -(-n_out // (n_tiles * 8))
    return None


def supports(cins: Sequence[int], k: int, cout: int) -> bool:
    """Whether ``conv_packed`` has a kernel for operands of ``cins`` channels:
    k in {3, 5, 7}, any cin >= 1 and cout >= 1 (cin 6/9/10 and cout 2/3/4
    stay on the kernel), at most four operands."""
    return (
        k in _K_CONV and 1 <= len(cins) <= MAX_OPS
        and _plan(k, k, k, cins, cout) is not None
    )


def supports_pool(cin: int, k: int, cout: int) -> bool:
    """``conv_pool_packed``: k in {3, 5}, cin a multiple of 8 (16-byte loads)."""
    return k in _K_POOL and cin % 8 == 0 and _plan(k, k, k, (cin,), cout) is not None


def supports_up_m(cin: int, k: int, cout: int) -> bool:
    """``conv_up_m_packed``: k in {3, 5}, cin a multiple of 8."""
    return k in _K_UP_M and cin % 8 == 0 and _plan(k, k, k, (cin,), cout) is not None


def supports_up_f(cin: int, k: int, cout: int) -> bool:
    """``conv_up_f_packed``: k = 3 (the fold is solved for it), cin a
    multiple of 8."""
    return (
        k in _K_UP_F and cin % 8 == 0
        and _plan(3, 3, 5, (cin,), 2 * cout) is not None
    )


# ----------------------------------------------------------- weight layout

def _weight_fragments(
    wt: torch.Tensor, cins: Sequence[int], cchunk: int, n_tiles: int
) -> torch.Tensor:
    """(ky, ntaps, sum(cins), n_out) weights -> bf16 in the kernel's
    B-fragment order
    ``[cout block][chunk][dy][tap][k16][n-tile][lane = g*4+tig][reg r][pair p]``.

    Chunks run operand by operand, each operand's channels zero-padded to a
    multiple of ``cchunk``; the element is ``wt[dy, tap, row(chunk) + k16*16
    + r*8 + tig*2 + p, block*n_tiles*8 + n-tile*8 + g]`` (zero where cin or
    cout is padding). ``wt`` is rounded to bfloat16 here, once."""
    ky, ntaps, _, n_out = wt.shape
    nb = n_tiles * 8
    n_cb = -(-n_out // nb)
    segs, row = [], 0
    for c in cins:
        pad_c = -(-c // cchunk) * cchunk - c
        segs.append(F.pad(wt[:, :, row:row + c], (0, n_cb * nb - n_out, 0, pad_c)))
        row += c
    wp = torch.cat(segs, dim=2).to(torch.bfloat16)
    n_chunks = wp.shape[2] // cchunk
    wp = wp.view(ky, ntaps, n_chunks, cchunk // 16, 2, 4, 2, n_cb, n_tiles, 8)
    #            dy  tap    ch        k16          r  tig p  cb    nt       g
    return wp.permute(7, 2, 0, 1, 3, 8, 9, 5, 4, 6).contiguous()


def _prepared(wt, bias, cins, k, cout, plan) -> Prepared:
    cchunk, n_tiles, _ = plan
    return {
        "wfrag": _weight_fragments(wt, cins, cchunk, n_tiles),
        "bias": bias.to(torch.float32).contiguous(),
        "cins": tuple(cins), "k": k, "cout": cout, "plan": plan,
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


def prep_conv(
    w: torch.Tensor, bias: torch.Tensor, real_cs: Sequence[int]
) -> Prepared:
    """Weight-side constants of one ``conv_packed`` site: HWIO weights in
    fragment order, split per operand, and the float32 bias."""
    real_cs = tuple(int(c) for c in real_cs)
    k, cout = _check_w(w, bias, sum(real_cs))
    _need(supports(real_cs, k, cout), "conv_packed", real_cs, k, cout)
    return _prepared(w.float(), bias, real_cs, k, cout, _plan(k, k, k, real_cs, cout))


def _prep_single(name, ok, w, bias) -> Prepared:
    k, cout = _check_w(w, bias, w.shape[2])
    cin = w.shape[2]
    _need(ok(cin, k, cout), name, cin, k, cout)
    return _prepared(w.float(), bias, (cin,), k, cout, _plan(k, k, k, (cin,), cout))


def prep_conv_pool(w: torch.Tensor, bias: torch.Tensor) -> Prepared:
    """Weight-side constants of one ``conv_pool_packed`` site (the conv's own
    weights: the pool lives in the kernel's load)."""
    return _prep_single("conv_pool_packed", supports_pool, w, bias)


def prep_conv_up_m(w: torch.Tensor, bias: torch.Tensor) -> Prepared:
    """Weight-side constants of one ``conv_up_m_packed`` site (the conv's own
    weights: the upsample lives in the kernel's load)."""
    return _prep_single("conv_up_m_packed", supports_up_m, w, bias)


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


def prep_conv_up_f(w: torch.Tensor, bias: torch.Tensor) -> Prepared:
    """Weight-side constants of one ``conv_up_f_packed`` site: the weights
    folded in float32, then rounded to bfloat16 in fragment order, and the
    bias repeated for both output parities."""
    k, cout = _check_w(w, bias, w.shape[2])
    cin = w.shape[2]
    _need(supports_up_f(cin, k, cout), "conv_up_f_packed", cin, k, cout)
    return _prepared(
        _upf_taps(w.float()), torch.cat([bias, bias]), (cin,), k, cout,
        _plan(3, 3, 5, (cin,), 2 * cout))


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
    function that both upsampling kernels compute."""
    return _conv_plain(upsample_2x_bilinear(x.float()).to(x.dtype), w, bias, slope)


def _conv_up_f_folded(x, w, bias, slope) -> torch.Tensor:
    """The folded kernel's own arithmetic in plain PyTorch: H-interpolated
    rows and folded weights rounded to ``x.dtype``, float32 products and sum,
    edge residuals, one rounding at the end. Equal to :func:`_conv_up_plain`
    in float32 up to summation order; in bfloat16 it rounds where the kernel
    rounds, so the kernel is held to it at one bfloat16 step."""
    dt = x.dtype
    b, hs, ws, cin = x.shape
    cout = w.shape[3]
    rows = _upsample_2x_axis(x.float(), 1).to(dt).float()      # (B, 2Hs, Ws, cin)
    taps = _upf_taps(w.float()).to(dt).float()                 # (3, 5, cin, 2*cout)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(rows.permute(0, 3, 1, 2), taps[:, :3].permute(3, 2, 0, 1), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = y.permute(0, 2, 3, 1).contiguous()                     # (B, 2Hs, Ws, 2*cout)
    for col, tap in ((0, 3), (ws - 1, 4)):
        edge = F.pad(rows[:, :, col], (0, 0, 1, 1))            # zero rows above, below
        y[:, :, col] += sum(
            edge[:, dy:dy + 2 * hs] @ taps[dy, tap] for dy in range(3))
    y = y.reshape(b, 2 * hs, 2 * ws, cout) + bias.float()
    return _leaky(y, slope).to(dt)


# ------------------------------------------------------------------ launch

def _lib() -> ctypes.CDLL:
    lib = _build.library("conv_packed")
    if not getattr(lib, "_rrin_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rrin_conv_packed_smem.argtypes = [ci] * 5
        lib.rrin_conv_packed_smem.restype = ctypes.c_longlong
        lib.rrin_conv_packed_launch.argtypes = (
            [ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.POINTER(ci), ci]
            + [vp] * 3 + [ci] * 8 + [cf, vp])
        fused = [vp, ci, vp, vp, vp] + [ci] * 8 + [cf, vp]
        lib.rrin_conv_pool_packed_launch.argtypes = fused
        lib.rrin_conv_up_m_packed_launch.argtypes = fused
        lib.rrin_conv_up_f_packed_launch.argtypes = (
            [vp, ci, vp, vp, vp] + [ci] * 7 + [cf, vp])
        for fn in (lib.rrin_conv_packed_launch, lib.rrin_conv_pool_packed_launch,
                   lib.rrin_conv_up_m_packed_launch, lib.rrin_conv_up_f_packed_launch):
            fn.restype = ci
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
        if x.shape[:3] != x0.shape[:3] or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(
                "the operands of one conv must agree in batch, height, width, "
                "dtype and device")
    return xs, tuple(cs)


def _check_cuda(name: str, xs, w, bias, prepared, cins, k, cout) -> Optional[Prepared]:
    """What a kernel asks of its tensors and of ``prepared``, which it
    returns."""
    for x in xs:
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"{name}: the packed kernels are bfloat16 only so far, got "
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
    if prepared["wfrag"].device != xs[0].device:
        raise ValueError(f"{name}: prepared= lies on another device")
    return prepared


def _smem_agrees(lib, ky, kx, ntaps, plan) -> None:
    cchunk, n_tiles, _ = plan
    if lib.rrin_conv_packed_smem(ky, kx, ntaps, cchunk, n_tiles) != _smem_bytes(
            ky, kx, ntaps, cchunk, n_tiles):
        raise RuntimeError("conv_packed.cu and conv_packed.py disagree on the tile")


def _slope_args(slope: Optional[float]) -> Tuple[int, float]:
    return int(slope is not None), 0.0 if slope is None else float(slope)


# ---------------------------------------------------------------- wrappers

def conv_packed(
    parts: Sequence[Part], w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
) -> torch.Tensor:
    """conv2d(stride 1, SAME) + bias + optional LeakyReLU over the channel
    concat of ``parts``, which is never materialised on the card.

    parts: tensors (B, H, W, C_i) NHWC or ``(tensor, real_c)`` pairs, whose
    first ``real_c`` channels enter the conv, in order; w: (k, k, sum real_c,
    cout) HWIO; bias: (cout,). Returns (B, H, W, cout) in the operands' dtype.
    """
    xs, cs = _split_parts(parts)
    k, cout = _check_w(w, bias, sum(cs))
    _need(supports(cs, k, cout), "conv_packed", cs, k, cout)
    if xs[0].device.type == "cpu":
        return _conv_packed_plain(
            [x[..., :c] for x, c in zip(xs, cs)], w, bias, slope)
    if xs[0].device.type != "cuda":
        raise RuntimeError(f"no conv_packed kernel for device {xs[0].device}")
    prepared = _check_cuda("conv_packed", xs, w, bias, prepared, cs, k, cout)
    if prepared is None:
        prepared = prep_conv(w, bias, cs)
    cchunk, n_tiles, _ = prepared["plan"]
    lib = _lib()
    _smem_agrees(lib, k, k, k, prepared["plan"])
    b, h, width, _ = xs[0].shape
    out = torch.empty((b, h, width, cout), dtype=torch.bfloat16, device=xs[0].device)
    n = len(xs)
    ptrs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in xs])
    c_arr = (ctypes.c_int * n)(*cs)
    s_arr = (ctypes.c_int * n)(*[x.shape[-1] for x in xs])
    with torch.cuda.device(out.device):
        _build.launch(
            "conv_packed", lib.rrin_conv_packed_launch,
            ptrs, c_arr, s_arr, n, prepared["wfrag"].data_ptr(),
            prepared["bias"].data_ptr(), out.data_ptr(), b, h, width, cout, k,
            cchunk, n_tiles, *_slope_args(slope),
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def _fused(name: str, x, w, bias, slope, prepared) -> torch.Tensor:
    """The shared body of the three fused-resample wrappers."""
    ok, prep, plain = _FUSED[name]
    pool = name == "conv_pool_packed"
    if x.ndim != 4:
        raise ValueError(f"{name} takes (B, H, W, C), got {tuple(x.shape)}")
    b, h, width, cin = x.shape
    k, cout = _check_w(w, bias, cin)
    _need(ok(cin, k, cout), name, cin, k, cout)
    if pool and (h % 2 or width % 2):
        raise ValueError(f"{name} pools 2x2: H and W must be even, got {h}x{width}")
    if x.device.type == "cpu":
        return plain(x, w, bias, slope)
    if x.device.type != "cuda":
        raise RuntimeError(f"no {name} kernel for device {x.device}")
    prepared = _check_cuda(name, [x], w, bias, prepared, (cin,), k, cout)
    if prepared is None:
        prepared = prep(w, bias)
    cchunk, n_tiles, _ = prepared["plan"]
    lib = _lib()
    folded = name == "conv_up_f_packed"
    _smem_agrees(lib, *((3, 3, 5) if folded else (k, k, k)), prepared["plan"])
    oh, ow = (h // 2, width // 2) if pool else (2 * h, 2 * width)
    out = torch.empty((b, oh, ow, cout), dtype=torch.bfloat16, device=x.device)
    # The pool's entry point takes the output's size, the upsamples' the
    # input's; the folded one has k = 3 built in.
    dims = (oh, ow) if pool else (h, width)
    with torch.cuda.device(x.device):
        _build.launch(
            name, getattr(lib, f"rrin_{name}_launch"),
            x.data_ptr(), cin, prepared["wfrag"].data_ptr(),
            prepared["bias"].data_ptr(), out.data_ptr(), b, *dims, cout,
            *(() if folded else (k,)), cchunk, n_tiles, *_slope_args(slope),
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def conv_pool_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
) -> torch.Tensor:
    """conv2d(avg_pool_2x(x)) + bias + optional LeakyReLU from the
    full-resolution ``x`` (B, 2H, 2W, cin); the pooled tensor never reaches
    device memory. Zero padding applies at the pooled resolution. Returns
    (B, H, W, cout)."""
    return _fused("conv_pool_packed", x, w, bias, slope, prepared)


def conv_up_m_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
) -> torch.Tensor:
    """conv2d(upsample_2x_bilinear(x)) + bias + optional LeakyReLU from the
    half-resolution ``x`` (B, Hs, Ws, cin), the upsampled tile built in shared
    memory (source index clamped at all four edges, zero padding at the
    upsampled resolution). Returns (B, 2Hs, 2Ws, cout)."""
    return _fused("conv_up_m_packed", x, w, bias, slope, prepared)


def conv_up_f_packed(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    slope: Optional[float] = None, prepared: Optional[Prepared] = None,
) -> torch.Tensor:
    """The function of :func:`conv_up_m_packed` for k = 3 with the W-upsample
    folded into the weights: the kernel builds the H-interpolated rows only
    and contracts them at half width. On the CPU it computes the plain
    upsample-then-conv; :func:`_conv_up_f_folded` is the fold itself."""
    return _fused("conv_up_f_packed", x, w, bias, slope, prepared)


# name -> (supports, prep, plain version) of the fused-resample wrappers.
_FUSED = {
    "conv_pool_packed": (supports_pool, prep_conv_pool, _conv_pool_plain),
    "conv_up_m_packed": (supports_up_m, prep_conv_up_m, _conv_up_plain),
    "conv_up_f_packed": (supports_up_f, prep_conv_up_f, _conv_up_plain),
}
