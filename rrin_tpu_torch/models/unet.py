"""The shared U-Net encoder-decoder: the plain path and the packed path.

One generic ``UNet(in_ch, out_ch)`` instantiated four times by the cascade
with different channel signatures (flow 6->4, refine 10->4, mask 16->2,
residue 9->3):

  stem:    conv7x7(in->32)  + LReLU(0.1), conv7x7(32->32) + LReLU
  down_i:  avgpool2x2 -> convKxK + LReLU -> convKxK + LReLU
           widths 32->64 (K=5), 64->128 (3), 128->256 (3), 256->512 (3)
  up_i:    bilinear 2x up -> conv3x3 + LReLU -> concat(skip) -> conv3x3 + LReLU
           widths 512->256->128->64->32
  head:    conv3x3(32->out), no activation.

Plain functions on NHWC tensors and a nested params dict with HWIO weights
(the JAX package's layout). On the plain path (:func:`unet_apply`) every
conv goes through ``ops.conv_phase.conv2d_fused``, which sends the
low-channel bfloat16 sites to the hand-written CUDA kernel and the rest to
``F.conv2d``.

:func:`unet_apply_packed` is the serving path (the JAX package's production
default): the same 19 convs through the kernels of ``ops.conv_packed``, which
read skip-concat operands separately and pool or upsample in their load, so
no pooled, upsampled or concatenated tensor reaches device memory at the
sites they cover and no conv goes to ``F.conv2d``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.ops.conv_packed import (
    _is_f32,
    _prep_on_card,
    conv_packed,
    conv_pool_packed,
    conv_up_f_packed,
    conv_up_m_packed,
    conv_up_packed,
    prep_conv,
    prep_conv_pool,
    prep_conv_up,
    prep_conv_up_f,
    prep_conv_up_m,
    supports,
    supports_pool,
    supports_up,
    supports_up_f,
    supports_up_m,
)
from rrin_tpu_torch.ops.conv_phase import conv2d_fused
from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear

Params = Dict[str, Any]


def _conv_init(
    gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
    device: torch.device,
) -> Params:
    """PyTorch Conv2d-style default init: kaiming_uniform(a=sqrt(5)) gives
    bound = 1/sqrt(fan_in) for the weight; the bias uses the same bound."""
    bound = float(1.0 / ((kh * kw * cin) ** 0.5))

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return ((2.0 * u - 1.0) * bound).to(device)

    return {"w": uniform((kh, kw, cin, cout)), "b": uniform((cout,))}


def unet_init(
    gen: torch.Generator, in_ch: int, out_ch: int, cfg: ModelConfig,
    device: DeviceLike = "cuda",
) -> Params:
    """Initialize one U-Net's parameter dict from ``gen`` (drawn on the
    generator's device, so a CPU generator gives the same weights on any
    ``device``)."""
    dev = resolve_device(device)
    w1, w2, w3, w4, w5 = cfg.widths
    k = cfg.down_kernels
    sk = cfg.stem_kernel

    def conv(kk, cin, cout):
        return _conv_init(gen, kk, kk, cin, cout, dev)

    return {
        "conv1": conv(sk, in_ch, w1),
        "conv2": conv(sk, w1, w1),
        "down1": {"conv1": conv(k[0], w1, w2), "conv2": conv(k[0], w2, w2)},
        "down2": {"conv1": conv(k[1], w2, w3), "conv2": conv(k[1], w3, w3)},
        "down3": {"conv1": conv(k[2], w3, w4), "conv2": conv(k[2], w4, w4)},
        "down4": {"conv1": conv(k[3], w4, w5), "conv2": conv(k[3], w5, w5)},
        "up1": {"conv1": conv(3, w5, w4), "conv2": conv(3, 2 * w4, w4)},
        "up2": {"conv1": conv(3, w4, w3), "conv2": conv(3, 2 * w3, w3)},
        "up3": {"conv1": conv(3, w3, w2), "conv2": conv(3, 2 * w2, w2)},
        "up4": {"conv1": conv(3, w2, w1), "conv2": conv(3, 2 * w1, w1)},
        "conv3": conv(3, w1, out_ch),
    }


class PlainOps:
    """The tensor ops of :func:`_unet` on whole frames. ``parallel.spatial``
    has their counterparts on frames cut into row shards."""

    conv = staticmethod(conv2d_fused)  # (x, w, b, slope)
    pool = staticmethod(avg_pool_2x)
    up = staticmethod(upsample_2x_bilinear)

    @staticmethod
    def cat(ts):
        return torch.cat(ts, dim=-1)


def _unet(p: Params, x: torch.Tensor, cfg: ModelConfig, rec, ops=PlainOps) -> torch.Tensor:
    """The plain U-Net; ``rec(name, t)`` sees the input ("in") and every
    conv's output (c1, c2, d1c1 ... u4c2) and returns the tensor to go on
    with. ``ops`` holds the conv, pool, upsample and channel concat."""
    s = cfg.leaky_slope

    def conv(name, t, prm):
        return rec(name, ops.conv(t, prm["w"], prm["b"], s))

    def down(i, t):
        t = conv(f"d{i}c1", ops.pool(t), p[f"down{i}"]["conv1"])
        return conv(f"d{i}c2", t, p[f"down{i}"]["conv2"])

    def up(i, t, skip):
        t = conv(f"u{i}c1", ops.up(t), p[f"up{i}"]["conv1"])
        return conv(f"u{i}c2", ops.cat([t, skip]), p[f"up{i}"]["conv2"])

    t = conv("c1", rec("in", x), p["conv1"])
    s1 = conv("c2", t, p["conv2"])
    s2 = down(1, s1)
    s3 = down(2, s2)
    s4 = down(3, s3)
    t = down(4, s4)
    t = up(1, t, s4)
    t = up(2, t, s3)
    t = up(3, t, s2)
    t = up(4, t, s1)
    return ops.conv(t, p["conv3"]["w"], p["conv3"]["b"], None)


def unet_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Apply one U-Net. x: (B, H, W, in_ch), H and W divisible by 16; runs
    on the device and in the dtype of ``x``."""
    return _unet(p, x, cfg, lambda name, t: t)


# ---------------------------------------------------------------------------
# int8 calibration. Conv input(s) per site of the int8 packed path: which
# producer tensor's calibrated |x| max quantises each conv operand ("in" = the
# U-Net input). Heads stay bf16 (flows, weights and residues need the
# precision). The JAX package's table, copied.
# ---------------------------------------------------------------------------

QUANT_SITES = {
    "c1": ("in",), "c2": ("c1",),
    "d1c1": ("c2",), "d1c2": ("d1c1",),
    "d2c1": ("d1c2",), "d2c2": ("d2c1",),
    "d3c1": ("d2c2",), "d3c2": ("d3c1",),
    "d4c1": ("d3c2",), "d4c2": ("d4c1",),
    "u1c1": ("d4c2",), "u1c2": ("u1c1", "d3c2"),
    "u2c1": ("u1c2",), "u2c2": ("u2c1", "d2c2"),
    "u3c1": ("u2c2",), "u3c2": ("u3c1", "d1c2"),
    "u4c1": ("u3c2",), "u4c2": ("u4c1", "c2"),
}


def _f32_quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a.astype(float32).ravel(), q)`` (linear) of a float
    tensor, bit for bit, as a float32 scalar on the device of ``a``, with no
    host sync. The order statistics are selected in the dtype of ``a`` (a
    cast to float32 is exact and keeps the order), then cast.

    The reference's index arithmetic is float32 throughout: ``pos = q *
    (n - 1)`` with ``n`` and ``q`` float32, ``low``/``high`` its floor and
    ceil, weight ``pos - low``, result ``lo * (1 - w) + hi * w``. Above 2^24
    elements the position is a rounded float32 (and the weight 0), so it is
    computed here in numpy float32, from the static size alone; a float64
    position picks other order statistics. XLA's CPU backend contracts the
    last multiply-add into one FMA, ``fma(hi, w, lo * (1 - w))``; float64
    reproduces it (the product is exact there, the sum rounds once more
    only where float32 would meet a tie). The two order statistics come
    from one ``torch.topk`` of the smaller side (``torch.quantile`` refuses
    more than 2^24 elements; a 1080p activation has 67 M)."""
    a = a.reshape(-1)
    n = a.numel()
    one, nf = np.float32(1), np.float32(n)
    pos = np.float32(q) * (nf - one)
    low, high = np.floor(pos), np.ceil(pos)
    w_hi = pos - low
    w_lo = one - w_hi
    lo = int(np.clip(low, np.float32(0), nf - one))
    hi = int(np.clip(high, np.float32(0), nf - one))
    if lo >= n // 2:  # the top n - lo values: lo is their least, hi the next
        side = torch.topk(a, n - lo, sorted=False).values
        pair = torch.topk(side, min(2, n - lo), largest=False).values
        v_lo, v_hi = pair[0].float(), pair[hi - lo].float()
    else:  # the bottom hi + 1 values: hi is their greatest, lo the one before
        side = torch.topk(a, hi + 1, largest=False, sorted=False).values
        pair = torch.topk(side, min(2, hi + 1)).values
        v_lo, v_hi = pair[hi - lo].float(), pair[0].float()
    return (v_hi.double() * float(w_hi) + (v_lo * float(w_lo)).double()).float()


def unet_apply_stats(
    p: Params, x: torch.Tensor, cfg: ModelConfig, quantile=None, ranges=None,
) -> tuple:
    """:func:`unet_apply` + per-tensor |x| statistics for int8 calibration.

    Returns (out, stats): stats maps each conv-output name (plus "in") to a
    float32 scalar tensor on the device of ``x``. Nothing is read back to
    the host. Three modes, as the JAX package's:

    - default: the |x| maximum, the range that the int8 packed path consumes
      (pool and upsample between sites are convex combinations, so a
      producer's absmax bounds every consumer);
    - ``quantile`` (in (0, 1]): the q-quantile of |x| in float32, equal to
      ``jnp.quantile`` bit for bit (:func:`_f32_quantile`): percentile
      clipping, whose clipped tail saturates;
    - ``ranges`` (a stats dict of this U-Net, margin applied): the
      saturation rate ``mean(|x| > range)``, the share of values the int8
      grid clips. |x| is compared in float32 (a bfloat16 tensor against a
      float32 scalar compares in bfloat16 in PyTorch, in float32 in JAX).
    """
    if quantile is not None and ranges is not None:
        raise ValueError("quantile and ranges are mutually exclusive")
    stats = {}

    def rec(name, t):
        if ranges is not None:
            r = torch.as_tensor(ranges[name], dtype=torch.float32, device=t.device)
            stats[name] = torch.count_nonzero(t.abs().float() > r).float() / float(t.numel())
        elif quantile is not None:
            stats[name] = _f32_quantile(t.abs(), quantile)
        else:
            stats[name] = t.abs().amax().float()
        return t

    return _unet(p, x, cfg, rec), stats


# ---------------------------------------------------------------------------
# Packed serving path. Counterpart of the JAX package's unet_apply_packed:
# what carries over is which sites fuse what, not the lane-packed layout
# (ops/conv_packed.py says why). Activations stay contiguous NHWC.
#
#   c1, c2                      conv_packed (7x7)
#   d1c1, d2c1                  conv_pool_packed   (pool fused into the load)
#   d1c2, d2c2, d3c*, d4c*      conv_packed
#   u1c1                        conv_packed on a materialised upsample
#   u1c2, u2c2, u3c2, u4c2      conv_packed, two operands (skip concat fused)
#   u2c1                        conv_up_m_packed   (upsample built in the load)
#   u3c1, u4c1                  conv_up_f_packed   (W-upsample folded), or
#                               conv_up_packed at 4K widths, where the JAX
#                               package routes them so
#   head                        conv_packed, no activation
#
# The pools before d3c1 and d4c1 and the upsample before u1c1 are plain
# PyTorch ops, as the JAX package materialises those three itself.
# ---------------------------------------------------------------------------

# The JAX package's bound on the folded kernel (its scoped-memory limit):
# u3c1 and u4c1 go to conv_up_packed where the level-0 group count exceeds it.
_UP_F_M_MAX = 800


def _packed_m0(w: int) -> int:
    """The JAX package's level-0 group count of a frame ``w`` wide (the M of
    its packed layout), a copy: it decides where the reference leaves the
    folded kernel."""
    return -(-(w + 6) // 4 // 8) * 8


def packed_branch_flags(h: int, w: int, cfg: ModelConfig):
    """The branch configuration of :func:`unet_apply_packed`, in the JAX
    package's order: (l2_kernel, l3_kernel, fuse_d1, fuse_d2, fuse_u3,
    fuse_u4, l4_kernel, fuse_u2).

    fuse_u3/fuse_u4 are tri-state as in the JAX package: 2 for the folded
    kernel (``conv_up_f_packed``), 1 for ``conv_up_packed`` where the JAX
    package's folded kernel rejects the site for its width alone
    (``_packed_m0(w) > 800``: w >= 3200, 4K frames), 0 for neither. Beyond
    that the CUDA kernels have no gate on H, W or M, so ``h`` does not enter
    and the other flags depend on the channel widths and kernel sizes only.
    The JAX package's flags differ at some shapes: it gates fuse_d2 and
    fuse_u2 on H alignment (False where ``h // 4`` is no multiple of 8: 720p,
    2160x3840) and its l2/l3/l4 branches and fused up sites on minimum
    heights (h < 64). Those of its flags that decide the int8 carry plan
    are copied as :func:`reference_carry_flags`."""
    w1, w2, w3, w4, w5 = cfg.widths
    k = cfg.down_kernels
    sk = cfg.stem_kernel
    level01 = (
        supports((16,), sk, w1) and supports((w1,), sk, w1)        # c1, c2
        and supports((w2,), k[0], w2)                              # d1c2
        and supports((w2, w2), 3, w2) and supports((w1, w1), 3, w1)  # u3c2, u4c2
        and supports((w1,), 3, 4)                                  # head
    )
    l2_kernel = level01 and supports((w3,), k[1], w3) and supports((w3, w3), 3, w3)
    l3_kernel = (
        supports((w3,), k[2], w4) and supports((w4,), k[2], w4)    # d3c1, d3c2
        and supports((w5,), 3, w4) and supports((w4, w4), 3, w4)   # u1c1, u1c2
    )
    l4_kernel = l3_kernel and supports((w4,), k[3], w5) and supports((w5,), k[3], w5)
    folded = _packed_m0(w) <= _UP_F_M_MAX

    def fuse_up(cin, cout):
        if folded and supports_up_f(cin, 3, cout):
            return 2
        return 1 if supports_up(cin, 3, cout) else 0

    return (
        l2_kernel, l3_kernel,
        supports_pool(w1, k[0], w2), supports_pool(w2, k[1], w3),
        fuse_up(w3, w2), fuse_up(w2, w1),
        l4_kernel, supports_up_m(w4, 3, w3),
    )


def packed_supported(h: int, w: int, cfg: ModelConfig) -> bool:
    """Whether :func:`unet_apply_packed` applies to this shape and config:
    the /16 grid and a kernel at every one of the 19 sites. A shape or
    config it rejects takes the plain path in ``models.rrin.forward``."""
    flags = packed_branch_flags(h, w, cfg)
    return h % 16 == 0 and w % 16 == 0 and all(
        f in ((1, 2) if i in (4, 5) else (True,)) for i, f in enumerate(flags))


def packed_bf16_supported(w: int) -> bool:
    """The JAX package bounds the bfloat16 packed kernels by frame width
    (their windows must fit the TPU's scoped memory). The tiles of the CUDA
    kernels do not grow with the frame, so every width is supported."""
    return True


# The JAX package's layout geometry that its int8 carry gates on, copied:
# output rows per grid step, the conv window's rows (its min_h), the source
# rows of the pool and upsample windows, and lanes.
_REF_RB, _REF_MIN_H, _REF_WIN_PSRC, _REF_WIN_SRC, _REF_LANES = 8, 24, 32, 16, 128


def _ref_supports_pool(p, c, w, m, k, cout, h_src) -> bool:
    """The JAX package's ``supports_pool`` on a packed spec (p, c, w, m)."""
    if p < 2 or p % 2 or h_src % 2 or w % 2:
        return False
    return (k % 2 == 1 and k <= 5 and (h_src // 2) % _REF_RB == 0
            and h_src >= _REF_WIN_PSRC and m % 8 == 0
            and (p // 2) * cout <= 4 * _REF_LANES and p * c <= 4 * _REF_LANES
            and (p * c) % _REF_LANES == 0)


def _ref_supports_up_m(c, w, m, k, cout, h_src, m_out) -> bool:
    """The JAX package's ``supports_up_m`` on a P=1, offset-0 input written
    at offset 0 (u2c1's place in its layout plan)."""
    hh = (k - 1) // 2
    return (k % 2 == 1 and 3 <= k <= 5 and k * cout > _REF_LANES
            and (2 * h_src) % _REF_RB == 0 and h_src >= _REF_WIN_SRC
            and m % 8 == 0 and m_out % 8 == 0 and cout <= 4 * _REF_LANES
            and c <= 4 * _REF_LANES and 2 * w <= m_out and 2 * m <= m_out + hh)


def reference_carry_flags(h: int, w: int, cfg: ModelConfig):
    """(l2_kernel, l3_kernel, fuse_d1, fuse_d2, fuse_u2) as the JAX
    package's ``packed_branch_flags`` computes them at (h, w), with its
    H-alignment and minimum-height gates: they decide its int8 carry plan.
    The port routes its kernels by :func:`packed_branch_flags`; these flags
    decide the carry only (:func:`int8_carry`)."""
    m0 = _packed_m0(w)
    k = cfg.down_kernels
    w1, w2, w3, w4, _ = cfg.widths
    l2_kernel = -(-(h // 4) // 8) * 8 >= _REF_MIN_H
    l3_kernel = -(-(h // 8) // 8) * 8 >= _REF_MIN_H
    fuse_d1 = _ref_supports_pool(4, w1, w, m0, k[0], w2, h)
    fuse_d2 = _ref_supports_pool(2, w2, w // 2, m0, k[1], w3, h // 2)
    fuse_u2 = l2_kernel and l3_kernel and _ref_supports_up_m(
        w4, w // 8, -(-(w // 8) // 8) * 8, 3, w3, h // 8, m0)
    return l2_kernel, l3_kernel, fuse_d1, fuse_d2, fuse_u2


def int8_carry(h: int, w: int, cfg: ModelConfig) -> set:
    """The int8 carry plan ``_CARRY`` of the JAX package's
    ``unet_apply_packed`` at (h, w), from :func:`reference_carry_flags`: the
    sites whose output stays on its own int8 grid (the kernel's epilogue
    emits int8) because every consumer reads it straight into a packed
    kernel; a site feeding a materialised pool or upsample stays bfloat16.
    The JAX package gates fuse_d2 and fuse_u2 on H alignment, which the
    port's kernels do not need: where ``h // 4`` is no multiple of 8 (720p,
    2160x3840) it carries neither d1c2 nor u1c2, and K7 and K8 then quantise
    their bfloat16 input in the load."""
    l2_kernel, _, fuse_d1, fuse_d2, fuse_u2 = reference_carry_flags(h, w, cfg)
    carry = {
        "c1", "d1c1", "d2c1", "d3c1", "d4c1", "u1c1",
        "u2c1", "u2c2", "u3c1", "u3c2", "u4c1",
    }
    if fuse_d1:
        carry.add("c2")
    if fuse_d2 and l2_kernel:
        carry.add("d1c2")
    if fuse_u2:
        carry.add("u1c2")
    return carry


# The 19 sites of the packed path in the order of its walk: site -> (params
# path, kernel, operands). "up" is conv_up_f_packed (K9) or conv_up_packed
# (K6) as packed_branch_flags routes the site; a two-operand site reads the
# skip beside the upsampled branch, half of its channels each. The walk of
# unet_apply_packed and prepare_sites both read their sites from here.
PACKED_SITES = {
    "c1": (("conv1",), "conv_packed", 1),
    "c2": (("conv2",), "conv_packed", 1),
    "d1c1": (("down1", "conv1"), "conv_pool_packed", 1),
    "d1c2": (("down1", "conv2"), "conv_packed", 1),
    "d2c1": (("down2", "conv1"), "conv_pool_packed", 1),
    "d2c2": (("down2", "conv2"), "conv_packed", 1),
    "d3c1": (("down3", "conv1"), "conv_packed", 1),
    "d3c2": (("down3", "conv2"), "conv_packed", 1),
    "d4c1": (("down4", "conv1"), "conv_packed", 1),
    "d4c2": (("down4", "conv2"), "conv_packed", 1),
    "u1c1": (("up1", "conv1"), "conv_packed", 1),
    "u1c2": (("up1", "conv2"), "conv_packed", 2),
    "u2c1": (("up2", "conv1"), "conv_up_m_packed", 1),
    "u2c2": (("up2", "conv2"), "conv_packed", 2),
    "u3c1": (("up3", "conv1"), "up", 1),
    "u3c2": (("up3", "conv2"), "conv_packed", 2),
    "u4c1": (("up4", "conv1"), "up", 1),
    "u4c2": (("up4", "conv2"), "conv_packed", 2),
    "head": (("conv3",), "conv_packed", 1),
}

# kernel (the name of its wrapper in this module) -> its prep_*
_PREPS = {
    "conv_packed": prep_conv,
    "conv_pool_packed": prep_conv_pool,
    "conv_up_packed": prep_conv_up,
    "conv_up_m_packed": prep_conv_up_m,
    "conv_up_f_packed": prep_conv_up_f,
}


def _site_plan(h: int, w: int, cfg: ModelConfig,
               absmax: Optional[Dict[str, torch.Tensor]]) -> Dict[str, tuple]:
    """site -> (kernel, params path, operands, in_absmax, out_absmax) at (h,
    w): the kernel as :func:`packed_branch_flags` routes the site; with
    ``absmax`` the operands' ranges per ``QUANT_SITES`` and the output's
    where :func:`int8_carry` keeps it on its int8 grid (Nones in bfloat16
    and float32, and at the head)."""
    flags = packed_branch_flags(h, w, cfg)
    carry = int8_carry(h, w, cfg) if absmax is not None else set()
    up = {"u3c1": flags[4], "u4c1": flags[5]}
    plan = {}
    for site, (path, kernel, n_ops) in PACKED_SITES.items():
        if kernel == "up":
            kernel = {2: "conv_up_f_packed", 1: "conv_up_packed"}[up[site]]
        am = oam = None
        if absmax is not None and site in QUANT_SITES:
            am = tuple(absmax[n] for n in QUANT_SITES[site])
            oam = absmax[site] if site in carry else None
        plan[site] = (kernel, path, n_ops, am, oam)
    return plan


def _site_params(p: Params, path) -> Params:
    for key in path:
        p = p[key]
    return p


def prepare_sites(
    p: Params, h: int, w: int, cfg: ModelConfig,
    absmax: Optional[Dict[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, dict]:
    """The weight-side constants of every site of :func:`unet_apply_packed`
    at (h, w) (site -> the ``prepared=`` of its wrapper), built once from
    the site table, on the device of the weights.

    A bfloat16 or float32 site (``dtype``; the head also in int8) is
    prepared on the card by the Hopper core's prep kernel, the launch its
    wrapper makes per call without ``prepared=``, so prepared and
    unprepared calls are bit-equal; on the CPU by its plain version
    ``prep_*``. An int8 site (``absmax`` given) by ``prep_*`` in PyTorch:
    codes, scale and bias folded with the ranges of its operands and, where
    :func:`int8_carry` keeps its output int8, of its output."""
    out = {}
    for site, (kernel, path, n_ops, am, oam) in _site_plan(h, w, cfg, absmax).items():
        prm = _site_params(p, path)
        wt, b = prm["w"], prm["b"]
        cins = (wt.shape[2] // n_ops,) * n_ops
        prep = _PREPS[kernel]
        if am is None and wt.device.type == "cuda":
            out[site] = _prep_on_card(kernel, wt, b, cins, f32=_is_f32(dtype))
        elif kernel == "conv_packed":
            out[site] = prep(wt, b, cins, am, oam, dtype=dtype)
        else:
            out[site] = prep(wt, b, None if am is None else am[0], oam, dtype=dtype)
    return out


def unet_apply_packed(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    absmax: Optional[Dict[str, torch.Tensor]] = None,
    prep: Optional[Dict[str, dict]] = None,
    collect: Optional[Dict[str, dict]] = None,
) -> torch.Tensor:
    """:func:`unet_apply` through the packed-path kernels (inference only).

    Equal to :func:`unet_apply` up to the summation order of the convs and,
    in bfloat16, up to where the fused resamples round. x: (B, H, W, in_ch)
    with ``packed_supported(H, W, cfg)``; runs on the device and in the dtype
    of ``x``: bfloat16 or float32 on the card (the kernels' bfloat16 and
    float32 modes), any float dtype on the CPU (their plain versions).

    ``absmax``: calibration stats from :func:`unet_apply_stats` (producer
    name -> |x| max, device scalars). Every conv but the head then runs int8:
    its operands are quantised per ``QUANT_SITES`` and the sites of
    :func:`int8_carry` emit int8 for their consumers; the head stays in the
    dtype of ``x``. On the card int8 takes a bfloat16 ``x``.

    ``prep``: every site's weight-side constants from :func:`prepare_sites`
    (built with the same ``absmax`` and the dtype of ``x``), handed to the
    wrappers as ``prepared=``: no conv then prepares its weights per call.
    ``collect``: a dict that receives them (site -> constants), built here
    from the site table without running a U-Net; this call then uses them.
    """
    _, h, w, _ = x.shape
    if not packed_supported(h, w, cfg):
        raise ValueError(
            f"unet_apply_packed does not apply to {h}x{w} with {cfg}: check "
            "packed_supported first")
    if collect is not None:
        collect.update(prepare_sites(p, h, w, cfg, absmax, x.dtype))
        prep = collect
    plan = _site_plan(h, w, cfg, absmax)
    s = cfg.leaky_slope
    dt = x.dtype

    def conv(site, *parts, slope=s):
        kernel, path, _, am, oam = plan[site]
        prm = _site_params(p, path)
        pr = None if prep is None else prep[site]
        if kernel == "conv_packed":
            return conv_packed(list(parts), prm["w"], prm["b"], slope, prepared=pr,
                               in_absmax=am, out_absmax=oam, out_dtype=dt)
        return globals()[kernel](
            parts[0], prm["w"], prm["b"], slope, prepared=pr,
            in_absmax=None if am is None else am[0], out_absmax=oam, out_dtype=dt)

    t = conv("c1", x.contiguous())
    s1 = conv("c2", t)
    t = conv("d1c1", s1)
    s2 = conv("d1c2", t)
    t = conv("d2c1", s2)
    s3 = conv("d2c2", t)
    t = conv("d3c1", avg_pool_2x(s3))
    s4 = conv("d3c2", t)
    t = conv("d4c1", avg_pool_2x(s4))
    t = conv("d4c2", t)
    t = conv("u1c1", upsample_2x_bilinear(t))
    t = conv("u1c2", t, s4)
    t = conv("u2c1", t)
    t = conv("u2c2", t, s3)
    t = conv("u3c1", t)
    t = conv("u3c2", t, s2)
    t = conv("u4c1", t)
    t = conv("u4c2", t, s1)
    return conv("head", t, slope=None)
