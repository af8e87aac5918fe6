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

import torch

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.ops.conv_packed import (
    conv_packed,
    conv_pool_packed,
    conv_up_f_packed,
    conv_up_m_packed,
    supports,
    supports_pool,
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


def _conv(x: torch.Tensor, p: Params) -> torch.Tensor:
    """conv + bias, no activation (head convs)."""
    return conv2d_fused(x, p["w"], p["b"], None)


def _conv_act(x: torch.Tensor, p: Params, slope: Optional[float]) -> torch.Tensor:
    """conv + bias + LeakyReLU, fused on the kernel path."""
    return conv2d_fused(x, p["w"], p["b"], slope)


def _down(x: torch.Tensor, p: Params, slope: float) -> torch.Tensor:
    x = avg_pool_2x(x)
    x = _conv_act(x, p["conv1"], slope)
    x = _conv_act(x, p["conv2"], slope)
    return x


def _up(x: torch.Tensor, skip: torch.Tensor, p: Params, slope: float) -> torch.Tensor:
    x = upsample_2x_bilinear(x)
    x = _conv_act(x, p["conv1"], slope)
    x = _conv_act(torch.cat([x, skip], dim=-1), p["conv2"], slope)
    return x


def unet_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Apply one U-Net. x: (B, H, W, in_ch), H and W divisible by 16; runs
    on the device and in the dtype of ``x``."""
    s = cfg.leaky_slope
    x = _conv_act(x, p["conv1"], s)
    s1 = _conv_act(x, p["conv2"], s)
    s2 = _down(s1, p["down1"], s)
    s3 = _down(s2, p["down2"], s)
    s4 = _down(s3, p["down3"], s)
    x = _down(s4, p["down4"], s)
    x = _up(x, s4, p["up1"], s)
    x = _up(x, s3, p["up2"], s)
    x = _up(x, s2, p["up3"], s)
    x = _up(x, s1, p["up4"], s)
    return _conv(x, p["conv3"])


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
#   u3c1, u4c1                  conv_up_f_packed   (W-upsample folded)
#   head                        conv_packed, no activation
#
# The pools before d3c1 and d4c1 and the upsample before u1c1 are plain
# PyTorch ops, as the JAX package materialises those three itself.
# ---------------------------------------------------------------------------


def packed_branch_flags(h: int, w: int, cfg: ModelConfig):
    """The branch configuration of :func:`unet_apply_packed`, in the JAX
    package's order: (l2_kernel, l3_kernel, fuse_d1, fuse_d2, fuse_u3,
    fuse_u4, l4_kernel, fuse_u2); fuse_u3/fuse_u4 are 2 for the folded
    kernel and 0 otherwise. The kernels have no gate on H, W or M, so ``h``
    and ``w`` do not enter: the flags depend on the channel widths and kernel
    sizes only."""
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
    return (
        l2_kernel, l3_kernel,
        supports_pool(w1, k[0], w2), supports_pool(w2, k[1], w3),
        2 if supports_up_f(w3, 3, w2) else 0,
        2 if supports_up_f(w2, 3, w1) else 0,
        l4_kernel, supports_up_m(w4, 3, w3),
    )


def packed_supported(h: int, w: int, cfg: ModelConfig) -> bool:
    """Whether :func:`unet_apply_packed` applies to this shape and config:
    the /16 grid and a kernel at every one of the 19 sites. A shape or
    config it rejects takes the plain path in ``models.rrin.forward``."""
    flags = packed_branch_flags(h, w, cfg)
    return h % 16 == 0 and w % 16 == 0 and all(
        f == (2 if i in (4, 5) else True) for i, f in enumerate(flags))


def packed_bf16_supported(w: int) -> bool:
    """The JAX package bounds the bfloat16 packed kernels by frame width
    (their windows must fit the TPU's scoped memory). The tiles of the CUDA
    kernels do not grow with the frame, so every width is supported."""
    return True


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
    of ``x`` (bfloat16 on the card; float32 only on the CPU, through the
    kernels' plain versions).

    ``absmax`` (int8 from calibration stats) and ``prep``/``collect``
    (prepare-once weight constants) are not ported yet and raise
    ``NotImplementedError``.
    """
    if absmax is not None:
        raise NotImplementedError(
            "absmax= (the int8 packed path) is not ported yet: ROADMAP.md "
            "Queue A item 2, 'int8'")
    if prep is not None or collect is not None:
        raise NotImplementedError(
            "prep=/collect= (prepare-once packed params) are not ported yet: "
            "ROADMAP.md Queue A item 3, 'Prepare-once params'")
    _, h, w, _ = x.shape
    if not packed_supported(h, w, cfg):
        raise ValueError(
            f"unet_apply_packed does not apply to {h}x{w} with {cfg}: check "
            "packed_supported first")
    s = cfg.leaky_slope

    def conv(parts, prm, slope=s):
        return conv_packed(parts, prm["w"], prm["b"], slope)

    t = conv([x.contiguous()], p["conv1"])
    s1 = conv([t], p["conv2"])
    t = conv_pool_packed(s1, p["down1"]["conv1"]["w"], p["down1"]["conv1"]["b"], s)
    s2 = conv([t], p["down1"]["conv2"])
    t = conv_pool_packed(s2, p["down2"]["conv1"]["w"], p["down2"]["conv1"]["b"], s)
    s3 = conv([t], p["down2"]["conv2"])
    t = conv([avg_pool_2x(s3)], p["down3"]["conv1"])
    s4 = conv([t], p["down3"]["conv2"])
    t = conv([avg_pool_2x(s4)], p["down4"]["conv1"])
    t = conv([t], p["down4"]["conv2"])
    t = conv([upsample_2x_bilinear(t)], p["up1"]["conv1"])
    t = conv([t, s4], p["up1"]["conv2"])
    t = conv_up_m_packed(t, p["up2"]["conv1"]["w"], p["up2"]["conv1"]["b"], s)
    t = conv([t, s3], p["up2"]["conv2"])
    t = conv_up_f_packed(t, p["up3"]["conv1"]["w"], p["up3"]["conv1"]["b"], s)
    t = conv([t, s2], p["up3"]["conv2"])
    t = conv_up_f_packed(t, p["up4"]["conv1"]["w"], p["up4"]["conv1"]["b"], s)
    t = conv([t, s1], p["up4"]["conv2"])
    return conv([t], p["conv3"], slope=None)
