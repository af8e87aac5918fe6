"""The shared U-Net encoder-decoder (plain path).

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
(the JAX package's layout). Every conv goes through
``ops.conv_phase.conv2d_fused``, which sends the low-channel bfloat16 sites
to the hand-written CUDA kernel and the rest to ``F.conv2d``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
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
