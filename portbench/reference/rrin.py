"""The RRIN cascade in plain float32 PyTorch: the yardstick that decides
``correct``.

It imports nothing of the program under test. It takes the benchmark's raw
weights (the nested dict of HWIO float32 tensors that ``portbench.weights``
makes) and the benchmark's uint8 frame pairs, and works out everything else
itself, in NCHW with ``F.conv2d``, ``F.interpolate`` and ``F.grid_sample``.

The model (Li, Yuan, Wang, "Video Frame Interpolation via Residue
Refinement", ICASSP 2020; github.com/HopLee6/RRIN):

  flows = UNet_flow(I0 | I1)                         6 -> 4  (F01 | F10)
  Ft0 = -(1-t) t F01 + t^2 F10,  Ft1 = (1-t)^2 F01 - t (1-t) F10
  Ft  = (Ft0 | Ft1) + UNet_refine(Ft0 | Ft1 | I0 | I1)          10 -> 4
  g0, g1 = warp(I0, Ft[:2]), warp(I1, Ft[2:])     backward bilinear, zeros
  M = sigmoid(UNet_mask(Ft | I0 | I1 | g0 | g1))                16 -> 2
  w0 = (1-t) M0, w1 = t M1, coarse = (w0 g0 + w1 g1) / (w0 + w1 + eps)
  It = clamp(coarse + UNet_final(I0 | I1 | coarse), 0, 1)        9 -> 3

Each U-Net: two stem convs, four stages of 2x2 average pool and two convs,
four stages of 2x bilinear upsample, a conv, the skip concatenated after it
and a conv, then a 3x3 head without activation; LeakyReLU after every other
conv. One departure from the upstream code, kept because the program
follows it: the warp normalises the sample grid by S - 1, not by S.

Frames are replicate-padded on the bottom and right to the /16 grid,
interpolated, cropped and rounded half to even to uint8.

Two options round the arithmetic, for the number that decides ``correct``
and for the control of an int8 configuration (see ``portbench.judge``):

- ``ranges`` and ``bits``: every conv but the heads takes its operands and
  weights rounded to ``bits``-bit symmetric grids (activations per tensor,
  from ranges that :func:`calibrate` records on the same calibration pairs
  the program sees; weights per output channel);
- ``lowp``: every other conv operand and weight, and each U-Net's output,
  rounded to bfloat16, as a bfloat16 program stores them; the products are
  summed in float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

UNETS = (("flow", 6, 4), ("refine", 10, 4), ("mask", 16, 2), ("final", 9, 3))


def _conv_params(p: dict) -> tuple:
    """HWIO weight and bias -> OIHW float32, the padding of a 'same' conv."""
    w = p["w"].float().permute(3, 2, 0, 1).contiguous()
    return w, p["b"].float(), w.shape[-1] // 2


def _fake_quant(x: torch.Tensor, r: torch.Tensor, bits: int) -> torch.Tensor:
    q = float(2 ** (bits - 1) - 1)
    s = torch.clamp(r, min=1e-12) / q
    return torch.clamp(torch.round(x / s), -q, q) * s


def _fake_quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    q = float(2 ** (bits - 1) - 1)
    s = torch.clamp(w.abs().amax(dim=(1, 2, 3), keepdim=True), min=1e-12) / q
    return torch.clamp(torch.round(w / s), -q, q) * s


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class _Sites:
    """What one U-Net's convs do with their operands: nothing, record their
    |x| maxima (``stats``) or round them (``ranges`` and ``bits``; ``lowp``)."""

    def __init__(self, prefix: str, stats=None, ranges=None, bits: int = 0,
                 lowp: bool = False):
        self.prefix, self.stats, self.ranges, self.bits = prefix, stats, ranges, bits
        self.lowp = lowp

    def conv(self, site: str, p: dict, ops: Sequence[torch.Tensor], slope) -> torch.Tensor:
        w, b, pad = _conv_params(p)
        if site != "head":
            for i, o in enumerate(ops):
                key = f"{self.prefix}/{site}/{i}"
                if self.stats is not None:
                    m = o.abs().amax()
                    self.stats[key] = m if key not in self.stats else torch.maximum(
                        self.stats[key], m)
            if self.ranges is not None:
                ops = [_fake_quant(o, self.ranges[f"{self.prefix}/{site}/{i}"], self.bits)
                       for i, o in enumerate(ops)]
                w = _fake_quant_weight(w, self.bits)
        if self.lowp and (site == "head" or self.ranges is None):
            ops, w = [_bf16(o) for o in ops], _bf16(w)
        x = ops[0] if len(ops) == 1 else torch.cat(list(ops), dim=1)
        y = F.conv2d(x, w, b, padding=pad)
        if slope is None:
            return _bf16(y) if self.lowp else y
        return F.leaky_relu(y, slope)


def unet(p: dict, x: torch.Tensor, slope: float, sites: _Sites) -> torch.Tensor:
    """One U-Net on NCHW float32."""

    def down(i, t):
        t = sites.conv(f"d{i}c1", p[f"down{i}"]["conv1"], [F.avg_pool2d(t, 2)], slope)
        return sites.conv(f"d{i}c2", p[f"down{i}"]["conv2"], [t], slope)

    def up(i, t, skip):
        t = F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)
        t = sites.conv(f"u{i}c1", p[f"up{i}"]["conv1"], [t], slope)
        return sites.conv(f"u{i}c2", p[f"up{i}"]["conv2"], [t, skip], slope)

    t = sites.conv("c1", p["conv1"], [x], slope)
    s1 = sites.conv("c2", p["conv2"], [t], slope)
    s2 = down(1, s1)
    s3 = down(2, s2)
    s4 = down(3, s3)
    t = down(4, s4)
    t = up(1, t, s4)
    t = up(2, t, s3)
    t = up(3, t, s2)
    t = up(4, t, s1)
    return sites.conv("head", p["conv3"], [t], None)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward bilinear warp of NCHW ``img`` by the (dx, dy) ``flow``;
    taps outside the frame count zero."""
    _, _, h, w = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    gx = 2.0 * (xs + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / max(h - 1, 1) - 1.0
    return F.grid_sample(img, torch.stack([gx, gy], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def cascade(weights: dict, i0: torch.Tensor, i1: torch.Tensor, t: float, model: dict,
            stats=None, ranges=None, bits: int = 0, lowp: bool = False,
            head_hook=None) -> torch.Tensor:
    """The interpolated frame at ``t`` of NCHW float32 frames on the /16 grid.
    ``head_hook(name, y)``, where given, sees each U-Net's output ``y`` and
    returns the one the cascade goes on with."""
    slope = model["leaky_slope"]

    def run(name, *feats):
        y = unet(weights[name], torch.cat(feats, dim=1), slope,
                 _Sites(name, stats, ranges, bits, lowp))
        return y if head_hook is None else head_hook(name, y)

    flows = run("flow", i0, i1)
    f01, f10 = flows[:, :2], flows[:, 2:]
    ft0 = -(1.0 - t) * t * f01 + t * t * f10
    ft1 = (1.0 - t) * (1.0 - t) * f01 - t * (1.0 - t) * f10
    ft = torch.cat([ft0, ft1], dim=1) + run("refine", ft0, ft1, i0, i1)
    g0, g1 = warp(i0, ft[:, :2]), warp(i1, ft[:, 2:])
    m = torch.sigmoid(run("mask", ft, i0, i1, g0, g1))
    w0, w1 = (1.0 - t) * m[:, 0:1], t * m[:, 1:2]
    coarse = (w0 * g0 + w1 * g1) / (w0 + w1 + model["blend_eps"])
    return torch.clamp(coarse + run("final", i0, i1, coarse), 0.0, 1.0)


def _frames(pairs_u8: torch.Tensor, multiple: int) -> tuple:
    """(B, 2, H, W, 3) uint8 -> the two NCHW float32 frames, padded."""
    _, _, h, w, _ = pairs_u8.shape
    x = pairs_u8.float().div(255.0).permute(0, 1, 4, 2, 3)
    ph, pw = -h % multiple, -w % multiple
    i0, i1 = x[:, 0], x[:, 1]
    if ph or pw:
        i0 = F.pad(i0, (0, pw, 0, ph), mode="replicate")
        i1 = F.pad(i1, (0, pw, 0, ph), mode="replicate")
    return i0, i1


def interpolate(weights: dict, pairs_u8: torch.Tensor, model: dict, exp: int = 1,
                mode: str = "direct", ranges=None, bits: int = 0,
                lowp: bool = False) -> torch.Tensor:
    """(B, 2, H, W, 3) uint8 pairs -> (B, 2^exp - 1, H, W, 3) uint8 frames
    between them: at t = j / 2^exp each (``direct``), or by midpoints of
    midpoints (``cascade``)."""
    _, _, h, w, _ = pairs_u8.shape
    i0, i1 = _frames(pairs_u8, model["pad_multiple"])
    m = (1 << exp) - 1
    with torch.no_grad():
        if mode == "direct" or exp == 1:
            mids = [cascade(weights, i0, i1, (j + 1) / (1 << exp), model, ranges=ranges,
                            bits=bits, lowp=lowp) for j in range(m)]
        elif mode == "cascade":
            frames: List[torch.Tensor] = [i0, i1]
            for _ in range(exp):
                nxt = [frames[0]]
                for a, b in zip(frames[:-1], frames[1:]):
                    nxt += [cascade(weights, a, b, 0.5, model, ranges=ranges, bits=bits,
                                    lowp=lowp), b]
                frames = nxt
            mids = frames[1:-1]
        else:
            raise ValueError(f"unknown mode {mode!r}")
    out = torch.stack(mids, dim=1)[..., :h, :w]          # (B, m, 3, H, W)
    return torch.round(out * 255.0).to(torch.uint8).permute(0, 1, 3, 4, 2)


def calibrate(weights: dict, pairs_u8: torch.Tensor, model: dict,
              margin: float) -> Dict[str, torch.Tensor]:
    """Every conv operand's |x| maximum over the cascade at t = 0.5 on
    ``pairs_u8``, times ``margin``: the ranges of the quantised control."""
    i0, i1 = _frames(pairs_u8, model["pad_multiple"])
    stats: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        cascade(weights, i0, i1, 0.5, model, stats=stats)
    return {k: v * margin for k, v in stats.items()}


def no_tf32() -> None:
    """float32 products in float32: no TF32 in matrix products or convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


__all__ = ["UNETS", "calibrate", "cascade", "interpolate", "no_tf32", "unet", "warp"]
