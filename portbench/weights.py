"""The benchmark's own weights for the RRIN cascade, made from ``--seed``.

Every conv's weight and bias are drawn from one normal draw on the device
(one ``torch.randn`` by a generator seeded with the run's seed), in the
layout the program takes: per U-Net a nested dict of HWIO float32 weights
and biases. The scales are the configuration's ``weights`` entry:

- a conv followed by the LeakyReLU has the std ``gain / sqrt(fan_in)``, with
  ``gain = sqrt(2 / (1 + slope^2))`` (He's init), so that activations keep
  their size through the 18 convs of a U-Net as in a trained network;
- biases have the std ``bias``;
- each head (the U-Net's last conv, no activation) is drawn at the std
  ``1 / sqrt(fan_in)`` and then scaled, weight and bias alike, so that its
  output on the run's first frame pair has the root mean square
  ``head_rms[name]`` (flow in pixels, refined flow, mask logits, residual
  on a 0-1 scale). A random U-Net's output size swings from seed to seed
  (flows of 0.2 to 3.3 px r.m.s. at 1080p), and with it how far a rounding
  error in the flow moves a sample across an edge; fixing each head's size
  gives every seed work of one difficulty.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import rrin as ref
from portbench.reference.rrin import UNETS


def conv_shapes(model: dict, cin: int, cout: int) -> List[Tuple[tuple, int, int, int, bool]]:
    """(params path, k, cin, cout, activated) of one U-Net's 19 convs, in the
    program's params layout."""
    w1, w2, w3, w4, w5 = (model["base_width"] << i for i in range(5))
    k = model["down_kernels"]
    sk = model["stem_kernel"]
    out = [(("conv1",), sk, cin, w1, True), (("conv2",), sk, w1, w1, True)]
    for i, (a, b) in enumerate(((w1, w2), (w2, w3), (w3, w4), (w4, w5)), start=1):
        out += [((f"down{i}", "conv1"), k[i - 1], a, b, True),
                ((f"down{i}", "conv2"), k[i - 1], b, b, True)]
    for i, (a, b) in enumerate(((w5, w4), (w4, w3), (w3, w2), (w2, w1)), start=1):
        out += [((f"up{i}", "conv1"), 3, a, b, True), ((f"up{i}", "conv2"), 3, 2 * b, b, True)]
    out.append((("conv3",), 3, w1, cout, False))
    return out


def make(seed: int, model: dict, scales: dict, pair: np.ndarray,
         device: torch.device) -> Dict[str, dict]:
    """The cascade's weights from ``seed``: one draw on ``device``, cut into
    views and scaled in place, the heads to their output sizes on ``pair``
    (one uint8 frame pair, (1, 2, H, W, 3))."""
    gain = math.sqrt(2.0 / (1.0 + model["leaky_slope"] ** 2))
    plan = []
    n = 0
    for name, cin, cout in UNETS:
        for path, k, a, b, act in conv_shapes(model, cin, cout):
            std = (gain if act else 1.0) / math.sqrt(k * k * a)
            plan.append((name, path, (k, k, a, b), std))
            n += k * k * a * b + b
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, dict] = {name: {} for name, _, _ in UNETS}
    at = 0
    for name, path, shape, std in plan:
        size = math.prod(shape)
        w = flat[at:at + size].view(shape).mul_(std)
        b = flat[at + size:at + size + shape[3]].mul_(scales["bias"])
        at += size + shape[3]
        node = out[name]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {"w": w, "b": b}
    scale_heads(out, pair, model, scales["head_rms"], device)
    return out


def scale_heads(w: Dict[str, dict], pair: np.ndarray, model: dict, head_rms: dict,
                device: torch.device) -> None:
    """Scale each U-Net's head in place, in the cascade's order, so that its
    output on ``pair`` at t = 0.5 has the r.m.s. ``head_rms[name]``: one
    float32 pass of the reference, without TF32."""

    def hook(name, y):
        s = head_rms[name] / float(y.pow(2).mean().sqrt())
        head = w[name]["conv3"]
        head["w"].mul_(s)
        head["b"].mul_(s)
        return y.mul_(s)

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    ref.no_tf32()
    try:
        i0, i1 = ref._frames(torch.from_numpy(pair).to(device), model["pad_multiple"])
        with torch.no_grad():
            ref.cascade(w, i0, i1, 0.5, model, head_hook=hook)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    if device.type == "cuda":
        torch.cuda.empty_cache()
