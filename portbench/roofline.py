"""Operations, bytes and the least time of every conv a step runs, from the
configuration's shapes and the traffic's frame size alone.

The arithmetic is that of the repository's chip smoke script: a conv of
``cin`` to ``cout`` channels, ``k`` x ``k`` taps, at an output of ``h`` x
``w`` does ``2 h w k^2 cin cout`` operations; its bytes are each operand
read once, the weights, the float32 bias and the output written once; its
least time is the larger of operations over the peak of the precision it
runs in and bytes over the memory bandwidth. An operand is counted at the
lower of its stored resolution and the conv's (a pooled input at the pooled
size, an upsampled one before the upsample), so that no kernel that fuses
or materialises a resample can beat the bound. The count is fixed by the
shapes, whatever kernel computes them.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference.rrin import UNETS

# Published peaks of one H100 SXM (dense), as the chip smoke script states them.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {
    "bfloat16": 989e12,
    "int8": 1979e12,
    # float32-accurate products: three TF32 products each, a third of 495 TFLOP/s
    "float32": 495e12 / 3,
}
BYTES = {"bfloat16": 2, "int8": 1, "float32": 4}


def padded(size: int, multiple: int) -> int:
    return -(-size // multiple) * multiple


def unet_sites(model: dict, cin: int, cout: int, h: int, w: int) -> List[dict]:
    """One U-Net's 19 convs at a padded ``h`` x ``w`` frame: site, k, output
    size, operand channels and the scale of each operand as counted (1 its
    conv's resolution, 1/2 a pooled or 2 an upsampled one stored at the
    other side of the resample, counted at the lower)."""
    w1, w2, w3, w4, w5 = (model["base_width"] << i for i in range(5))
    k = model["down_kernels"]
    sk = model["stem_kernel"]
    sites = [("c1", sk, 1, [cin], w1), ("c2", sk, 1, [w1], w1)]
    for i, (a, b) in enumerate(((w1, w2), (w2, w3), (w3, w4), (w4, w5)), start=1):
        sites += [(f"d{i}c1", k[i - 1], 2 ** i, [a], b), (f"d{i}c2", k[i - 1], 2 ** i, [b], b)]
    for i, (a, b) in enumerate(((w5, w4), (w4, w3), (w3, w2), (w2, w1)), start=1):
        div = 2 ** (4 - i)
        sites += [(f"u{i}c1", 3, div, [a], b), (f"u{i}c2", 3, div, [b, b], b)]
    sites.append(("head", 3, 1, [w1], cout))
    out = []
    for site, kk, div, cins, co in sites:
        ho, wo = h // div, w // div
        # the one operand of u*c1 lies at half the conv's resolution
        in_px = ho * wo // 4 if site.startswith("u") and site.endswith("c1") else ho * wo
        out.append({"site": site, "k": kk, "h": ho, "w": wo, "cin": cins, "cout": co,
                    "in_px": in_px})
    return out


def unet_runs(traffic: dict) -> Dict[str, int]:
    """How often each U-Net runs in one step of the traffic: per pair, the
    flow U-Net once and the others once per mid (``direct``), or the whole
    cascade once per mid (``cascade``)."""
    m = (1 << traffic["exp"]) - 1
    b = traffic["batch"]
    if m == 1 or traffic["mode"] == "cascade":
        return {name: b * m for name, _, _ in UNETS}
    return {name: b * (1 if name == "flow" else m) for name, _, _ in UNETS}


def step_convs(config: dict, traffic: dict) -> List[dict]:
    """Every conv of one step, with its count a step, operations, bytes,
    precision and least seconds."""
    model = config["model"]
    h = padded(traffic["height"], model["pad_multiple"])
    w = padded(traffic["width"], model["pad_multiple"])
    runs = unet_runs(traffic)
    out = []
    for name, cin, cout in UNETS:
        for s in unet_sites(model, cin, cout, h, w):
            prec = config["precision"]
            if prec == "int8" and s["site"] == "head":
                prec = config["head_precision"]
            e = BYTES[prec]
            ops = 2.0 * s["h"] * s["w"] * s["k"] ** 2 * sum(s["cin"]) * s["cout"]
            nbytes = (s["in_px"] * sum(s["cin"]) * e + s["h"] * s["w"] * s["cout"] * e
                      + s["k"] ** 2 * sum(s["cin"]) * s["cout"] * e + s["cout"] * 4)
            t_ops, t_bytes = ops / PEAK_OPS[prec], nbytes / HBM_BYTES_PER_S
            out.append(dict(s, unet=name, count=runs[name], precision=prec, ops=ops,
                            bytes=nbytes, ops_s=t_ops, bound_s=max(t_ops, t_bytes),
                            bound_by="operations" if t_ops >= t_bytes else "bytes"))
    return out


def step_totals(config: dict, traffic: dict) -> Dict[str, float]:
    """A step's operations, its least conv seconds, and its convs' seconds
    at the peak of their precision (what ``step_mfu`` divides by the time a
    step took)."""
    convs = step_convs(config, traffic)
    return {
        "ops": sum(c["ops"] * c["count"] for c in convs),
        "bound_s": sum(c["bound_s"] * c["count"] for c in convs),
        "ops_s": sum(c["ops_s"] * c["count"] for c in convs),
        "convs": sum(c["count"] for c in convs),
    }
