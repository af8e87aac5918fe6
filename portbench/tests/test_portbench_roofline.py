"""The operations and bounds counted from the shapes alone."""

import json

import pytest

from portbench import roofline, spec

MODEL = spec.cell("bf16-1080p-x2")["config"]["model"]


def test_flow_unet_flops_at_1088x1920_by_hand():
    h, w = 1088, 1920
    # the 19 convs of the flow U-Net (6 -> 4): output size, k, cin, cout
    convs = [
        (h, w, 7, 6, 32), (h, w, 7, 32, 32),
        (h // 2, w // 2, 5, 32, 64), (h // 2, w // 2, 5, 64, 64),
        (h // 4, w // 4, 3, 64, 128), (h // 4, w // 4, 3, 128, 128),
        (h // 8, w // 8, 3, 128, 256), (h // 8, w // 8, 3, 256, 256),
        (h // 16, w // 16, 3, 256, 512), (h // 16, w // 16, 3, 512, 512),
        (h // 8, w // 8, 3, 512, 256), (h // 8, w // 8, 3, 512, 256),
        (h // 4, w // 4, 3, 256, 128), (h // 4, w // 4, 3, 256, 128),
        (h // 2, w // 2, 3, 128, 64), (h // 2, w // 2, 3, 128, 64),
        (h, w, 3, 64, 32), (h, w, 3, 64, 32),
        (h, w, 3, 32, 4),
    ]
    by_hand = sum(2.0 * a * b * k * k * ci * co for a, b, k, ci, co in convs)
    sites = roofline.unet_sites(MODEL, 6, 4, h, w)
    ours = sum(2.0 * s["h"] * s["w"] * s["k"] ** 2 * sum(s["cin"]) * s["cout"] for s in sites)
    assert len(sites) == 19 and ours == by_hand
    assert 1.15e12 < by_hand < 1.25e12


@pytest.mark.parametrize("name,traffic", [
    ("bf16-1080p-x2", None), ("int8-1080p-x2", None), ("bf16-4k-x2", None),
    ("bf16-1080p-x2", "vimeo-b8"),
])
def test_step_totals(name, traffic):
    parts = spec.cell(name)
    cfg, t = parts["config"], parts["traffic"]
    if traffic:
        with open(spec.HERE / "traffic" / f"{traffic}.json") as f:
            t = json.load(f)
    convs = roofline.step_convs(cfg, t)
    tot = roofline.step_totals(cfg, t)
    assert tot["convs"] == 76 * t["batch"]
    assert tot["bound_s"] >= tot["ops_s"] > 0
    heads = [c for c in convs if c["site"] == "head"]
    assert all(c["precision"] == "bfloat16" for c in heads)
    if cfg["precision"] == "int8":
        assert {c["precision"] for c in convs if c["site"] != "head"} == {"int8"}
    pair = 4.92e12 * (3840 * 2160 / (1920 * 1088) if t["height"] == 2160 else 1)
    if t["height"] in (1080, 2160):
        assert abs(tot["ops"] - pair) / pair < 0.02


def test_direct_and_cascade_runs():
    t = dict(exp=2, mode="direct", batch=2)
    assert roofline.unet_runs(t) == {"flow": 2, "refine": 6, "mask": 6, "final": 6}
    t["mode"] = "cascade"
    assert roofline.unet_runs(t) == {"flow": 6, "refine": 6, "mask": 6, "final": 6}
