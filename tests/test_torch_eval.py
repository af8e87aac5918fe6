"""The port's triplet evaluation harness (``eval.py``) against the JAX
package's on the same weights and PNG triplets, and its checks and CLI."""

import inspect
import json

import jax
import numpy as np
import pytest
import torch

from rrin_tpu import eval as jeval
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.params import save_params
from rrin_tpu_torch import eval as teval
from rrin_tpu_torch.params import load_params
from torch_packed_util import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

# Per-triplet bars of float32 eval against float32 eval: the reference's
# float32 frame bar (2e-4, tests/test_parity.py) moves a PSNR near 30 dB by
# far less than 0.05 dB and an SSIM by far less than 5e-4. Measured at
# 48x64: 0.0 and 0.0 on each triplet, at the report's rounding (4 and 5
# places).
PSNR_DB_TOL = 0.05
SSIM_TOL = 5e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three 48x64 triplets, the JAX package's random weights as a file, and
    the reference's float32 plain-path report on them."""
    root = tmp_path_factory.mktemp("trips")
    dirs = jeval.synthesize_triplets(str(root), count=3, hw=(48, 64), seed=11)
    ckpt = str(root / "w.npz")
    jp = jrrin.init_params(jax.random.key(3))
    save_params(ckpt, jp)
    want = jeval.evaluate(jp, dirs, batch_size=2, compute_dtype="float32")
    return {"root": str(root), "dirs": dirs, "ckpt": ckpt, "want": want,
            "params": load_params(ckpt, device="cpu")}


def test_evaluate_matches_reference(setup):
    got = teval.evaluate(setup["params"], setup["dirs"], batch_size=2,
                         compute_dtype="float32", device="cpu")
    want = setup["want"]
    assert got["count"] == want["count"] == 3
    for g, w in zip(got["per_triplet"], want["per_triplet"]):
        assert g["dir"] == w["dir"]
        assert abs(g["psnr"] - w["psnr"]) <= PSNR_DB_TOL, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= SSIM_TOL, (g, w)
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= PSNR_DB_TOL
    assert set(got) == set(want)


def test_int8_calibrates_per_group_and_preset_only_under_int8(setup, monkeypatch):
    """int8 on the packed path: one calibration per resolution group; a
    preset is used only under int8 (without it the float path is scored)."""
    import rrin_tpu_torch.models.rrin as trrin

    calls = []
    real = trrin.forward_calibrate

    def spy(*a, **kw):
        calls.append(kw.get("quantile"))
        return real(*a, **kw)

    monkeypatch.setattr(trrin, "forward_calibrate", spy)
    p = setup["params"]
    q8 = teval.evaluate(p, setup["dirs"], batch_size=2, compute_dtype="bfloat16",
                        use_pallas=True, int8=True, int8_percentile=99.9, device="cpu")
    assert calls == [99.9 / 100.0] and q8["count"] == 3
    f32 = teval.evaluate(p, setup["dirs"][:1], batch_size=1, device="cpu")
    preset = {"flow": {"d1c1": torch.tensor(1e-6)}}  # would ruin an int8 run
    same = teval.evaluate(p, setup["dirs"][:1], batch_size=1, quant_stats=preset,
                          device="cpu")
    assert same["per_triplet"] == f32["per_triplet"] and len(calls) == 1


def test_percentile_bound_and_device_default(setup):
    for bad in (0.999, 50.0, 100.5):
        with pytest.raises(ValueError, match=r"\(50, 100\]"):
            teval.evaluate(setup["params"], setup["dirs"], int8=True, int8_percentile=bad,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            teval.evaluate(setup["params"], setup["dirs"])


def test_main_scores_and_reports(setup, tmp_path, capsys):
    report = str(tmp_path / "r.json")
    assert teval.main(["--data", setup["root"], "--ckpt", setup["ckpt"], "--fp32",
                       "--no-pallas", "--batch", "2", "--device", "cpu",
                       "--report", report]) == 0
    summary = json.loads(capsys.readouterr().out)
    with open(report) as f:
        full = json.load(f)
    assert summary["count"] == 3 and "per_triplet" not in summary
    assert abs(full["psnr_mean"] - setup["want"]["psnr_mean"]) <= PSNR_DB_TOL
    assert teval.main(["--data", str(tmp_path), "--device", "cpu"]) == 2
    assert "no im1/im2/im3 triplets" in capsys.readouterr().err
    assert teval.main(["--synthesize", "1", "--data", str(tmp_path / "s")]) == 0
    assert len(teval.find_triplets(str(tmp_path / "s"))) == 1


def test_public_names_and_signatures():
    for name in ("find_triplets", "image_hw", "load_triplet", "synthesize_triplets",
                 "evaluate", "main"):
        ref = inspect.signature(getattr(jeval, name)).parameters
        got = inspect.signature(getattr(teval, name)).parameters
        extra = ["device"] if name == "evaluate" else []
        assert list(got) == list(ref) + extra, name
        assert [got[k].default for k in ref] == [ref[k].default for k in ref], name
    assert teval.FRAME_NAMES == jeval.FRAME_NAMES
