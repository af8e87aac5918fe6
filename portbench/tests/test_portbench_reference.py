"""The plain float32 reference against the program's plain CPU path at 64x96
(with 8 rows of replicate padding at 56x96)."""

import numpy as np
import torch

from portbench import frames, weights
from portbench.reference import rrin as ref
from portbench.tests.util import cpu, tiny


def _setup(h, w, seed=5):
    parts = tiny("bf16-1080p-x2", h, w)
    cfg = parts["config"]
    dev = cpu()
    pairs = frames.pairs(seed, 2, h, w, dev)
    wts = weights.make(seed, cfg["model"], cfg["weights"], pairs[:1], dev)
    return cfg, wts, pairs


def test_cascade_matches_program_plain_float32():
    from rrin_tpu_torch import forward

    cfg, wts, pairs = _setup(64, 96)
    i0, i1 = ref._frames(torch.from_numpy(pairs), 16)
    with torch.no_grad():
        want = ref.cascade(wts, i0, i1, 0.5, cfg["model"])
        got = forward(wts, i0.permute(0, 2, 3, 1), i1.permute(0, 2, 3, 1), 0.5,
                      compute_dtype=torch.float32, use_pallas=False, packed=False,
                      device="cpu")
    assert torch.allclose(got.permute(0, 3, 1, 2), want, atol=2e-5, rtol=0)


def test_interpolate_matches_program_uint8_with_padding():
    from rrin_tpu_torch.pipeline import Interpolator

    cfg, wts, pairs = _setup(56, 96)
    want = ref.interpolate(wts, torch.from_numpy(pairs), cfg["model"]).numpy()
    it = Interpolator(wts, compute_dtype="float32", device="cpu")
    got = it.step(pairs).numpy()
    assert got.shape == want.shape == (2, 1, 56, 96, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_quantised_control_departs():
    cfg, wts, pairs = _setup(64, 96)
    x = torch.from_numpy(pairs)
    want = ref.interpolate(wts, x, cfg["model"]).numpy()
    ranges = ref.calibrate(wts, x[:1], cfg["model"], 1.2)
    assert len(ranges) == 4 * 22  # 18 convs a U-Net, four of them with a skip operand
    got = ref.interpolate(wts, x, cfg["model"], ranges=ranges, bits=4).numpy()
    assert (np.abs(got.astype(int) - want.astype(int)) >= 2).mean() > 0.05
