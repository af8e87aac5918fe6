"""The int8 serving path on the CPU: ``Interpolator(int8=True)`` against the
JAX package's on the same weights and frames, the int8 cascade against the
float32 one, and when the Interpolator calibrates."""

import jax
import numpy as np
import pytest
import torch

from rrin_tpu import pipeline as jpipe
from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu_torch import ModelConfig, forward
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.models import rrin as trrin
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    jp = jrrin.init_params(jax.random.key(3), JConfig())
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _pairs(seed, h, w):
    base = np.random.default_rng(seed).integers(0, 256, (1, h, w + 8, 3), dtype=np.uint8)
    return np.stack([base[:, :, :w], base[:, :, 8:]], axis=1)


def _psnr_u8(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_interpolator_matches_jax(weights):
    """Both calibrate on the first batch (margin 1.2) and serve int8: 66.3 dB
    measured at 48x64, bar 40 dB (the bf16 bar across the two packages)."""
    jp, tp = weights
    pairs = _pairs(2, 48, 64)
    want = np.asarray(jpipe.Interpolator(jp, compute_dtype="float32", int8=True).step(pairs))
    it = tpipe.Interpolator(tp, compute_dtype="float32", int8=True, device="cpu")
    assert it.packed is True
    got = it.step(pairs).numpy()
    assert got.shape == want.shape == (1, 1, 48, 64, 3) and got.dtype == np.uint8
    assert _psnr_u8(got, want) >= 40.0


def test_int8_cascade_close_to_fp32(weights):
    """The JAX package's bar for its int8 cascade against float32: > 35 dB."""
    _, tp = weights
    rng = np.random.default_rng(8)
    i0 = rng.random((1, 48, 64, 3), dtype=np.float32)
    i1 = np.clip(np.roll(i0, 2, axis=1) + 0.03, 0, 1).astype(np.float32)
    _, stats = trrin.forward_calibrate(tp, i0, i1, device="cpu")
    stats = trrin.scale_quant_stats(stats, 1.2)
    ref = forward(tp, i0, i1, device="cpu").numpy()
    got = forward(tp, i0, i1, packed=True, quant_stats=stats, device="cpu").numpy()
    assert 10 * np.log10(1.0 / float(np.mean((got - ref) ** 2))) > 35.0


def test_calibrates_once_per_resolution_or_takes_preset(weights, monkeypatch):
    _, tp = weights
    calls = []
    real = tpipe.device_calibrate

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "device_calibrate", spy)
    it = tpipe.Interpolator(tp, compute_dtype="float32", int8=True, int8_margin=1.5,
                            device="cpu")
    a, b = _pairs(3, 32, 48), _pairs(4, 48, 64)
    first = it.step(a).numpy()
    it.step(_pairs(5, 32, 48))
    it.step(b)
    assert len(calls) == 2 and sorted(it._quant_stats) == [(32, 48), (48, 64)]
    raw = real(tp, a, compute_dtype=torch.float32, device="cpu")
    assert it._quant_stats[(32, 48)]["refine"]["u2c2"] == raw["refine"]["u2c2"] * 1.5
    # preset stats (margin already applied) skip the calibration pass
    preset = tpipe.Interpolator(tp, compute_dtype="float32", int8=True,
                                quant_stats=it._quant_stats[(32, 48)], device="cpu")
    assert np.array_equal(preset.step(a).numpy(), first) and len(calls) == 2
    with pytest.raises(ValueError, match="packed"):
        tpipe.Interpolator(tp, ModelConfig(stem_kernel=9), int8=True, device="cpu").step(a)
