"""The port's PSNR and SSIM against the JAX package's on the same numpy
frames, and the module's public names and signatures."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu import metrics as jmetrics
from rrin_tpu_torch import metrics as tmetrics
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

# float32 on both sides, another summation order: 1e-4 dB of PSNR, 1e-5 of
# SSIM (a mean of per-pixel ratios near 1).
PSNR_DB_TOL = 1e-4
SSIM_TOL = 1e-5


def _pair(shape, noise):
    rng = fresh_rng()
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0.0, noise, shape).astype(np.float32), 0.0, 1.0)
    return a, b


@pytest.mark.parametrize("shape,noise,max_val", [
    ((2, 48, 64, 3), 0.05, 1.0),
    ((3, 23, 31, 1), 0.2, 1.0),
    ((1, 40, 60, 3), 0.02, 255.0),
])
def test_psnr_ssim_match_reference(shape, noise, max_val):
    a, b = _pair(shape, noise)
    a, b = a * max_val, b * max_val
    want_p = np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), max_val))
    want_s = np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), max_val=max_val))
    got_p = tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b), max_val).numpy()
    got_s = tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b), max_val=max_val).numpy()
    assert got_p.shape == got_s.shape == (shape[0],)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PSNR_DB_TOL)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=SSIM_TOL)


def test_identical_frames():
    a, _ = _pair((2, 32, 32, 3), 0.0)
    t = torch.from_numpy(a)
    np.testing.assert_allclose(tmetrics.ssim(t, t).numpy(), 1.0, atol=SSIM_TOL)
    # the 1e-12 floor on the MSE: 120 dB, as the reference caps it
    np.testing.assert_allclose(tmetrics.psnr(t, t).numpy(), 120.0, atol=PSNR_DB_TOL)


def test_bfloat16_and_uint8_inputs_score_in_float32():
    """Inputs of another dtype are scored in float32, as the reference casts
    them: a bf16 prediction against a float32 target."""
    a, b = _pair((1, 24, 24, 3), 0.1)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    want = np.asarray(jmetrics.ssim(jnp.asarray(a16.float().numpy()), jnp.asarray(b)))
    got = tmetrics.ssim(a16, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SSIM_TOL)


def test_public_names_and_signatures():
    for name in ("psnr", "ssim"):
        ref = inspect.signature(getattr(jmetrics, name))
        got = inspect.signature(getattr(tmetrics, name))
        assert list(got.parameters) == list(ref.parameters), name
        assert [p.default for p in got.parameters.values()] == \
            [p.default for p in ref.parameters.values()], name
