"""The port's synthetic triplet feed (``data.synthetic``) and the PNG
triplets of ``eval.synthesize_triplets`` against the JAX package's."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu import eval as jeval
from rrin_tpu.data import synthetic as jsyn
from rrin_tpu_torch import data as tdata
from rrin_tpu_torch import eval as teval
from rrin_tpu_torch.data import synthetic as tsyn
from torch_packed_util import one_torch_thread  # noqa: F401

# float32 bilinear resize and warp on both sides.
TOL = 1e-5


def _reference_draws(key, batch, hw, max_shift=6.0, cells=8):
    """The noise and shifts the JAX package's ``synthetic_triplet_batch``
    draws from ``key`` (its own split and calls)."""
    h, w = hw
    kt, km = jax.random.split(key)
    base = jax.random.uniform(kt, (batch, 2 * h // cells, 2 * w // cells, 3), jnp.float32)
    d = jax.random.uniform(km, (batch, 2), jnp.float32, -max_shift, max_shift)
    return np.array(base), np.array(d)


@pytest.mark.parametrize("hw,seed", [((48, 64), 0), ((50, 72), 1), ((40, 60), 2)])
def test_triplets_from_noise_matches_reference(hw, seed):
    """(50, 72) upsamples the noise by 100/12 and 144/18, scales that are
    not integers."""
    key = jax.random.key(seed)
    base, d = _reference_draws(key, 2, hw)
    want = jsyn.synthetic_triplet_batch(key, 2, hw)
    got = tsyn.triplets_from_noise(torch.from_numpy(base), torch.from_numpy(d), hw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, hw[0], hw[1], 3) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_batch_from_generator():
    """Drawn from the generator: the same seed gives the same triplets, the
    frames lie in [0, 1], and i0 -> gt -> i1 is one linear motion."""
    a = tdata.synthetic_triplet_batch(torch.Generator().manual_seed(3), 3, (32, 48),
                                      device="cpu")
    b = tdata.synthetic_triplet_batch(torch.Generator().manual_seed(3), 3, (32, 48),
                                      device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert x.shape == (3, 32, 48, 3) and float(x.min()) >= 0 and float(x.max()) <= 1
    c = tdata.synthetic_triplet_batch(torch.Generator().manual_seed(4), 3, (32, 48),
                                      device="cpu")
    assert not torch.equal(a[1], c[1])
    # the middle frame is not either end frame (a motion happened)
    assert float((a[1] - a[0]).abs().mean()) > 1e-3
    assert float((a[1] - a[2]).abs().mean()) > 1e-3


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tdata.synthetic_triplet_batch(torch.Generator().manual_seed(0), 1, (32, 32))


def test_signature_is_the_reference_with_a_generator():
    ref = list(inspect.signature(jsyn.synthetic_triplet_batch).parameters)
    got = list(inspect.signature(tsyn.synthetic_triplet_batch).parameters)
    assert got == ["gen"] + ref[1:] + ["device"]
    assert tdata.__all__ == ["synthetic_triplet_batch"]


def test_synthesize_triplets_pngs_byte_equal(tmp_path):
    """Same seed, same PNG bytes: both packages make their eval triplets with
    one numpy generator and OpenCV."""
    pytest.importorskip("cv2")
    ja = jeval.synthesize_triplets(str(tmp_path / "jax"), count=2, hw=(48, 64), seed=7)
    ta = teval.synthesize_triplets(str(tmp_path / "torch"), count=2, hw=(48, 64), seed=7)
    assert [os.path.basename(p) for p in ja] == [os.path.basename(p) for p in ta]
    for dj, dt in zip(ja, ta):
        for name in teval.FRAME_NAMES:
            with open(os.path.join(dj, name), "rb") as fj, \
                    open(os.path.join(dt, name), "rb") as ft:
                assert fj.read() == ft.read(), (dt, name)
    assert teval.find_triplets(str(tmp_path / "torch")) == ta
    assert teval.image_hw(os.path.join(ta[0], "im1.png")) == \
        jeval.image_hw(os.path.join(ja[0], "im1.png")) == (48, 64)
