"""A ``ModelConfig(stem_kernel=9)`` cascade, the configuration whose stems
take K1 at k 9 (on the card the Hopper core's streamed mode): K1's plain
version at k 9 against the JAX package's kernel in interpret mode, the
cascade in float32 and bf16 against the JAX package's on the same weights
(carried by the checkpoint converter), and the K1 sites a request runs.
32x48 frames, full widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.ops import conv_phase as jcp
from rrin_tpu_torch import ModelConfig, forward
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.ops import conv_phase as tcp
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import one_torch_thread  # noqa: F401

CFG, JCFG = ModelConfig(stem_kernel=9), JConfig(stem_kernel=9)


@pytest.fixture(scope="module")
def weights():
    """JAX parameters of the stem-9 cascade and their copy in the port."""
    jp = jrrin.init_params(jax.random.key(9), JCFG)
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(19)
    i0 = rng.integers(0, 256, (1, 32, 48, 3)).astype(np.float32) / np.float32(255)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    return i0, i1


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def _bf16_step(v):
    """One bf16 step (the spacing of bf16 values) at |v| > 0: 2^(e - 7) for
    |v| in [2^e, 2^(e+1))."""
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


@pytest.mark.parametrize("cin,cout", [(6, 32), (32, 32)])
def test_k1_plain_matches_interpreted_kernel_k9(cin, cout):
    """K1's plain version (bf16 conv, bias and slope in bf16) against the
    JAX package's phase kernel at k 9 (interpret mode; float32 sums, one
    rounding), weights at the model's init bound: within one bf16 step at
    the output's scale (its largest magnitude). The plain version rounds the
    conv sum to bf16 before it adds the bias, so an output that the bias
    nearly cancels carries the rounding error of the larger sum, many of its
    own steps."""
    rng = np.random.default_rng(cin)
    bound = 1.0 / np.sqrt(81 * cin)
    x = rng.standard_normal((1, 16, 64, cin)).astype(np.float32)
    w = rng.uniform(-bound, bound, (9, 9, cin, cout)).astype(np.float32)
    b = rng.uniform(-bound, bound, cout).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    assert jcp.supports(xb.shape, w.shape) is not None
    assert tcp.supports(xb.shape, w.shape) is not None
    jcp._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jcp.conv2d_fused(xb, jnp.asarray(w), jnp.asarray(b), 0.1)
                              .astype(jnp.float32))
    finally:
        jcp._FORCE_KERNEL = False
    got = tcp.conv2d_fused(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16), torch.from_numpy(w), torch.from_numpy(b), 0.1).float().numpy()
    assert got.shape == want.shape == (1, 16, 64, cout)
    step = _bf16_step(np.abs(want).max())
    assert np.abs(got - want).max() <= step, (np.abs(got - want).max(), step)


def test_cascade_fp32(weights, frames):
    """The float32 cascade against the JAX package's: the JAX package's own
    bar against its oracle on the full cascade (2e-4)."""
    jp, tp = weights
    i0, i1 = frames
    want = np.asarray(jrrin.forward(jp, jnp.asarray(i0), jnp.asarray(i1), 0.5, JCFG))
    got = forward(tp, i0, i1, 0.5, CFG, device="cpu").numpy()
    assert got.shape == want.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_cascade_bf16(weights, frames):
    """bf16 with the kernels' plain versions (``use_pallas``, the plain path:
    the packed path refuses stem_kernel 9) against the JAX package's bf16
    cascade: >= 40 dB, the bar of the default configuration's bf16 test."""
    jp, tp = weights
    i0, i1 = frames
    want = np.asarray(jrrin.forward(jp, jnp.asarray(i0), jnp.asarray(i1), 0.5, JCFG,
                                    compute_dtype=jnp.bfloat16, use_pallas=True))
    got = forward(tp, i0, i1, 0.5, CFG, compute_dtype=torch.bfloat16, use_pallas=True,
                  packed=None, device="cpu").numpy()
    assert np.isfinite(got).all()
    assert _psnr(got, want) >= 40.0, _psnr(got, want)


def test_request_runs_k1_at_k9(weights, frames, monkeypatch):
    """A bf16 request of the stem-9 cascade takes the plain path, whose 36
    K1 sites are those of the default configuration, 8 of them (conv1 and
    conv2 of each U-Net) at k 9: the launches that chip_smoke.py's
    ``serve_stem9`` checks on the card."""
    _, tp = weights
    i0, i1 = frames
    assert not tunet.packed_supported(32, 48, CFG) and tunet.packed_supported(32, 48,
                                                                               ModelConfig())
    ks = []
    real = tcp._conv_forward

    def counting(x, w, bias, slope):
        if tcp.supports(tuple(x.shape), tuple(w.shape)) is not None \
                and x.dtype == torch.bfloat16:
            ks.append(w.shape[0])
        return real(x, w, bias, slope)

    monkeypatch.setattr(tcp, "_conv_forward", counting)
    forward(tp, i0, i1, 0.5, CFG, compute_dtype=torch.bfloat16, use_pallas=True,
            packed=None, device="cpu")
    assert len(ks) == 36 and ks.count(9) == 8, ks
