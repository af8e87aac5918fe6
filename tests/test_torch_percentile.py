"""Percentile calibration and saturation telemetry on the CPU: the port's
quantile against ``jnp.quantile`` bit for bit, ``unet_apply_stats(quantile=,
ranges=)``, ``forward_calibrate(quantile=)`` and ``forward_saturation``
against the JAX package's, and the Interpolator and video loop around them.
Full widths at tiny spatial sizes, one compiled JAX function per
signature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.models import unet as junet
from rrin_tpu_torch import ModelConfig
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.models import rrin as trrin
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

CFG = ModelConfig()
SITES = sorted(set(tunet.QUANT_SITES) | {"in"})


@pytest.fixture(scope="module")
def weights():
    jp = jrrin.init_params(jax.random.key(9), JConfig())
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _bits(a):
    return np.asarray(a, np.float32).tobytes()


@pytest.mark.parametrize("case", ["fractional", "above_2_24", "bf16"])
def test_quantile_bit_equal_to_jnp(case):
    """Fractional weights at small n; the float32 position above 2^24
    elements, where a float64 one picks another order statistic (index
    16760447, weight 0, at q = 0.999); bf16 activations, their order
    statistics selected in bf16 as calibration selects them (the JAX
    package casts to float32 first)."""
    rng = fresh_rng()
    if case == "fractional":
        for n in (1000, 4097):
            a = np.abs(rng.standard_normal(n)).astype(np.float32)
            for q in (0.999, 0.9, 0.51, 0.3):
                want = jnp.quantile(jnp.asarray(a), q)
                assert _bits(tunet._f32_quantile(torch.from_numpy(a), q)) == _bits(want), (n, q)
        return
    if case == "above_2_24":
        n = (1 << 24) + 7
        a = np.abs(rng.standard_normal(n)).astype(np.float32)
        got = tunet._f32_quantile(torch.from_numpy(a), 0.999)
        assert _bits(got) == _bits(jnp.quantile(jnp.asarray(a), 0.999))
        assert float(got) == np.partition(a, 16760447)[16760447]
        return
    x = torch.from_numpy(rng.standard_normal((1, 24, 40, 32)).astype(np.float32)).bfloat16()
    a = x.abs()
    ja = jnp.abs(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)).astype(jnp.float32)
    for q in (0.999, 0.99, 0.75):
        assert _bits(tunet._f32_quantile(a, q)) == _bits(jnp.quantile(ja.ravel(), q)), q


def test_unet_apply_stats_quantile_matches_jax(weights):
    """float32 activations of two programs (summation order): rtol 1e-5,
    the bar of the absmax test."""
    jp, tp = weights
    x = fresh_rng().standard_normal((1, 48, 64, 6)).astype(np.float32)
    _, want = jax.jit(junet.unet_apply_stats, static_argnums=2)(
        jp["flow"], jnp.asarray(x), JConfig(), quantile=0.999)
    _, got = tunet.unet_apply_stats(tp["flow"], torch.from_numpy(x), CFG, quantile=0.999)
    assert sorted(got) == sorted(want) == SITES
    for k in SITES:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_apply_stats_ranges_matches_jax(weights, dtype):
    """Rates against one set of ranges (half the float32 maxima, so that no
    range sits on a value): float32 activations of two programs, 2e-3
    absolute (a few values of some thousand near a range). bf16: the input
    holds 1.0078125 (a bf16 value) and its range 1.006 lies below it and
    rounds to it in bf16, so only a float32 comparison counts those values:
    the "in" rate equals the JAX package's bit for bit."""
    jp, tp = weights
    rng = fresh_rng()
    x = rng.standard_normal((1, 48, 64, 6)).astype(np.float32)
    _, amax = tunet.unet_apply_stats(tp["flow"], torch.from_numpy(x), CFG)
    ranges = {k: v * 0.5 for k, v in amax.items()}
    if dtype == "bfloat16":
        x[..., 0] = 1.0078125
        ranges["in"] = torch.tensor(1.006)
        assert float(torch.tensor(1.006).bfloat16()) == 1.0078125
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    _, want = jax.jit(junet.unet_apply_stats, static_argnums=2)(
        jp["flow"], jnp.asarray(x).astype(jd), JConfig(),
        ranges={k: jnp.float32(float(v)) for k, v in ranges.items()})
    _, got = tunet.unet_apply_stats(tp["flow"], torch.from_numpy(x).to(td), CFG,
                                    ranges=ranges)
    assert sorted(got) == sorted(want) == SITES
    if dtype == "bfloat16":
        assert _bits(got["in"]) == _bits(want["in"])
        # PyTorch's own comparison of the bf16 tensor with the float32
        # range rounds the range to bf16 and misses channel 0 (of 6)
        xb = torch.from_numpy(x).bfloat16().abs()
        assert float(got["in"]) - float((xb > ranges["in"]).float().mean()) >= 1.0 / 6
        return
    for k in SITES:
        assert got[k].dtype == torch.float32 and 0.0 <= float(got[k]) <= 1.0
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=2e-3, err_msg=k)


def test_forward_calibrate_quantile_and_saturation_match_jax(weights):
    """The plain float32 cascade on both sides: quantiles to rtol 1e-4 (the
    cascade's port-vs-JAX bar is 2e-4 on its output), rates against the
    JAX package's stats to 2e-3."""
    jp, tp = weights
    rng = fresh_rng()
    i0 = rng.random((1, 32, 48, 3), dtype=np.float32)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    _, want = jrrin.forward_calibrate(jp, jnp.asarray(i0), jnp.asarray(i1), quantile=0.99)
    _, got = trrin.forward_calibrate(tp, i0, i1, quantile=0.99, device="cpu")
    assert sorted(got) == sorted(want) == sorted(trrin.UNET_SIGNATURES)
    for u in got:
        assert sorted(got[u]) == SITES
        for k in SITES:
            np.testing.assert_allclose(float(got[u][k]), float(want[u][k]), rtol=1e-4,
                                       err_msg=f"{u}/{k}")
    ranges = {u: {k: float(v) for k, v in s.items()} for u, s in want.items()}
    jr = jrrin.forward_saturation(jp, jnp.asarray(i0), jnp.asarray(i1),
                                  jax.tree.map(jnp.float32, ranges))
    tr = trrin.forward_saturation(tp, i0, i1, ranges, device="cpu")
    for u in tr:
        for k in SITES:
            np.testing.assert_allclose(float(tr[u][k]), float(jr[u][k]), atol=2e-3,
                                       err_msg=f"{u}/{k}")


def test_interpolator_percentile_validations(weights):
    _, tp = weights
    with pytest.raises(ValueError, match="requires int8"):
        tpipe.Interpolator(tp, int8_percentile=99.9, device="cpu")
    with pytest.raises(ValueError, match="preset"):
        tpipe.Interpolator(tp, int8=True, int8_percentile=99.9, quant_stats={}, device="cpu")
    for bad in (50.0, 100.5, 10.0):
        with pytest.raises(ValueError, match=r"\(50, 100\]"):
            tpipe.Interpolator(tp, int8=True, int8_percentile=bad, device="cpu")
    assert tpipe.Interpolator(tp, int8=True, int8_percentile=100.0,
                              device="cpu")._calib_quantile == 1.0


def test_saturation_rates_keys_and_absmax_zero(weights):
    """``"unet/site"`` keys in sorted order; absmax with its margin clips
    nothing of its own calibration batch; a 99th percentile without margin
    clips about 1 %."""
    _, tp = weights
    pairs = fresh_rng().integers(0, 256, (1, 2, 32, 48, 3), dtype=np.uint8)
    want = [f"{u}/{k}" for u in sorted(trrin.UNET_SIGNATURES) for k in SITES]
    rates = tpipe.Interpolator(tp, compute_dtype="float32", int8=True,
                               device="cpu").saturation_rates(pairs)
    assert list(rates) == want and all(v == 0.0 for v in rates.values())
    pct = tpipe.Interpolator(tp, compute_dtype="float32", int8=True, int8_percentile=99.0,
                             int8_margin=1.0, device="cpu").saturation_rates(pairs)
    assert list(pct) == want
    assert all(0.0 <= v <= 0.02 for v in pct.values())
    assert 0.002 < float(np.mean(list(pct.values()))) < 0.02


def test_interpolate_video_int8_saturation(weights, tmp_path):
    import cv2
    _, tp = weights
    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    wr = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (48, 32))
    for i in range(3):
        f = np.full((32, 48, 3), 30, np.uint8)
        f[8:20, 4 + 3 * i: 16 + 3 * i] = (200, 120, 40)
        wr.write(f)
    wr.release()
    rep = tpipe.interpolate_video(src, dst, tp, compute_dtype="float32", use_pallas=True,
                                  int8=True, int8_percentile=99.9, int8_saturation=True,
                                  device="cpu")
    assert rep.frames_out == 5
    sat = rep.int8_saturation
    assert len(sat) == 4 * len(SITES) and all(0.0 <= v <= 1.0 for v in sat.values())
    assert '"int8_saturation"' in rep.to_json()
    plain = tpipe.interpolate_video(src, dst, tp, compute_dtype="float32", device="cpu",
                                    int8_saturation=True)
    assert plain.int8_saturation is None  # int8 only, as in the JAX package
