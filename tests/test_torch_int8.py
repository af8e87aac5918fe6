"""int8 calibration and the int8 U-Net on the CPU: the port's
``unet_apply_stats`` and ``unet_apply_packed(absmax=)`` against the JAX
package's on the same numpy weights and inputs, the calibration entry points
of ``models.rrin``, calibration files shared by both packages, and the
options whose port is deferred."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.models import unet as junet
from rrin_tpu.params import checkpoint as jckpt
from rrin_tpu_torch import ModelConfig, RRIN, forward
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.models import rrin as trrin
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import one_torch_thread  # noqa: F401

CFG = ModelConfig()


@pytest.fixture(scope="module")
def flow():
    """The flow U-Net's JAX parameters, their copy in the port, and one
    192x64 input: there the JAX package's fuse_d1, fuse_d2 and fuse_u2 are
    all True, so both packages carry int8 between the same sites."""
    jp = jrrin.init_params(jax.random.key(3), JConfig())["flow"]
    tp = tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(6).standard_normal((1, 192, 64, 6)).astype(np.float32)
    assert tunet.carry_plan(tunet.packed_branch_flags(192, 64, CFG)) == tunet.carry_plan(
        junet.packed_branch_flags(192, 64, JConfig()))
    out, stats = jax.jit(junet.unet_apply_stats, static_argnums=2)(
        jp, jnp.asarray(x), JConfig())
    return jp, tp, x, np.asarray(out), {k: np.float32(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def cascade():
    tp = trrin.init_params(torch.Generator().manual_seed(1), CFG, device="cpu")
    rng = np.random.default_rng(11)
    i0 = rng.random((1, 48, 64, 3), dtype=np.float32)
    i1 = np.clip(np.roll(i0, 3, axis=2) * 0.9 + 0.05, 0, 1).astype(np.float32)
    return tp, i0, i1


def _psnr(got, want):
    peak = float(np.abs(want).max())
    return 10 * np.log10(peak * peak / float(np.mean((got - want) ** 2)))


def test_unet_apply_stats_matches_jax(flow):
    _, tp, x, out, want = flow
    got_out, got = tunet.unet_apply_stats(tp, torch.from_numpy(x), CFG)
    assert sorted(got) == sorted(want) == sorted(set(tunet.QUANT_SITES) | {"in"})
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.ndim == 0
        np.testing.assert_allclose(float(v), want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got_out.numpy(), out, atol=1e-4, rtol=1e-4)


def test_unet_apply_packed_int8_matches_jax(flow):
    """int8 on both sides from the same stats, float32 activations between
    the convs: 76.2 dB measured (bar 45 dB); the JAX package runs level 4 of
    this shape without its kernel (not int8), the port with it."""
    jp, tp, x, out, stats = flow
    want = np.asarray(jax.jit(junet.unet_apply_packed, static_argnums=2)(
        jp, jnp.asarray(x), JConfig(), {k: jnp.float32(v) for k, v in stats.items()}))
    got = tunet.unet_apply_packed(
        tp, torch.from_numpy(x), CFG, {k: torch.tensor(v) for k, v in stats.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _psnr(got.numpy(), want) > 45.0
    # and int8 stays near the float32 U-Net (44 dB measured)
    assert _psnr(got.numpy(), out) > 35.0


def test_forward_calibrate_merge_scale_quantize(cascade):
    tp, i0, i1 = cascade
    out, stats = trrin.forward_calibrate(tp, i0, i1, 0.5, device="cpu")
    assert sorted(stats) == sorted(trrin.UNET_SIGNATURES)
    assert all(sorted(s) == sorted(set(tunet.QUANT_SITES) | {"in"}) for s in stats.values())
    np.testing.assert_allclose(out.numpy(), forward(tp, i0, i1, 0.5, device="cpu").numpy(),
                               atol=1e-6)
    _, other = trrin.forward_calibrate(tp, i1, i0, 0.5, device="cpu")
    merged = trrin.merge_quant_stats(stats, other)
    scaled = trrin.scale_quant_stats(merged, 1.5)
    for u in stats:
        for k in stats[u]:
            assert merged[u][k] == max(stats[u][k], other[u][k])
            assert scaled[u][k] == merged[u][k] * 1.5
    net = RRIN(tp, device="cpu").quantize(i0, i1, margin=1.25)
    assert net.packed is True
    assert net.quant_stats["mask"]["d3c2"] == stats["mask"]["d3c2"] * 1.25
    np.testing.assert_array_equal(
        net(i0, i1).numpy(),
        forward(tp, i0, i1, packed=True, quant_stats=net.quant_stats, device="cpu").numpy())


def test_quant_stats_without_packed_raises(cascade):
    tp, i0, i1 = cascade
    _, stats = trrin.forward_calibrate(tp, i0, i1, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        forward(tp, i0, i1, quant_stats=stats, device="cpu")


def test_calibration_files_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(4)
    stats = {u: {k: np.float32(rng.random() * 9) for k in ("in", "c1", "u4c2")}
             for u in ("flow", "final")}
    jckpt.save_calibration(str(tmp_path / "jax.npz"), stats)
    got = tckpt.load_calibration(str(tmp_path / "jax.npz"), device="cpu")
    assert {u: {k: float(v) for k, v in s.items()} for u, s in got.items()} == {
        u: {k: float(v) for k, v in s.items()} for u, s in stats.items()}
    tckpt.save_calibration(str(tmp_path / "port.npz"), got)
    back = jckpt.load_calibration(str(tmp_path / "port.npz"))
    assert jax.tree.map(float, back) == jax.tree.map(float, stats)
    with np.load(tmp_path / "port.npz") as f:
        assert sorted(f.files) == sorted(
            f"__calib__.{u}.{k}" for u in stats for k in stats[u])


def test_deferred_options_raise(cascade):
    tp, i0, i1 = cascade
    x = torch.zeros((1, 16, 16, 6))
    item = "percentile calibration and saturation telemetry"
    for call in (
        lambda: tunet.unet_apply_stats(tp["flow"], x, CFG, quantile=0.999),
        lambda: tunet.unet_apply_stats(tp["flow"], x, CFG, ranges={}),
        lambda: trrin.forward_calibrate(tp, i0, i1, quantile=0.99, device="cpu"),
        lambda: trrin.forward_saturation(tp, i0, i1, {}),
        lambda: tpipe.Interpolator(tp, int8=True, int8_percentile=99.9, device="cpu"),
        lambda: tpipe.Interpolator(tp, int8=True, device="cpu").saturation_rates(None),
        lambda: tpipe.interpolate_video("in.mp4", "out.mp4", tp, int8=True,
                                        int8_saturation=True, device="cpu"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(ValueError, match="spatial"):
        tpipe.Interpolator(tp, int8=True, spatial=2, device="cpu")
