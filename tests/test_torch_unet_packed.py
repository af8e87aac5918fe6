"""The packed serving path as a whole on the CPU: the port's
``unet_apply_packed`` and ``forward(packed=True)`` against the JAX package's
on the same numpy weights and inputs, and against the port's own plain path.
Full widths at tiny spatial sizes; the JAX side compiles one function per
signature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.models import unet as junet
from rrin_tpu_torch import RRIN, ModelConfig, forward
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.models import rrin as trrin
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import one_torch_thread  # noqa: F401

CFG = ModelConfig()


@pytest.fixture(scope="module")
def weights():
    """One set of JAX parameters and its copy in the port, carried across by
    ``params_from_numpy``: the packed functions take the same tree."""
    jp = jrrin.init_params(jax.random.key(3), JConfig())
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(21)
    i0 = rng.integers(0, 256, (1, 48, 64, 3)).astype(np.float32) / np.float32(255)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    return i0, i1


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


class TestUnetApplyPacked:
    # 19 float32 convs in another summation order on each side: 1e-4, the bar
    # of the plain-path U-Net test.
    @pytest.mark.parametrize("name,hw", [
        ("flow", (48, 64)),
        ("mask", (112, 64)),   # levels of 28, 14 and 7 rows: not multiples of 8
    ])
    def test_fp32_matches_jax_and_plain_path(self, weights, name, hw):
        jp, tp = weights
        cin, cout = trrin.UNET_SIGNATURES[name]
        x = np.random.default_rng(cin).standard_normal((1, *hw, cin)).astype(np.float32)
        assert junet.packed_supported(*hw, JConfig()) and tunet.packed_supported(*hw, CFG)
        want = np.asarray(jax.jit(junet.unet_apply_packed, static_argnums=2)(
            jp[name], jnp.asarray(x), JConfig()))
        with torch.no_grad():
            got = tunet.unet_apply_packed(tp[name], torch.from_numpy(x), CFG)
            plain = tunet.unet_apply(tp[name], torch.from_numpy(x), CFG)
        assert got.shape == (1, *hw, cout) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)

    def test_bf16_close_to_fp32(self, weights):
        _, tp = weights
        x = torch.from_numpy(
            np.random.default_rng(5).standard_normal((1, 48, 64, 6)).astype(np.float32))
        with torch.no_grad():
            ref = tunet.unet_apply_packed(tp["flow"], x, CFG)
            got = tunet.unet_apply_packed(tp["flow"], x.to(torch.bfloat16), CFG)
        assert got.dtype == torch.bfloat16
        peak = float(ref.abs().max())
        mse = float(((got.float() - ref) ** 2).mean())
        assert 10 * np.log10(peak * peak / mse) > 40.0

    def test_unported_options_raise(self, weights):
        """The options once deferred are ported: ``collect`` fills every
        site's constants and serves the call from them, ``prep`` takes
        them, and the two statistics modes exclude each other, as in the
        JAX package. A shape off the packed path still raises."""
        _, tp = weights
        x = torch.from_numpy(
            np.random.default_rng(8).standard_normal((1, 16, 16, 6)).astype(np.float32))
        with torch.no_grad():
            want = tunet.unet_apply_packed(tp["flow"], x, CFG)
            col = {}
            assert torch.equal(tunet.unet_apply_packed(tp["flow"], x, CFG, collect=col), want)
            assert sorted(col) == sorted(tunet.PACKED_SITES)
            assert torch.equal(tunet.unet_apply_packed(tp["flow"], x, CFG, prep=col), want)
        with pytest.raises(ValueError, match="mutually exclusive"):
            tunet.unet_apply_stats(tp["flow"], x, CFG, quantile=0.999, ranges={})
        with pytest.raises(ValueError, match="packed_supported"):
            tunet.unet_apply_packed(tp["flow"], torch.zeros((1, 24, 16, 6)), CFG)

    def test_gates_hold_no_shape(self):
        """The CUDA kernels need channel multiples and kernel sizes, never a
        height, width or group count: every /16 shape is supported, and the
        flags do not depend on the shape, but for the up sites' routing, which
        follows the JAX package's width bound (K6 from width 3200 on)."""
        flags = tunet.packed_branch_flags(1088, 1920, CFG)
        assert flags == (True, True, True, True, 2, 2, True, True)
        assert flags == junet.packed_branch_flags(1088, 1920, JConfig())
        for hw in ((16, 16), (32, 64), (48, 64), (2160, 3840), (720, 1280)):
            assert tunet.packed_supported(*hw, CFG)
            want = flags[:4] + ((1, 1) if hw[1] >= 3200 else (2, 2)) + flags[6:]
            assert tunet.packed_branch_flags(*hw, CFG) == want
        assert not tunet.packed_supported(24, 64, CFG)
        assert not tunet.packed_supported(48, 64, ModelConfig(base_width=12))
        assert not tunet.packed_supported(48, 64, ModelConfig(stem_kernel=9))
        assert not tunet.packed_supported(48, 64, ModelConfig(down_kernels=(7, 3, 3, 3)))
        assert tunet.packed_bf16_supported(3840) and tunet.packed_bf16_supported(7680)


class TestForwardPacked:
    def test_fp32_matches_jax(self, weights, frames):
        # atol 2e-4: the bar of the plain-path cascade test.
        jp, tp = weights
        i0, i1 = frames
        t = np.asarray([0.4], np.float32)
        want = np.asarray(jrrin.forward(
            jp, jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(t), packed=True))
        got = forward(tp, i0, i1, t, packed=True, device="cpu")
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
        plain = forward(tp, i0, i1, t, packed=False, device="cpu")
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5)

    def test_bf16(self, weights, frames):
        """bf16 rounds at other places on the two paths (the fused resamples
        round once from float32) and in the two frameworks: 40 dB, the JAX
        package's bar between its packed and plain bf16 paths."""
        jp, tp = weights
        i0, i1 = frames
        want = np.asarray(jrrin.forward(
            jp, jnp.asarray(i0), jnp.asarray(i1), 0.5, compute_dtype=jnp.bfloat16,
            use_pallas=True, packed=True))
        kw = dict(compute_dtype=torch.bfloat16, use_pallas=True, device="cpu")
        got = forward(tp, i0, i1, 0.5, packed=True, **kw).numpy()
        plain = forward(tp, i0, i1, 0.5, packed=False, **kw).numpy()
        assert np.isfinite(got).all()
        assert _psnr(got, want) > 40.0, _psnr(got, want)
        assert _psnr(got, plain) > 40.0, _psnr(got, plain)

    def test_packed_none_follows_use_pallas(self, weights, frames, monkeypatch):
        _, tp = weights
        i0, i1 = frames
        calls = []
        real = trrin.unet_apply_packed

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(trrin, "unet_apply_packed", spy)
        for use_pallas, per_unet in ((False, 0), (True, 1)):
            del calls[:]
            forward(tp, i0, i1, flows_only=True, use_pallas=use_pallas, packed=None,
                    device="cpu")
            assert len(calls) == 1 * per_unet
            net = RRIN(tp, use_pallas=use_pallas, device="cpu")
            assert net.packed is None
            net(i0, i1)
            assert len(calls) == 5 * per_unet
            tpipe.device_step(tp, np.zeros((1, 2, 16, 16, 3), np.uint8),
                              use_pallas=use_pallas, compute_dtype=torch.float32,
                              device="cpu")
            assert len(calls) == 9 * per_unet

    def test_rejected_shape_takes_the_plain_path(self, weights, frames, monkeypatch):
        _, tp = weights
        i0, i1 = frames
        assert tunet.packed_supported(48, 64, CFG)
        monkeypatch.setattr(trrin, "packed_supported", lambda h, w, c: False)
        monkeypatch.setattr(trrin, "unet_apply_packed", None)  # must not be called
        got = forward(tp, i0, i1, flows_only=True, packed=True, device="cpu")
        want = forward(tp, i0, i1, flows_only=True, packed=False, device="cpu")
        assert torch.equal(got, want)

    def test_packed_and_remat_raise(self, weights, frames):
        _, tp = weights
        i0, i1 = frames
        with pytest.raises(ValueError, match="inference-only"):
            forward(tp, i0, i1, packed=True, remat=True, device="cpu")
        with pytest.raises(ValueError, match="inference-only"):
            forward(tp, i0, i1, use_pallas=True, packed=None, remat=True, device="cpu")


class TestPipelinePacked:
    def _assert_one_step(self, got, want):
        """At most one uint8 step, on fewer than 1e-3 of the pixels."""
        assert got.shape == want.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, d.max()
        assert (d > 0).mean() < 1e-3, (d > 0).mean()

    def test_device_step_and_interpolator_u8(self, weights):
        from rrin_tpu import pipeline as jpipe
        jp, tp = weights
        rng = np.random.default_rng(2)
        base = rng.integers(0, 256, (1, 40, 64, 3), dtype=np.uint8)
        pairs = np.stack([base[:, :, :56], base[:, :, 8:]], axis=1)  # 40x56 -> 48x64
        want = np.asarray(jpipe.device_step(
            jp, jnp.asarray(pairs), compute_dtype=jnp.float32, packed=True))
        got = tpipe.device_step(
            tp, pairs, compute_dtype=torch.float32, packed=True, device="cpu").numpy()
        assert got.shape == (1, 1, 40, 56, 3)
        self._assert_one_step(got, want)
        it = tpipe.Interpolator(tp, compute_dtype="float32", packed=True, device="cpu")
        assert it.packed is True
        assert np.array_equal(it.step(pairs).numpy(), got)
