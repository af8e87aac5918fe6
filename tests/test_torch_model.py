"""The slice as a whole on the CPU: the port's U-Net and cascade against the
JAX package on the same numpy weights and inputs, plus checkpoints. Full
widths at tiny spatial sizes; the JAX side reuses one compiled function per
signature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.models import unet as junet
from rrin_tpu.params import checkpoint as jckpt
from rrin_tpu_torch import RRIN, ModelConfig, forward, init_params
from rrin_tpu_torch.models import rrin as trrin
from rrin_tpu_torch.models.unet import unet_apply
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    """One set of JAX parameters, as numpy, and its copy in the port."""
    jp = jrrin.init_params(jax.random.key(7), JConfig())
    tree = jax.tree.map(np.asarray, jp)
    return jp, tree, tckpt.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    # u8-derived frames, the production source: the byte-packed warp source
    # is exact for them, so both packages sample identical values.
    i0 = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.float32) / np.float32(255)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    return i0, i1


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_config_fields_match():
    import dataclasses
    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JConfig())
    assert ModelConfig().widths == JConfig().widths


@pytest.mark.parametrize("name", ["flow", "refine", "mask", "final"])
def test_unet_apply_fp32(weights, name):
    jp, _, tp = weights
    cin, cout = trrin.UNET_SIGNATURES[name]
    assert trrin.UNET_SIGNATURES == jrrin.UNET_SIGNATURES
    x = np.random.default_rng(cin).standard_normal((1, 32, 64, cin)).astype(np.float32)
    want = np.asarray(junet.unet_apply(jp[name], jnp.asarray(x), JConfig()))
    with torch.no_grad():
        got = unet_apply(tp[name], torch.from_numpy(x), ModelConfig()).numpy()
    assert got.shape == (1, 32, 64, cout)
    # 19 float32 convs in another summation order: 1e-4.
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


class TestForwardFp32:
    # atol 2e-4: the bar the JAX package holds itself to against its torch
    # oracle on the full cascade.
    @pytest.mark.parametrize("t", [(0.5, 0.5), (0.25, 0.8), (0.1, 0.1)])
    def test_vector_t(self, weights, frames, t):
        jp, _, tp = weights
        i0, i1 = frames
        want = np.asarray(jrrin.forward(
            jp, jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(t, jnp.float32)))
        got = forward(tp, i0, i1, np.asarray(t, np.float32), device="cpu").numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-4)

    def test_scalar_t_equals_vector_t(self, weights, frames):
        _, _, tp = weights
        i0, i1 = frames
        a = forward(tp, i0, i1, 0.3, device="cpu")
        b = forward(tp, torch.from_numpy(i0), torch.from_numpy(i1),
                    torch.tensor([0.3, 0.3]), device="cpu")
        assert torch.equal(a, b)

    def test_flows_round_trip(self, weights, frames):
        jp, _, tp = weights
        i0, i1 = frames
        t = np.asarray([0.4, 0.7], np.float32)
        jfl = jrrin.forward(jp, jnp.asarray(i0), jnp.asarray(i1), flows_only=True)
        fl = forward(tp, i0, i1, flows_only=True, device="cpu")
        assert fl.shape == (2, 32, 48, 4) and fl.dtype == torch.float32
        np.testing.assert_allclose(fl.numpy(), np.asarray(jfl), atol=2e-4)
        shared = forward(tp, i0, i1, t, flows=fl, device="cpu")
        plain = forward(tp, i0, i1, t, device="cpu")
        assert torch.equal(shared, plain)
        want = np.asarray(jrrin.forward(
            jp, jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(t), flows=jfl))
        np.testing.assert_allclose(shared.numpy(), want, atol=2e-4)

    def test_kernel_wrappers_and_planar_same_on_cpu(self, weights, frames):
        _, _, tp = weights
        i0, i1 = frames
        base = forward(tp, i0, i1, 0.5, device="cpu")
        kern = forward(tp, i0, i1, 0.5, use_pallas=True, device="cpu")
        assert torch.equal(base, kern)

    def test_shape_check_and_unported_options(self, weights):
        _, _, tp = weights
        x = np.zeros((1, 24, 32, 3), np.float32)
        with pytest.raises(ValueError, match="multiples of 16"):
            forward(tp, x, x, device="cpu")
        x = np.zeros((1, 16, 16, 3), np.float32)
        # packed=True is ported: it runs, and equals the plain path in float32
        assert torch.equal(forward(tp, x, x, packed=True, device="cpu"),
                           forward(tp, x, x, packed=False, device="cpu"))
        # remat is ported (training): it runs and equals remat=False
        assert torch.equal(forward(tp, x, x, remat=True, device="cpu"),
                           forward(tp, x, x, device="cpu"))
        with pytest.raises(ValueError, match="inference-only"):
            forward(tp, x, x, packed=True, remat=True, device="cpu")


def test_forward_bf16(weights, frames):
    """bf16 convs round at other places in the two frameworks (XLA's CPU
    conv against oneDNN's, bias and slope in other precisions), through 76
    convs with random weights; both stay above 40 dB of each other and of
    their float32 outputs."""
    jp, _, tp = weights
    i0, i1 = frames
    t = np.asarray([0.5, 0.3], np.float32)
    want = np.asarray(jrrin.forward(
        jp, jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(t),
        compute_dtype=jnp.bfloat16, use_pallas=True))
    got = forward(tp, i0, i1, t, compute_dtype=torch.bfloat16, use_pallas=True,
                  device="cpu").numpy()
    ref = forward(tp, i0, i1, t, device="cpu").numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _psnr(got, want) > 40.0, _psnr(got, want)
    assert _psnr(got, ref) > 40.0, _psnr(got, ref)


def test_warp_pairs_mode():
    assert trrin._warp_pairs_mode(torch.float32) is False
    assert trrin._warp_pairs_mode(torch.bfloat16) == ("u8" if trrin._WARP_U8 else True)


def test_planar_cascade_is_pure_layout(weights, frames):
    _, _, tp = weights
    i0, i1 = (torch.from_numpy(a) for a in frames)
    cfg = ModelConfig()

    def run_unet(name, *feats):
        return unet_apply(tp[name], torch.cat(feats, dim=-1), cfg)

    tb = trrin._as_t(0.4, 2, torch.device("cpu"))
    with torch.no_grad():
        a = trrin._cascade(run_unet, i0, i1, tb, cfg, True, False, planar=False)
        b = trrin._cascade(run_unet, i0, i1, tb, cfg, True, False, planar=True)
    assert torch.equal(a, b)


class TestInit:
    def test_bounds_shapes_and_seed(self):
        cfg = ModelConfig()
        a = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
        b = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
        c = init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
        fa, fb, fc = (tckpt.flatten_params(p) for p in (a, b, c))
        jshapes = {k: v.shape for k, v in jckpt.flatten_params(
            jax.tree.map(np.asarray, jrrin.init_params(jax.random.key(0)))).items()}
        assert {k: v.shape for k, v in fa.items()} == jshapes
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
        assert any(not np.array_equal(fa[k], fc[k]) for k in fa)
        for key, v in fa.items():
            wkey = key[:-1] + "w"
            kh, kw, cin, _ = fa[wkey].shape
            bound = (1.0 + 1e-6) / np.sqrt(kh * kw * cin)
            assert np.abs(v).max() <= bound
            if v.size > 1000:
                assert np.abs(v).max() > 0.95 * bound and abs(v.mean()) < 0.05 * bound

    def test_rrin_class(self, frames):
        net = RRIN.init(torch.Generator().manual_seed(0), device="cpu")
        i0, i1 = frames
        out = net(i0[:1], i1[:1], t=0.5)
        assert out.shape == (1, 32, 48, 3)
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
        assert torch.equal(out, net.forward(i0[:1], i1[:1], 0.5))


class TestCheckpoint:
    def test_npz_round_trip_both_packages(self, weights, tmp_path):
        jp, tree, tp = weights
        path = str(tmp_path / "w.npz")
        tckpt.save_params(path, tp)
        back = tckpt.load_params(path, device="cpu")
        jback = jckpt.load_params(path)  # the JAX package reads the port's file
        flat, fj = tckpt.flatten_params(back), jckpt.flatten_params(jback)
        want = jckpt.flatten_params(tree)
        assert flat.keys() == want.keys() == fj.keys()
        assert "flow.down1.conv1.w" in flat
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k])
            np.testing.assert_array_equal(fj[k], want[k])
        jpath = str(tmp_path / "j.npz")
        jckpt.save_params(jpath, jp)  # and the port reads the JAX package's
        fl2 = tckpt.flatten_params(tckpt.load_params(jpath, device="cpu"))
        assert all(np.array_equal(fl2[k], want[k]) for k in want)

    def test_trained_checkpoint_loads(self):
        import pathlib
        path = pathlib.Path(__file__).parents[1] / "benchmarks" / "trained_synth_f16.npz"
        tp = tckpt.load_params(str(path), device="cpu")
        want = jckpt.flatten_params(jckpt.load_params(str(path)))
        got = tckpt.flatten_params(tp)
        assert got.keys() == want.keys()
        assert all(v.dtype == np.float32 for v in got.values())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].astype(np.float32))

    def test_state_dict_round_trip(self, weights):
        _, tree, tp = weights
        sd = tckpt.params_to_torch_state_dict(tp)
        jsd = jckpt.params_to_torch_state_dict(tree)
        assert sd.keys() == jsd.keys()
        assert all(torch.equal(sd[k], jsd[k]) for k in sd)
        assert sd["flow.down1.conv1.weight"].shape == (64, 32, 5, 5)
        wrapped = {"module." + k: v for k, v in sd.items()}
        back = tckpt.flatten_params(
            tckpt.convert_torch_state_dict(wrapped, device="cpu"))
        want = tckpt.flatten_params(tp)
        assert all(np.array_equal(back[k], want[k]) for k in want)
        with pytest.raises(ValueError):
            tckpt.convert_torch_state_dict({"epoch": np.zeros(())}, device="cpu")
        lenient = tckpt.convert_torch_state_dict(
            {**sd, "epoch": np.zeros(())}, strict=False, device="cpu")
        assert tckpt.flatten_params(lenient).keys() == want.keys()

    def test_load_torch_checkpoint(self, weights, tmp_path):
        _, _, tp = weights
        path = str(tmp_path / "ref.pth")
        torch.save({"state_dict": tckpt.params_to_torch_state_dict(
            {"flow": tp["flow"]}), "epoch": 3}, path)
        back = tckpt.load_torch_checkpoint(path, device="cpu")
        assert torch.equal(back["flow"]["conv1"]["w"], tp["flow"]["conv1"]["w"])
