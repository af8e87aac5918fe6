"""PyTorch port vs the JAX package: plain ops (pad, resize, warp), the
retiming plan, and the port's import hygiene. Same numpy inputs go through
both; everything runs on the CPU."""

import ast
import fractions
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu import pipeline as jpipe
from rrin_tpu.ops import pad as jpad
from rrin_tpu.ops import resize as jresize
from rrin_tpu.ops import warp as jwarp
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch._device import resolve_device
from rrin_tpu_torch.ops import pad as tpad
from rrin_tpu_torch.ops import resize as tresize
from rrin_tpu_torch.ops import warp as twarp
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401


@pytest.fixture
def rng():
    """This file's own generator (not the one conftest.py shares across the
    test run), fresh for every test."""
    return fresh_rng()

REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestResizePad:
    # Same shifted adds in the same order on both sides: float32 rounding
    # only, hence 1e-6.
    @pytest.mark.parametrize("shape", [(1, 8, 12, 3), (2, 16, 6, 5)])
    def test_avg_pool(self, rng, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jresize.avg_pool_2x(jnp.asarray(x)))
        got = tresize.avg_pool_2x(_t(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    @pytest.mark.parametrize("shape", [(1, 4, 6, 3), (2, 1, 5, 2), (1, 7, 1, 4)])
    def test_upsample(self, rng, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jresize.upsample_2x_bilinear(jnp.asarray(x)))
        got = tresize.upsample_2x_bilinear(_t(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_upsample_equals_interpolate(self, rng):
        x = _t(rng.standard_normal((1, 6, 9, 4)).astype(np.float32))
        want = torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(
            tresize.upsample_2x_bilinear(x).numpy(), want.numpy(), atol=1e-6)

    def test_upsample_bf16_same_rounding_points(self, rng):
        x = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
        want = np.asarray(jresize.upsample_2x_bilinear(
            jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
        got = tresize.upsample_2x_bilinear(_t(x).to(torch.bfloat16)).float().numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("shape", [(1, 40, 72, 3), (2, 32, 48, 3), (17, 5, 2)])
    def test_pad_unpad(self, rng, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        want, hw_j = jpad.pad_to_multiple(jnp.asarray(x))
        got, hw_t = tpad.pad_to_multiple(_t(x))
        assert hw_j == hw_t
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_array_equal(tpad.unpad(got, hw_t).numpy(), x)

    @pytest.mark.parametrize("n", [1, 15, 16, 17, 1080])
    def test_padded_size(self, n):
        assert tpad.padded_size(n) == jpad.padded_size(n)


class TestWarpBilinear:
    # Same arithmetic in float32 on both sides; 1e-5 as the JAX package's
    # own warp tests use.
    @pytest.mark.parametrize("align_corners", [False, True])
    @pytest.mark.parametrize("hw", [(16, 24), (13, 21)])
    def test_matches_jax(self, rng, align_corners, hw):
        h, w = hw
        img = rng.random((2, h, w, 3), dtype=np.float32)
        flow = (rng.standard_normal((2, h, w, 2)) * 3.0).astype(np.float32)
        want = np.asarray(jwarp.warp_bilinear(
            jnp.asarray(img), jnp.asarray(flow), align_corners))
        got = twarp.warp_bilinear(_t(img), _t(flow), align_corners).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("align_corners", [False, True])
    def test_flow_leaving_image(self, rng, align_corners):
        img = rng.random((1, 12, 20, 3), dtype=np.float32)
        flow = (rng.standard_normal((1, 12, 20, 2)) * 2.0).astype(np.float32)
        flow[..., 0] += 9.0
        flow[..., 1] -= 7.0
        flow[0, 0, 0] = (1e6, -1e6)  # far outside: all taps are zero
        want = np.asarray(jwarp.warp_bilinear(
            jnp.asarray(img), jnp.asarray(flow), align_corners))
        got = twarp.warp_bilinear(_t(img), _t(flow), align_corners).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (got == 0).any() and got[0, 0, 0].max() == 0.0

    def test_warp_pair_and_blend(self, rng):
        i0 = rng.random((1, 16, 16, 3), dtype=np.float32)
        i1 = rng.random((1, 16, 16, 3), dtype=np.float32)
        f0 = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
        f1 = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
        w0 = rng.random((1, 16, 16, 1), dtype=np.float32)
        w1 = rng.random((1, 16, 16, 1), dtype=np.float32)
        want = jwarp.warp_blend(*map(jnp.asarray, (i0, i1, f0, f1, w0, w1)))
        got = twarp.warp_blend(*map(_t, (i0, i1, f0, f1, w0, w1)))
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5)
        gp = twarp.warp_pair(_t(i0), _t(i1), _t(f0), _t(f1), planar_out=True)
        np.testing.assert_array_equal(gp[0].movedim(1, -1).numpy(), got[1].numpy())


class TestRetime:
    @pytest.mark.parametrize("factor", [
        fractions.Fraction(5, 2), fractions.Fraction(4, 5),
        fractions.Fraction(1200, 1001), fractions.Fraction(3, 1),
        fractions.Fraction(10001, 9999)])
    def test_plan_and_slots_exact(self, factor):
        want = jpipe.retime_plan(factor, 3, 40)
        got = tpipe.retime_plan(factor, 3, 40)
        assert [(p.emit_copy, p.ts) for p in got] == [
            (p.emit_copy, p.ts) for p in want]
        assert tpipe.retime_slots(factor) == jpipe.retime_slots(factor)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or rrin_tpu."""
    files = sorted((REPO / "rrin_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "rrin_tpu", "flax", "optax"), (f, mod)


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without")
    from rrin_tpu_torch import forward, init_params
    from rrin_tpu_torch.pipeline import Interpolator, device_step

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        init_params()
    x = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError):
        forward({}, x, x)
    with pytest.raises(RuntimeError):
        device_step({}, np.zeros((1, 2, 16, 16, 3), np.uint8))
    with pytest.raises(RuntimeError):
        Interpolator({})
    assert resolve_device("cpu").type == "cpu"
