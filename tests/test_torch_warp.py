"""K2-K4's module: the port's warp_one (plain versions, CPU) vs the JAX warp
kernels in interpret mode. Without forcing, the JAX CPU branch ignores
``pairs``, so the kernels are forced as the JAX package's own tests do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.ops import warp_pallas as jwp
from rrin_tpu_torch.ops import warp_kernel as twk
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401


@pytest.fixture
def rng():
    """This file's own generator (not the one conftest.py shares across the
    test run), fresh for every test."""
    return fresh_rng()


def _run_jax_kernel(img, flow, align_corners, pairs, planar_out=False):
    jwp._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jwp.warp_one_pallas(
                jnp.asarray(img), jnp.asarray(flow), align_corners, pairs, planar_out))
    finally:
        jwp._FORCE_KERNEL = False


def _case(rng, b, h, w, scale=3.0, bias=(0.0, 0.0)):
    img = rng.random((b, h, w, 3), dtype=np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    flow[..., 0] += bias[0]
    flow[..., 1] += bias[1]
    return img, flow


class TestAgainstJaxKernels:
    # float32 weights and accumulation on the same rounded source: 1e-5, the
    # JAX package's own bar for its kernels against warp_bilinear.
    @pytest.mark.parametrize("pairs", [False, True, "u8"])
    @pytest.mark.parametrize("hw", [(64, 128), (64, 200)])
    @pytest.mark.parametrize("align_corners", [False, True])
    def test_matches_interpreted_kernel(self, rng, pairs, hw, align_corners):
        img, flow = _case(rng, 1, *hw)
        want = _run_jax_kernel(img, flow, align_corners, pairs)
        got = twk.warp_one(
            torch.from_numpy(img), torch.from_numpy(flow), align_corners, pairs)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    @pytest.mark.parametrize("pairs", [False, "u8"])
    def test_flow_leaving_image_and_planar(self, rng, pairs):
        img, flow = _case(rng, 1, 32, 128, scale=0.5, bias=(6.0, 5.0))
        want = _run_jax_kernel(img, flow, False, pairs, True)
        got = twk.warp_one(
            torch.from_numpy(img), torch.from_numpy(flow), False, pairs, True)
        assert got.shape == (1, 3, 32, 128)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        assert np.all(got.numpy()[0, :, -4:, -4:] == 0.0)

    def test_u8_source_is_exact_for_u8_frames(self, rng):
        raw = rng.integers(0, 256, (1, 32, 48, 3)).astype(np.float32)
        img = torch.from_numpy(raw) * (1.0 / 255.0)
        assert torch.equal(twk._rounded_source(img, "u8"), img)

    def test_pair(self, rng):
        i0, f0 = _case(rng, 1, 16, 16)
        i1, f1 = _case(rng, 1, 16, 16)
        g0, g1 = twk.warp_pair_kernel(*map(torch.from_numpy, (i0, i1, f0, f1)), pairs=True)
        assert torch.equal(g1, twk.warp_one(torch.from_numpy(i1), torch.from_numpy(f1), False, True))
        assert g0.shape == (1, 16, 16, 3)


class TestWrapperChecks:
    def test_bad_arguments_raise(self):
        img = torch.zeros(1, 8, 8, 3)
        flow = torch.zeros(1, 8, 8, 2)
        with pytest.raises(ValueError):
            twk.warp_one(torch.zeros(1, 8, 8, 4), flow)
        with pytest.raises(ValueError):
            twk.warp_one(img, torch.zeros(1, 8, 9, 2))
        with pytest.raises(ValueError):
            twk.warp_one(img, flow, pairs="u16")

    def test_flow_stride_check(self):
        img = torch.zeros(2, 8, 8, 3)
        ftc = torch.zeros(2, 8, 8, 4)
        assert twk._check_cuda_inputs(img, ftc[..., :2]) == 4
        assert twk._check_cuda_inputs(img, ftc[..., 2:]) == 4
        assert twk._check_cuda_inputs(img, torch.zeros(2, 8, 8, 2)) == 2
        with pytest.raises(ValueError):
            twk._check_cuda_inputs(img, torch.zeros(2, 8, 8, 3)[..., :2])
        with pytest.raises(ValueError):
            twk._check_cuda_inputs(img, ftc[..., 1:3])
        with pytest.raises(ValueError):
            twk._check_cuda_inputs(img, torch.zeros(2, 16, 8, 2)[:, ::2])
        with pytest.raises(TypeError):
            twk._check_cuda_inputs(img.double(), ftc[..., :2])
        with pytest.raises(RuntimeError):
            twk._check_cuda_inputs(img, torch.zeros(2, 8, 8, 2, requires_grad=True))
        with pytest.raises(ValueError):
            twk._check_cuda_inputs(torch.zeros(2, 3, 8, 8).permute(0, 2, 3, 1), ftc[..., :2])
