"""The pair entry point of K2-K4: ``warp_pair_kernel`` warps both frames of
the cascade in one launch on the card. On the CPU (its plain version) it
equals two ``warp_one`` calls and the JAX package's ``warp_pair_pallas``
with its kernels in interpret mode; the host-side test that decides whether
the two flows are read with one 16-byte load a pixel; its argument checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.ops import warp_pallas as jwp
from rrin_tpu_torch import _build
from rrin_tpu_torch.ops import warp_kernel as twk
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


def _pair_case(rng, b, h, w):
    imgs = [rng.random((b, h, w, 3), dtype=np.float32) for _ in range(2)]
    ftc = (rng.standard_normal((b, h, w, 4)) * 3.0).astype(np.float32)
    ftc[..., 0] += 5.0  # some taps leave the image
    return imgs, ftc


@pytest.mark.parametrize("pairs", [False, True, "u8"])
def test_pair_matches_warp_one_and_jax(rng, pairs):
    """Both outputs equal ``warp_one`` of each frame bit for bit, and the JAX
    pair through its interpreted kernels within 1e-5 (float32 weights and
    accumulation on the same rounded source, the JAX package's bar), NHWC
    and planar, for the flows as halves of one tensor (the cascade's Ft0|Ft1)
    and batch 2."""
    imgs, ftc = _pair_case(rng, 2, 32, 40)  # h >= 32, h % 16 == 0: the JAX kernel path
    i0, i1 = (torch.from_numpy(i) for i in imgs)
    flows = torch.from_numpy(ftc)
    f0, f1 = flows[..., :2], flows[..., 2:]
    for planar in (False, True):
        g0, g1 = twk.warp_pair_kernel(i0, i1, f0, f1, False, pairs, planar)
        assert torch.equal(g0, twk.warp_one(i0, f0, False, pairs, planar))
        assert torch.equal(g1, twk.warp_one(i1, f1, False, pairs, planar))
        jwp._FORCE_KERNEL = True
        try:
            with pltpu.force_tpu_interpret_mode():
                want = jwp.warp_pair_pallas(
                    *(jnp.asarray(a) for a in (*imgs, ftc[..., :2], ftc[..., 2:])),
                    False, pairs, planar)
        finally:
            jwp._FORCE_KERNEL = False
        for got, ref in zip((g0, g1), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_flow_halves():
    """Two flows are one 16-byte load a pixel only as channels 0-1 and 2-3,
    in that order, of one NHWC-contiguous 4-channel float32 tensor."""
    ftc = torch.zeros(2, 6, 10, 4)
    assert twk._flow_halves(ftc[..., :2], ftc[..., 2:])
    assert twk._flow_halves(ftc[:1, ..., :2], ftc[:1, ..., 2:])  # one batch element
    assert not twk._flow_halves(ftc[..., 2:], ftc[..., :2])      # swapped
    assert not twk._flow_halves(ftc[..., :2].contiguous(), ftc[..., 2:].contiguous())
    assert not twk._flow_halves(ftc[..., 1:3], ftc[..., 2:])     # overlapping
    wide = torch.zeros(2, 6, 10, 6)
    assert not twk._flow_halves(wide[..., :2], wide[..., 2:4])   # 6 floats a pixel
    assert not twk._flow_halves(ftc[:, ::2, :, :2], ftc[:, ::2, :, 2:])  # rows skipped
    planar = torch.zeros(2, 4, 6, 10).permute(0, 2, 3, 1)
    assert not twk._flow_halves(planar[..., :2], planar[..., 2:])
    f64 = ftc.double()
    assert not twk._flow_halves(f64[..., :2], f64[..., 2:])
    other = torch.zeros(2, 6, 11, 4)
    assert not twk._flow_halves(ftc[..., :2], other[..., 2:])


def test_pair_argument_checks(rng):
    """The pair's frames share one shape and device; shapes and ``pairs`` are
    checked as ``warp_one`` checks them; a tensor on a device without a
    kernel raises (no plain version) and nothing is launched."""
    img = torch.zeros(1, 8, 8, 3)
    flow = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="agree"):
        twk.warp_pair_kernel(img, torch.zeros(1, 8, 9, 3), flow, torch.zeros(1, 8, 9, 2))
    with pytest.raises(ValueError):
        twk.warp_pair_kernel(img, img, flow, torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError):
        twk.warp_pair_kernel(img, img, flow, flow, pairs="u16")
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="no warp kernel for device meta"):
        twk.warp_pair_kernel(*(x.to("meta") for x in (img, img, flow, flow)))
    assert _build.launch_counts() == before
    assert before.keys() >= {"warp_u8", "warp_f32", "warp_bf16"}
