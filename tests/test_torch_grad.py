"""Gradients of the port's kernel wrappers against ``jax.grad`` of the JAX
package's on the CPU, from the same numpy inputs.

``conv2d_fused`` and the warps are autograd Functions whose backward is the
JAX package's ``custom_vjp`` backward (``_conv_bwd``: the VJP of the plain
conv, recomputed; ``_warp_one_bwd``: the VJP of ``warp_bilinear`` on the
unrounded source). Each case takes the reference's VJP of one random
cotangent and the port's ``backward`` of the same cotangent.

Tolerances, fixed before any run:
  * float32: 1e-5 (5e-5 where |sx| is large, as the warp kernels' bars); of
    the largest gradient value for the convs, whose weight and bias
    gradients are sums over every pixel.
  * bfloat16: one bf16 step, 2e-2 of the largest gradient value. XLA's CPU
    backend sums the bias cotangent in bfloat16 (error about 3 % of the sum
    at these sizes) where PyTorch sums in float32 and rounds once, so the
    bias gradient is held to the exact float64 sum at one bf16 step, and to
    the reference at the reference's own distance from that sum plus one
    step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.ops import conv_phase as jcp
from rrin_tpu.ops import warp_pallas as jwp
from rrin_tpu_torch.ops import conv_phase as tcp
from rrin_tpu_torch.ops import warp_kernel as twk
from rrin_tpu_torch.ops.warp import warp_bilinear
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

F32_ATOL = 1e-5
WARP_ATOL_LARGE = 5e-5
BF16_STEP = 2e-2

# (k, cin, cout): a site K1 takes on the card (stem-like, cout <= 64) and one
# it leaves to F.conv2d (cout 128).
K1_SITE, LIBRARY_SITE = (3, 16, 32), (3, 64, 128)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("slope", [None, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_fused_grads(dtype, slope):
    """x, w and bias gradients at a site K1 takes and at one it does not."""
    rng = fresh_rng()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sites = {"k1": K1_SITE, "library": LIBRARY_SITE}
    for site, (k, cin, cout) in sites.items():
        assert (tcp.supports((2, 16, 24, cin), (k, k, cin, cout)) is None) == (site != "k1")
        x = rng.standard_normal((2, 16, 24, cin)).astype(np.float32)
        w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
        b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        g = rng.standard_normal((2, 16, 24, cout)).astype(np.float32)
        y, vjp = jax.vjp(lambda a, ww, bb: jcp.conv2d_fused(a, ww, bb, slope),
                         jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b))
        want = vjp(jnp.asarray(g).astype(y.dtype))
        tx = torch.from_numpy(x).to(tdt).requires_grad_()
        tw, tb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
        ty = tcp.conv2d_fused(tx, tw, tb, slope)
        ty.backward(torch.from_numpy(g).to(ty.dtype))
        assert tx.grad.dtype == tdt and tw.grad.dtype == tb.grad.dtype == torch.float32
        if dtype == "float32":
            for name, got, ref in zip("xwb", (tx.grad, tw.grad, tb.grad), want):
                assert _rel(_np(got), _np(ref)) <= F32_ATOL, (site, name)
            continue
        for name, got, ref in zip("xw", (tx.grad, tw.grad), want[:2]):
            assert _rel(_np(got), _np(ref)) <= BF16_STEP, (site, name)
        # the bias gradient: the exact sum of the bf16 cotangent where the
        # output passed the activation's mask (the port's forward mask)
        y_port = _np(ty)
        gbf = _np(torch.from_numpy(g).to(tdt)).astype(np.float64)
        if slope is not None:
            gbf = gbf * np.where(y_port >= 0, 1.0, slope)
        exact = gbf.sum((0, 1, 2))
        scale = np.abs(exact).max()
        err_port = np.abs(_np(tb.grad) - exact).max() / scale
        err_ref = np.abs(_np(want[2]) - exact).max() / scale
        assert err_port <= BF16_STEP, (site, err_port)
        assert _rel(_np(tb.grad), _np(want[2])) <= err_ref + BF16_STEP, (site, err_ref)


def test_conv2d_fused_only_asked_grads():
    """Only the gradients autograd asks for are computed (``None`` for the
    others), and inputs that do not require grad build no graph."""
    rng = fresh_rng()
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 16, 32)).astype(np.float32) * 0.1)
    b = torch.zeros(32)
    assert not tcp.conv2d_fused(x, w, b, 0.1).requires_grad
    w.requires_grad_()
    y = tcp.conv2d_fused(x, w, b, 0.1)
    gx, gw, gb, gslope = tcp._ConvFused.backward(y.grad_fn, torch.ones_like(y))
    assert gx is None and gb is None and gslope is None and gw.shape == w.shape


def _warp_inputs(rng, shape=(2, 32, 40), scale=3.0):
    b, h, w = shape
    # not u8-derived: the byte grid and bf16 round this source
    img = rng.random((b, h, w, 3), dtype=np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("pairs", [False, True, "u8"])
def test_warp_grads(pairs):
    """``warp_one`` and ``warp_pair_kernel`` (NHWC and planar out) against
    ``warp_one_pallas`` / ``warp_pair_pallas``: image and flow gradients."""
    rng = fresh_rng()
    i0, f0 = _warp_inputs(rng)
    i1, f1 = _warp_inputs(rng)
    for planar in (False, True):
        for align in (False, True):
            cot = rng.standard_normal((2, 3, 32, 40) if planar else (2, 32, 40, 3)
                                      ).astype(np.float32)
            _, vjp = jax.vjp(lambda im, fl: jwp.warp_one_pallas(im, fl, align, pairs, planar),
                             jnp.asarray(i0), jnp.asarray(f0))
            want = vjp(jnp.asarray(cot))
            ti, tf = torch.from_numpy(i0).requires_grad_(), torch.from_numpy(f0).requires_grad_()
            out = twk.warp_one(ti, tf, align, pairs=pairs, planar_out=planar)
            out.backward(torch.from_numpy(cot))
            for got, ref in zip((ti.grad, tf.grad), want):
                np.testing.assert_allclose(_np(got), _np(ref), atol=F32_ATOL, rtol=F32_ATOL)

        cots = [rng.standard_normal((2, 3, 32, 40) if planar else (2, 32, 40, 3)
                                    ).astype(np.float32) for _ in range(2)]
        _, vjp = jax.vjp(
            lambda a, b_, c, d: jwp.warp_pair_pallas(a, b_, c, d, False, pairs, planar),
            *map(jnp.asarray, (i0, i1, f0, f1)))
        want = vjp(tuple(map(jnp.asarray, cots)))
        ts = [torch.from_numpy(a).requires_grad_() for a in (i0, i1, f0, f1)]
        g0, g1 = twk.warp_pair_kernel(*ts, False, pairs=pairs, planar_out=planar)
        torch.autograd.backward([g0, g1], [torch.from_numpy(c) for c in cots])
        for got, ref in zip(ts, want):
            np.testing.assert_allclose(_np(got.grad), _np(ref), atol=F32_ATOL, rtol=F32_ATOL)


def test_warp_flow_grad_is_of_the_unrounded_source():
    """The flow's gradient depends on the source's values: the port's is the
    reference's (``warp_bilinear`` on the unrounded source), not the autograd
    of what the forward samples (the source rounded to the byte grid)."""
    rng = fresh_rng()
    img, flow = _warp_inputs(rng)
    cot = rng.standard_normal((2, 32, 40, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda fl: jwp.warp_one_pallas(jnp.asarray(img), fl, False, "u8", False),
                     jnp.asarray(flow))
    (want,) = vjp(jnp.asarray(cot))
    tf = torch.from_numpy(flow).requires_grad_()
    twk.warp_one(torch.from_numpy(img), tf, pairs="u8").backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tf.grad.numpy(), _np(want), atol=F32_ATOL, rtol=F32_ATOL)
    rounded = torch.from_numpy(flow).requires_grad_()
    warp_bilinear(twk._rounded_source(torch.from_numpy(img), "u8"), rounded).backward(
        torch.from_numpy(cot))
    # the byte grid moves a source value by up to 1/510; the flow gradient
    # sums tap differences, so the two differ far beyond the bar
    assert np.abs(rounded.grad.numpy() - tf.grad.numpy()).max() > 100 * F32_ATOL


def test_warp_pair_grad_through_flow_halves():
    """The cascade's flows are channels 0-1 and 2-3 of one ``Ft0|Ft1``
    tensor (``_flow_halves``, the layout the pair kernel reads in one load);
    their gradients reach that tensor, and it equals the reference's, with
    large flows (the 5e-5 bar)."""
    rng = fresh_rng()
    i0, _ = _warp_inputs(rng)
    i1, _ = _warp_inputs(rng)
    ftc = (rng.standard_normal((2, 32, 40, 4)) * 40.0).astype(np.float32)
    cots = [rng.standard_normal((2, 32, 40, 3)).astype(np.float32) for _ in range(2)]

    def ref(fc):
        return jwp.warp_pair_pallas(jnp.asarray(i0), jnp.asarray(i1), fc[..., :2], fc[..., 2:],
                                    False, "u8", False)

    _, vjp = jax.vjp(ref, jnp.asarray(ftc))
    (want,) = vjp(tuple(map(jnp.asarray, cots)))
    tftc = torch.from_numpy(ftc).requires_grad_()
    f0, f1 = tftc[..., :2], tftc[..., 2:]
    assert twk._flow_halves(f0.detach(), f1.detach())
    g0, g1 = twk.warp_pair_kernel(torch.from_numpy(i0), torch.from_numpy(i1), f0, f1,
                                  pairs="u8")
    torch.autograd.backward([g0, g1], [torch.from_numpy(c) for c in cots])
    assert tftc.grad.shape == ftc.shape
    np.testing.assert_allclose(tftc.grad.numpy(), _np(want), atol=WARP_ATOL_LARGE,
                               rtol=F32_ATOL)
