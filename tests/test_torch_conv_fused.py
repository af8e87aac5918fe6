"""The modules of K7, K8 and K9: the port's ``conv_pool_packed``,
``conv_up_m_packed`` and ``conv_up_f_packed`` on the CPU (their plain
versions) against the JAX package's functions of the same names on the same
numpy inputs, packed and unpacked on the JAX side only; one case per kernel
runs the Pallas body in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.ops import conv_packed as jcp
from rrin_tpu.ops.packed import pack, unpack
from rrin_tpu_torch.ops import conv_packed as tcp
from rrin_tpu_torch.ops.conv_phase import _conv_plain
from torch_packed_util import BF16_PSNR_DB, F32_TOL, case, fresh_rng, interpreted, psnr, t


@pytest.fixture
def rng():
    return fresh_rng()


def _packed_input(x, p, off, m, dtype=jnp.float32):
    return pack(jnp.asarray(x, dtype), p, off, m)


class TestConvPoolPacked:
    @pytest.mark.parametrize("p,k,cin,cout,off_in,off_out", [
        (4, 5, 32, 64, 3, 1), (2, 3, 64, 128, 1, 0)])
    def test_fp32_matches_jax(self, rng, p, k, cin, cout, off_in, off_out):
        m = 16
        wd = m * p - off_in - (1 + (off_in + 1) % 2)
        x, w, b = case(rng, (1, 32, wd, cin), k, cin, cout)
        xp, spec = _packed_input(x, p, off_in, m)
        y, ospec = jcp.conv_pool_packed(xp, spec, cin, jnp.asarray(w), jnp.asarray(b),
                                        off_out, 0.1)
        got = tcp.conv_pool_packed(t(x), t(w), t(b), 0.1)
        assert got.shape == (1, 16, wd // 2, cout)
        np.testing.assert_allclose(got.numpy(), np.asarray(unpack(y, ospec)), **F32_TOL)

    def test_bf16_matches_interpreted_kernel(self, rng):
        x, w, b = case(rng, (1, 64, 28, 64), 3, 64, 128)
        xp, spec = _packed_input(x, 2, 1, 16, jnp.bfloat16)
        assert jcp.supports_pool(spec, 3, 128, 64)
        y, ospec = interpreted(jcp.conv_pool_packed, xp, spec, 64,
                                jnp.asarray(w, jnp.bfloat16), jnp.asarray(b), 0, 0.1)
        got = tcp.conv_pool_packed(t(x).to(torch.bfloat16), t(w), t(b), 0.1)
        want = np.asarray(unpack(y, ospec).astype(jnp.float32))
        assert psnr(got.float().numpy(), want) > BF16_PSNR_DB

    def test_pools_in_float32_and_rounds_once(self, rng):
        x, w, b = case(rng, (1, 8, 12, 16), 3, 16, 8)
        xb = t(x).to(torch.bfloat16)
        pooled = xb.float().reshape(1, 4, 2, 6, 2, 16).mean(dim=(2, 4)).to(torch.bfloat16)
        want = _conv_plain(pooled, t(w), t(b), 0.1)
        assert torch.equal(tcp.conv_pool_packed(xb, t(w), t(b), 0.1), want)
        with pytest.raises(ValueError, match="even"):
            tcp.conv_pool_packed(xb[:, :7], t(w), t(b))


class TestConvUpPacked:
    """K8 and K9 compute one function; both are held to both JAX functions'
    reference at their own geometries."""

    def test_up_m_fp32_matches_jax(self, rng, k=3, cin=256, cout=128):
        h, m_src = 16, 16
        x, w, b = case(rng, (1, h, m_src - 2, cin), k, cin, cout)
        xp, spec = _packed_input(x, 1, 0, m_src)
        y, ospec = jcp.conv_up_m_packed(xp, spec, cin, jnp.asarray(w), jnp.asarray(b),
                                        32, 0, h, 0.1)
        got = tcp.conv_up_m_packed(t(x), t(w), t(b), 0.1)
        assert got.shape == (1, 2 * h, 2 * (m_src - 2), cout)
        np.testing.assert_allclose(got.numpy(), np.asarray(unpack(y, ospec)), **F32_TOL)

    def test_up_f_fp32_matches_jax(self, rng, p=2, cin=64, cout=32, off_out=3, wd=36):
        x, w, b = case(rng, (1, 16, wd, cin), 3, cin, cout)
        xp, spec = _packed_input(x, p, 0, 40)
        y, ospec = jcp.conv_up_f_packed(xp, spec, cin, jnp.asarray(w), jnp.asarray(b),
                                        off_out, 0.1)
        want = np.asarray(unpack(y, ospec))
        got = tcp.conv_up_f_packed(t(x), t(w), t(b), 0.1)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        folded = tcp._conv_up_f_folded(t(x), t(w), t(b), 0.1)
        np.testing.assert_allclose(folded.numpy(), want, **F32_TOL)

    @pytest.mark.parametrize("fn,k", [
        (tcp.conv_up_m_packed, 3), (tcp.conv_up_m_packed, 5), (tcp.conv_up_f_packed, 3)])
    def test_equals_interpolate_then_conv(self, rng, fn, k):
        x, w, b = case(rng, (2, 5, 7, 16), k, 16, 8)
        up = torch.nn.functional.interpolate(
            t(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        want = _conv_plain(up, t(w), t(b), 0.1)
        np.testing.assert_allclose(
            fn(t(x), t(w), t(b), 0.1).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)

    def test_up_m_bf16_matches_interpreted_kernel(self, rng):
        x, w, b = case(rng, (1, 16, 14, 64), 3, 64, 64)
        xp, spec = _packed_input(x, 1, 0, 16, jnp.bfloat16)
        assert jcp.supports_up_m(spec, 3, 64, 16, 32, 0)
        y, ospec = interpreted(jcp.conv_up_m_packed, xp, spec, 64,
                                jnp.asarray(w, jnp.bfloat16), jnp.asarray(b), 32, 0, 16, 0.1)
        got = tcp.conv_up_m_packed(t(x).to(torch.bfloat16), t(w), t(b), 0.1)
        want = np.asarray(unpack(y, ospec).astype(jnp.float32))
        assert psnr(got.float().numpy(), want) > BF16_PSNR_DB

    def test_up_f_bf16_matches_interpreted_kernel(self, rng):
        x, w, b = case(rng, (1, 16, 36, 64), 3, 64, 32)
        xp, spec = _packed_input(x, 2, 0, 40, jnp.bfloat16)
        assert jcp.supports_up_f(spec, 3, 32, 16, 3)
        y, ospec = interpreted(jcp.conv_up_f_packed, xp, spec, 64,
                                jnp.asarray(w, jnp.bfloat16), jnp.asarray(b), 3, 0.1)
        want = np.asarray(unpack(y, ospec).astype(jnp.float32))
        xb = t(x).to(torch.bfloat16)
        got = tcp.conv_up_f_packed(xb, t(w), t(b), 0.1)
        assert psnr(got.float().numpy(), want) > BF16_PSNR_DB
        # the fold in bf16 (the CUDA kernel's rounding points) against the same
        assert psnr(tcp._conv_up_f_folded(xb, t(w), t(b), 0.1).float().numpy(),
                     want) > BF16_PSNR_DB
