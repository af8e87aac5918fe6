"""K5's module: the port's ``conv_packed`` on the CPU (its plain version)
against the JAX package's ``conv_packed`` on the same numpy inputs, packed with
the JAX ``pack`` and unpacked with ``unpack`` on the JAX side only; one case
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


def _jax_conv_packed(xs, w, b, slope, p=1, off_in=0, off_out=0, m=None, c_pad=None,
                     dtype=jnp.float32, run=None):
    m = m or -(-(xs[0].shape[2] + 8) // p // 8) * 8
    parts = []
    for x in xs:
        xp, spec = pack(jnp.asarray(x, dtype), p, off_in, m, c_pad=c_pad)
        parts.append((xp, spec, x.shape[-1]))
    args = (parts, jnp.asarray(w, dtype), jnp.asarray(b), off_out, slope)
    y, spec = jcp.conv_packed(*args) if run is None else run(jcp.conv_packed, *args)
    return np.asarray(unpack(y, spec).astype(jnp.float32))


class TestConvPacked:
    @pytest.mark.parametrize("cins,cout,k,p,off_in,off_out", [
        ((6,), 32, 7, 4, 1, 2), ((9,), 32, 7, 4, 1, 2), ((10,), 32, 7, 4, 1, 2),
        ((32,), 32, 7, 4, 2, 3), ((64,), 64, 5, 2, 1, 1), ((128,), 128, 3, 1, 0, 0),
        ((32,), 4, 3, 4, 2, 1), ((64, 64), 64, 3, 2, 1, 0),
    ])
    def test_fp32_matches_jax(self, rng, cins, cout, k, p, off_in, off_out):
        h, wd = 32, 16 * p - 4  # 16 storage groups, room for both offsets
        xs = [rng.random((1, h, wd, c), dtype=np.float32) - 0.5 for c in cins]
        _, w, b = case(rng, (1, 1, 1, 1), k, sum(cins), cout)
        slope = None if cout < 8 else 0.1
        want = _jax_conv_packed(xs, w, b, slope, p=p, off_in=off_in, off_out=off_out,
                                m=16, c_pad=32 if cins[0] < 32 else None)
        got = tcp.conv_packed([t(x) for x in xs], t(w), t(b), slope)
        assert got.shape == (1, h, wd, cout) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)

    def test_bf16_matches_interpreted_kernel(self, rng):
        xs = [rng.random((1, 32, 24, 64), dtype=np.float32) - 0.5 for _ in range(2)]
        _, w, b = case(rng, (1, 1, 1, 1), 3, 128, 64)
        want = _jax_conv_packed(xs, w, b, 0.1, p=2, off_in=1, off_out=0, m=16,
                                dtype=jnp.bfloat16, run=interpreted)
        got = tcp.conv_packed([t(x).to(torch.bfloat16) for x in xs], t(w), t(b), 0.1)
        assert got.dtype == torch.bfloat16
        assert psnr(got.float().numpy(), want) > BF16_PSNR_DB

    def test_operands_equal_conv_of_concat(self, rng):
        xs = [t(rng.standard_normal((2, 9, 11, c)).astype(np.float32)) for c in (16, 8, 24)]
        _, w, b = case(rng, (1, 1, 1, 1), 3, 48, 12)
        got = tcp.conv_packed(xs, t(w), t(b), 0.1)
        want = _conv_plain(torch.cat(xs, dim=-1), t(w), t(b), 0.1)
        assert torch.equal(got, want)
        # (tensor, real_c): only the first real_c channels enter the conv
        wide = torch.cat([xs[1], torch.full((2, 9, 11, 3), float("nan"))], dim=-1)
        got2 = tcp.conv_packed([xs[0], (wide, 8), xs[2]], t(w), t(b), 0.1)
        assert torch.equal(got2, want)
