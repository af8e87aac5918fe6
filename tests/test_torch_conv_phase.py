"""K1's module: the port's conv2d_fused (plain version, CPU) vs the JAX
phase-conv kernel in interpret mode, and the routing/layout code around the
CUDA kernel that the CPU can reach."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.ops import conv_phase as jcp
from rrin_tpu_torch.ops import conv_phase as tcp
from torch_packed_util import one_torch_thread  # noqa: F401

# (cin, cout, k): the U-Net's kernel-eligible shape classes.
SHAPES = [
    (6, 32, 7), (16, 32, 7), (32, 32, 7), (32, 64, 5),
    (64, 64, 5), (64, 32, 3), (128, 64, 3), (32, 2, 3),
]


def _run_jax_kernel(x, w, b, slope):
    jcp._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(
                jcp.conv2d_fused(x, w, b, slope).astype(jnp.float32))
    finally:
        jcp._FORCE_KERNEL = False


def _case(rng, b, h, w, cin, cout, k):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    return x, wgt, bias


class TestAgainstJaxKernel:
    # 3e-2 is the JAX package's own bar for its kernel against the XLA conv
    # (bf16 output rounding, two roundings in the plain version vs one).
    @pytest.mark.parametrize("cin,cout,k", SHAPES)
    def test_bf16_matches_interpreted_kernel(self, rng, cin, cout, k):
        x, w, b = _case(rng, 1, 16, 64, cin, cout, k)
        slope = None if cout < 8 else 0.1
        want = _run_jax_kernel(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), slope)
        got = tcp.conv2d_fused(
            torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(b), slope)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)

    def test_fp32_matches_xla_conv(self, rng):
        x, w, b = _case(rng, 1, 16, 24, 32, 32, 7)
        want = np.asarray(jcp._conv_xla(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 0.1))
        got = tcp.conv2d_fused(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 0.1)
        # float32 on both sides, other summation order: 1e-4.
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


class TestSupports:
    def test_superset_of_jax_supports(self):
        n_jax = 0
        for k in (1, 3, 5, 7, 9):
            for cin in (3, 6, 9, 10, 16, 32, 48, 64, 128, 256, 512):
                for cout in (2, 3, 4, 16, 32, 64, 128):
                    for hw in ((32, 64), (1088, 1920), (24, 100)):
                        xs, ws = (1, *hw, cin), (k, k, cin, cout)
                        if jcp.supports(xs, ws) is not None:
                            n_jax += 1
                            assert tcp.supports(xs, ws) is not None, (xs, ws)
        assert n_jax > 100

    @pytest.mark.parametrize("cin,cout,k", SHAPES + [(9, 32, 7), (10, 32, 7), (32, 3, 3)])
    def test_routes_every_site_class_without_shape_gates(self, cin, cout, k):
        for hw in ((1088, 1920), (544, 960), (33, 45)):
            assert tcp.supports((1, *hw, cin), (k, k, cin, cout)) is not None

    def test_rejections(self):
        assert tcp.supports((1, 32, 64, 128), (3, 3, 128, 128)) is None
        assert tcp.supports((1, 32, 64, 32), (4, 4, 32, 32)) is None
        assert tcp.supports((1, 32, 64, 16), (3, 3, 32, 32)) is None
        assert tcp.supports((32, 64, 32), (3, 3, 32, 32)) is None

    def test_plan_fits_shared_memory(self):
        for k in (1, 3, 5, 7, 9, 11):
            for cin in (1, 6, 16, 33, 64, 100, 256):
                for cout in (1, 8, 9, 33, 64):
                    plan = tcp._plan(k, cin, cout)
                    assert plan is not None
                    cchunk, n_chunks, n_tiles = plan
                    assert cchunk % 16 == 0 and cchunk * n_chunks >= cin
                    assert n_tiles * 8 >= cout
                    assert tcp._smem_bytes(k, cchunk, n_tiles) <= tcp._SMEM_MAX


def test_weight_fragments_layout(rng):
    """The B-fragment order the kernel reads: element (chunk, dy, dx, k16, nt,
    g, tig, r, p) is w[dy, dx, chunk*cchunk + k16*16 + r*8 + tig*2 + p, nt*8 + g]."""
    k, cin, cout = 3, 40, 12
    cchunk, n_chunks, n_tiles = 32, 2, 2
    w = torch.from_numpy(rng.standard_normal((k, k, cin, cout)).astype(np.float32))
    frag = tcp._weight_fragments(w, cchunk, n_chunks, n_tiles)
    assert frag.shape == (n_chunks, k, k, cchunk // 16, n_tiles, 8, 4, 2, 2)
    assert frag.dtype == torch.bfloat16 and frag.is_contiguous()
    wb = w.to(torch.bfloat16)
    for idx in np.ndindex(*frag.shape):
        ch, dy, dx, k16, nt, g, tig, r, p = idx
        ci = ch * cchunk + k16 * 16 + r * 8 + tig * 2 + p
        co = nt * 8 + g
        want = wb[dy, dx, ci, co] if ci < cin and co < cout else 0.0
        assert float(frag[idx]) == float(want), idx


def test_kernel_refuses_cuda_without_gpu(rng):
    """On a CPU tensor the wrapper takes the plain version; it never decides
    by anything but the tensor's device."""
    x, w, b = _case(rng, 1, 8, 8, 32, 32, 3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tcp.conv2d_fused(xt, torch.from_numpy(w), torch.from_numpy(b), 0.1)
    want = tcp._conv_plain(xt, torch.from_numpy(w), torch.from_numpy(b), 0.1)
    assert torch.equal(got, want)
    from rrin_tpu_torch import _build
    assert _build.launch_counts()["conv_phase"] == 0
