"""K1's module: the port's conv2d_fused (plain version, CPU) vs the JAX
phase-conv kernel in interpret mode, and the routing, plan and weight
layout of the CUDA kernel (the Hopper core) that the CPU can reach."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rrin_tpu.ops import conv_phase as jcp
from rrin_tpu_torch.ops import conv_packed as tpk
from rrin_tpu_torch.ops import conv_phase as tcp
from torch_packed_util import check_sm90_layout, fresh_rng, one_torch_thread  # noqa: F401


@pytest.fixture
def rng():
    """This file's own generator (not the one conftest.py shares across the
    test run), fresh for every test."""
    return fresh_rng()

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
        """Every site the JAX kernel takes within the port's k range
        (``MAX_K``: 49 at cout <= 8 down to 37 at cout <= 64) has a K1
        kernel. The reference has no bound on k; beyond the range the port
        runs ``F.conv2d`` (ROADMAP Queue C), pinned here: the sites it
        leaves, and k 39 at cout 64 and k 51 at cout 8."""
        n_jax = n_beyond = 0
        for k in range(1, 50, 2):
            for cin in (3, 6, 9, 10, 16, 32, 48, 64, 128, 256, 512):
                for cout in (2, 3, 4, 16, 32, 64, 128):
                    for hw in ((32, 64), (1088, 1920), (24, 100)):
                        xs, ws = (1, *hw, cin), (k, k, cin, cout)
                        if jcp.supports(xs, ws) is None:
                            continue
                        n_jax += 1
                        if k <= tcp._max_k(cout):
                            assert tcp.supports(xs, ws) is not None, (xs, ws)
                        else:
                            n_beyond += 1
                            assert tcp.supports(xs, ws) is None, (xs, ws)
        assert (n_jax, n_beyond) == (3000, 200)
        for k, cin, cout in ((39, 64, 64), (51, 32, 8)):
            xs, ws = (1, 32, 128, cin), (k, k, cin, cout)
            assert jcp.supports(xs, ws) is not None and tcp.supports(xs, ws) is None

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
        """At every odd k K1 takes, the Hopper core's plan: whole chunks of
        16-64 channels over cin, channel blocks over cout, within the 227 KB
        of shared memory; K5's layout (resident weights where they fit) at k
        3/5/7, the streamed mode's elsewhere."""
        for k in range(1, 50, 2):
            for cin in (1, 6, 16, 33, 64, 100, 256):
                for cout in (1, 8, 9, 33, 64):
                    if k > tcp._max_k(cout):
                        assert tcp._sm90_plan(k, cin, cout) is None
                        continue
                    plan = tcp._sm90_plan(k, cin, cout)
                    assert plan is not None, (k, cin, cout)
                    cchunk, n_tiles, n_cb = plan
                    assert cchunk in tpk._SM90_CHUNKS[False] and cchunk < 2 * max(cin, 16)
                    assert n_tiles * 8 * n_cb >= cout > n_tiles * 8 * (n_cb - 1)
                    streamed = k not in tpk._K_CONV
                    res = 0 if streamed else tpk._sm90_res_chunks((cin,), plan, True)
                    assert tpk._sm90_smem_bytes(k, cchunk, n_tiles, False, False, res,
                                                streamed) <= tpk._SMEM_MAX


@pytest.mark.parametrize("k,cin,cout", [(1, 40, 12), (9, 6, 32), (13, 33, 20), (37, 3, 40)])
def test_weight_fragments_layout(rng, k, cin, cout):
    """The weights K1 launches with at the k off DIRECT's (1, 9, 13, and 37,
    where a narrower N and two channel blocks fit beside the halo): the
    core's layout for K1's plan, every bf16 weight where the wgmma
    descriptor reads it and each dy row of a chunk one contiguous slab of
    k taps, as the streamed mode copies it, zero in padded channels."""
    plan = tcp._sm90_plan(k, cin, cout)
    assert plan == tpk._sm90_plan(k, (cin,), cout, streamed=True)
    cchunk, n_tiles, n_cb = plan
    assert n_cb == (2 if k == 37 else 1)
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32))
    pr = {"wfrag": tpk._sm90_weights(w, (cin,), cchunk, n_tiles), "plan": plan}
    check_sm90_layout(pr, w, k, False, (cin,))
    slab = k * cchunk * n_tiles * 8 * 2
    assert pr["wfrag"].permute(*tpk._SM90_ORDER).numel() * 2 == (
        n_cb * -(-cin // cchunk) * k * slab)


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
