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
from torch_packed_util import (  # noqa: F401
    check_sm90_layout,
    fresh_rng,
    one_torch_thread,
    sm90_offset,
)


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
        """Every site the JAX kernel takes has a K1 kernel, at every odd k
        1-129 and at k 201 and 255 (the reference has no bound on k): the
        port's streamed mode splits a wide stencil into blocks. k 39 at cout
        64 and k 51 at cout 8, which the port once left to ``F.conv2d``,
        take the streamed mode's plan."""
        n_jax = 0
        for k in [*range(1, 130, 2), 201, 255]:
            for cin in (3, 6, 9, 10, 16, 32, 48, 64, 128, 256, 512):
                for cout in (2, 3, 4, 16, 32, 64, 128):
                    for hw in ((32, 64), (1088, 1920), (24, 100)):
                        xs, ws = (1, *hw, cin), (k, k, cin, cout)
                        if jcp.supports(xs, ws) is None:
                            continue
                        n_jax += 1
                        assert tcp.supports(xs, ws) is not None, (xs, ws)
        assert n_jax == 8040
        for k, cin, cout in ((39, 64, 64), (51, 32, 8)):
            xs, ws = (1, 32, 128, cin), (k, k, cin, cout)
            assert jcp.supports(xs, ws) is not None
            plan = tpk._sm90_plan(k, (cin,), cout, streamed=True)
            assert plan is not None and tcp.supports(xs, ws) == plan[0]

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
        """At every odd k (1-129, 201, 255), the Hopper core's plan: whole
        chunks of 16-64 channels over cin, channel blocks over cout, within
        the 227 KB of shared memory; K5's layout (resident weights where
        they fit) at k 3/5/7, the streamed mode's elsewhere. The streamed
        mode's shared memory is that of its widest stencil block (at most
        13 taps, the blocks balanced and covering the stencil once), at
        every chunk and width: it no longer grows with k."""
        for k in [*range(1, 130, 2), 201, 255]:
            streamed = k not in tpk._K_CONV
            blocks = tpk._stream_blocks(k)
            widest = max(size for _, size in blocks)
            assert [o for o, _ in blocks] == [sum(s for _, s in blocks[:i])
                                              for i in range(len(blocks))]
            assert sum(s for _, s in blocks) == k and widest <= 13
            assert widest - min(s for _, s in blocks) <= 1 and (len(blocks) == 1) == (k <= 13)
            if streamed:
                for cchunk in tpk._SM90_CHUNKS[False]:
                    for n_tiles in (1, 2, 4, 8):
                        assert tpk._sm90_smem_bytes(k, cchunk, n_tiles, streamed=True) == (
                            tpk._sm90_smem_bytes(widest, cchunk, n_tiles, streamed=True))
            for cin in (1, 6, 16, 33, 64, 100, 256):
                for cout in (1, 8, 9, 33, 64):
                    plan = tcp._sm90_plan(k, cin, cout)
                    assert plan is not None, (k, cin, cout)
                    cchunk, n_tiles, n_cb = plan
                    assert cchunk in tpk._SM90_CHUNKS[False] and cchunk < 2 * max(cin, 16)
                    assert n_tiles * 8 * n_cb >= cout > n_tiles * 8 * (n_cb - 1)
                    res = 0 if streamed else tpk._sm90_res_chunks((cin,), plan, True)
                    assert tpk._sm90_smem_bytes(k, cchunk, n_tiles, False, False, res,
                                                streamed) <= tpk._SMEM_MAX


@pytest.mark.parametrize("k,cin,cout", [(1, 40, 12), (9, 6, 32), (13, 33, 20), (37, 3, 40),
                                        (65, 32, 32)])
def test_weight_fragments_layout(rng, k, cin, cout):
    """The weights K1 launches with at the k off DIRECT's (1, 9, 13, 37 and
    65, a stencil of five blocks a side): the core's layout for K1's plan,
    every bf16 weight where the wgmma descriptor reads it (below k 65: at
    65 that is 4.3 million weights), zero in padded channels. Each copy the
    streamed mode makes, one (chunk, block, dy) slab, starts where the
    address formula puts its first tap, ends where it puts its last, holds
    the block's taps of that dy row in the layout the consumer reads, and
    the copies cover the buffer once."""
    plan = tcp._sm90_plan(k, cin, cout)
    assert plan == tpk._sm90_plan(k, (cin,), cout, streamed=True)
    cchunk, n_tiles, n_cb = plan
    assert n_cb == 1
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32))
    wfrag = tpk._sm90_weights(w, (cin,), cchunk, n_tiles)
    if k < 65:
        check_sm90_layout({"wfrag": wfrag, "plan": plan}, w, k, False, (cin,))
    flat = wfrag.permute(*tpk._SM90_ORDER).reshape(-1)
    n_chunks, big_n = -(-cin // cchunk), n_tiles * 8
    tap_bytes = cchunk * big_n * 2
    assert flat.numel() * 2 == n_cb * n_chunks * k * k * tap_bytes
    blocks = tpk._stream_blocks(k)
    copied = np.zeros(flat.numel(), np.int64)
    for ox, tx in blocks:
        # the block's taps of every dy row, laid out alone: what one slab holds
        want = tpk._sm90_weights(w[:, ox:ox + tx], (cin,), cchunk, n_tiles).permute(
            *tpk._SM90_ORDER)
        for cb in range(n_cb):
            for ch in range(n_chunks):
                for oy, ty in blocks:
                    for dy in range(oy, oy + ty):
                        # the kernel's source address (produce_stream)
                        off = (((cb * n_chunks + ch) * k + dy) * k + ox) * tap_bytes
                        assert off == sm90_offset(ch * cchunk, cb * big_n, dy, ox, cchunk,
                                                  n_tiles, k, k, n_chunks, False)
                        last = sm90_offset(ch * cchunk + cchunk - 1, cb * big_n + big_n - 1,
                                           dy, ox + tx - 1, cchunk, n_tiles, k, k, n_chunks,
                                           False)
                        assert last + 2 == off + tx * tap_bytes
                        slab = flat[off // 2:(off + tx * tap_bytes) // 2]
                        assert torch.equal(slab, want[cb, ch, dy].reshape(-1))
                        copied[off // 2:(off + tx * tap_bytes) // 2] += 1
    assert (copied == 1).all()


def test_wide_k_matches_xla_conv(rng):
    """A site beyond the port's former k range (k 41, cout 64), which the
    reference's kernel takes: routed to K1, and on the CPU its plain version
    agrees with the JAX package's XLA conv in bf16 at the reference's 3e-2
    bar (the interpreted JAX kernel takes minutes at this k)."""
    x, w, b = _case(rng, 1, 16, 32, 8, 64, 41)
    xs, ws = x.shape, w.shape
    assert jcp.supports(xs, ws) is not None and tcp.supports(xs, ws) is not None
    want = np.asarray(jcp._conv_xla(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), 0.1
    ).astype(jnp.float32))
    got = tcp.conv2d_fused(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w), torch.from_numpy(b), 0.1)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 16, 32, 64)
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


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
