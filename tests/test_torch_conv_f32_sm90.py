"""The host side of K5-K9 in float32 on the Hopper core
(``csrc/conv_sm90.cuh``, element type F32; entry points of K5 and K6 in
``csrc/conv_packed_sm90.cu``, of K7-K9 in ``csrc/conv_up_sm90.cu``): the two
TF32 weight planes that its wgmma B descriptor reads, located element by
element through its address formula (K9: the five folded taps, both channel
blocks where 2*cout exceeds 64); the tile and shared-memory planner at every
K5-K9 site of the 1080p and 4K cascades and of ``chip_smoke.py`` (K7 with
its weights resident where that is what fits); and that a float32 operand
without a kernel raises instead of falling back to the plain version."""

import numpy as np
import pytest
import torch

from rrin_tpu_torch import _build
from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import (  # noqa: F401
    check_sm90_layout,
    fresh_rng,
    one_torch_thread,
    sm90_rows,
    t,
)

F32 = tcp.F32


@pytest.fixture
def rng():
    return fresh_rng()


# (name, kernel, k, operands' channels, cout)
LAYOUTS = [
    ("two_operands", "conv_packed", 3, (24, 16), 20),
    ("stem_cin6", "conv_packed", 7, (6,), 12),
    ("k6_k1", "conv_up_packed", 1, (24,), 12),
    ("k6_k3", "conv_up_packed", 3, (40,), 20),
    # u3c1-like: 2*cout = 80 > 64, two channel blocks, the second half padding
    ("k9_two_blocks", "conv_up_f_packed", 3, (24,), 40),
    # K7 where its one chunk of weights stays resident (plan (8, 8, 1))
    ("k7_resident", "conv_pool_packed", 5, (8,), 64),
    ("k8_k5", "conv_up_m_packed", 5, (24,), 20),
]


@pytest.mark.parametrize("site", LAYOUTS, ids=[s[0] for s in LAYOUTS])
def test_weight_layout_read_by_the_core(rng, site):
    """q = "f32": every float32 that the core reads holds the hi TF32 part
    (plane 0) or the lo part (plane 1, one B tile later) of the weight of its
    (dy, tap, channel-in, channel-out), zero where an operand's chunk or the
    output channels are padding; indexed in fragment order, the layout holds
    the elements of ``_weight_fragments(q=F32)``. K9: the weights folded in
    float32 (three stencil taps, then the two edge taps, ``_upf_taps``)
    before the split, 2*cout channels out, the bias repeated. K7 and K8 take
    the conv's own weights; resident ones are laid out as any."""
    _, kernel, k, cins, cout = site
    w = t(rng.standard_normal((k, k, sum(cins), cout)).astype(np.float32))
    b = t(rng.standard_normal(cout).astype(np.float32))
    ref, n_out, (folded, resident) = w, cout, tcp._SM90_KERNELS[kernel]
    if kernel == "conv_packed":
        pr = tcp.prep_conv(w, b, cins, dtype=torch.float32)
    elif folded:
        pr = tcp.prep_conv_up_f(w, b, dtype=torch.float32)
        ref, n_out = tcp._upf_taps(w), 2 * cout
        assert ref.shape[1] == 5 and torch.equal(pr["bias"], torch.cat([b, b]))
        assert pr["plan"][2] == 2  # one channel block per output parity
    else:
        prep = {"conv_up_packed": tcp.prep_conv_up, "conv_pool_packed": tcp.prep_conv_pool,
                "conv_up_m_packed": tcp.prep_conv_up_m}[kernel]
        pr = prep(w, b, dtype=torch.float32)
    assert pr["plan"] == tcp._sm90_plan(k, cins, n_out, F32, folded=folded, resident=resident)
    if kernel == "conv_pool_packed":
        assert pr["plan"] == (8, 8, 1) and tcp._sm90_res_chunks(cins, pr["plan"], True) == 1
    assert pr["cins"] == cins and not pr["q"] and pr["scale"] is None
    check_sm90_layout(pr, ref, k, F32, cins)
    cchunk, n_tiles, _ = pr["plan"]
    frag = tcp._weight_fragments(ref, cins, cchunk, n_tiles, F32)
    assert torch.equal(pr["wfrag"], frag)
    tcp._check_sm90_layout(kernel, pr)
    with pytest.raises(ValueError, match="not in the layout of _sm90_weights"):
        tcp._check_sm90_layout(kernel, dict(pr, wfrag=frag))


S = 0.1
# (name, kernel, k, operands' channels, cout): every K5 and K6 site of the
# U-Net (the planner has no spatial input, so one plan serves 1080p and 4K)
# and chip_smoke.py's other cases.
SITES = [
    *((f"c1_cin{c}", "conv_packed", 7, (c,), 32) for c in (6, 9, 10, 16)),
    ("c2", "conv_packed", 7, (32,), 32),
    ("d1c2", "conv_packed", 5, (64,), 64),
    ("d2c2", "conv_packed", 3, (128,), 128),
    ("d3c1", "conv_packed", 3, (128,), 256),
    ("d3c2", "conv_packed", 3, (256,), 256),
    ("d4c1", "conv_packed", 3, (256,), 512),
    ("d4c2", "conv_packed", 3, (512,), 512),
    ("u1c1", "conv_packed", 3, (512,), 256),
    ("u1c2", "conv_packed", 3, (256, 256), 256),
    ("u2c2", "conv_packed", 3, (128, 128), 128),
    ("u3c2", "conv_packed", 3, (64, 64), 64),
    ("u4c2", "conv_packed", 3, (32, 32), 32),
    *((f"head_cout{c}", "conv_packed", 3, (32,), c) for c in (4, 2, 3)),
    ("k7_ragged", "conv_packed", 7, (32,), 32),
    ("four_operands", "conv_packed", 3, (64, 24, 16, 10), 48),
    ("u3c1_4k", "conv_up_packed", 3, (128,), 64),
    ("u4c1_4k", "conv_up_packed", 3, (64,), 32),
    ("k6_k5", "conv_up_packed", 5, (64,), 32),
    ("k6_k1", "conv_up_packed", 1, (32,), 16),
    # K9 (cout; 2*cout channels a GEMM pixel): u3c1 and u4c1 at 1080p, and
    # chip_smoke.py's ragged, edge-in-tile and 4K cases at those widths
    ("k9_u3c1", "conv_up_f_packed", 3, (128,), 64),
    ("k9_u4c1", "conv_up_f_packed", 3, (64,), 32),
    # K7: d1c1 (also at 4K, and chip_smoke.py's ragged and edge-in-tile k 5
    # cases), d2c1 (its k 3 edge-in-tile case), the resident-weights case
    ("k7_d1c1", "conv_pool_packed", 5, (32,), 64),
    ("k7_d2c1", "conv_pool_packed", 3, (64,), 128),
    ("k7_resident", "conv_pool_packed", 5, (8,), 64),
    # K8: u2c1 (also at 4K), chip_smoke.py's ragged, edge-in-tile and k 5 cases
    ("k8_u2c1", "conv_up_m_packed", 3, (256,), 128),
    ("k8_ragged", "conv_up_m_packed", 3, (64,), 64),
    ("k8_edge_in_tile", "conv_up_m_packed", 3, (128,), 64),
    ("k8_k5", "conv_up_m_packed", 5, (64,), 32),
]


def test_planner_fits_every_site():
    """float32: each plan takes chunks that the producers split evenly
    (powers of two, whole k-steps of 8 channels), none of which holds
    channels of two operands, N <= 64 (the promotion sums double the
    accumulators: 4 rows a consumer up to N = 32, 2 at N = 64, 6 at k 7 and
    N <= 16), and fits the 227 KB of shared memory; the support gates agree,
    so routing does not depend on the dtype. Where a site's weights alone
    fill a buffer (k 7: a
    chunk of 8 channels at N = 32 is 100,352 bytes), N narrows; chunks of 16
    or 32 are left only where N is small (u4c2, the heads)."""
    supports = {"conv_up_f_packed": tcp.supports_up_f, "conv_up_packed": tcp.supports_up,
                "conv_pool_packed": tcp.supports_pool, "conv_up_m_packed": tcp.supports_up_m}
    for name, kernel, k, cins, cout in SITES:
        folded, resident = tcp._SM90_KERNELS[kernel]
        n_out = 2 * cout if folded else cout
        plan = tcp._sm90_plan(k, cins, n_out, F32, folded=folded, resident=resident)
        assert plan is not None, name
        cchunk, n_tiles, n_cb = plan
        assert cchunk % 8 == 0 and cchunk & (cchunk - 1) == 0, name
        assert n_tiles * 8 in tcp._SM90_N and n_tiles * 8 <= 64, name
        assert n_tiles * 8 * n_cb >= n_out > n_tiles * 8 * (n_cb - 1), name
        res = tcp._sm90_res_chunks(cins, plan, resident)
        assert tcp._sm90_smem_bytes(k, cchunk, n_tiles, F32, folded,
                                    res) <= tcp._SMEM_MAX, name
        rows = sm90_rows(cins, cchunk)
        owner = np.repeat(np.arange(len(cins)), cins)
        for ch in range(len(rows) // cchunk):
            ops = {owner[r] for r in rows[ch * cchunk:(ch + 1) * cchunk] if r is not None}
            assert len(ops) == 1, (name, ch)
        if kernel == "conv_packed":
            assert tcp.supports(cins, k, cout), name
        else:
            assert supports[kernel](cins[0], k, cout), name
    assert [tcp._sm90_rows(n, F32) for n in (8, 16, 32, 64)] == [8, 8, 8, 4]
    assert [tcp._sm90_rows(n, F32, 7) for n in (8, 16, 32)] == [12, 12, 8]
    assert tcp._sm90_plan(7, (32,), 32, F32, resident=True) == (8, 2, 2)
    assert tcp._sm90_smem_bytes(7, 8, 4, F32) > tcp._SMEM_MAX
    assert tcp._sm90_plan(3, (512,), 512, F32, resident=True) == (8, 8, 8)
    assert tcp._sm90_plan(3, (32, 32), 32, F32, resident=True) == (16, 4, 1)
    assert tcp._sm90_plan(3, (32,), 4, F32, resident=True) == (32, 1, 1)
    # K9: N = 64 and 2 rows a consumer; u3c1's 128 folded channels are two
    # channel blocks, one per output parity, each building the tile's halo
    assert tcp._sm90_plan(3, (128,), 128, F32, folded=True) == (8, 8, 2)
    assert tcp._sm90_plan(3, (64,), 64, F32, folded=True) == (8, 8, 1)
    # the edge sums of two tiles (4 rows x 64 channels a side) beside K6's layout
    assert tcp._sm90_smem_bytes(3, 8, 8, F32, True) == tcp._sm90_smem_bytes(
        3, 8, 8, F32) + 2 * 2 * 4 * 64 * 4
    # K7 and K8: a k 5 chunk of float32 weights at N = 64 leaves no room for
    # two buffers, so d1c1 takes N = 32 in two channel blocks; d2c1 and u2c1
    # N = 64 in two; nothing is resident at the model's sites
    assert tcp._sm90_plan(5, (32,), 64, F32, resident=True) == (8, 4, 2)
    assert tcp._sm90_plan(3, (64,), 128, F32, resident=True) == (8, 8, 2)
    assert tcp._sm90_plan(3, (256,), 128, F32) == (8, 8, 2)
    assert tcp._sm90_smem_bytes(5, 8, 8, F32) > tcp._SMEM_MAX
    # K7 at cin 8: its one chunk resident beside three halo buffers fits
    # (211,528 bytes) where two buffers with their weights do not (289,352)
    assert tcp._sm90_plan(5, (8,), 64, F32, resident=True) == (8, 8, 1)
    assert tcp._sm90_smem_bytes(5, 8, 8, F32, False, 1) == 211528
    # float32 halo, weights (two planes) and staged row against bfloat16
    assert tcp._sm90_smem_bytes(3, 8, 4, F32) == tcp._sm90_smem_bytes(3, 16, 4) + 3 * (
        9 * 8 * 32 * 8 - 9 * 16 * 32 * 2) + 2 * 64 * 32 * 2


def test_no_fallback_for_float32(rng, monkeypatch, tmp_path):
    """A float32 tensor on a device without a kernel raises (no plain
    version), and without a CUDA compiler the Hopper core's libraries do not
    build: its float32 weight prep (K9's fold included) and libraries raise,
    and no launch is counted. All five kernels route float32 to the Hopper
    core: there is no other float32 kernel source."""
    assert sorted(tcp._SM90_KERNELS) == sorted(tcp._SM90_SOURCE) == sorted(_build._PACKED)
    assert set(tcp._SM90_SOURCE.values()) == {"conv_packed_sm90", "conv_up_sm90"}
    assert "conv_packed" not in _build.sources() and not hasattr(tcp, "_lib")
    x = t(rng.standard_normal((1, 4, 6, 16)).astype(np.float32))
    w = t(rng.standard_normal((3, 3, 16, 8)).astype(np.float32))
    b = t(rng.standard_normal(8).astype(np.float32))
    xm, wm, bm = x.to("meta"), w.to("meta"), b.to("meta")
    with pytest.raises(RuntimeError, match="no conv_packed kernel for device meta"):
        tcp.conv_packed([xm[..., :8], xm[..., 8:]], wm, bm, S)
    with pytest.raises(RuntimeError, match="no conv_up_packed kernel for device meta"):
        tcp.conv_up_packed(xm, wm, bm, S)
    with pytest.raises(RuntimeError, match="no conv_up_f_packed kernel for device meta"):
        tcp.conv_up_f_packed(xm, wm, bm, S)
    with pytest.raises(RuntimeError, match="no conv_pool_packed kernel for device meta"):
        tcp.conv_pool_packed(xm, wm, bm, S)
    with pytest.raises(RuntimeError, match="no conv_up_m_packed kernel for device meta"):
        tcp.conv_up_m_packed(xm, wm, bm, S)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    before = _build.launch_counts()
    for call in (lambda: tcp._prep_on_card("conv_packed", wm, bm, (8, 8), f32=True),
                 lambda: tcp._prep_on_card("conv_up_packed", wm, bm, f32=True),
                 lambda: tcp._prep_on_card("conv_up_f_packed", wm, bm, f32=True),
                 lambda: tcp._prep_on_card("conv_pool_packed", wm, bm, f32=True),
                 lambda: tcp._prep_on_card("conv_up_m_packed", wm, bm, f32=True),
                 lambda: tcp._f32_promotion(1), lambda: tcp._lib_sm90("conv_packed_sm90"),
                 lambda: tcp._lib_sm90("conv_up_sm90")):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert _build.launch_counts() == before
