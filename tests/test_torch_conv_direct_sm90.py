"""The host side of K5 (``conv_packed``) and K6 (``conv_up_packed``) on the
Hopper core (``csrc/conv_sm90.cuh``, entry points in
``csrc/conv_packed_sm90.cu``): the weight layout that the core's wgmma B
descriptor reads, located element by element through its address formula,
for several operands, a stem and K6 at k 1 and 3; the tile and
shared-memory planner at every K5/K6 site of the 1080p and 4K cascades and
of ``chip_smoke.py``, k 7 included, with no chunk straddling two operands;
and that the wrappers refuse a tensor they have no kernel for instead of
falling back."""

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


@pytest.fixture
def rng():
    return fresh_rng()


# (name, kernel, k, operands' channels, cout)
LAYOUTS = [
    ("two_operands", "conv_packed", 3, (24, 16), 20),
    ("stem_cin6", "conv_packed", 7, (6,), 12),
    ("k6_k1", "conv_up_packed", 1, (24,), 12),
    ("k6_k3", "conv_up_packed", 3, (40,), 20),
]


@pytest.mark.parametrize("q", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("site", LAYOUTS, ids=[s[0] for s in LAYOUTS])
def test_weight_layout_read_by_the_core(rng, site, q):
    """Every byte that the core reads holds the weight (bf16, or the int8
    code, operand i's rows pre-scaled by ax_i/ax_0) of its (dy, tap,
    channel-in, channel-out), zero where an operand's chunk (the stem's 6
    channels in a chunk of 16 or 32) or the output channels are padding."""
    _, kernel, k, cins, cout = site
    w = t(rng.standard_normal((k, k, sum(cins), cout)).astype(np.float32))
    b = t(rng.standard_normal(cout).astype(np.float32))
    axs = (1.3, 0.7)[:len(cins)] if q else None
    if kernel == "conv_packed":
        pr = tcp.prep_conv(w, b, cins, axs)
    else:
        pr = tcp.prep_conv_up(w, b, axs[0] if q else None)
    ref = w
    if q:
        ref = torch.cat(tcp._quantize_weights(torch.split(w, cins, dim=2), axs)[0], 2).float()
    assert pr["plan"] == tcp._sm90_plan(k, cins, cout, q, resident=kernel == "conv_packed")
    assert pr["cins"] == cins and pr["wfrag"].shape[3] == k
    check_sm90_layout(pr, ref, k, q, cins)


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
]


@pytest.mark.parametrize("q", [False, True], ids=["bf16", "int8"])
def test_planner_fits_every_site(q):
    """Each plan holds every output channel up to 128 in one block, takes
    chunks that the producers split evenly (powers of two, whole k-steps),
    none of which holds channels of two operands, and fits the 227 KB of
    shared memory; the support gates agree. At k 7 (c2) a chunk of 32 bf16
    channels does not fit: its weights alone are 100,352 bytes a buffer, so
    the plan takes chunks of 16 and two buffers (and the stems, one chunk,
    keep their weights resident)."""
    kk = 32 if q else 16
    for name, kernel, k, cins, cout in SITES:
        resident = kernel == "conv_packed"
        plan = tcp._sm90_plan(k, cins, cout, q, resident=resident)
        assert plan is not None, name
        cchunk, n_tiles, n_cb = plan
        assert cchunk % kk == 0 and cchunk & (cchunk - 1) == 0, name
        assert n_tiles * 8 in tcp._SM90_N, name
        assert n_tiles * 8 * n_cb >= cout > n_tiles * 8 * (n_cb - 1), name
        assert n_cb == 1 or n_tiles == 16, name
        res = tcp._sm90_res_chunks(cins, plan, resident)
        assert tcp._sm90_smem_bytes(k, cchunk, n_tiles, q, False, res) <= tcp._SMEM_MAX, name
        rows = sm90_rows(cins, cchunk)
        assert len(rows) == tcp._sm90_chunks(cins, cchunk) * cchunk
        owner = np.repeat(np.arange(len(cins)), cins)
        for ch in range(len(rows) // cchunk):
            ops = {owner[r] for r in rows[ch * cchunk:(ch + 1) * cchunk] if r is not None}
            assert len(ops) == 1, (name, ch)
        if kernel == "conv_packed":
            assert tcp.supports(cins, k, cout), name
        else:
            assert tcp.supports_up(cins[0], k, cout), name
    c2 = tcp._sm90_plan(7, (32,), 32, q, resident=True)
    assert c2 == ((32, 4, 1) if q else (16, 4, 1))
    assert tcp._sm90_smem_bytes(7, 2 * kk, 4, q) > tcp._SMEM_MAX
    stem = tcp._sm90_plan(7, (6,), 32, q, resident=True)
    assert stem[0] == kk and tcp._sm90_smem_bytes(7, kk, 4, q, False, 1) != (
        tcp._sm90_smem_bytes(7, kk, 4, q))


def test_no_fallback_without_a_kernel(rng, monkeypatch, tmp_path):
    """A tensor on a device without a kernel raises (no plain version), and
    without a CUDA compiler the core's library does not build: the wrappers'
    library and the on-card weight prep raise instead of falling back, and
    no launch is counted."""
    x = t(rng.standard_normal((1, 4, 6, 16)).astype(np.float32)).to(torch.bfloat16)
    w = t(rng.standard_normal((3, 3, 16, 8)).astype(np.float32))
    b = t(rng.standard_normal(8).astype(np.float32))
    xm, wm, bm = x.to("meta"), w.to("meta"), b.to("meta")
    with pytest.raises(RuntimeError, match="no conv_packed kernel for device meta"):
        tcp.conv_packed([xm[..., :8], xm[..., 8:]], wm, bm, S)
    with pytest.raises(RuntimeError, match="no conv_up_packed kernel for device meta"):
        tcp.conv_up_packed(xm, wm, bm, S)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcp._prep_on_card("conv_packed", wm, bm, (8, 8))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcp._prep_on_card("conv_up_packed", wm, bm)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcp._lib_sm90("conv_packed_sm90")
    assert _build.launch_counts() == before
