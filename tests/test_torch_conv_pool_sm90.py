"""The host side of K7 (``conv_pool_packed``) on the Hopper core of K8 and K9
(``csrc/conv_up_sm90.cu``): the weight layout that the core's wgmma B
descriptor reads, located element by element through its address formula;
the tile and shared-memory planner at K7's sites of the 1080p and 4K
cascades; the routing gate; and that the wrapper refuses a tensor it has no
kernel for instead of falling back."""

import numpy as np
import pytest
import torch

from rrin_tpu_torch import ModelConfig, _build
from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import check_sm90_layout, fresh_rng, one_torch_thread, t  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


@pytest.mark.parametrize("q", [False, True], ids=["bf16", "int8"])
def test_weight_layout_read_by_the_core(rng, q):
    """``prep_conv_pool`` lays out the conv's own weights (K8's layout, no
    fold): every byte that the core reads holds the weight (bf16, or the int8
    code) of its (dy, tap, channel-in, channel-out), zero where cin or cout
    is padding; the weight prep on the card computes the same bf16 bytes."""
    k, cin, cout = 5, 40, 20
    w = t(rng.standard_normal((k, k, cin, cout)).astype(np.float32))
    b = t(rng.standard_normal(cout).astype(np.float32))
    ax = 1.3 if q else None
    pr = tcp.prep_conv_pool(w, b, ax)
    ref = tcp._quantize_weights([w], (ax,))[0][0].float() if q else w
    assert pr["plan"] == tcp._sm90_plan(k, cin, cout, q, resident=True)
    assert pr["wfrag"].shape[3] == k
    check_sm90_layout(pr, ref, k, q)
    assert torch.equal(pr["wfrag"], tcp._sm90_weights(ref, (cin,), *pr["plan"][:2], q))


# (name, k, cin, cout, the plan (cchunk, n_tiles, n_cb) and whether the
# weights are resident, in bf16, in int8): K7's two sites of every U-Net,
# d1c1 reading 1088x1920x32 at 1080p and 2160x3840x32 at 4K (the planner has
# no spatial input, so one plan serves both), d2c1 reading 544x960x64. All
# output channels are in one block. At d1c1 three buffers that each hold a
# chunk's stencil weights do not fit (bf16: 3 x 88,064 bytes at a chunk of
# 16), so the weights of both chunks stay resident beside three halo
# buffers; a bf16 chunk of 32 fits in neither way.
POOL_SITES = [
    ("d1c1", 5, 32, 64, ((16, 8, 1), True), ((32, 8, 1), True)),
    ("d1c1_4k", 5, 32, 64, ((16, 8, 1), True), ((32, 8, 1), True)),
    ("d2c1", 3, 64, 128, ((16, 16, 1), False), ((64, 16, 1), True)),
]


@pytest.mark.parametrize("q", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("site", POOL_SITES, ids=[s[0] for s in POOL_SITES])
def test_planner_at_the_pool_sites(site, q):
    """The plan of each K7 site and element type, and the shared memory it
    takes: within the 227 KB of a block, every output channel in one block,
    chunks that the producers split evenly, the widest chunk that fits."""
    name, k, cin, cout, want_bf16, want_int8 = site
    want_plan, want_resident = want_int8 if q else want_bf16
    plan = tcp._sm90_plan(k, cin, cout, q, resident=True)
    assert plan == want_plan, name
    cchunk, n_tiles, n_cb = plan
    assert cchunk % (32 if q else 16) == 0 and cchunk & (cchunk - 1) == 0
    assert n_cb == 1 and n_tiles * 8 >= cout
    res = tcp._sm90_res_chunks(cin, plan, True)
    assert res == -(-cin // cchunk)
    smem = tcp._sm90_smem_bytes(k, cchunk, n_tiles, q, False, res)
    assert smem <= tcp._SMEM_MAX
    assert (smem != tcp._sm90_smem_bytes(k, cchunk, n_tiles, q)) == want_resident, name
    wider = 2 * cchunk
    assert wider > -(-cin // 16) * 16 or tcp._sm90_smem_bytes(
        k, wider, n_tiles, q, False, -(-cin // wider)) > tcp._SMEM_MAX


def test_routing_and_no_fallback(rng, monkeypatch, tmp_path):
    """``supports_pool`` takes both pool sites of ``ModelConfig()`` onto the
    core and nothing it has no kernel for; a tensor on a device without a
    kernel raises, and without a CUDA compiler neither the core nor its
    weight prep builds: no fallback, no launch counted."""
    cfg = ModelConfig()
    w1, w2, w3 = cfg.widths[:3]
    assert tcp.supports_pool(w1, cfg.down_kernels[0], w2)
    assert tcp.supports_pool(w2, cfg.down_kernels[1], w3)
    assert not tcp.supports_pool(32, 7, 64) and not tcp.supports_pool(12, 3, 64)
    x = t(rng.standard_normal((1, 8, 12, 16)).astype(np.float32)).to(torch.bfloat16)
    w = t(rng.standard_normal((3, 3, 16, 8)).astype(np.float32))
    b = t(rng.standard_normal(8).astype(np.float32))
    with pytest.raises(RuntimeError, match="no conv_pool_packed kernel for device meta"):
        tcp.conv_pool_packed(x.to("meta"), w.to("meta"), b.to("meta"), 0.1)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcp._prep_on_card("conv_pool_packed", w.to("meta"), b.to("meta"))
    assert _build.launch_counts() == before
