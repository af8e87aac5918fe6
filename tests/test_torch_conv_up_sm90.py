"""The host side of K8 and K9 on their Hopper core (``csrc/conv_up_sm90.cu``):
the weight layout that its wgmma B descriptor reads, located element by
element through the core's own address formula; the tile and shared-memory
planner at every K8/K9 site of the 1080p and 4K cascades and of
``chip_smoke.py``; and that the wrappers refuse a tensor they have no kernel
for instead of falling back."""

import numpy as np
import pytest
import torch

from rrin_tpu_torch import _build
from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import check_sm90_layout, fresh_rng, one_torch_thread, t  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


@pytest.mark.parametrize("q", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("folded", [False, True], ids=["K8", "K9"])
def test_weight_layout_read_by_the_core(rng, folded, q):
    """Every byte that the core reads holds the weight (bf16, or the int8
    code) of its (dy, tap, channel-in, channel-out), zero where cin or cout
    is padding: the conv's own weights for K8, ``_upf_taps`` and its two edge
    taps (``_upf_q_taps`` in int8) for K9."""
    k, cin, cout = 3, 40, (12 if folded else 20)
    w = t(rng.standard_normal((k, k, cin, cout)).astype(np.float32))
    b = t(rng.standard_normal(cout).astype(np.float32))
    ax = 1.7 if q else None
    if folded:
        pr = tcp.prep_conv_up_f(w, b, ax)
        ref = tcp._upf_q_taps(w)[0] if q else tcp._upf_taps(w)
    else:
        pr = tcp.prep_conv_up_m(w, b, ax)
        ref = tcp._quantize_weights([w], (ax,))[0][0].float() if q else w
    assert pr["wfrag"].shape[3] == (5 if folded else k)
    check_sm90_layout(pr, ref, k, q)


# (name, k, cin, n_out = cout or 2*cout when folded, folded): every K8 and
# K9 site of the 1080p and 4K cascades (u2c1 at 136x240 and 270x480 inputs,
# u3c1 and u4c1 below width 3200) and of chip_smoke.py's ragged cases.
SITES = [
    ("u2c1", 3, 256, 128, False),
    ("u3c1", 3, 128, 128, True),
    ("u4c1", 3, 64, 64, True),
    ("ragged_m", 3, 64, 64, False),
    ("ragged_f", 3, 64, 64, True),
    ("edge_in_tile_m", 3, 128, 64, False),
    ("k5_m", 5, 64, 32, False),
]


@pytest.mark.parametrize("q", [False, True], ids=["bf16", "int8"])
def test_planner_fits_every_site(q):
    """The plan holds every output channel of a site in one block (N = 8 *
    n_tiles covers n_out, up to 128), takes channel chunks that the
    producers split evenly (powers of two, whole k-steps), and fits the 227
    KB of shared memory; the support gates agree."""
    kk = 32 if q else 16
    for name, k, cin, n_out, folded in SITES:
        plan = tcp._sm90_plan(k, cin, n_out, q, folded)
        assert plan is not None, name
        cchunk, n_tiles, n_cb = plan
        assert cchunk % kk == 0 and cchunk & (cchunk - 1) == 0, name
        assert n_tiles * 8 in tcp._SM90_N and n_cb == 1 and n_tiles * 8 >= n_out, name
        assert tcp._sm90_smem_bytes(k, cchunk, n_tiles, q, folded) <= tcp._SMEM_MAX, name
        cout = n_out // 2 if folded else n_out
        assert (tcp.supports_up_f if folded else tcp.supports_up_m)(cin, k, cout), name
    # wider than one block: two channel blocks of 128
    assert tcp._sm90_plan(3, 256, 256, q)[1:] == (16, 2)


def test_no_fallback_without_a_kernel(rng, monkeypatch, tmp_path):
    """A tensor on a device without a kernel raises (no plain version), and
    without a CUDA compiler the core's library does not build: the wrappers
    and the on-card weight prep raise instead of falling back."""
    x = t(rng.standard_normal((1, 4, 6, 16)).astype(np.float32)).to(torch.bfloat16)
    w = t(rng.standard_normal((3, 3, 16, 8)).astype(np.float32))
    b = t(rng.standard_normal(8).astype(np.float32))
    for fn in (tcp.conv_up_m_packed, tcp.conv_up_f_packed):
        with pytest.raises(RuntimeError, match="no conv_up_._packed kernel for device meta"):
            fn(x.to("meta"), w.to("meta"), b.to("meta"), 0.1)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    before = _build.launch_counts()
    for name in ("conv_up_m_packed", "conv_up_f_packed"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tcp._prep_on_card(name, w.to("meta"), b.to("meta"))
    assert _build.launch_counts() == before
