"""K1 (``conv_phase.conv2d_fused``) on the Hopper core of the packed path
(``csrc/conv_sm90.cuh``, entry point ``rrin_conv_phase_sm90_launch`` in
``csrc/conv_packed_sm90.cu``: mode DIRECT with one bf16 operand at k 3/5/7,
the streamed mode at the other odd k): the plan and shared memory at each
of the plain U-Net's nine site classes, the weights it prepares (K5's
one-operand layout, ``prep_conv``), its routing (``supports`` takes every
odd k, every cin and cout up to 64) and that a tensor without a kernel raises instead of
falling back. Host side only: the kernels run on the card
(``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from rrin_tpu_torch import ModelConfig, _build
from rrin_tpu_torch.ops import conv_packed as tpk
from rrin_tpu_torch.ops import conv_phase as tcp
from torch_packed_util import check_sm90_layout, fresh_rng, one_torch_thread, t  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


def _sites(cfg):
    """(name, k, cin, cout) of the plain U-Net's convs that reach K1."""
    w1, w2, _, _, _ = cfg.widths
    sk, k = cfg.stem_kernel, cfg.down_kernels
    return [("c1", sk, 6, w1), ("c2", sk, w1, w1), ("d1c1", k[0], w1, w2),
            ("d1c2", k[0], w2, w2), ("u3c1", 3, 2 * w2, w2), ("u3c2", 3, 2 * w2, w2),
            ("u4c1", 3, w2, w1), ("u4c2", 3, 2 * w1, w1), ("head", 3, w1, 4)]


def test_plan_at_every_site_class():
    """Every K1 site of the plain U-Net (and the stems' other cin 9, 10, 16)
    takes the core: its k is one DIRECT is built for, and its plan is K5's
    for one bf16 operand (resident weights where they fit), whole chunks
    of 16-64 channels, all output channels in one block (cout <= 64 at k 3
    and 5, and at k 7 where cout <= 32), within the 227 KB of shared
    memory. The other odd k take the streamed mode's plan."""
    sites = _sites(ModelConfig())
    sites += [(f"c1_cin{c}", 7, c, 32) for c in (9, 10, 16)]
    assert len(sites) == 12
    for name, k, cin, cout in sites:
        assert tcp.supports((1, 64, 96, cin), (k, k, cin, cout)) is not None, name
        assert k in tpk._K_CONV, name
        plan = tcp._sm90_plan(k, cin, cout)
        assert plan == tpk._sm90_plan(k, (cin,), cout, resident=True), name
        cchunk, n_tiles, n_cb = plan
        assert cchunk in tpk._SM90_CHUNKS[False] and n_cb == 1, name
        assert n_tiles * 8 >= cout > n_tiles * 4 or n_tiles == 1, name
        res = tpk._sm90_res_chunks((cin,), plan, True)
        assert tpk._sm90_smem_bytes(k, cchunk, n_tiles, False, False, res) <= tpk._SMEM_MAX
    assert tcp._sm90_plan(7, 6, 32) == (16, 4, 1)
    assert tcp._sm90_plan(3, 128, 64) == (32, 8, 1)
    for k in (1, 9):
        assert tcp._sm90_plan(k, 32, 32) == tpk._sm90_plan(k, (32,), 32, streamed=True)
    assert tcp._sm90_plan(9, 32, 32) == (32, 4, 1)
    for k, cin, cout in ((51, 32, 8), (39, 32, 64)):
        assert tcp._sm90_plan(k, cin, cout) == tpk._sm90_plan(k, (cin,), cout, streamed=True)
        assert tcp._sm90_plan(k, cin, cout) is not None


@pytest.mark.parametrize("k,cin,cout", [(7, 6, 32), (3, 40, 4)])
def test_prepared_weights_are_prep_conv_layout(rng, k, cin, cout):
    """The weights K1 launches with are laid out on the card by the core's
    prep kernel as ``prep_conv`` lays out one operand (its plain version):
    every bf16 weight where the wgmma descriptor reads it, zero in a
    stem's padded channels and past cout, with K1's plan."""
    w = t(rng.standard_normal((k, k, cin, cout)).astype(np.float32))
    b = t(rng.standard_normal(cout).astype(np.float32))
    pr = tpk.prep_conv(w, b, (cin,))
    assert pr["plan"] == tcp._sm90_plan(k, cin, cout)
    assert pr["wfrag"].dtype == torch.bfloat16 and torch.equal(pr["bias"], b)
    check_sm90_layout(pr, w, k, False, (cin,))
    tpk._check_sm90_layout("conv_packed", pr)


def test_wrapper_prepares_one_operand(rng, monkeypatch):
    """The route asks the core's prep for exactly ``prep_conv``'s one-operand
    weights (kernel ``conv_packed``, cins ``(cin,)``, K1's plan) before it
    launches, and checks its tensors."""
    x = t(rng.standard_normal((1, 8, 12, 6)).astype(np.float32)).to(torch.bfloat16)
    w = t(rng.standard_normal((7, 7, 6, 32)).astype(np.float32))
    b = t(rng.standard_normal(32).astype(np.float32))
    asked = []

    def prep(name, wt, bias, cins=None, f32=False, plan=None):
        asked.append((name, wt, bias, cins, f32, plan))
        raise RuntimeError("prep asked")

    monkeypatch.setattr(tpk, "_prep_on_card", prep)
    with pytest.raises(RuntimeError, match="prep asked"):
        tcp._conv_sm90(x, w, b, 0.1)
    assert len(asked) == 1
    name, wt, bias, cins, f32, plan = asked[0]
    assert (name, cins, f32) == ("conv_packed", (6,), False) and wt is w and bias is b
    assert plan == tcp._sm90_plan(7, 6, 32) == tpk._sm90_plan(7, (6,), 32, resident=True)
    with pytest.raises(ValueError, match="bias must be"):
        tcp._conv_sm90(x, w, b[:4], 0.1)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        tcp._conv_sm90(x.transpose(1, 2), w, b, 0.1)
    with pytest.raises(RuntimeError, match="forward-only"):
        tcp._conv_sm90(x, w.requires_grad_(), b, 0.1)
    assert len(asked) == 1


def test_supports_as_before_on_a_grid():
    """``supports`` takes every odd k 1-129, every cout 1-64 and every cin,
    whatever H and W, and answers the core's plan's chunk: K5's plan at k
    3/5/7, the streamed mode's at the other k. It refuses even k, cout > 64
    and a stencil that is not square."""
    for k in range(1, 130, 2):
        for cin in (1, 3, 6, 9, 10, 16, 32, 48, 64, 128, 256, 512):
            for cout in range(1, 65):
                plan = tpk._sm90_plan(k, (cin,), cout, resident=k in tpk._K_CONV,
                                      streamed=k not in tpk._K_CONV)
                assert plan is not None, (k, cin, cout)
                for hw in ((32, 64), (1088, 1920), (33, 45)):
                    got = tcp.supports((1, *hw, cin), (k, k, cin, cout))
                    assert got == plan[0], (k, cin, cout, hw)
            for cout in (65, 128):
                assert tcp.supports((1, 32, 64, cin), (k, k, cin, cout)) is None
        assert tcp.supports((1, 32, 64, 32), (k, k + 1, 32, 32)) is None
        assert tcp.supports((1, 32, 64, 32), (k + 1, k + 1, 32, 32)) is None
    assert tcp.supports((1, 32, 64, 32), (4, 4, 32, 32)) is None


def test_no_fallback_without_a_kernel(rng, monkeypatch, tmp_path):
    """A bf16 tensor on a device without a kernel raises, and without a CUDA
    compiler K1 does not build at k 3 (DIRECT) or k 9 (the streamed mode):
    the core's weight prep raises, no launch is counted. A CPU tensor takes
    the plain version, and nothing else decides."""
    x = t(rng.standard_normal((1, 8, 12, 32)).astype(np.float32)).to(torch.bfloat16)
    w3 = t(rng.standard_normal((3, 3, 32, 16)).astype(np.float32))
    w9 = t(rng.standard_normal((9, 9, 32, 16)).astype(np.float32))
    b = t(rng.standard_normal(16).astype(np.float32))
    for w in (w3, w9):
        assert torch.equal(tcp.conv2d_fused(x, w, b, 0.1), tcp._conv_plain(x, w, b, 0.1))
        with pytest.raises(RuntimeError, match="no conv kernel for device meta"):
            tcp.conv2d_fused(x.to("meta"), w.to("meta"), b.to("meta"), 0.1)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    before = _build.launch_counts()
    for w in (w3, w9):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tcp._conv_sm90(x, w, b, 0.1)
    assert _build.launch_counts() == before
