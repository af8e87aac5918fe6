"""The float32 mode of the packed-path kernels K5-K9 on the CPU: the plans
and shared memory of the float32 kernels, the split TF32 weight layout, the
checks made before a float32 launch, a plain-PyTorch emulation of the split
("3xTF32") products against the float32 bar, and each kernel's plain version
in float32 against the JAX package's Pallas body run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.ops import conv_packed as jcp
from rrin_tpu.ops.packed import pack, unpack
from rrin_tpu_torch import ModelConfig
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.ops import conv_packed as tcp
from rrin_tpu_torch.ops.conv_phase import _conv_plain, _leaky
from rrin_tpu_torch.ops.resize import _upsample_2x_axis
from torch_packed_util import case, fresh_rng, interpreted, one_torch_thread, t  # noqa: F401

# The reference's bar between its packed and plain float32 U-Nets
# (tests/test_unet_packed.py), which the float32 kernels are held to.
F32_BAR = dict(atol=1e-5, rtol=1e-5)
CFG = ModelConfig()


@pytest.fixture
def rng():
    return fresh_rng()


def _sites(cfg):
    """(kernel, k, cins, cout) of every conv of a U-Net on the packed path."""
    w1, w2, w3, w4, w5 = cfg.widths
    k, sk = cfg.down_kernels, cfg.stem_kernel
    conv = [(sk, (cin,), w1) for cin in (6, 9, 10, 16)] + [
        (sk, (w1,), w1), (k[0], (w2,), w2), (k[1], (w3,), w3), (k[2], (w3,), w4),
        (k[2], (w4,), w4), (k[3], (w4,), w5), (k[3], (w5,), w5), (3, (w5,), w4),
        (3, (w4, w4), w4), (3, (w3, w3), w3), (3, (w2, w2), w2), (3, (w1, w1), w1),
    ] + [(3, (w1,), c) for c in (2, 3, 4)]
    return ([("conv_packed", kk, cins, cout) for kk, cins, cout in conv]
            + [("conv_pool_packed", k[0], (w1,), w2), ("conv_pool_packed", k[1], (w2,), w3),
               ("conv_up_m_packed", 3, (w4,), w3)]
            + [(name, 3, (cin,), cout) for name in ("conv_up_f_packed", "conv_up_packed")
               for cin, cout in ((w3, w2), (w2, w1))])


def test_float32_plans_fit_every_site():
    """Every site that the bfloat16 and int8 plans accept has a float32 plan
    on the Hopper core that fits shared memory, so that routing does not
    depend on the dtype: all five kernels (K9 folded, 2*cout channels a GEMM
    pixel); 1080p and 4K take the packed path at every site."""
    supports = {"conv_packed": lambda k, cins, cout: tcp.supports(cins, k, cout),
                "conv_pool_packed": lambda k, cins, cout: tcp.supports_pool(cins[0], k, cout),
                "conv_up_m_packed": lambda k, cins, cout: tcp.supports_up_m(cins[0], k, cout),
                "conv_up_f_packed": lambda k, cins, cout: tcp.supports_up_f(cins[0], k, cout),
                "conv_up_packed": lambda k, cins, cout: tcp.supports_up(cins[0], k, cout)}
    for name, k, cins, cout in _sites(CFG):
        assert supports[name](k, cins, cout), (name, cins)
        folded, resident = tcp._SM90_KERNELS[name]
        n_out = 2 * cout if folded else cout
        plan = tcp._sm90_plan(k, cins, n_out, tcp.F32, folded=folded, resident=resident)
        assert plan is not None, (name, cins)
        cchunk, n_tiles, n_cb = plan
        assert cchunk % 8 == 0 and n_cb * n_tiles * 8 >= n_out and n_tiles <= 8
        res = tcp._sm90_res_chunks(cins, plan, resident)
        assert tcp._sm90_smem_bytes(k, cchunk, n_tiles, tcp.F32, folded,
                                    res) <= tcp._SMEM_MAX
    for h, w, up in ((1088, 1920, 2), (2160, 3840, 1)):
        assert tunet.packed_supported(h, w, CFG)
        assert tunet.packed_branch_flags(h, w, CFG)[4:6] == (up, up)


def _gather_f32(frag, wt, cins, cchunk, n_tiles):
    """Every element of a float32 fragment tensor ([...][g][tig][plane][r][p])
    against a gather of ``wt`` (ky, taps, sum(cins), n_out): where the tf32
    m16n8k8 B fragment reads it (b0 = B[tig][g], b1 = B[tig + 4][g])."""
    wt = wt.numpy()
    starts, rows, row = [], [], 0
    for c in cins:
        for ch in range(-(-c // cchunk)):
            starts.append(row + ch * cchunk)
            rows.append(row + c)
        row += c
    f = frag.numpy()
    assert f.shape[1] == len(starts) and f.shape[-3:] == (2, 2, 1)
    want = np.zeros(f.shape[:-3] + (2,), np.float32)
    for idx in np.ndindex(*want.shape):
        cb, ch, dy, tap, ks, nt, g, tig, r = idx
        ci = starts[ch] + ks * 8 + r * 4 + tig
        co = (cb * n_tiles + nt) * 8 + g
        if ci < rows[ch] and co < wt.shape[3]:
            want[idx] = wt[dy, tap, ci, co]
    hi, lo = f[..., 0, :, 0], f[..., 1, :, 0]
    np.testing.assert_array_equal(hi, tcp._tf32(torch.from_numpy(want)).numpy())
    np.testing.assert_array_equal(lo, tcp._tf32(torch.from_numpy(want - hi)).numpy())
    # hi + lo is exact in float32 and within 2^-22 of the weight
    assert (np.abs(hi.astype(np.float64) + lo - want) <= 2.0 ** -22 * np.abs(want)).all()
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(want)).all()


@pytest.mark.parametrize("kind", ["conv", "up_f"])
def test_float32_weight_layout(rng, kind):
    """The two TF32 planes of a float32 prep in the Hopper core's layout
    (read in fragment order): K5's, and K9's folded taps."""
    if kind == "conv":
        cins, k, cout = (40, 12), 3, 70
        w = t(rng.standard_normal((k, k, sum(cins), cout)).astype(np.float32))
        b = t(rng.standard_normal(cout).astype(np.float32))
        pr = tcp.prep_conv(w, b, cins, dtype=torch.float32)
        ref, plan = w, tcp._sm90_plan(k, cins, cout, tcp.F32, resident=True)
        tcp._check_sm90_layout("conv_packed", pr)
    else:
        cins, k, cout = (24,), 3, 12
        w = t(rng.standard_normal((k, k, 24, cout)).astype(np.float32))
        b = t(rng.standard_normal(cout).astype(np.float32))
        pr = tcp.prep_conv_up_f(w, b, dtype=torch.float32)
        ref = tcp._upf_taps(w)
        plan = tcp._sm90_plan(k, cins, ref.shape[3], tcp.F32, folded=True)
        assert torch.equal(pr["bias"], torch.cat([b, b]))
        tcp._check_sm90_layout("conv_up_f_packed", pr)
    cchunk, n_tiles, _ = pr["plan"]
    assert pr["plan"] == plan
    assert pr["wfrag"].dtype == torch.float32
    assert not pr["q"] and pr["scale"] is None
    _gather_f32(pr["wfrag"], ref, cins, cchunk, n_tiles)


def test_check_cuda_refuses_a_prep_of_another_dtype(rng):
    x, w, b = case(rng, (1, 8, 8, 16), 3, 16, 8)
    x, w, b = t(x), t(w), t(b)
    xb = x.to(torch.bfloat16)
    f32 = tcp.prep_conv(w, b, (16,), dtype=torch.float32)
    bf16 = tcp.prep_conv(w, b, (16,))
    assert tcp._check_cuda("conv_packed", [x], w, b, f32, (16,), 3, 8) is f32
    assert tcp._check_cuda("conv_packed", [xb], w, b, bf16, (16,), 3, 8) is bf16
    with pytest.raises(ValueError, match="prepared= holds torch.bfloat16"):
        tcp._check_cuda("conv_packed", [x], w, b, bf16, (16,), 3, 8)
    with pytest.raises(ValueError, match="prepared= holds torch.float32"):
        tcp._check_cuda("conv_packed", [xb], w, b, f32, (16,), 3, 8)
    for prep in (tcp.prep_conv_pool, tcp.prep_conv_up_m, tcp.prep_conv_up_f, tcp.prep_conv_up):
        pr = prep(w, b, dtype=torch.float32)
        assert pr["wfrag"].dtype == torch.float32
        with pytest.raises(ValueError, match="prepared= holds torch.float32"):
            tcp._check_cuda("conv_pool_packed", [xb], w, b, pr, (16,), 3, 8)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tcp.prep_conv(w, b, (16,), dtype=torch.float16)


def _split(x):
    hi = tcp._tf32(x)
    return hi, tcp._tf32(x - hi)


def _emulated(contract, a, b):
    """The kernels' products in float64: lo_a*hi_b + hi_a*lo_b + hi_a*hi_b
    (each product of two TF32 parts is exact in float32), and one TF32
    product alone."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    d = torch.float64
    three = (contract(al.to(d), bh.to(d)) + contract(ah.to(d), bl.to(d))
             + contract(ah.to(d), bh.to(d)))
    return three, contract(ah.to(d), bh.to(d))


@pytest.mark.parametrize("site", ["K5_d4c2", "K9_u3c1"])
def test_split_tf32_meets_the_float32_bar(rng, site):
    """The split products (hi/lo by tf32 rounding, the dropped lo*lo) stay
    within 1e-5 of the float32 conv at full channel depth; one TF32 product
    alone does not (about 2^-12 of each product)."""
    if site == "K5_d4c2":
        cin, cout, x_shape = 512, 64, (1, 8, 12, 512)
    else:
        cin, cout, x_shape = 128, 64, (1, 8, 12, 128)
    x = t(rng.standard_normal(x_shape).astype(np.float32))
    bound = 1.0 / np.sqrt(9 * cin)
    w = t(rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32))
    b = t(rng.uniform(-bound, bound, cout).astype(np.float32))
    if site == "K5_d4c2":
        def contract(xx, ww):
            return _conv_plain(xx, ww, torch.zeros(cout, dtype=xx.dtype), None)
        three, one = _emulated(contract, x, w)
        want = _conv_plain(x, w, b, 0.1)
    else:
        rows = _upsample_2x_axis(x, 1)                        # H-interpolated, float32
        taps = tcp._upf_taps(w)                               # folded in float32
        three, one = _emulated(tcp._fold_apply, rows, taps)
        want = tcp._conv_up_plain(x, w, b, 0.1)
    got = _leaky(three + b.double(), 0.1).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_BAR)
    single = _leaky(one + b.double(), 0.1).float()
    assert not np.allclose(single.numpy(), want.numpy(), **F32_BAR)


def _jax_f32(fn, *args):
    y, spec = interpreted(fn, *args)
    return np.asarray(unpack(y, spec))


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8", "K9"])
def test_float32_plain_matches_interpreted_kernel(rng, kernel):
    """Each kernel's plain version in float32 (what a float32 launch is held
    to on the card) against the JAX package's Pallas body in float32,
    interpreted, at the reference's packed-vs-plain float32 bar."""
    if kernel == "K5":
        xs = [rng.random((1, 32, 24, 64), dtype=np.float32) - 0.5 for _ in range(2)]
        _, w, b = case(rng, (1, 1, 1, 1), 3, 128, 64)
        parts = [(*pack(jnp.asarray(x), 2, 1, 16), 64) for x in xs]
        want = _jax_f32(jcp.conv_packed, parts, jnp.asarray(w), jnp.asarray(b), 0, 0.1)
        got = tcp.conv_packed([t(x) for x in xs], t(w), t(b), 0.1)
    elif kernel == "K6":
        x, w, b = case(rng, (2, 16, 27, 64), 3, 64, 32)
        xp, spec = pack(jnp.asarray(x), 2, 0, 16)
        want = _jax_f32(jcp.conv_up_packed, xp, spec, 64, jnp.asarray(w), jnp.asarray(b), 3,
                        0.1)
        got = tcp.conv_up_packed(t(x), t(w), t(b), 0.1)
    elif kernel == "K7":
        x, w, b = case(rng, (1, 64, 28, 64), 3, 64, 128)
        xp, spec = pack(jnp.asarray(x), 2, 1, 16)
        want = _jax_f32(jcp.conv_pool_packed, xp, spec, 64, jnp.asarray(w), jnp.asarray(b), 0,
                        0.1)
        got = tcp.conv_pool_packed(t(x), t(w), t(b), 0.1)
    elif kernel == "K8":
        x, w, b = case(rng, (1, 16, 14, 64), 3, 64, 64)
        xp, spec = pack(jnp.asarray(x), 1, 0, 16)
        want = _jax_f32(jcp.conv_up_m_packed, xp, spec, 64, jnp.asarray(w), jnp.asarray(b),
                        32, 0, 16, 0.1)
        got = tcp.conv_up_m_packed(t(x), t(w), t(b), 0.1)
    else:
        x, w, b = case(rng, (1, 16, 36, 64), 3, 64, 32)
        xp, spec = pack(jnp.asarray(x), 2, 0, 40)
        want = _jax_f32(jcp.conv_up_f_packed, xp, spec, 64, jnp.asarray(w), jnp.asarray(b), 3,
                        0.1)
        got = tcp.conv_up_f_packed(t(x), t(w), t(b), 0.1)
        # the fold in float32, as the float32 kernel contracts it
        np.testing.assert_allclose(tcp._conv_up_f_folded(t(x), t(w), t(b), 0.1).numpy(),
                                   want, **F32_BAR)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_BAR)
