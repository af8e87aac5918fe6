"""The int8 mode of the packed-path convs (K5-K9) on the CPU: the port's
quantisers against the JAX package's bit for bit, and the int8 plain version
of each of the five wrappers against the JAX package's fake-quant ``_xla``
reference on the same numpy inputs and the same calibrated absmax, packed
and unpacked on the JAX side only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.ops import conv_packed as jcp
from rrin_tpu.ops.packed import PackedSpec, pack, unpack
from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import case, fresh_rng, gather, one_torch_thread, t  # noqa: F401

# The bar of the JAX package's own int8 kernels against these references
# (tests/test_conv_int8.py): the same grid, float32 sums in another order.
Q_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture
def rng():
    return fresh_rng()


def _ax(a):
    return float(np.abs(a).max())


def _codes(x, ax):
    return np.clip(np.round(x * np.float32(127.0 / ax)), -127, 127).astype(np.int8)


def _assert_out(got, want):
    """float outputs to Q_TOL; int8 outputs (a grid of their own) within one
    step, on under 1 % of the elements."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    else:
        np.testing.assert_allclose(got, want, **Q_TOL)


def test_quantize_act_bit_equal(rng):
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 200.0, -300.0, 0.0],
                    np.float32)
    for x, ax in ((ties, 127.0), (rng.standard_normal(4096).astype(np.float32), 1.7),
                  (ties, 0.0)):
        want = np.asarray(jcp._quantize_act(jnp.asarray(x), jnp.float32(ax)))
        got = tcp._quantize_act(t(x), torch.tensor(ax)).numpy()
        assert got.dtype == np.int8 and np.array_equal(got, want)
    assert np.array_equal(tcp._quantize_act(t(ties), 127.0).numpy(),
                          [0, 2, 2, 0, -2, 126, -126, 127, -127, 0])
    # Dequantised codes interpolated as K6 does land on exact ties of the
    # grid: 127/ax and ax/127 must be true divisions (not a reciprocal times
    # 127, which PyTorch's ``127.0 / t`` computes) to round as the reference.
    codes = rng.integers(-127, 128, (2, 4096)).astype(np.float32)
    for ax in rng.uniform(0.5, 4.0, 24).astype(np.float32):
        deq = codes * (ax / np.float32(127.0))
        assert np.array_equal(tcp._over127(torch.tensor(ax)).numpy(), ax / np.float32(127.0))
        x = np.float32(0.25) * deq[0] + np.float32(0.75) * deq[1]
        want = np.asarray(jcp._quantize_act(jnp.asarray(x), jnp.float32(ax)))
        assert np.array_equal(tcp._quantize_act(t(x), torch.tensor(ax)).numpy(), want)


def test_quantize_weights_bit_equal(rng):
    w0 = rng.standard_normal((3, 3, 16, 24)).astype(np.float32)
    w1 = rng.standard_normal((3, 3, 8, 24)).astype(np.float32) * 3.0
    ax = (np.float32(0.37), np.float32(41.0))
    (j0, j1), jsw = jcp._quantize_weights([jnp.asarray(w0), jnp.asarray(w1)],
                                          tuple(jnp.asarray(a) for a in ax))
    (q0, q1), sw = tcp._quantize_weights([t(w0), t(w1)], [torch.tensor(a) for a in ax])
    assert np.array_equal(q0.numpy(), np.asarray(j0))
    assert np.array_equal(q1.numpy(), np.asarray(j1))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))


def _jax_conv(xs, w, b, slope, axs, out_ax, p, m=16, off_out=0):
    """The JAX package's ``_conv_packed_xla`` on packed copies of ``xs``."""
    parts = [pack(jnp.asarray(x), p, 0, m) for x in xs]
    y = jcp._conv_packed_xla(
        [xp for xp, _ in parts], jnp.asarray(w), jnp.asarray(b), [s for _, s in parts],
        [x.shape[-1] for x in xs], off_out, slope, tuple(jnp.float32(a) for a in axs),
        None if out_ax is None else jnp.float32(out_ax), jnp.float32)
    return unpack(y, PackedSpec(p=p, c=w.shape[3], w=xs[0].shape[2], off=off_out, m=m))


@pytest.mark.parametrize("k,cin,cout,out_q", [(7, 6, 32, False), (3, 64, 64, True)])
def test_conv_packed_matches_xla(rng, k, cin, cout, out_q):
    """The stem (cin 6, bf16 out) and a wide site with int8 out."""
    x, w, b = case(rng, (1, 16, 30, cin), k, cin, cout)
    ax, oax = _ax(x), 0.9
    want = _jax_conv([x], w, b, 0.1, [ax], oax if out_q else None, p=4 if cin < 32 else 2)
    got = tcp.conv_packed([t(x)], t(w), t(b), 0.1, in_absmax=[ax],
                          out_absmax=oax if out_q else None, out_dtype=torch.float32)
    _assert_out(got, want)


def test_dual_operand_int8_input_and_scale_fold(rng):
    """A carried int8 operand beside a float one 37x its range: the ax_i/ax_0
    fold keeps both on one int32 sum; int8 out."""
    a = (rng.random((1, 16, 28, 16), dtype=np.float32) - 0.5)
    c = (rng.random((1, 16, 28, 16), dtype=np.float32) - 0.5) * 37.0
    _, w, b = case(rng, (1, 1, 1, 32), 3, 32, 16)
    axs = (_ax(a), _ax(c))
    qa = _codes(a, axs[0])
    full = tcp.conv_packed([t(qa.astype(np.float32) * np.float32(axs[0] / 127)), t(c)],
                           t(w), t(b), 0.1)
    oax = 1.1 * float(full.abs().max())
    for out_ax in (None, oax):
        want = _jax_conv([qa, c], w, b, 0.1, axs, out_ax, p=2)
        got = tcp.conv_packed([t(qa), t(c)], t(w), t(b), 0.1, in_absmax=axs,
                              out_absmax=out_ax, out_dtype=torch.float32)
        _assert_out(got, want)
    # both operands kept their accuracy: within a few steps of the output grid
    err = got.float() * (oax / 127) - full
    assert float(err.abs().max()) < 4 * oax / 127


# kernel, p of the JAX input packing, k, cin, cout, int8 input, int8 output
FUSED = [
    ("conv_pool_packed", 4, 5, 32, 64, True, True),
    ("conv_up_m_packed", 1, 3, 128, 64, True, False),
    ("conv_up_packed", 2, 3, 64, 32, True, True),
    ("conv_up_f_packed", 2, 3, 64, 32, False, True),
]


def _jax_fused(name, x, w, b, slope, ax, oax, p, m=16):
    xp, spec = pack(jnp.asarray(x), p, 0, m)
    args = (jnp.asarray(w), jnp.asarray(b), spec, x.shape[-1])
    q = (jnp.float32(ax), None if oax is None else jnp.float32(oax), jnp.float32)
    hs, ws, cout = x.shape[1], x.shape[2], w.shape[3]
    if name == "conv_pool_packed":
        y = jcp._conv_pool_packed_xla(xp, *args, 0, slope, *q)
        ospec = PackedSpec(p=p // 2, c=cout, w=ws // 2, off=0, m=m)
    elif name == "conv_up_m_packed":
        y = jcp._conv_up_m_xla(xp, *args, 2 * m, 0, hs, slope, *q)
        ospec = PackedSpec(p=1, c=cout, w=2 * ws, off=0, m=2 * m)
    else:
        fn = jcp._conv_up_packed_xla if name == "conv_up_packed" else jcp._conv_up_f_xla
        off_out = 3 if name == "conv_up_packed" else 1
        y = fn(xp, *args, off_out, slope, *q)
        ospec = PackedSpec(p=2 * p, c=cout, w=2 * ws, off=off_out, m=m)
    return unpack(y, ospec)


@pytest.mark.parametrize("name,p,k,cin,cout,in_q,out_q", FUSED)
def test_fused_matches_xla(rng, name, p, k, cin, cout, in_q, out_q):
    """Each fused kernel's int8 plain version against its reference: a float
    input quantised after the resample (K9: scaled before its H-interpolation),
    an int8 input resampled on its grid (K7, K8) or dequantised first (K6)."""
    shape = (1, 32, 24, cin) if name == "conv_pool_packed" else (1, 16, 14, cin)
    x, w, b = case(rng, shape, k, cin, cout)
    ax, oax = _ax(x), (0.8 if out_q else None)
    xin = _codes(x, ax) if in_q else x
    want = _jax_fused(name, xin, w, b, 0.1, ax, oax, p)
    got = getattr(tcp, name)(t(xin), t(w), t(b), 0.1, in_absmax=ax, out_absmax=oax,
                             out_dtype=torch.float32)
    _assert_out(got, want)


def test_weight_fragments_int8_layout(rng):
    """The k32 B-fragment order of ``mma.m16n8k32.s8``: lane (g, tig) holds
    rows 4*tig .. +3 and 16 + 4*tig .. +3 of column g."""
    codes = torch.from_numpy(rng.integers(-127, 128, (3, 3, 40 + 24, 20)).astype(np.float32))
    cins, cchunk, n_tiles = (40, 24), 32, 2
    frag = tcp._weight_fragments(codes, cins, cchunk, n_tiles, q=True)
    assert frag.dtype == torch.int8 and frag.shape == (2, 3, 3, 3, 1, 2, 8, 4, 2, 4)
    gather(frag, codes, cins, cchunk, n_tiles, kk=32)


def test_prep_int8(rng):
    x, w, b = case(rng, (1, 8, 8, 32), 3, 32, 16)
    ax, oax = torch.tensor(1.3), torch.tensor(0.6)
    prep = tcp.prep_conv(t(w), t(b), (32,), [ax], oax)
    (wq,), sw = tcp._quantize_weights([t(w)], [ax])
    assert prep["q"] and prep["out_q"] and prep["wfrag"].dtype == torch.int8
    inv = 127.0 / oax
    assert torch.equal(prep["scale"], ax * sw / (127.0 * 127.0) * inv)
    assert torch.equal(prep["bias"], t(b) * inv)
    folded = tcp.prep_conv_up_f(t(w), t(b), ax)
    codes, sw_f = tcp._upf_q_taps(t(w))
    assert folded["scale"].shape == (32,) and sw_f.shape == (16,)
    assert float(codes.abs().amax(dim=(0, 1, 2)).view(2, 16).amax(0).min()) == 127.0
    with pytest.raises(ValueError, match="prepared"):
        tcp._check_cuda("conv_packed", [t(x).to(torch.bfloat16)], t(w), t(b), prep,
                        (32,), 3, 16, q=True, out_q=False)
    with pytest.raises(ValueError, match="in_absmax"):
        tcp.conv_packed([t(_codes(x, 1.0))], t(w), t(b))
