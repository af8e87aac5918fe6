"""Prepare-once packed params on the CPU: the sites that the port's
``prepare_packed_params`` collects against the JAX package's collect, each
site's constants against its ``prep_*``, the three checks of
``forward(packed_params=)``, and the Interpolator that prepares once per
padded resolution. Full widths at tiny spatial sizes; on the CPU the
wrappers compute their plain versions and take no ``prepared=``, so a
prepared cascade equals an unprepared one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu_torch import ModelConfig, forward, prepare_packed_params
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.models import rrin as trrin
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.ops import conv_packed as tcp
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

CFG = ModelConfig()
HW = (48, 64)

# site -> the prep_* of its kernel in the JAX package's walk at width 64
# (u3c1 and u4c1 on the folded kernel), the params path and its operands
_PREP = {
    "c1": (tcp.prep_conv, ("conv1",), 1), "c2": (tcp.prep_conv, ("conv2",), 1),
    "d1c1": (tcp.prep_conv_pool, ("down1", "conv1"), 1),
    "d1c2": (tcp.prep_conv, ("down1", "conv2"), 1),
    "d2c1": (tcp.prep_conv_pool, ("down2", "conv1"), 1),
    "d2c2": (tcp.prep_conv, ("down2", "conv2"), 1),
    "d3c1": (tcp.prep_conv, ("down3", "conv1"), 1),
    "d3c2": (tcp.prep_conv, ("down3", "conv2"), 1),
    "d4c1": (tcp.prep_conv, ("down4", "conv1"), 1),
    "d4c2": (tcp.prep_conv, ("down4", "conv2"), 1),
    "u1c1": (tcp.prep_conv, ("up1", "conv1"), 1),
    "u1c2": (tcp.prep_conv, ("up1", "conv2"), 2),
    "u2c1": (tcp.prep_conv_up_m, ("up2", "conv1"), 1),
    "u2c2": (tcp.prep_conv, ("up2", "conv2"), 2),
    "u3c1": (tcp.prep_conv_up_f, ("up3", "conv1"), 1),
    "u3c2": (tcp.prep_conv, ("up3", "conv2"), 2),
    "u4c1": (tcp.prep_conv_up_f, ("up4", "conv1"), 1),
    "u4c2": (tcp.prep_conv, ("up4", "conv2"), 2),
    "head": (tcp.prep_conv, ("conv3",), 1),
}


@pytest.fixture(scope="module")
def weights():
    jp = jrrin.init_params(jax.random.key(7), JConfig())
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = fresh_rng()
    i0 = rng.integers(0, 256, (1, *HW, 3)).astype(np.float32) / np.float32(255)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    return i0, i1


@pytest.fixture(scope="module")
def stats(weights, frames):
    _, tp = weights
    return trrin.scale_quant_stats(trrin.forward_calibrate(tp, *frames, device="cpu")[1], 1.2)


def test_collect_sites_equal_jax(weights):
    """At the default shape, where the JAX package runs every site on a
    kernel, both collects hold the same sites of every U-Net (the JAX
    collect traced, not run)."""
    jp, tp = weights
    want = jax.eval_shape(
        lambda p: jrrin._prepare_packed_collect(p, JConfig(), jnp.bfloat16, None, (320, 64)),
        jp)
    got = prepare_packed_params(tp, device="cpu")
    assert got.hw == (320, 64) and got.quant_fp is None
    assert sorted(got.tree) == sorted(want)
    for name in want:
        assert sorted(got.tree[name]) == sorted(want[name]) == sorted(tunet.PACKED_SITES)


@pytest.mark.parametrize("mode", ["bfloat16", "float32", "int8"])
def test_each_site_equals_its_prep(weights, stats, mode):
    """Each collected site holds what its prep_* gives with the site's
    operand ranges (``QUANT_SITES``) and, where the carry plan keeps the
    output int8, the output's range; the head stays in the compute dtype."""
    _, tp = weights
    dtype = torch.float32 if mode == "float32" else torch.bfloat16
    qs = stats if mode == "int8" else None
    got = prepare_packed_params(tp, compute_dtype=dtype, quant_stats=qs, hw=HW,
                                device="cpu").tree["mask"]
    p = tp["mask"]
    carry = tunet.int8_carry(*HW, CFG)
    for site, (prep, path, n_ops) in _PREP.items():
        prm = p
        for key in path:
            prm = prm[key]
        am = oam = None
        if qs is not None and site in tunet.QUANT_SITES:
            am = tuple(qs["mask"][n] for n in tunet.QUANT_SITES[site])
            oam = qs["mask"][site] if site in carry else None
        if prep is tcp.prep_conv:
            cins = (prm["w"].shape[2] // n_ops,) * n_ops
            want = prep(prm["w"], prm["b"], cins, am, oam, dtype=dtype)
        else:
            want = prep(prm["w"], prm["b"], None if am is None else am[0], oam, dtype=dtype)
        have = got[site]
        assert sorted(have) == sorted(want), site
        for key, v in want.items():
            if isinstance(v, torch.Tensor):
                assert v.dtype == have[key].dtype and torch.equal(v, have[key]), (site, key)
            elif key == "axs" and v is not None:
                assert all(torch.equal(a, b) for a, b in zip(v, have[key])), site
            else:
                assert have[key] == v, (site, key)
        assert have["q"] == (am is not None) and have["out_q"] == (oam is not None)


def test_forward_checks_raise(weights, frames, stats):
    """The JAX package's three checks: the prep's shape routes otherwise,
    int8 stats in one of prep and call only, other stats values."""
    _, tp = weights
    i0, i1 = frames
    kw = dict(packed=True, device="cpu")
    wide = prepare_packed_params(tp, compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="kernel-branch configuration"):
        forward(tp, i0, i1, packed_params=wide, **kw)
    plain = prepare_packed_params(tp, compute_dtype=torch.float32, hw=HW, device="cpu")
    q8 = prepare_packed_params(tp, compute_dtype=torch.float32, quant_stats=stats, hw=HW,
                               device="cpu")
    assert q8.quant_stats is stats and isinstance(q8.quant_fp, str)
    with pytest.raises(ValueError, match="built without int8"):
        forward(tp, i0, i1, quant_stats=stats, packed_params=plain, **kw)
    with pytest.raises(ValueError, match="built with int8"):
        forward(tp, i0, i1, packed_params=q8, **kw)
    with pytest.raises(ValueError, match="other quant_stats values"):
        forward(tp, i0, i1, quant_stats=trrin.scale_quant_stats(stats, 1.01),
                packed_params=q8, **kw)
    # the same values in another object pass the hash
    copy = {u: {k: v.clone() for k, v in s.items()} for u, s in stats.items()}
    forward(tp, i0, i1, quant_stats=copy, packed_params=q8, flows_only=True, **kw)
    # off the packed path the prep is not used, as in the JAX package
    forward(tp, i0, i1, packed=False, packed_params=wide, flows_only=True, device="cpu")


def test_same_stats_object_skips_fingerprint(weights, frames, stats, monkeypatch):
    """The served path passes the stats object the prep was built with: no
    hash, so no copy of the stats to the host."""
    _, tp = weights
    i0, i1 = frames
    q8 = prepare_packed_params(tp, compute_dtype=torch.float32, quant_stats=stats, hw=HW,
                               device="cpu")

    def boom(_):
        raise AssertionError("fingerprint computed")

    monkeypatch.setattr(trrin, "_stats_fingerprint", boom)
    forward(tp, i0, i1, packed=True, quant_stats=stats, packed_params=q8, flows_only=True,
            device="cpu")
    other = {u: dict(s) for u, s in stats.items()}
    with pytest.raises(AssertionError, match="fingerprint computed"):
        forward(tp, i0, i1, packed=True, quant_stats=other, packed_params=q8,
                flows_only=True, device="cpu")


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_prepared_forward_bit_equal(weights, frames, stats, mode):
    _, tp = weights
    i0, i1 = frames
    qs = stats if mode == "int8" else None
    kw = dict(compute_dtype=torch.float32, packed=True, quant_stats=qs, device="cpu")
    pp = prepare_packed_params(tp, compute_dtype=torch.float32, quant_stats=qs, hw=HW,
                               device="cpu")
    assert torch.equal(forward(tp, i0, i1, 0.3, packed_params=pp, **kw),
                       forward(tp, i0, i1, 0.3, **kw))


def test_interpolator_prepares_once_per_resolution(weights, monkeypatch):
    """One prep per padded resolution (40x72 and 48x80 pad to one), built
    with the very stats object that serves it; none off the packed path."""
    _, tp = weights
    calls = []
    real = tpipe.prepare_packed_params

    def spy(*a, **kw):
        calls.append(kw["hw"])
        return real(*a, **kw)

    monkeypatch.setattr(tpipe, "prepare_packed_params", spy)
    rng = fresh_rng()

    def pairs(h, w):
        return rng.integers(0, 256, (1, 2, h, w, 3), dtype=np.uint8)

    it = tpipe.Interpolator(tp, compute_dtype="float32", use_pallas=True, int8=True,
                            device="cpu")
    for hw in ((40, 72), (48, 80), (48, 64), (48, 64)):
        it.step(pairs(*hw))
    assert calls == [(48, 80), (48, 64)]
    for key, prep in it._packed_params.items():
        assert prep.hw == key and prep.quant_stats is it._quant_stats[key]
    plain = tpipe.Interpolator(tp, compute_dtype="float32", use_pallas=True, packed=False,
                               device="cpu")
    plain.step(pairs(32, 48))
    assert plain._packed_params == {(32, 48): None} and len(calls) == 2
