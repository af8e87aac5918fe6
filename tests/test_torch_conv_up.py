"""The module of K6: the port's ``conv_up_packed`` on the CPU (its plain
version) against the JAX package's ``conv_up_packed`` run through its Pallas
body in interpret mode, its routing and argument checks, the up-site routing
of ``packed_branch_flags`` against the JAX package's, and one U-Net at a 4K
width that goes through it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.models import unet as junet
from rrin_tpu.ops import conv_packed as jcp
from rrin_tpu.ops.packed import pack, unpack
from rrin_tpu_torch import ModelConfig
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.ops import conv_packed as tcp
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import (  # noqa: F401
    case, F32_TOL, fresh_rng, interpreted, one_torch_thread, t,
)

CFG = ModelConfig()


@pytest.fixture
def rng():
    return fresh_rng()


# (p_in, k, cin, cout, batch, half-res width, off_out): k 1/3/5 over the three
# lane packings the JAX kernel takes (P*C = 128), batch 2, odd widths.
SITES = [
    (4, 1, 32, 16, 1, 60, 0),
    (2, 3, 64, 32, 2, 27, 3),
    (1, 5, 128, 32, 1, 13, 2),
]


@pytest.mark.parametrize("p,k,cin,cout,b,ws,off_out", SITES)
def test_plain_matches_interpreted_kernel(rng, p, k, cin, cout, b, ws, off_out):
    # float32 through the interpreted Pallas body against the port's plain
    # version: the bar of the other packed-conv modules (1e-4).
    hs = 16  # the kernel's smallest source window
    x, w, bias = case(rng, (b, hs, ws, cin), k, cin, cout)
    xp, spec = pack(jnp.asarray(x), p, 0, 16)
    assert jcp.supports_up(spec, k, cout, 2 * hs) and tcp.supports_up(cin, k, cout)
    y, ospec = interpreted(jcp.conv_up_packed, xp, spec, cin, jnp.asarray(w),
                           jnp.asarray(bias), off_out, 0.1)
    got = tcp.conv_up_packed(t(x), t(w), t(bias), 0.1)
    assert got.shape == (b, 2 * hs, 2 * ws, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack(y, ospec)), **F32_TOL)
    # K8 computes the same function (k 3 and 5), interpolating H first
    if k in (3, 5):
        np.testing.assert_allclose(
            tcp.conv_up_m_packed(t(x), t(w), t(bias), 0.1).numpy(), got.numpy(), **F32_TOL)


def test_supports_up():
    for k in (1, 3, 5):
        for cin, cout in ((32, 16), (64, 32), (128, 64), (512, 256)):
            assert tcp.supports_up(cin, k, cout)
    assert not tcp.supports_up(64, 7, 32)     # the reference takes k <= 5
    assert not tcp.supports_up(64, 2, 32)     # odd k only
    assert not tcp.supports_up(36, 3, 32)     # 8-channel loads
    assert tcp.supports_up(64, 1, 32) and not tcp.supports_up_m(64, 1, 32)


def test_argument_checks(rng):
    x, w, b = case(rng, (1, 4, 6, 16), 3, 16, 8)
    x, w, b = t(x), t(w), t(b)
    with pytest.raises(ValueError, match="no kernel"):
        tcp.conv_up_packed(x[..., :12].contiguous(), w[:, :, :12], b)
    with pytest.raises(ValueError, match="cin"):
        tcp.conv_up_packed(x, w[:, :, :8], b)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        tcp.conv_up_packed(x[0], w, b)
    with pytest.raises(ValueError, match="in_absmax"):
        tcp.conv_up_packed(x, w, b, out_absmax=1.0)
    prep = tcp.prep_conv_up(w, b)
    assert prep["k"] == 3 and prep["cins"] == (16,) and not prep["q"]
    with pytest.raises(ValueError, match="prepared"):
        tcp._check_cuda("conv_up_packed", [x.to(torch.bfloat16)], w, b, prep, (16,), 3, 8,
                        q=True)
    assert torch.equal(tcp.conv_up_packed(x, w, b, 0.1, prepared=prep),
                       tcp._conv_up_wh_plain(x, w, b, 0.1))


@pytest.mark.parametrize("hw", [(1088, 1920), (2160, 3840), (64, 3200), (64, 3184),
                                (720, 1280)])
def test_up_routing_matches_jax(hw):
    """fuse_u3 and fuse_u4 (2: folded kernel, 1: conv_up_packed) as the JAX
    package routes them: K6 from width 3200 on."""
    flags = tunet.packed_branch_flags(*hw, CFG)
    assert flags[4:6] == junet.packed_branch_flags(*hw, JConfig())[4:6]
    assert flags[4:6] == ((1, 1) if hw[1] >= 3200 else (2, 2))
    assert tunet.packed_supported(*hw, CFG)


def test_unet_at_4k_width_takes_conv_up_packed(monkeypatch):
    """The flow U-Net at 64x3200, full widths, float32, port against JAX (both
    route u3c1 and u4c1 to conv_up_packed there): the float32 bar of
    ``test_torch_unet_packed.py``."""
    jp = jrrin.init_params(jax.random.key(4), JConfig())["flow"]
    tp = tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(64).standard_normal((1, 64, 3200, 6)).astype(np.float32)
    calls = {"conv_up_packed": [], "conv_up_f_packed": []}
    for name, seen in calls.items():
        def spy(t_in, *a, _real=getattr(tunet, name), _seen=seen, **kw):
            _seen.append(tuple(t_in.shape))
            return _real(t_in, *a, **kw)
        monkeypatch.setattr(tunet, name, spy)
    got = tunet.unet_apply_packed(tp, torch.from_numpy(x), CFG)
    assert calls == {"conv_up_packed": [(1, 16, 800, 128), (1, 32, 1600, 64)],
                     "conv_up_f_packed": []}
    want = np.asarray(jax.jit(junet.unet_apply_packed, static_argnums=2)(
        jp, jnp.asarray(x), JConfig()))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
