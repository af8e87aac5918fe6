"""Two repairs of the port against the JAX package: the package's top-level
names, and the int8 carry plan of ``unet_apply_packed``, which follows the
JAX package's layout gates at every shape (the port's own kernel routing
does not enter it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrin_tpu
import rrin_tpu_torch
from rrin_tpu.config import ModelConfig as JConfig
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.models import unet as junet
from rrin_tpu_torch import ModelConfig
from rrin_tpu_torch.models import unet as tunet
from rrin_tpu_torch.params import checkpoint as tckpt
from torch_packed_util import one_torch_thread, psnr  # noqa: F401

CFG = ModelConfig()


def test_top_level_names():
    """The two packages export the same names, and the port's entry points
    of them run on the card unless given ``device="cpu"``."""
    assert set(rrin_tpu.__all__) == set(rrin_tpu_torch.__all__)
    from rrin_tpu_torch import (  # noqa: F401
        forward_calibrate, forward_saturation, merge_quant_stats, prepare_packed_params,
        scale_quant_stats)
    for name in rrin_tpu_torch.__all__:
        assert getattr(rrin_tpu_torch, name) is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            prepare_packed_params({})
        with pytest.raises(RuntimeError, match="is_available"):
            forward_saturation({}, np.zeros((1, 16, 16, 3)), np.zeros((1, 16, 16, 3)), {})


def _reference_carry(flags):
    """``_CARRY`` of the JAX package's ``unet_apply_packed``
    (rrin_tpu/models/unet.py), written out from its branch flags."""
    l2_kernel, _, fuse_d1, fuse_d2, _, _, _, fuse_u2 = flags
    carry = {"c1", "d1c1", "d2c1", "d3c1", "d4c1", "u1c1",
             "u2c1", "u2c2", "u3c1", "u3c2", "u4c1"}
    if fuse_d1:
        carry.add("c2")
    if fuse_d2 and l2_kernel:
        carry.add("d1c2")
    if fuse_u2:
        carry.add("u1c2")
    return carry


@pytest.mark.parametrize("hw", [(112, 64), (144, 64), (176, 64), (160, 64), (192, 64),
                                (720, 1280), (1088, 1920), (2160, 3840)])
def test_int8_carry_equals_the_reference(hw):
    jflags = junet.packed_branch_flags(*hw, JConfig())
    # (l2_kernel, l3_kernel, fuse_d1, fuse_d2, fuse_u2) of the JAX package's order
    assert tunet.reference_carry_flags(*hw, CFG) == tuple(jflags[i] for i in (0, 1, 2, 3, 7))
    assert tunet.int8_carry(*hw, CFG) == _reference_carry(jflags)
    # where h // 4 is no multiple of 8 the reference carries neither d1c2 nor u1c2
    aligned = (hw[0] // 4) % 8 == 0
    assert ({"d1c2", "u1c2"} <= tunet.int8_carry(*hw, CFG)) == aligned


def test_int8_unet_matches_reference_at_144x64():
    """144x64, where the reference's carry plan leaves d1c2 and u1c2 in
    float: the int8 flow U-Net on the same stats agrees with the JAX
    package's at the level of the shapes where the plans always agreed (75.7
    dB measured, 75.4 before the carry plan followed the reference's; 76.0
    at 160x64 and 76.2 at 192x64; the bar of tests/test_torch_int8.py, 45
    dB)."""
    jp = jrrin.init_params(jax.random.key(3), JConfig())["flow"]
    tp = tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(6).standard_normal((1, 144, 64, 6)).astype(np.float32)
    _, stats = jax.jit(junet.unet_apply_stats, static_argnums=2)(
        jp, jnp.asarray(x), JConfig())
    stats = {k: np.float32(v) for k, v in stats.items()}
    want = np.asarray(jax.jit(junet.unet_apply_packed, static_argnums=2)(
        jp, jnp.asarray(x), JConfig(), {k: jnp.float32(v) for k, v in stats.items()}))
    got = tunet.unet_apply_packed(
        tp, torch.from_numpy(x), CFG, {k: torch.tensor(v) for k, v in stats.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert psnr(got.numpy(), want) > 45.0, psnr(got.numpy(), want)
