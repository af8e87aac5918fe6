"""The host side of the packed-path kernels that the CPU can reach: argument
checks of the wrappers, the checks made before a launch, and the fragment
order of the weights that ``prep_*`` lay out for the CUDA kernel."""

import numpy as np
import pytest
import torch

from rrin_tpu_torch import _build
from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import case, fresh_rng, gather, one_torch_thread, t  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


class TestArgumentChecks:
    def test_conv_packed(self, rng):
        x, w, b = case(rng, (1, 8, 8, 16), 3, 16, 8)
        x, w, b = t(x), t(w), t(b)
        with pytest.raises(ValueError, match="cin"):
            tcp.conv_packed([x, x], w, b)
        with pytest.raises(ValueError, match="bias"):
            tcp.conv_packed([x], w, b[:4])
        with pytest.raises(ValueError, match="agree"):
            tcp.conv_packed([x, x[:, :4]], torch.cat([w, w], 2), b)
        with pytest.raises(ValueError, match="real_c"):
            tcp.conv_packed([(x, 17)], w, b)
        with pytest.raises(ValueError, match="at least one"):
            tcp.conv_packed([], w, b)
        with pytest.raises(ValueError, match="no kernel"):
            tcp.conv_packed([x], t(np.zeros((4, 4, 16, 8), np.float32)), b)
        with pytest.raises(ValueError, match="no kernel"):
            tcp.prep_conv(w, b, (4, 4, 4, 2, 2))

    @pytest.mark.parametrize("fn,prep", [
        (tcp.conv_pool_packed, tcp.prep_conv_pool), (tcp.conv_up_m_packed, tcp.prep_conv_up_m),
        (tcp.conv_up_f_packed, tcp.prep_conv_up_f)])
    def test_fused(self, rng, fn, prep):
        x, w, b = case(rng, (1, 8, 8, 16), 3, 16, 8)
        x, w, b = t(x), t(w), t(b)
        with pytest.raises(ValueError, match="cin"):
            fn(x[..., :8].contiguous(), w, b)
        with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
            fn(x[0], w, b)
        with pytest.raises(ValueError, match="no kernel"):
            fn(x, t(np.zeros((7, 7, 16, 8), np.float32)), b)
        with pytest.raises(ValueError, match="no kernel"):
            prep(t(np.zeros((3, 3, 12, 8), np.float32)), b)

    def test_cuda_side_checks(self, rng):
        """What a kernel asks of a tensor on the card, checked before any
        launch (the checks need no card)."""
        x, w, b = case(rng, (1, 8, 8, 16), 3, 16, 8)
        x, w, b = t(x), t(w), t(b)
        # float32 has its own mode; float64, and float32 in int8 mode, none
        assert tcp._check_cuda("conv_packed", [x], w, b, None, (16,), 3, 8) is None
        with pytest.raises(NotImplementedError, match="float64"):
            tcp._check_cuda("conv_packed", [x.double()], w, b, None, (16,), 3, 8)
        with pytest.raises(NotImplementedError, match="int8 mode"):
            tcp._check_cuda("conv_packed", [x], w, b, None, (16,), 3, 8, q=True)
        xb = x.to(torch.bfloat16)
        with pytest.raises(ValueError, match="contiguous"):
            tcp._check_cuda("conv_packed", [xb[..., :8]], w, b, None, (8,), 3, 8)
        with pytest.raises(RuntimeError, match="forward-only"):
            tcp._check_cuda("conv_packed", [xb.clone().requires_grad_()], w, b, None,
                            (16,), 3, 8)
        with pytest.raises(ValueError, match="prepared"):
            tcp._check_cuda("conv_packed", [xb], w, b, tcp.prep_conv(w, b, (16,)),
                            (8, 8), 3, 8)
        assert tcp._check_cuda("conv_packed", [xb], w, b, None, (16,), 3, 8) is None

    def test_cpu_tensors_launch_nothing(self, rng):
        x, w, b = case(rng, (1, 8, 8, 16), 3, 16, 8)
        xb = t(x).to(torch.bfloat16)
        before = _build.launch_counts()
        for fn in (tcp.conv_pool_packed, tcp.conv_up_m_packed, tcp.conv_up_f_packed):
            fn(xb, t(w), t(b), 0.1)
        tcp.conv_packed([xb], t(w), t(b), 0.1, prepared=tcp.prep_conv(t(w), t(b), (16,)))
        assert _build.launch_counts() == before
        assert {"conv_packed", "conv_pool_packed", "conv_up_m_packed",
                "conv_up_f_packed"} <= set(before)


class TestWeightLayout:
    def test_prep_conv_multi_operand(self, rng):
        cins, k, cout = (40, 10), 3, 70
        w = t(rng.standard_normal((k, k, sum(cins), cout)).astype(np.float32))
        b = t(rng.standard_normal(cout).astype(np.float32))
        pr = tcp.prep_conv(w, b, cins)
        cchunk, n_tiles, n_cb = pr["plan"]
        # the Hopper core: all 70 output channels in one block of N = 128,
        # chunks of 16 (wider ones leave no room for two buffers at N = 128)
        assert (cchunk, n_tiles, n_cb) == (16, 16, 1)
        assert pr["wfrag"].shape == (1, 3 + 1, k, k, 1, 16, 8, 4, 2, 2)
        assert pr["wfrag"].dtype == torch.bfloat16
        assert pr["wfrag"].permute(*tcp._SM90_ORDER).is_contiguous()
        assert pr["bias"].dtype == torch.float32 and torch.equal(pr["bias"], b)
        gather(pr["wfrag"], w, cins, cchunk, n_tiles)

    @pytest.mark.parametrize("prep,k", [(tcp.prep_conv_pool, 5), (tcp.prep_conv_up_m, 3)])
    def test_prep_pool_and_up_m_hold_the_convs_own_weights(self, rng, prep, k):
        w = t(rng.standard_normal((k, k, 24, 12)).astype(np.float32))
        b = t(rng.standard_normal(12).astype(np.float32))
        pr = prep(w, b)
        assert pr["plan"] == (32, 2, 1) and pr["cins"] == (24,)
        gather(pr["wfrag"], w, (24,), 32, 2)
