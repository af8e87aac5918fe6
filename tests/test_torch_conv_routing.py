"""Routing of the packed-path convs: what ``supports*`` accept and reject, the
tile plans, and the channel counts at the edge of the MMA tile (cin 6/9/10,
cout 2/3/4), which stay on ``conv_packed``."""

import numpy as np
import pytest
import torch

from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import case, fresh_rng, one_torch_thread, t  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


class TestSmallChannelCounts:
    @pytest.mark.parametrize("cin,cout,k", [
        (6, 32, 7), (9, 32, 7), (10, 32, 7), (32, 2, 3), (32, 3, 3), (32, 4, 3), (24, 16, 5)])
    def test_small_channel_counts_against_nchw_float64(self, rng, cin, cout, k):
        x, w, b = case(rng, (2, 9, 13, cin), k, cin, cout)
        ref = torch.nn.functional.conv2d(
            t(x).double().permute(0, 3, 1, 2), t(w).double().permute(3, 2, 0, 1),
            t(b).double(), padding=k // 2).permute(0, 2, 3, 1)
        got = tcp.conv_packed([t(x)], t(w), t(b), None)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


class TestSupports:
    def test_every_site_of_the_unet_is_routed(self):
        for cins, k, cout in [((6,), 7, 32), ((9,), 7, 32), ((10,), 7, 32), ((16,), 7, 32),
                              ((32,), 7, 32), ((64,), 5, 64), ((128,), 3, 128),
                              ((128,), 3, 256), ((256,), 3, 256), ((256,), 3, 512),
                              ((512,), 3, 512), ((512,), 3, 256), ((256, 256), 3, 256),
                              ((128, 128), 3, 128), ((64, 64), 3, 64), ((32, 32), 3, 32),
                              ((32,), 3, 4), ((32,), 3, 3), ((32,), 3, 2)]:
            assert tcp.supports(cins, k, cout), (cins, k, cout)
        assert tcp.supports_pool(32, 5, 64) and tcp.supports_pool(64, 3, 128)
        assert tcp.supports_up_m(256, 3, 128)
        assert tcp.supports_up_f(128, 3, 64) and tcp.supports_up_f(64, 3, 32)

    def test_rejections(self):
        assert not tcp.supports((32,), 4, 32) and not tcp.supports((32,), 9, 32)
        assert not tcp.supports((32,), 1, 32)
        assert not tcp.supports((8,) * 5, 3, 8) and not tcp.supports((), 3, 8)
        assert not tcp.supports_pool(32, 7, 64) and not tcp.supports_pool(12, 3, 64)
        assert not tcp.supports_up_m(256, 7, 128) and not tcp.supports_up_m(6, 3, 8)
        assert not tcp.supports_up_f(64, 5, 32) and not tcp.supports_up_f(10, 3, 32)

    def test_supports_up_f_at_the_cascade_sites(self):
        """K9 takes u3c1 (cin 128 -> 64) and u4c1 (64 -> 32) of the 1080p
        cascade in every dtype, float32 now on the Hopper core as bfloat16
        and int8 are, and the routing is the reference's: the folded kernel
        below width 3200 (the flag 2), K6 from there on (1), 4K included;
        K9 keeps rejecting what it rejected (k 5, cin no multiple of 8)."""
        from rrin_tpu_torch import ModelConfig
        from rrin_tpu_torch.models import unet as tunet
        cfg = ModelConfig()
        _, w2, w3, _, _ = cfg.widths
        w1 = cfg.widths[0]
        for cin, cout in ((w3, w2), (w2, w1)):  # u3c1, u4c1
            assert tcp.supports_up_f(cin, 3, cout) and tcp.supports_up(cin, 3, cout)
            for q in (False, True, tcp.F32):
                assert tcp._sm90_plan(3, cin, 2 * cout, q, folded=True) is not None
        for (h, w), up in (((1088, 1920), 2), ((256, 448), 2), ((64, 3184), 2),
                           ((64, 3200), 1), ((2160, 3840), 1)):
            assert tunet.packed_branch_flags(h, w, cfg)[4:6] == (up, up), (h, w)
        assert not tcp.supports_up_f(64, 5, 32) and not tcp.supports_up_f(60, 3, 32)

    def test_plans_fit_shared_memory(self):
        """conv_packed's plans on the Hopper core, bfloat16 and int8: whole
        k-steps a chunk, channel blocks of N <= 128 that cover cout, and a
        block within the 227 KB of shared memory."""
        for k in tcp._K_CONV:
            for cins in ((1,), (6,), (33,), (64,), (512,), (256, 256), (64, 32, 16, 8)):
                for cout in (1, 3, 8, 33, 64, 100, 512):
                    for q in (False, True):
                        plan = tcp._sm90_plan(k, cins, cout, q, resident=True)
                        cchunk, n_tiles, n_cb = plan
                        assert cchunk % (32 if q else 16) == 0 and cchunk <= (128 if q else 64)
                        assert n_tiles * 8 * n_cb >= cout > n_tiles * 8 * (n_cb - 1)
                        res = tcp._sm90_res_chunks(cins, plan, True)
                        assert tcp._sm90_smem_bytes(k, cchunk, n_tiles, q, False,
                                                    res) <= tcp._SMEM_MAX
        cchunk, n_tiles, n_cb = tcp._sm90_plan(3, 128, 128, folded=True)  # u3c1, folded
        assert (cchunk, n_tiles, n_cb) == (16, 16, 1)
