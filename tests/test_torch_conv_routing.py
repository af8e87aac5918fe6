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

    def test_plans_fit_shared_memory(self):
        for k in tcp._K_CONV:
            for cins in ((1,), (6,), (33,), (64,), (512,), (256, 256), (64, 32, 16, 8)):
                for cout in (1, 3, 8, 33, 64, 100, 512):
                    cchunk, n_tiles, n_cb = tcp._plan(k, k, k, cins, cout)
                    assert cchunk % 16 == 0 and cchunk <= 64
                    assert n_tiles * 8 * n_cb >= cout > n_tiles * 8 * (n_cb - 1)
                    assert tcp._smem_bytes(k, k, k, cchunk, n_tiles) <= tcp._SMEM_MAX
        cchunk, n_tiles, n_cb = tcp._plan(3, 3, 5, (128,), 128)  # u3c1, folded
        assert (cchunk, n_tiles, n_cb) == (64, 8, 2)
