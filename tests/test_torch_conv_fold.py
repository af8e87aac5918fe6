"""K9's weight fold on the host: ``_upf_fold`` and its edge residuals against
upsample-then-conv at every edge, against the JAX package's fold, and the
layout of the folded taps that the CUDA kernel reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu.ops import conv_packed as jcp
from rrin_tpu_torch.ops import conv_packed as tcp
from torch_packed_util import case, fresh_rng, gather, one_torch_thread, t  # noqa: F401


@pytest.fixture
def rng():
    return fresh_rng()


class TestFold:
    @pytest.mark.parametrize("hw", [(1, 1), (1, 5), (4, 1), (2, 2), (5, 7), (3, 16), (2, 17)])
    def test_fold_equals_upsample_then_conv_at_every_edge(self, rng, hw):
        """``_upf_fold`` with its edge residuals against upsample-then-conv on
        images so small that every pixel is at a left, right, top or bottom
        edge (and at both at once for a width or height of 1)."""
        x, w, b = case(rng, (2, *hw, 8), 3, 8, 5)
        want = tcp._conv_up_plain(t(x), t(w), t(b), None)
        got = tcp._conv_up_f_folded(t(x), t(w), t(b), None)
        assert got.shape == (2, 2 * hw[0], 2 * hw[1], 5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=2e-6)

    def test_fold_matches_jax_fold(self, rng):
        w = ((rng.random((3, 3, 4, 6), dtype=np.float32) - 0.5))
        jweff, jedges = jcp._upf_fold(jnp.asarray(w))
        weff, edges = tcp._upf_fold(t(w))
        np.testing.assert_allclose(weff.numpy(), np.asarray(jweff), atol=1e-7)
        for got, want in zip(edges, jedges):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
        np.testing.assert_array_equal(np.asarray(tcp._UPF_A, np.float32), jcp._UPF_A)

    def test_prep_conv_up_f_holds_folded_taps(self, rng):
        cin, cout = 16, 4
        w = t(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
        b = t(rng.standard_normal(cout).astype(np.float32))
        pr = tcp.prep_conv_up_f(w, b)
        assert pr["plan"] == (16, 1, 1) and pr["wfrag"].shape[3] == 5
        assert torch.equal(pr["bias"], torch.cat([b, b]))
        wn = w.numpy()
        taps = np.zeros((3, 5, cin, 2 * cout), np.float32)
        a = np.asarray(tcp._UPF_A, np.float32)
        for rho in range(2):
            for d in range(3):
                taps[:, d, :, rho * cout:(rho + 1) * cout] = sum(
                    a[rho, d, kx] * wn[:, kx] for kx in range(3))
        taps[:, 3, :, :cout] = 0.25 * (wn[:, 1] - wn[:, 0])
        taps[:, 3, :, cout:] = 0.25 * wn[:, 0]
        taps[:, 4, :, :cout] = 0.25 * wn[:, 2]
        taps[:, 4, :, cout:] = 0.25 * (wn[:, 1] - wn[:, 2])
        np.testing.assert_allclose(tcp._upf_taps(w).numpy(), taps, atol=1e-6)
        gather(pr["wfrag"], tcp._upf_taps(w), (cin,), 16, 1)
