"""H-sharded (spatial) serving and data-parallel / spatial training on the
CPU: ``rrin_tpu_torch.parallel.spatial`` against the port's plain cascade and
the JAX package's spatially sharded ``forward``, its halo ops against the
whole-frame ops, and mesh training steps against the one-device step and the
JAX package's data-parallel ``Trainer``.

The meshes list the CPU more than once. Full model widths at tiny crops.

Bars, fixed before any run:
  * halo conv / halo upsample against the whole-frame op: float32, 1e-6
    (the same products in another blocking of the conv); the upsample is
    elementwise, so equal;
  * the spatial forward against the plain cascade on one device: float32
    1e-5 (the reference's spatial bar is 5e-4, ``tests/test_sharding.py``);
    against the JAX package's forward on a 2x2 ('data', 'spatial') mesh:
    5e-4, the reference's own;
  * a spatial request against the one-device plain request: equal u8 frames
    (the whole-frame and the sharded convs agree on the CPU);
  * a mesh training step against the one-device step on the same batch:
    loss 1e-6 relative, every U-Net's gradient within 1e-5 of the
    reference's in relative norm, the params after an Adam step within
    1e-5 (its first update is lr*g/(|g|+eps): a gradient near eps moves its
    param by up to lr whatever its error; lr 1e-3);
  * against the JAX package's data-parallel Trainer (float32, Adamax): loss
    1e-5 relative; the first Adamax update is -lr*sign(g) but where |g| is
    near eps, so at most 1e-3 of the params may move otherwise than the
    reference's by more than lr/1000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu import train as jtrain
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.parallel import sharding as jsharding
from rrin_tpu_torch import forward
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch import train as ttrain
from rrin_tpu_torch.ops.conv_phase import conv2d_fused
from rrin_tpu_torch.ops.resize import upsample_2x_bilinear
from rrin_tpu_torch.params import checkpoint as tckpt
from rrin_tpu_torch.parallel import sharding as tsharding
from rrin_tpu_torch.parallel import spatial as tspatial
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
LR = 1e-3


@pytest.fixture(scope="module")
def weights():
    jp = jrrin.init_params(jax.random.key(6))
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    i0 = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32) / np.float32(255)
    i1 = np.clip(np.roll(i0, 2, axis=2) + 0.05, 0, 1).astype(np.float32)
    return i0, i1


def _split(x, rows):
    cuts = np.cumsum([0] + rows)
    return [x[:, a:b] for a, b in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("k", [3, 7])
def test_halo_ops_match_whole_frame(k):
    """1-row and 3-row halos, over shards thinner than the halo (a shard may
    take its rows from two neighbours)."""
    rng = fresh_rng()
    x = torch.from_numpy(rng.random((2, 16, 12, 8), dtype=np.float32) - 0.5)
    w = torch.from_numpy((rng.random((k, k, 8, 5), dtype=np.float32) - 0.5) * 0.3)
    b = torch.from_numpy(rng.random(5, dtype=np.float32) - 0.5)
    rows = [1, 4, 2, 9]
    n = len(rows)
    got = torch.cat(tspatial.halo_conv(_split(x, rows), [w] * n, [b] * n, 0.1), dim=1)
    np.testing.assert_allclose(got.numpy(), conv2d_fused(x, w, b, 0.1).numpy(), atol=1e-6)
    up = torch.cat(tspatial.halo_upsample(_split(x.bfloat16(), rows)), dim=1)
    assert torch.equal(up, upsample_2x_bilinear(x.bfloat16()))
    ext = tspatial.with_halo(_split(x, rows), (k - 1) // 2)
    assert [top for _, top in ext] == [0, min(1, k // 2), min(5, k // 2), min(7, k // 2)]


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_forward_matches_plain(weights, n):
    """80 rows cut unevenly (row_cuts: 48 + 32, 32 + 16 + 16 + 16)."""
    _, tp = weights
    i0, i1 = _frames(2, 80, 48)
    with torch.no_grad():
        want = forward(tp, i0, i1, 0.3, device="cpu")
        got = tspatial.forward_spatial({CPU: tp}, torch.from_numpy(i0), torch.from_numpy(i1),
                                       0.3, [CPU] * n)
        fl = forward(tp, i0, i1, flows_only=True, device="cpu")
        got_fl = tspatial.forward_spatial({CPU: tp}, torch.from_numpy(i0),
                                          torch.from_numpy(i1), 0.5, [CPU] * n,
                                          flows_only=True)
    assert got.shape == want.shape == (2, 80, 48, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_fl.numpy(), fl.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="shards"):
        tspatial.forward_spatial({CPU: tp}, torch.from_numpy(i0), torch.from_numpy(i1), 0.5,
                                 [CPU] * 6)


def test_spatial_forward_matches_jax_mesh(weights):
    """The reference's DP x spatial case (``test_dp_spatial_matches_single_
    device``): a 2x2 mesh, H cut over 'spatial', at 5e-4."""
    jp, tp = weights
    rng = fresh_rng()
    i0 = rng.random((4, 64, 48, 3), dtype=np.float32)
    i1 = rng.random((4, 64, 48, 3), dtype=np.float32)
    mesh = jsharding.make_mesh(n_data=2, n_spatial=2)
    s0, s1 = jsharding.shard_pairs(mesh, i0, i1, spatial_dim=1)
    want = np.asarray(jrrin.forward(jsharding.replicate_params(mesh, jp), s0, s1, 0.5))
    tmesh = tsharding.make_mesh(n_data=2, n_spatial=2, devices=[CPU] * 4)
    t0, t1 = tsharding.shard_pairs(tmesh, i0, i1)
    with torch.no_grad():
        got = torch.cat([tspatial.forward_spatial(
            tsharding.replicate_params(tmesh, tp), a, c, 0.5, list(tmesh.devices[d]))
            for d, (a, c) in enumerate(zip(t0.data_shards(), t1.data_shards()))])
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_spatial_interpolator_matches_one_device(weights):
    """Interpolator(spatial=2) is the plain path with H cut (bf16 with
    use_pallas, as the reference, forces packed and the warp kernel off);
    times mode runs the flow U-Net once over the shards too."""
    _, tp = weights
    pairs = np.stack(_frames(2, 40, 48, seed=3), axis=1)
    pairs = np.round(pairs * 255).astype(np.uint8)
    sp = tpipe.Interpolator(tp, use_pallas=True, spatial=2, device="cpu")
    assert sp.mesh.shape == {"data": 1, "spatial": 2} and not sp._dp_fast
    one = tpipe.Interpolator(tp, use_pallas=False, packed=False, device="cpu")
    np.testing.assert_array_equal(sp.step(pairs).numpy(), one.step(pairs).numpy())
    assert sp._packed_params == {}
    ts = np.array([[0.25, 0.6], [0.5, 0.8]], np.float32)
    kw = dict(mode="times", compute_dtype="float32", device="cpu")
    mesh = tsharding.make_mesh(2, 2, devices=[CPU] * 4)
    got = tpipe.Interpolator(tp, mesh=mesh, **kw).step(pairs, ts).numpy()
    np.testing.assert_array_equal(got, tpipe.Interpolator(tp, **kw).step(pairs, ts).numpy())


def _trainer_step(tp, batch, mesh=None, **kw):
    tr = ttrain.Trainer.create(params=tp, learning_rate=LR, optimizer="adam", mesh=mesh,
                               compute_dtype=torch.float32, device="cpu", **kw)
    loss = tr.step(*batch)
    leaves = ttrain.param_leaves(tr.params)
    grads = {u: torch.cat([t.grad.flatten() for t in ttrain.param_leaves(tr.params[u])])
             for u in tr.params}
    return loss, torch.cat([t.detach().flatten() for t in leaves]), grads


def _check_mesh_step(tp, mesh, **kw):
    i0, i1 = _frames(4, 32, 32, seed=1)
    gt = ((i0 + i1) / 2).astype(np.float32)
    l1, p1, g1 = _trainer_step(tp, (i0, gt, i1), **kw)
    l2, p2, g2 = _trainer_step(tp, (i0, gt, i1), mesh=mesh, **kw)
    assert abs(l2 - l1) <= 1e-6 * abs(l1), (l1, l2)
    for u in g1:
        assert float((g2[u] - g1[u]).norm() / g1[u].norm()) <= 1e-5, u
    assert float((p2 - p1).abs().max()) <= 1e-5


def test_dp_train_step_matches_one_device(weights):
    _, tp = weights
    _check_mesh_step(tp, tsharding.make_mesh(2, devices=[CPU] * 2))


def test_dp_spatial_train_step_matches_one_device(weights):
    """A 2x2 mesh with H cut (``spatial_dim=1``), the Laplacian-pyramid loss
    (its pyramid crosses the shard borders: the prediction is gathered
    first) and remat."""
    _, tp = weights
    _check_mesh_step(tp, tsharding.make_mesh(2, 2, devices=[CPU] * 4), spatial_dim=1,
                     loss="laplacian", remat=True)


def test_dp_train_step_matches_jax_trainer(weights):
    jp, tp = weights
    i0, i1 = _frames(2, 32, 32, seed=2)
    gt = ((i0 + i1) / 2).astype(np.float32)
    jt = jtrain.Trainer.create(params=jax.tree.map(jnp.copy, jp), learning_rate=LR,
                               mesh=jsharding.make_mesh(n_data=2), compute_dtype=jnp.float32)
    want = jt.step(i0, gt, i1)
    tt = ttrain.Trainer.create(params=tp, learning_rate=LR, compute_dtype=torch.float32,
                               mesh=tsharding.make_mesh(2, devices=[CPU] * 2))
    got = tt.step(i0, gt, i1)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    moved = {k: v - np.asarray(tckpt.flatten_params(jp)[k])
             for k, v in tckpt.flatten_params(jt.params).items()}
    ported = tckpt.flatten_params(tt.params)
    init = tckpt.flatten_params(tp)
    off = sum(int((np.abs((ported[k] - init[k]) - moved[k]) > LR / 1000).sum()) for k in moved)
    assert off <= 1e-3 * sum(v.size for v in moved.values()), off


def test_mesh_size_check(weights):
    """The batch must divide by the whole mesh (data x spatial), as the
    reference checks, even where only the data axis cuts it."""
    jp, tp = weights
    i0, i1 = _frames(2, 32, 32)
    tr = ttrain.Trainer.create(params=tp, mesh=tsharding.make_mesh(2, 2, devices=[CPU] * 4))
    assert tr.device == CPU
    with pytest.raises(ValueError) as got:
        tr.step(i0, i0, i1)
    jt = jtrain.Trainer.create(params=jp, mesh=jsharding.make_mesh(2, 2))
    with pytest.raises(ValueError) as want:
        jt.step(i0, i0, i1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="spatial_dim"):
        ttrain.Trainer.create(params=tp, spatial_dim=2, device="cpu")


def test_train_cli_data_parallel(tmp_path, monkeypatch, capsys):
    """``--data-parallel 4`` with ``--batch 2`` shrinks to the largest count
    that divides the batch (the gcd), 2."""
    seen = {}
    create = ttrain.Trainer.create

    def spy(*a, **kw):
        seen["mesh"] = kw.get("mesh")
        return create(*a, **kw)

    monkeypatch.setattr(ttrain.Trainer, "create", staticmethod(spy))
    ckpt = str(tmp_path / "w.npz")
    rc = ttrain.main(["--synthetic", "--data-parallel", "4", "--batch", "2", "--crop", "32",
                      "32", "--steps", "2", "--fp32", "--device", "cpu", "--log-every", "1",
                      "--ckpt-out", ckpt])
    assert rc == 0 and "after 2 steps" in capsys.readouterr().out
    assert seen["mesh"].shape == {"data": 2, "spatial": 1}
    back = tckpt.flatten_params(tckpt.load_params(ckpt, device="cpu"))
    assert len(back) == 152 and all(np.isfinite(v).all() for v in back.values())
