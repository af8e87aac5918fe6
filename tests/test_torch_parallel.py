"""``rrin_tpu_torch.parallel`` and data-parallel serving on the CPU: meshes
against the JAX package's (same shapes, same messages), placement round
trips, ``initialize`` alone and in two gloo processes, and the data-parallel
``Interpolator`` against the port's one-device one and the JAX package's.

The mesh lists the CPU more than once (the port's counterpart of the 8
virtual CPU devices that ``conftest.py`` gives the JAX package). Full model
widths at 32x48.

Bars, fixed before any run:
  * a data-parallel request (bfloat16 packed, float32 plain, times mode)
    equals the one-device request on the same batch: every kernel's plain
    version computes each image alone, so bit for bit;
  * int8 on the CPU: the int8 convs' plain versions are not batch-pointwise
    here (the one-device int8 request on a batch of 2 and on its two halves
    differ by one u8 step on about 1 % of the values), so a data-parallel
    int8 request is held to the JAX package's own DP int8 bar
    (``tests/test_sharding.py``): at most 3 u8 steps, on < 5 % of the values;
  * data-parallel absmax calibration equals the one-device full-batch
    calibration bit for bit; against the JAX package's ``_dp_calibrate``
    (float32 plain cascade on both sides) within rtol 1e-4, absmax and the
    99th percentile (the port-vs-JAX bar of ``test_torch_percentile.py``);
  * port against the JAX ``Interpolator(data_parallel=2)`` (float32 plain
    path, 8-virtual-device mesh): at most one u8 step on < 1e-3 of the
    values (``tests/test_flow_shared.py``).
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import rrin_tpu.parallel as jparallel
from rrin_tpu import pipeline as jpipe
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.parallel import sharding as jsharding
from rrin_tpu_torch import parallel as tparallel
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.params import checkpoint as tckpt
from rrin_tpu_torch.parallel import distributed as tdist
from rrin_tpu_torch.parallel import sharding as tsharding
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
H, W = 32, 48


@pytest.fixture(scope="module")
def weights():
    jp = jrrin.init_params(jax.random.key(4))
    return jp, tckpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _pairs(b, h=H, w=W):
    base = fresh_rng().integers(0, 256, (b, h, w + 6, 3), dtype=np.uint8)
    return np.stack([base[:, :, :w], base[:, :, 6:]], axis=1)


def _raises_same(fn_ref, fn_port):
    with pytest.raises(ValueError) as want:
        fn_ref()
    with pytest.raises(ValueError) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def test_make_mesh_matches_reference():
    assert tparallel.__all__ == jparallel.__all__
    assert (tsharding.DATA_AXIS, tsharding.SPATIAL_AXIS) == (
        jsharding.DATA_AXIS, jsharding.SPATIAL_AXIS)
    cpus = [CPU] * 8
    for n_data, n_spatial in ((0, 1), (0, 2), (4, 2), (2, 1), (1, 8)):
        want = jsharding.make_mesh(n_data, n_spatial)
        got = tsharding.make_mesh(n_data, n_spatial, devices=cpus)
        assert got.shape == dict(want.shape)
        assert got.devices.shape == want.devices.shape
        assert got.devices.size == want.devices.size
        assert got.axis_names == tuple(want.axis_names)
    _raises_same(lambda: jsharding.make_mesh(0, 3), lambda: tsharding.make_mesh(0, 3, cpus))
    _raises_same(lambda: jsharding.make_mesh(4, 4), lambda: tsharding.make_mesh(4, 4, cpus))
    spec = tsharding.batch_sharding(got, spatial_dim=2, ndim=5).spec
    assert spec == tuple(jsharding.batch_sharding(want, spatial_dim=2, ndim=5).spec)
    assert tsharding.replicate(got).spec == ()
    if not torch.cuda.is_available():  # no CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            tsharding.make_mesh()


def test_shard_and_gather_round_trip():
    mesh = tsharding.make_mesh(2, 2, devices=[CPU] * 4)
    a = np.arange(4 * 48 * 5 * 3, dtype=np.float32).reshape(4, 48, 5, 3)
    x = tsharding.shard_pairs(mesh, a)
    assert x.sharding == tsharding.batch_sharding(mesh) and x.shape == a.shape
    # not cut over the spatial axis: one piece per data index, on its row's
    # first device
    assert [[s.shape[0] for s in row] for row in x.shards] == [[2], [2]]
    np.testing.assert_array_equal(x.gather().numpy(), a)
    y, z = tsharding.shard_pairs(mesh, a, a[:, :32], spatial_dim=1)
    # rows cut at multiples of 16: 48 -> 32 + 16, 32 -> 16 + 16
    assert [s.shape[1] for s in y.shards[0]] == [32, 16]
    assert [s.shape[1] for s in z.shards[1]] == [16, 16]
    np.testing.assert_array_equal(y.gather().numpy(), a)
    np.testing.assert_array_equal(z.gather().numpy(), a[:, :32])
    # every shard its own tensor, also on a repeated device
    ptrs = [s.data_ptr() for v in (x, y) for row in v.shards for s in row]
    assert len(set(ptrs)) == len(ptrs)
    with pytest.raises(ValueError, match="divide"):
        tsharding.shard_pairs(mesh, a[:3])
    params = {"u": {"w": torch.ones(2)}}
    rep = tsharding.replicate_params(mesh, params)
    assert list(rep) == [CPU] and rep[CPU]["u"]["w"] is params["u"]["w"]


def test_initialize_is_a_noop_without_configuration(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    ctx = tdist.initialize()
    assert isinstance(ctx, tdist.DistributedContext)
    assert not ctx.initialized and ctx.process_count == 1 and ctx.process_index == 0
    assert ctx.local_device_count >= 1 and tdist.world_size() == 1
    # a host's cards shared out among its processes by their rank on it
    hosts = ["a", "b", "a", "b"]
    assert [tdist.host_share(hosts, r, 2) for r in range(4)] == [
        [torch.device("cuda", 0)], [torch.device("cuda", 0)],
        [torch.device("cuda", 1)], [torch.device("cuda", 1)]]
    assert tdist.host_share(["a", "b"], 1, 4) == [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(RuntimeError, match="device of its own"):
        tdist.host_share(hosts, 0, 1)


_WORKER = textwrap.dedent(
    """
    import os, sys
    import torch
    import torch.distributed as dist

    mode, coord, pid, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
    from rrin_tpu_torch.parallel.distributed import initialize, world_size
    if mode == "env":
        os.environ["JAX_COORDINATOR_ADDRESS"] = coord
        os.environ["JAX_NUM_PROCESSES"] = "2"
        os.environ["JAX_PROCESS_ID"] = str(pid)
        ctx = initialize()
    else:
        ctx = initialize(coordinator_address=coord, num_processes=2, process_id=pid)
    assert ctx.initialized and ctx.process_count == 2 and world_size() == 2, ctx
    assert ctx.process_index == pid, ctx
    assert ctx.global_device_count == 2 * ctx.local_device_count, ctx
    x = torch.full((3,), float(pid + 1))
    dist.all_reduce(x)
    assert x.tolist() == [3.0, 3.0, 3.0], x

    if mode == "env":
        # the tool as a user runs it, one device per process: --batch is the
        # group's, each process trains on its half and the steps average
        from rrin_tpu_torch import train as ttrain

        assert ttrain.main(TRAIN_ARGS + ["--ckpt-out", f"{out}/rank{pid}.npz"]) == 0
        print(f"worker {pid} OK: {ctx}")
        dist.destroy_process_group()
        sys.exit(0)

    # a training step over the group: each process takes half of one batch
    # on a mesh of its one device; the gradients averaged over the group
    # are the whole batch's (SGD at lr 1 moves the params by the gradient)
    from rrin_tpu_torch.config import ModelConfig
    from rrin_tpu_torch.models.rrin import init_params
    from rrin_tpu_torch.parallel.sharding import make_mesh
    from rrin_tpu_torch.train import Trainer, _trainable, param_leaves

    cfg, cpu = ModelConfig(base_width=4), torch.device("cpu")

    def trainer(mesh):
        p = _trainable(init_params(torch.Generator().manual_seed(0), cfg, device="cpu"), cpu)
        return Trainer(params=p, optimizer=torch.optim.SGD(param_leaves(p), lr=1.0), cfg=cfg,
                       compute_dtype=torch.float32, mesh=mesh, device=cpu)

    g = torch.Generator().manual_seed(7)
    batch = [torch.rand((4, 32, 32, 3), generator=g) for _ in range(3)]
    dp, one = trainer(make_mesh(1, devices=[cpu])), trainer(None)
    loss = dp.step(*(b[2 * pid: 2 * pid + 2] for b in batch))
    want = one.step(*batch)
    assert abs(loss - want) <= 1e-6 * abs(want), (loss, want)
    flat = [torch.cat([t.detach().flatten() for t in param_leaves(tr.params)])
            for tr in (dp, one)]
    assert float((flat[0] - flat[1]).abs().max()) <= 1e-6
    print(f"worker {pid} OK: {ctx}")
    dist.destroy_process_group()
    """
)


# One full-width float32 step of the training tool on the CPU, one device.
_TRAIN_ARGS = ["--synthetic", "--batch", "2", "--crop", "32", "32", "--steps", "1", "--fp32",
               "--device", "cpu", "--data-parallel", "0"]


@pytest.mark.parametrize("mode", ["env", "args"])
def test_initialize_two_processes(mode, tmp_path):
    """Two gloo processes on 127.0.0.1, through the environment and through
    the arguments, all-reduce a tensor and train over the group.

    ``args``: one data-parallel ``Trainer`` step (narrow widths, a mesh of
    one device each): loss and params within 1e-6 of the one-process step on
    the whole batch. ``env``: ``rrin-tpu-torch-train`` itself, one device
    and half the batch each (full width, Adamax at lr 1e-4): the two ranks
    end with equal params, bit for bit, and at most 1e-4 of them differ by
    more than 1e-6 from one process's step on the whole batch."""
    from rrin_tpu_torch import train as ttrain

    script = tmp_path / "worker.py"
    script.write_text(f"TRAIN_ARGS = {_TRAIN_ARGS!r}\n" + _WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), mode, coord, str(i), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i in range(2)]
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0 and f"worker {i} OK" in out, out[-3000:]
    if mode == "env":
        assert ttrain.main(_TRAIN_ARGS + ["--ckpt-out", str(tmp_path / "one.npz")]) == 0
        r0, r1, one = (np.load(tmp_path / f"{n}.npz") for n in ("rank0", "rank1", "one"))
        assert sorted(r0.files) == sorted(one.files)
        for k in r0.files:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        flat = [np.concatenate([z[k].ravel() for k in sorted(one.files)]) for z in (r0, one)]
        share = float(np.mean(np.abs(flat[0] - flat[1]) > 1e-6))
        assert share <= 1e-4, share


@pytest.mark.parametrize("dtype,use_pallas", [("bfloat16", True), ("float32", False)])
def test_dp_request_equals_one_device(weights, dtype, use_pallas):
    _, tp = weights
    pairs = _pairs(4)
    one = tpipe.Interpolator(tp, compute_dtype=dtype, use_pallas=use_pallas, device="cpu")
    dp = tpipe.Interpolator(tp, compute_dtype=dtype, use_pallas=use_pallas, data_parallel=2,
                            device="cpu")
    assert dp.mesh is not None and dp.shard_count == 2 and dp._dp_fast
    got = dp.step(pairs)
    assert got.device == CPU and got.shape == (4, 1, H, W, 3)
    np.testing.assert_array_equal(got.numpy(), one.step(pairs).numpy())
    assert (dp._packed_params[(H, W)] is not None) == use_pallas  # prepared once


def test_dp_int8_and_calibration(weights):
    """Absmax DP calibration equals the full batch's bit for bit and the
    JAX package's ``_dp_calibrate`` within rtol 1e-4, as does the 99th
    percentile's fold; an int8 DP request is held to the JAX package's DP
    int8 bar against the one-device request."""
    jp, tp = weights
    pairs = _pairs(2)
    dp = tpipe.Interpolator(tp, use_pallas=True, int8=True, data_parallel=2, device="cpu")
    full = tpipe.device_calibrate(tp, pairs, compute_dtype=torch.bfloat16, pad_hw=(0, 0),
                                  device="cpu")
    got = dp._dp_calibrate(pairs, (0, 0))
    for u in full:
        for k in full[u]:
            assert float(got[u][k]) == float(full[u][k]), (u, k)
    for quantile in (None, 99.0):
        kw = dict(compute_dtype="float32", int8=True, int8_percentile=quantile)
        want = jpipe.Interpolator(jp, data_parallel=2, **kw)._dp_calibrate(pairs, (0, 0))
        got = tpipe.Interpolator(tp, data_parallel=2, device="cpu", **kw)._dp_calibrate(
            pairs, (0, 0))
        for u in want:
            for k in want[u]:
                np.testing.assert_allclose(float(got[u][k]), float(want[u][k]), rtol=1e-4,
                                           err_msg=f"{quantile} {u}/{k}")
    out = dp.step(pairs).numpy()
    ref = tpipe.Interpolator(tp, use_pallas=True, int8=True, device="cpu").step(pairs).numpy()
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 3 and (d != 0).mean() < 0.05, (d.max(), (d != 0).mean())
    stats, prep = dp._state_on(CPU, (H, W))
    assert prep is not None and prep.quant_stats is stats
    assert set(dp.saturation_rates(pairs).values()) == {0.0}


def test_dp_matches_jax_data_parallel(weights):
    jp, tp = weights
    pairs = _pairs(2)
    want = np.asarray(jpipe.Interpolator(jp, compute_dtype="float32", data_parallel=2)
                      .step(pairs))
    got = tpipe.Interpolator(tp, compute_dtype="float32", data_parallel=2,
                             device="cpu").step(pairs).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape and d.max() <= 1 and (d > 0).mean() < 1e-3, (
        d.max(), (d > 0).mean())


def test_dp_times_mode(weights):
    """Per-pair times are cut with the batch."""
    _, tp = weights
    pairs = _pairs(4)
    ts = np.array([[0.2, 0.7], [0.5, 0.5], [0.3, 0.9], [0.1, 0.4]], np.float32)
    kw = dict(mode="times", compute_dtype="float32", device="cpu")
    want = tpipe.Interpolator(tp, **kw).step(pairs, ts).numpy()
    got = tpipe.Interpolator(tp, data_parallel=2, **kw).step(pairs, ts).numpy()
    assert got.shape == (4, 2, H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_refusals_match_reference(weights):
    jp, tp = weights
    with pytest.raises(ValueError, match="spatial"):
        jpipe.Interpolator(jp, int8=True, spatial=2)
    with pytest.raises(ValueError, match="spatial"):
        tpipe.Interpolator(tp, int8=True, spatial=2, device="cpu")
    mesh = tsharding.make_mesh(1, 2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="'spatial' axis"):
        tpipe.Interpolator(tp, int8=True, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="'spatial' axis"):
        jpipe.Interpolator(jp, int8=True, mesh=jsharding.make_mesh(1, 2))
    it = tpipe.Interpolator(tp, mesh=mesh, device="cpu")
    assert it.shard_count == 1 and not it._dp_fast
    # a mesh of one device is dropped: the one-device route
    assert tpipe.Interpolator(tp, data_parallel=0, device="cpu").mesh is None
    assert tpipe.Interpolator(tp, mesh=tsharding.make_mesh(1, 1, [CPU]), device="cpu").mesh \
        is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpipe.Interpolator(tp, data_parallel=2)
