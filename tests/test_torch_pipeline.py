"""The port's uint8 device step, Interpolator and video loop on the CPU
against the JAX package's pipeline, on the same weights and frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrin_tpu import pipeline as jpipe
from rrin_tpu.models import rrin as jrrin
from rrin_tpu_torch import pipeline as tpipe
from rrin_tpu_torch.params.checkpoint import params_from_numpy
from torch_packed_util import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    jp = jrrin.init_params(jax.random.key(5))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """Two frame pairs at 40x72, a size that needs padding to 48x80."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (2, 40, 80, 3), dtype=np.uint8)
    return np.stack([base[:, :, :72], base[:, :, 8:]], axis=1)


def _assert_one_step(got, want):
    """At most one uint8 step, on fewer than 1e-3 of the pixels: the bar the
    JAX package sets between two programs that compute the same frames."""
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-3, (d > 0).mean()


@pytest.mark.parametrize("kw,m", [
    (dict(exp=1, mode="direct"), 1),
    (dict(exp=2, mode="direct"), 3),
    (dict(exp=2, mode="cascade"), 3),
])
def test_device_step_fp32(weights, pairs, kw, m):
    jp, tp = weights
    want = np.asarray(jpipe.device_step(
        jp, jnp.asarray(pairs), compute_dtype=jnp.float32, **kw))
    got = tpipe.device_step(
        tp, pairs, compute_dtype=torch.float32, device="cpu", **kw).numpy()
    assert got.shape == (2, m, 40, 72, 3)
    _assert_one_step(got, want)


def test_device_step_times(weights, pairs):
    jp, tp = weights
    ts = np.asarray([[0.2, 0.7], [0.5, 0.9]], np.float32)
    want = np.asarray(jpipe.device_step(
        jp, jnp.asarray(pairs), mode="times", compute_dtype=jnp.float32,
        ts=jnp.asarray(ts)))
    got = tpipe.device_step(
        tp, pairs, mode="times", compute_dtype=torch.float32, ts=ts,
        device="cpu").numpy()
    _assert_one_step(got, want)


def test_device_step_bf16_kernel_path(weights, pairs):
    """The serving configuration (bf16, kernel wrappers) on the CPU, i.e. the
    plain versions. 40 dB: bf16 rounds at other places in the two frameworks
    through 76 random-weight convs."""
    jp, tp = weights
    want = np.asarray(jpipe.device_step(
        jp, jnp.asarray(pairs[:1]), compute_dtype=jnp.bfloat16, use_pallas=True,
        packed=False)).astype(np.float32)
    got = tpipe.device_step(
        tp, pairs[:1], compute_dtype=torch.bfloat16, use_pallas=True,
        packed=False, device="cpu").numpy().astype(np.float32)
    mse = float(np.mean((got - want) ** 2)) / 255.0 ** 2
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40.0


def test_normalize_pad_matches(pairs):
    want = np.asarray(jpipe._normalize_pad(jnp.asarray(pairs), 8, 8))
    got = tpipe._normalize_pad(torch.from_numpy(pairs), 8, 8).numpy()
    np.testing.assert_array_equal(got, want)


class TestInterpolator:
    def test_step_and_validation(self, weights, pairs):
        _, tp = weights
        it = tpipe.Interpolator(tp, exp=1, compute_dtype="float32", device="cpu")
        assert it.mids_per_pair == 1 and it.shard_count == 1
        out = it.step(pairs)
        want = tpipe.device_step(tp, pairs, compute_dtype=torch.float32, device="cpu")
        assert torch.equal(out, want)
        with pytest.raises(ValueError):
            it.step(pairs, ts=np.full((2, 1), 0.5, np.float32))
        tm = tpipe.Interpolator(tp, mode="times", compute_dtype="float32", device="cpu")
        with pytest.raises(ValueError):
            tm.step(pairs)
        assert tm.step(pairs, ts=np.full((2, 1), 0.5, np.float32)).shape == (2, 1, 40, 72, 3)
        assert tpipe.Interpolator(tp, exp=3, device="cpu").mids_per_pair == 7

    # Every option is ported now (parallel/ last): on the CPU each builds a
    # mesh of the CPU listed once per shard, and a mesh of one device is
    # dropped (data_parallel=0 is every device: one here).
    @pytest.mark.parametrize("kw", [
        dict(int8=True, int8_percentile=99.9, data_parallel=2),
        dict(int8_percentile=99.9, int8=True, data_parallel=4),
        dict(data_parallel=2), dict(data_parallel=0), dict(spatial=2)])
    def test_unported_options_raise(self, kw):
        it = tpipe.Interpolator({}, device="cpu", **kw)
        n_data, n_spatial = max(kw.get("data_parallel", 1), 1), kw.get("spatial", 1)
        if n_data * n_spatial == 1:
            assert it.mesh is None
        else:
            assert it.mesh.shape == {"data": n_data, "spatial": n_spatial}
            assert set(it.mesh.devices.flat) == {torch.device("cpu")}
        assert it.shard_count == n_data

    @pytest.mark.parametrize("kw", [dict(mode="bogus"), dict(exp=0), dict(spatial=0)])
    def test_bad_arguments_raise(self, kw):
        with pytest.raises(ValueError):
            tpipe.Interpolator({}, device="cpu", **kw)

    def test_device_step_rejects_bad_input(self):
        with pytest.raises(ValueError):
            tpipe.device_step({}, np.zeros((1, 2, 16, 16, 3), np.float32), device="cpu")
        with pytest.raises(ValueError):  # packed=True is ported; the check stays
            tpipe.device_step({}, np.zeros((1, 2, 16, 16, 3), np.float32),
                              packed=True, device="cpu")
        assert tpipe.Interpolator({}, packed=True, device="cpu").packed is True


def _write_clip(path, n, h=32, w=48, fps=10.0):
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert wr.isOpened()
    for i in range(n):
        f = np.full((h, w, 3), 30, np.uint8)
        f[8:20, 4 + 3 * i: 16 + 3 * i] = (200, 120, 40)
        wr.write(f)
    wr.release()


class TestVideo:
    @pytest.mark.parametrize("exp,batch", [(1, 1), (2, 2)])
    def test_interpolate_video_frame_count(self, weights, tmp_path, exp, batch):
        from rrin_tpu_torch.io.video import probe_video
        _, tp = weights
        src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
        n = 4
        _write_clip(src, n)
        rep = tpipe.interpolate_video(
            src, dst, tp, exp=exp, batch_size=batch, compute_dtype="float32",
            device="cpu")
        want = (1 << exp) * (n - 1) + 1
        assert rep.frames_in == n and rep.frames_out == want
        meta = probe_video(dst)
        assert meta.frame_count == want and (meta.height, meta.width) == (32, 48)
        assert abs(meta.fps - 10.0 * (1 << exp)) < 1e-3
        assert "total" in rep.timers and rep.to_json()

    def test_retime_video(self, weights, tmp_path):
        from rrin_tpu_torch.io.video import VideoReader
        _, tp = weights
        src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
        _write_clip(src, 3)
        rep = tpipe.interpolate_video(
            src, dst, tp, retime_fps=25.0, compute_dtype="float32", device="cpu")
        assert rep.frames_out == int((3 - 1) * 25.0 / 10.0) + 1
        rd = VideoReader(dst)
        frames = list(rd)
        rd.close()
        assert len(frames) == rep.frames_out and frames[0].shape == (32, 48, 3)

    def test_times_mode_needs_factor(self, weights, tmp_path):
        _, tp = weights
        with pytest.raises(ValueError):
            tpipe.interpolate_video("a", "b", tp, mode="times", device="cpu")
