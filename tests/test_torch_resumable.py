"""The port's resumable segmented jobs (``resumable.py``) and its native pair
packer (``native/``): segments against a single pass, resume, job-signature
checks and the int8 sidecar on the port; manifests and packed bytes against
the JAX package's."""

import ctypes
import inspect
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from rrin_tpu import native as jnative
from rrin_tpu import resumable as jres
from rrin_tpu_torch import _build
from rrin_tpu_torch import cli as tcli
from rrin_tpu_torch import native as tnative
from rrin_tpu_torch import resumable as tres
from rrin_tpu_torch.models.rrin import init_params
from rrin_tpu_torch.pipeline import interpolate_video
from torch_packed_util import fresh_rng, one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

H, W, N, FPS = 48, 64, 5, 10.0
# A segmented job re-encodes its segments once more: the reference's codec
# bar between a segmented and a single-pass output (tests/test_resumable.py).
CODEC_MEAN_U8 = 12.0
F32 = dict(compute_dtype="float32", use_pallas=False, device="cpu")


def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.astype(np.int32))
    cap.release()
    return out


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "in.mp4")
    rng = np.random.default_rng(4)
    small = rng.random((H // 8, 2 * W // 8, 3)).astype(np.float32)
    base = (np.clip(cv2.resize(small, (2 * W, H), interpolation=cv2.INTER_CUBIC), 0, 1)
            * 255).astype(np.uint8)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for i in range(N):
        wr.write(base[:, 2 * i: 2 * i + W])
    wr.release()
    return path


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), device="cpu")


def test_segmented_matches_single_pass(video, params, tmp_path, monkeypatch, capsys):
    """Two segments of two pairs against one pass: the same frame count,
    frames within the codec bar, no segment file left; every pair packed by
    the native packer; ``--status`` reads the manifest."""
    packed = []
    real_pack = tnative.pack_pair_bgr

    def spy(*a, **kw):
        packed.append(real_pack(*a, **kw))
        return packed[-1]

    monkeypatch.setattr(tnative, "pack_pair_bgr", spy)
    direct, seg = str(tmp_path / "direct.mp4"), str(tmp_path / "seg.mp4")
    interpolate_video(video, direct, params, **F32)
    manifest = tres.interpolate_video_resumable(video, seg, params, segment_pairs=2, **F32)
    assert manifest["finished"] and manifest["n_segments"] == 2
    assert [s["frames"] for s in manifest["segments"]] == [4, 5]
    assert packed == [True] * (2 * (N - 1))
    fd, fs = _frames(direct), _frames(seg)
    assert len(fd) == len(fs) == 2 * (N - 1) + 1
    for a, b in zip(fd, fs):
        assert np.mean(np.abs(a - b)) < CODEC_MEAN_U8
    assert [p for p in os.listdir(tmp_path) if ".seg" in p] == []
    assert tcli.main(["-i", video, "-o", seg, "--status"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status == tres.job_status(seg) == jres.job_status(seg)
    assert status["finished"] and status["segments_done"] == status["segments_total"] == 2
    assert tcli.main(["-i", video, "-o", str(tmp_path / "none.mp4"), "--status"]) == 1


def test_resume_after_partial_run_and_mismatch(video, params, tmp_path, monkeypatch):
    out = str(tmp_path / "resume.mp4")
    real = tres.interpolate_video
    calls = []

    def crashing(*a, **kw):
        if calls:
            raise RuntimeError("simulated crash")
        calls.append(kw["start_frame"])
        return real(*a, **kw)

    monkeypatch.setattr(tres, "interpolate_video", crashing)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tres.interpolate_video_resumable(video, out, params, segment_pairs=2, **F32)
    status = tres.job_status(out)
    assert not status["finished"] and status["segments_done"] == 1

    def resumed(*a, **kw):
        calls.append(kw["start_frame"])
        return real(*a, **kw)

    monkeypatch.setattr(tres, "interpolate_video", resumed)
    manifest = tres.interpolate_video_resumable(video, out, params, segment_pairs=2, **F32)
    assert manifest["finished"] and calls == [0, 2]  # only the second segment ran again
    assert len(_frames(out)) == 2 * (N - 1) + 1
    with pytest.raises(ValueError, match="different job config"):
        tres.interpolate_video_resumable(video, out, params, segment_pairs=3, **F32)
    with pytest.raises(ValueError, match="different job config"):
        tres.interpolate_video_resumable(video, out, params, segment_pairs=2,
                                         **{**F32, "compute_dtype": "bfloat16"})


def test_int8_segments_share_one_calibration(video, params, tmp_path, monkeypatch):
    """The first segment calibrates and writes the job's sidecar; the later
    ones serve that grid; --save-calib receives it (a file the JAX package
    reads too) and the sidecar goes."""
    from rrin_tpu.params import load_calibration as jload

    calls = []
    real = tres.interpolate_video

    def spy(*a, **kw):
        calls.append({"quant_stats": kw.get("quant_stats"), "save_calib": kw.get("save_calib"),
                      "int8_percentile": kw.get("int8_percentile")})
        return real(*a, **kw)

    monkeypatch.setattr(tres, "interpolate_video", spy)
    calib, out = str(tmp_path / "job_calib.npz"), str(tmp_path / "seg_int8.mp4")
    manifest = tres.interpolate_video_resumable(
        video, out, params, segment_pairs=2, compute_dtype="bfloat16", int8=True,
        int8_percentile=99.9, save_calib=calib, device="cpu")
    assert manifest["finished"] and len(calls) == 2
    assert calls[0] == {"quant_stats": None, "save_calib": out + ".calib.npz",
                        "int8_percentile": 99.9}
    assert calls[1]["quant_stats"] is not None and calls[1]["save_calib"] is None
    assert calls[1]["int8_percentile"] is None
    assert not os.path.exists(out + ".calib.npz")
    grid = jload(calib)
    for u, sites in calls[1]["quant_stats"].items():
        for k, v in sites.items():
            assert float(v) == float(grid[u][k]) > 0, (u, k)
    assert len(_frames(out)) == 2 * (N - 1) + 1


def test_job_status_reads_a_reference_manifest(video, tmp_path, monkeypatch):
    """A job the JAX package started (one of two segments done) reads the
    same in both packages, and the port resumes it at its second segment."""
    out = str(tmp_path / "jax_job.mp4")

    class Report:
        frames_out, interp_fps = 4, 1.0

    def one_segment(*a, **kw):
        if kw["start_frame"]:
            raise RuntimeError("crash in the second segment")
        return Report()

    monkeypatch.setattr(jres, "interpolate_video", one_segment)
    with pytest.raises(RuntimeError, match="second segment"):
        jres.interpolate_video_resumable(video, out, {}, compute_dtype="float32",
                                         use_pallas=False, segment_pairs=2)
    assert tres.job_status(out) == jres.job_status(out)
    assert tres.job_status(out)["segments_done"] == 1

    starts = []

    def port_segment(*a, **kw):
        starts.append(kw["start_frame"])
        raise RuntimeError("stop")

    monkeypatch.setattr(tres, "interpolate_video", port_segment)
    with pytest.raises(RuntimeError, match="stop"):
        tres.interpolate_video_resumable(video, out, {}, segment_pairs=2, **F32)
    assert starts == [2]


def _reference_library(tmp_path):
    """The JAX package's ``framepack.cpp`` built by this test into its own
    directory (loading ``rrin_tpu.native`` would build beside the JAX
    package's source, which its own tests in other workers load)."""
    out = str(tmp_path / "libframepack_ref.so")
    subprocess.run(["g++", *tnative._FLAGS, "-o", out, jnative._SRC], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(out)
    lib.rrin_swap_rb_u8.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int32]
    lib.rrin_pack_pair_bgr.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
        ctypes.c_int32]
    return lib


def test_native_packer_matches_numpy_and_reference(tmp_path):
    """Built with g++ into rrin_tpu_torch/_build/ from a copy of the JAX
    package's source; byte-equal to numpy and to the JAX package's library
    on the same frames, threaded at 1080p."""
    with open(tnative._SRC, "rb") as f, open(jnative._SRC, "rb") as g:
        assert f.read() == g.read()
    assert tnative.available()
    lib = tnative._target()
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert not list((lib.parent.parent / "native").glob("*.so"))
    ref = _reference_library(tmp_path)
    rng = fresh_rng()
    for h, w in ((48, 64), (1088, 1920)):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        b = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tnative.swap_rb(a), a[:, :, ::-1])
        swapped = np.empty_like(a)
        ref.rrin_swap_rb_u8(a.ctypes.data, swapped.ctypes.data, h * w, 4)
        np.testing.assert_array_equal(tnative.swap_rb(a, threads=4), swapped)
        got = np.zeros((3, 2, h, w, 3), np.uint8)
        want = np.zeros_like(got)
        assert tnative.pack_pair_bgr(a, b, got, 1)
        ref.rrin_pack_pair_bgr(a.ctypes.data, b.ctypes.data, want.ctypes.data, 1, a.nbytes, 4)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[1, 0], a[:, :, ::-1])
        np.testing.assert_array_equal(got[1, 1], b[:, :, ::-1])
        assert not got[0].any() and not got[2].any()


def test_native_falls_back_where_it_cannot_pack():
    rng = fresh_rng()
    wide = rng.integers(0, 256, (16, 24, 6), dtype=np.uint8)
    view = wide[:, :, ::2]  # not contiguous
    np.testing.assert_array_equal(tnative.swap_rb(view), view[:, :, ::-1])
    a = np.ascontiguousarray(view)
    batch = np.zeros((1, 2, 16, 24, 3), np.uint8)
    assert not tnative.pack_pair_bgr(view, a, batch, 0)
    assert not tnative.pack_pair_bgr(a, a[:8].copy(), batch, 0)  # shapes differ
    assert not tnative.pack_pair_bgr(a, a, batch, 1)  # no such slot
    assert not tnative.pack_pair_bgr(a, a, np.zeros((1, 2, 16, 24, 3), np.float32), 0)
    assert not batch.any()


def test_public_names_and_signatures():
    for ref, port, extra in ((jres, tres, {"interpolate_video_resumable": ["device"]}),
                             (jnative, tnative, {})):
        names = {n for n, v in vars(ref).items() if not n.startswith("_")
                 and inspect.isfunction(v) and v.__module__ == ref.__name__}
        got = {n for n, v in vars(port).items() if not n.startswith("_")
               and inspect.isfunction(v) and v.__module__ == port.__name__}
        assert got == names, port.__name__
        for n in names:
            rp = inspect.signature(getattr(ref, n)).parameters
            pp = inspect.signature(getattr(port, n)).parameters
            assert list(pp) == list(rp) + extra.get(n, []), n
            # repr: the two packages' ModelConfig are distinct classes
            assert [repr(pp[k].default) for k in rp] == [repr(rp[k].default) for k in rp], n
