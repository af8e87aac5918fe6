"""The port's command-line tools: ``cli.py`` (video) and ``interp_image.py``
(one still pair) against the JAX package's on the same weights and files,
and their parsers, usage errors and unported options."""

import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch

from rrin_tpu import cli as jcli
from rrin_tpu import interp_image as jimage
from rrin_tpu.models import rrin as jrrin
from rrin_tpu.params import save_params
from rrin_tpu_torch import cli as tcli
from rrin_tpu_torch import interp_image as timage
from rrin_tpu_torch.params import load_params
from torch_packed_util import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

H, W, N, FPS = 48, 64, 5, 10.0
# Two encodes of frames that agree to the u8 step differ only where the
# frames do: a mean absolute difference of half a step over each frame.
VIDEO_MEAN_U8 = 0.5


def _assert_one_step(got, want):
    """At most one uint8 step, on fewer than 1e-3 of the pixels: the bar the
    JAX package sets between two programs that compute the same frames
    (tests/test_flow_shared.py)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _frames(path):
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out, fps


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 5-frame 48x64 clip, a 40x60 still pair with its middle frame, and
    the JAX package's random weights as a file."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(5)
    small = rng.random((H // 8, 2 * W // 8, 3)).astype(np.float32)
    base = (np.clip(cv2.resize(small, (2 * W, H), interpolation=cv2.INTER_CUBIC), 0, 1)
            * 255).astype(np.uint8)
    video = str(root / "in.mp4")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for i in range(N):
        wr.write(base[:, 2 * i: 2 * i + W])
    wr.release()
    ims = {}
    for j, name in enumerate(("im1", "im2", "im3")):
        ims[name] = str(root / f"{name}.png")
        cv2.imwrite(ims[name], base[4:44, 3 * j: 3 * j + 60])
    ckpt = str(root / "w.npz")
    save_params(ckpt, jrrin.init_params(jax.random.key(9)))
    return {"root": root, "video": video, "ckpt": ckpt, **ims}


def test_parser_is_the_reference_plus_device():
    ref = {a.dest: a for a in jcli.build_parser()._actions}
    got = {a.dest: a for a in tcli.build_parser()._actions}
    assert set(got) == set(ref) | {"device"}
    for dest, a in ref.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.type, b.required, b.choices, b.nargs) == \
            (a.option_strings, a.default, a.type, a.required, a.choices, a.nargs), dest
    assert got["device"].default == "cuda"
    assert tcli.build_parser().prog == "rrin-tpu-torch"
    for name in ("build_parser", "main"):
        assert list(inspect.signature(getattr(tcli, name)).parameters) == \
            list(inspect.signature(getattr(jcli, name)).parameters)


def test_usage_errors_exit_2_before_any_load(monkeypatch, capsys, tmp_path):
    """Each usage error exits 2 with the reference's message and loads no
    checkpoint."""
    def no_load(*a, **kw):
        raise AssertionError("a usage error must not load a checkpoint")

    monkeypatch.setattr(tcli, "_load_params", no_load)
    io = ["-i", "in.mp4", "-o", str(tmp_path / "o.mp4")]
    cases = [
        ["--sf", "3"], ["--sf", "1"],
        ["--retime", "60", "--fps", "30"],
        ["--retime", "60", "--slowmo", "2"],
        ["--calib", "c.npz"], ["--save-calib", "c.npz"],
        ["--int8-percentile", "99"], ["--int8-saturation"],
        ["--int8", "--int8-percentile", "99", "--calib", "c.npz"],
        ["--int8", "--int8-saturation", "--segment-pairs", "2"],
    ]
    for extra in cases:
        assert jcli.main(io + extra) == 2, extra
        want = capsys.readouterr().err
        assert tcli.main(io + extra + ["--device", "cpu"]) == 2, extra
        got = capsys.readouterr().err
        assert got == want and got.startswith("error: "), (extra, got, want)
    with pytest.raises(SystemExit) as e:
        tcli.main(io + ["--exp", "2", "--sf", "4"])
    assert e.value.code == 2


def test_data_parallel_is_not_ported(files, tmp_path):
    """``--data-parallel 2`` (the batch rounds up to 2 pairs) and
    ``--spatial 2`` are ported: on the CPU's plain path both write the
    frames of the one-device run."""
    def run(name, *flags):
        out = str(tmp_path / f"{name}.mp4")
        assert tcli.main(["-i", files["video"], "-o", out, "--no-pallas", *flags,
                          "--ckpt", files["ckpt"], "--device", "cpu", "-q"]) == 0
        return _frames(out)

    want, fps = run("one")
    assert len(want) == 2 * N - 1
    for flag in ("--data-parallel", "--spatial"):
        got, got_fps = run(flag.strip("-"), flag, "2")
        assert got_fps == fps and len(got) == len(want), flag
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=flag)


def test_cli_matches_reference(files, tmp_path, monkeypatch):
    """One clip through both CLIs (float32, plain path, the same weights):
    the same frame count and fps, frames within half a u8 step on average;
    the port's --report and --profile files. The JAX package's packer takes
    its numpy path (byte-equal): its library builds beside the JAX package's
    source, where tests/test_native.py may be loading it in another worker."""
    from rrin_tpu import native as jnative

    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    jout, tout = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    common = ["-i", files["video"], "--ckpt", files["ckpt"], "--fp32", "--no-pallas", "-q"]
    assert jcli.main(common + ["-o", jout]) == 0
    report, prof = str(tmp_path / "r.json"), str(tmp_path / "prof")
    assert tcli.main(common + ["-o", tout, "--device", "cpu", "--report", report,
                               "--profile", prof]) == 0
    want, fps_want = _frames(jout)
    got, fps_got = _frames(tout)
    assert len(got) == len(want) == 2 * (N - 1) + 1
    assert fps_got == fps_want == 2 * FPS
    for g, w in zip(got, want):
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).mean() <= VIDEO_MEAN_U8
    with open(report) as f:
        rep = json.load(f)
    assert rep["frames_out"] == len(got) and set(rep["timers"]) == {
        "decode", "pack", "dispatch", "d2h", "encode_wait", "total"}
    with open(os.path.join(prof, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_interpolate_pair_matches_reference(files):
    """40x60 (padded to 48x64), float32 on the plain path."""
    jp = jrrin.init_params(jax.random.key(9))
    im1 = cv2.imread(files["im1"])[:, :, ::-1]
    im3 = cv2.imread(files["im3"])[:, :, ::-1]
    want = jimage.interpolate_pair(jp, im1, im3, t=0.3)
    got = timage.interpolate_pair(load_params(files["ckpt"], device="cpu"), im1, im3, t=0.3,
                                  device="cpu")
    assert got.shape == (40, 60, 3)
    _assert_one_step(got, want)
    ref = inspect.signature(jimage.interpolate_pair).parameters
    port = inspect.signature(timage.interpolate_pair).parameters
    assert list(port) == list(ref) + ["device"]
    assert [port[k].default for k in ref] == [ref[k].default for k in ref]


def test_interpolate_pair_int8(files):
    """int8 at 48x64 (a height both packages' packed paths take): calibrated
    on the pair, within the reference's int8 bar (> 35 dB) of float32."""
    rng = np.random.default_rng(6)
    im1 = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    im3 = np.roll(im1, 2, axis=1)
    p = load_params(files["ckpt"], device="cpu")
    f32 = timage.interpolate_pair(p, im1, im3, device="cpu").astype(np.float64)
    q8 = timage.interpolate_pair(p, im1, im3, compute_dtype="bfloat16", use_pallas=True,
                                 int8=True, device="cpu").astype(np.float64)
    mse = float(np.mean((q8 - f32) ** 2)) / 255.0 ** 2
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 35.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            timage.interpolate_pair(p, im1, im3)


def test_image_main_matches_reference(files, tmp_path, capsys):
    """Both image tools on one still pair with --gt: the same middle frame
    (to one u8 step) and the same scores."""
    args = ["--im1", files["im1"], "--im3", files["im3"], "--gt", files["im2"],
            "--ckpt", files["ckpt"], "--fp32", "--no-pallas"]
    assert jimage.main(args + ["-o", str(tmp_path / "j.png")]) == 0
    want = json.loads(capsys.readouterr().out)
    assert timage.main(args + ["-o", str(tmp_path / "t.png"), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    _assert_one_step(cv2.imread(str(tmp_path / "t.png")), cv2.imread(str(tmp_path / "j.png")))
    assert abs(got["psnr"] - want["psnr"]) <= 0.05 and abs(got["ssim"] - want["ssim"]) <= 5e-4
    assert timage.main(["--im1", "missing.png", "--im3", files["im3"], "-o", "x.png",
                        "--device", "cpu"]) == 2
