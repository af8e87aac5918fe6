"""Resumable segmented video jobs of the port.

A long job is split into fixed-size segments of source frame pairs; each
segment encodes to its own file and a JSON manifest records completion
(written atomically via rename). On restart with resume=True, finished
segments are skipped and work continues from the first incomplete one.
``_finalize`` concatenates the segments into the final output (an OpenCV
re-encode: no ffmpeg for a lossless stream concat). Manifests, segment paths
and calibration sidecars are the JAX package's, so either package reads the
other's job state.

Layout next to ``out.mp4``:
    out.mp4.manifest.json      job state
    out.mp4.seg0000.mp4 ...    completed/in-progress segments
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from rrin_tpu_torch._device import DeviceLike
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.pipeline import interpolate_video


def _manifest_path(output_path: str) -> str:
    return output_path + ".manifest.json"


def _segment_path(output_path: str, idx: int) -> str:
    root, ext = os.path.splitext(output_path)
    return f"{output_path}.seg{idx:04d}{ext or '.mp4'}"


def _atomic_write(path: str, obj: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def interpolate_video_resumable(
    input_path: str,
    output_path: str,
    params: Dict[str, Any],
    cfg: ModelConfig = ModelConfig(),
    exp: int = 1,
    mode: str = "direct",
    batch_size: int = 1,
    compute_dtype: str = "bfloat16",
    use_pallas: bool = True,
    fps_out: Optional[float] = None,
    fourcc: str = "mp4v",
    segment_pairs: int = 200,
    resume: bool = True,
    keep_segments: bool = False,
    progress: bool = False,
    data_parallel: int = 1,
    spatial: int = 1,
    int8: bool = False,
    int8_margin: float = 1.2,
    int8_percentile: Optional[float] = None,
    quant_stats: Optional[Dict[str, Any]] = None,
    save_calib: Optional[str] = None,
    retime_fps: Optional[float] = None,
    slowmo: Optional[float] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Run (or resume) a segmented interpolation job on ``device`` (default:
    the card; raises without one); returns the manifest.

    ``retime_fps`` retimes instead of 2^exp-upsampling
    (``pipeline.retime_plan``): the per-pair schedule depends only on the
    absolute pair index, so every segment reproduces the same timeline and
    the concatenation is identical to a single-pass retime run."""
    from rrin_tpu_torch.io.video import probe_video

    meta = probe_video(input_path)
    n_frames = meta.frame_count
    if n_frames < 2:
        raise ValueError(f"need >= 2 frames, got {n_frames} in {input_path}")
    n_pairs = n_frames - 1
    n_segments = -(-n_pairs // segment_pairs)
    out_fps = (
        retime_fps if retime_fps is not None
        else fps_out if fps_out is not None
        else meta.fps if slowmo is not None
        else meta.fps * (1 << exp)
    )

    mpath = _manifest_path(output_path)
    # exp/mode are ignored under retiming: normalise them in the signature
    # so a resume with a different (unused) --exp matches.
    if retime_fps is not None or slowmo is not None:
        exp, mode = 1, "times"
    job_sig = {
        "input": os.path.abspath(input_path),
        "output": os.path.abspath(output_path),
        "exp": exp,
        "mode": mode,
        "segment_pairs": segment_pairs,
        "n_frames": n_frames,
        "n_segments": n_segments,
        "fps_out": out_fps,
        "fourcc": fourcc,
        "retime_fps": retime_fps,
        "slowmo": slowmo,
        # The quantisation config is part of the job identity: a resume
        # under another int8 grid would silently mix quantisations across
        # segments (the sidecar below assumes ONE config).
        "compute_dtype": str(compute_dtype),
        "int8": int8,
        "int8_margin": int8_margin,
        "int8_percentile": int8_percentile,
    }
    manifest: Dict[str, Any]
    fresh_job = not (resume and os.path.exists(mpath))
    if not fresh_job:
        with open(mpath) as f:
            manifest = json.load(f)
        if {k: manifest.get(k) for k in job_sig} != job_sig:
            raise ValueError(
                f"manifest {mpath} belongs to a different job config; "
                "delete it (or pass resume=False) to start over"
            )
    else:
        manifest = dict(job_sig)
        manifest["segments"] = [
            {"idx": i, "done": False, "frames": 0} for i in range(n_segments)
        ]
        manifest["finished"] = False
        _atomic_write(mpath, manifest)

    # int8 calibration consistency across segments AND resumes: without a
    # preset, the FIRST computed segment calibrates and persists its ranges
    # to a job-local sidecar; every later segment (and any resumed process)
    # loads them back, so the whole job quantises under ONE int8 grid, as a
    # single-pass run (which calibrates once on its first batch) does.
    calib_sidecar: Optional[str] = None
    seg_stats = quant_stats
    if int8 and quant_stats is None:
        calib_sidecar = output_path + ".calib.npz"
        if fresh_job and os.path.exists(calib_sidecar):
            # A sidecar from a previous job at this output path would
            # silently impose a stale int8 grid on the new one.
            os.remove(calib_sidecar)
        elif resume and os.path.exists(calib_sidecar):
            from rrin_tpu_torch.params import load_calibration

            seg_stats = load_calibration(calib_sidecar, device=device)

    if not manifest.get("finished"):
        for seg in manifest["segments"]:
            if seg["done"]:
                continue
            i = seg["idx"]
            first_pair = i * segment_pairs
            pairs = min(segment_pairs, n_pairs - first_pair)
            last = i == n_segments - 1
            report = interpolate_video(
                input_path,
                _segment_path(output_path, i),
                params,
                cfg=cfg,
                exp=exp,
                mode=mode,
                batch_size=batch_size,
                compute_dtype=compute_dtype,
                use_pallas=use_pallas,
                fps_out=out_fps,
                fourcc=fourcc,
                progress=progress,
                start_frame=first_pair,
                max_pairs=pairs,
                write_trailing_frame=last,
                data_parallel=data_parallel,
                spatial=spatial,
                int8=int8,
                int8_margin=int8_margin,
                # Only the calibrating (first) segment needs the percentile;
                # later segments serve the sidecar grid.
                int8_percentile=(
                    int8_percentile if seg_stats is None else None
                ),
                quant_stats=seg_stats,
                retime_fps=retime_fps,
                slowmo=slowmo,
                save_calib=(
                    calib_sidecar
                    if calib_sidecar and seg_stats is None
                    else None
                ),
                device=device,
            )
            if (calib_sidecar and seg_stats is None
                    and os.path.exists(calib_sidecar)):
                # A segment that dispatched no device work (e.g. a pure-copy
                # retime slice) never calibrates and writes no sidecar:
                # leave seg_stats unset so the first segment that does
                # compute calibrates the job grid.
                from rrin_tpu_torch.params import load_calibration

                seg_stats = load_calibration(calib_sidecar, device=device)
            seg["done"] = True
            seg["frames"] = report.frames_out
            seg["interp_fps"] = report.interp_fps
            seg["completed_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
            _atomic_write(mpath, manifest)

        if save_calib and int8 and seg_stats is not None:
            # The user-facing calib file holds the job's single grid
            # (save_calibration copies it to host numpy, once, here at the
            # end of the job).
            from rrin_tpu_torch.params import save_calibration

            save_calibration(save_calib, seg_stats)
        _finalize(output_path, manifest, keep_segments=keep_segments)
        if calib_sidecar and not keep_segments:
            try:
                os.remove(calib_sidecar)
            except OSError:
                pass
        manifest["finished"] = True
        _atomic_write(mpath, manifest)
    return manifest


def _finalize(output_path: str, manifest: Dict[str, Any], keep_segments: bool) -> None:
    """Concatenate segment files into the final output (re-encode).

    Zero-frame segments are skipped by the manifest's recorded frame count:
    a retime segment can legitimately emit nothing (extreme downsampling: no
    output timestamp in its pair range), and OpenCV cannot even reopen the
    header-only file such a segment leaves."""
    from rrin_tpu_torch.io.video import VideoReader, VideoWriter, probe_video

    seg_paths = [
        _segment_path(output_path, s["idx"])
        for s in manifest["segments"]
        if s.get("frames", 0) > 0
    ]
    all_paths = [
        _segment_path(output_path, s["idx"]) for s in manifest["segments"]
    ]
    if not seg_paths:
        raise ValueError(
            f"job produced no output frames at all ({output_path})"
        )
    first = probe_video(seg_paths[0])
    writer = VideoWriter(
        output_path,
        manifest["fps_out"],
        (first.height, first.width),
        fourcc=manifest["fourcc"],
    )
    try:
        for sp in seg_paths:
            reader = VideoReader(sp)
            try:
                for frame in reader:
                    writer.write(frame)
            finally:
                reader.close()
    finally:
        writer.close()
    if not keep_segments:
        for sp in all_paths:
            try:
                os.remove(sp)
            except OSError:
                pass


def job_status(output_path: str) -> Optional[Dict[str, Any]]:
    """Manifest summary for a job, or None if no manifest exists."""
    mpath = _manifest_path(output_path)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    done = sum(1 for s in manifest["segments"] if s["done"])
    return {
        "finished": manifest.get("finished", False),
        "segments_done": done,
        "segments_total": manifest["n_segments"],
        "manifest": mpath,
    }
