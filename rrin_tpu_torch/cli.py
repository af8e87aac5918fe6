"""CLI of the port: 2^k-upsample a video's frame rate on one GPU.

The JAX package's tool with the same flags, plus ``--device`` (default: the
card; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m rrin_tpu_torch.cli -i in.mp4 -o out.mp4 --exp 1 --ckpt weights.npz
    python -m rrin_tpu_torch.cli -i in.mp4 -o out.mp4 --sf 4 --ckpt weights.pth
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Iterator, List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rrin-tpu-torch",
        description="RRIN video frame-rate 2^k upsampler (PyTorch + hand-written "
        "CUDA kernels for one H100)",
    )
    p.add_argument("--input", "-i", required=True, help="input video path")
    p.add_argument("--output", "-o", required=True, help="output video path")
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "--exp", "-e", type=int, default=1,
        help="frame-rate upsampling exponent k (output fps = input fps * 2^k)",
    )
    g.add_argument(
        "--sf", type=int, default=None,
        help="scale factor (power of two; reference-style alias for --exp)",
    )
    p.add_argument(
        "--ckpt", "-c", default=None,
        help=".npz (native) or .pth/.pth.tar (reference torch) weights; "
        "random init if omitted (for smoke tests)",
    )
    p.add_argument("--batch-size", "-b", type=int, default=1,
                   help="frame pairs per device step")
    p.add_argument("--data-parallel", "-d", type=int, default=1,
                   help="shard frame-pair batches over N devices (0 = all; "
                   "with --device cpu the CPU is listed N times); the batch "
                   "size rounds up to a multiple of N")
    p.add_argument("--spatial", type=int, default=1,
                   help="additionally shard frame HEIGHT over N devices for "
                   "very large frames (the plain path; excludes --int8)")
    p.add_argument(
        "--mode", choices=("direct", "cascade"), default="direct",
        help="direct: each intermediate at its own t in one pass; "
        "cascade: reference-style recursive midpoints (device-resident)",
    )
    p.add_argument("--fp32", action="store_true",
                   help="full float32 compute (default bfloat16)")
    p.add_argument("--int8", action="store_true",
                   help="int8 U-Net convs: calibrates activation ranges on "
                   "the first batch; >35 dB vs the fp32 output (excluded by "
                   "--spatial sharding)")
    p.add_argument("--int8-margin", type=float, default=1.2,
                   help="safety factor on the calibrated int8 activation "
                   "ranges (guards later frames exceeding the first "
                   "batch's ranges)")
    p.add_argument("--int8-percentile", type=float, default=None,
                   metavar="P",
                   help="with --int8: calibrate each activation range at "
                   "the P-th |x| percentile instead of the max (e.g. 99.9), "
                   "percentile clipping for trained weights with outlier "
                   "activations; pair with --int8-saturation to see the "
                   "resulting clip rates")
    p.add_argument("--int8-saturation", action="store_true",
                   help="with --int8: add per-site clip-rate telemetry "
                   "(fraction of |activation| above the serving ranges, "
                   "measured on the first batch) to the JSON report")
    p.add_argument("--calib", default=None, metavar="NPZ",
                   help="with --int8: load persisted calibration ranges "
                   "(from --save-calib) instead of calibrating on the "
                   "first batch, which skips the calibration pass")
    p.add_argument("--save-calib", default=None, metavar="NPZ",
                   help="with --int8: persist the calibrated (margin-"
                   "scaled) activation ranges for later --calib runs")
    p.add_argument("--no-pallas", action="store_true",
                   help="use the plain PyTorch warp and U-Nets instead of "
                   "the hand-written kernels")
    p.add_argument("--fps", type=float, default=None,
                   help="override output fps metadata")
    p.add_argument("--retime", type=float, default=None, metavar="FPS",
                   help="retime to an arbitrary output frame rate (e.g. "
                   "24->60, 30->24, NTSC rates): each output frame is "
                   "interpolated at its exact source time "
                   "(ignores --exp/--sf/--mode)")
    p.add_argument("--slowmo", type=float, default=None, metavar="X",
                   help="arbitrary-ratio slow motion (e.g. 2.5): "
                   "interpolate X times the frames and keep the playback "
                   "clock at the input rate (--fps overrides it); "
                   "ignores --exp/--sf/--mode")
    p.add_argument("--fourcc", default="mp4v", help="output codec fourcc")
    p.add_argument("--align-corners", action="store_true",
                   help="use align_corners=True grid_sample semantics")
    p.add_argument("--report", default=None,
                   help="write the JSON pipeline report to this path")
    p.add_argument("--segment-pairs", type=int, default=0, metavar="N",
                   help="run as a resumable segmented job of N source pairs "
                   "per segment (0 = single pass, no manifest)")
    p.add_argument("--no-resume", action="store_true",
                   help="with --segment-pairs: restart instead of resuming")
    p.add_argument("--keep-segments", action="store_true",
                   help="with --segment-pairs: keep segment files after concat")
    p.add_argument("--status", action="store_true",
                   help="print the resumable-job status for --output and exit")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                   "into DIR")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                   "runs the kernels' plain versions)")
    return p


def _load_params(ckpt: Optional[str], quiet: bool, device: str = "cuda"):
    import torch

    from rrin_tpu_torch.models.rrin import init_params
    from rrin_tpu_torch.params import load_params, load_torch_checkpoint

    if ckpt is None:
        if not quiet:
            print(
                "[rrin-tpu-torch] WARNING: no --ckpt given; using random weights "
                "(output will be a blurry blend — smoke-test only)",
                file=sys.stderr,
            )
        return init_params(torch.Generator().manual_seed(0), device=device)
    if ckpt.endswith((".pth", ".tar", ".pt")):
        return load_torch_checkpoint(ckpt, device=device)
    return load_params(ckpt, device=device)


@contextlib.contextmanager
def _profiled(trace_dir: str, device: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (host, and the card's kernels
    when it runs there), written to ``trace_dir/trace.json``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    exp = args.exp
    if args.sf is not None:
        if args.sf < 2 or args.sf & (args.sf - 1):
            print(f"error: --sf must be a power of two >= 2, got {args.sf}",
                  file=sys.stderr)
            return 2
        exp = args.sf.bit_length() - 1

    if args.retime is not None and args.fps is not None:
        print("error: --retime sets the output fps; drop --fps",
              file=sys.stderr)
        return 2
    if args.retime is not None and args.slowmo is not None:
        print("error: --retime and --slowmo are mutually exclusive",
              file=sys.stderr)
        return 2
    if (args.calib or args.save_calib) and not args.int8:
        # Fail before the checkpoint load: usage errors must be instant.
        print("error: --calib/--save-calib only apply to --int8 runs",
              file=sys.stderr)
        return 2
    if (args.int8_percentile is not None
            or args.int8_saturation) and not args.int8:
        print("error: --int8-percentile/--int8-saturation only apply to "
              "--int8 runs", file=sys.stderr)
        return 2
    if args.int8_percentile is not None and args.calib:
        print("error: --int8-percentile shapes calibration; it cannot "
              "apply to preset --calib ranges", file=sys.stderr)
        return 2
    if args.int8_saturation and args.segment_pairs > 0:
        print("error: --int8-saturation reports through the single-pass "
              "JSON report; drop --segment-pairs", file=sys.stderr)
        return 2

    if args.status:
        import json

        from rrin_tpu_torch.resumable import job_status

        status = job_status(args.output)
        print(json.dumps(status if status else {"error": "no manifest"}, indent=2))
        return 0 if status else 1

    from rrin_tpu_torch.config import ModelConfig
    from rrin_tpu_torch.pipeline import interpolate_video

    params = _load_params(args.ckpt, args.quiet, args.device)
    cfg = ModelConfig(align_corners=args.align_corners)

    profile_cm = contextlib.nullcontext()
    if args.profile:
        profile_cm = _profiled(args.profile, args.device)

    common = dict(
        cfg=cfg,
        exp=exp,
        mode=args.mode,
        batch_size=args.batch_size,
        compute_dtype="float32" if args.fp32 else "bfloat16",
        use_pallas=not args.no_pallas,
        fps_out=args.fps,
        fourcc=args.fourcc,
        progress=not args.quiet,
        data_parallel=args.data_parallel,
        spatial=args.spatial,
        int8=args.int8,
        int8_margin=args.int8_margin,
        int8_percentile=args.int8_percentile,
        retime_fps=args.retime,
        slowmo=args.slowmo,
        device=args.device,
    )
    if args.calib:
        from rrin_tpu_torch.params import load_calibration

        common["quant_stats"] = load_calibration(args.calib, device=args.device)
    if args.save_calib:
        common["save_calib"] = args.save_calib
    with profile_cm:
        if args.segment_pairs > 0:
            import json

            from rrin_tpu_torch.resumable import interpolate_video_resumable

            manifest = interpolate_video_resumable(
                args.input, args.output, params,
                segment_pairs=args.segment_pairs,
                resume=not args.no_resume,
                keep_segments=args.keep_segments,
                **common,
            )
            out_json = json.dumps(manifest, indent=2)
        else:
            report = interpolate_video(
                args.input, args.output, params,
                int8_saturation=args.int8_saturation, **common,
            )
            out_json = report.to_json()
    if args.report:
        with open(args.report, "w") as f:
            f.write(out_json)
    if not args.quiet:
        print(out_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
