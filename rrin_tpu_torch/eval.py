"""Vimeo-90K-style triplet evaluation harness of the port.

A triplet directory holds im1/im2/im3 images (Vimeo-90K layout); the model
predicts im2 from (im1, im3) at t=0.5 and is scored with PSNR/SSIM. Where no
dataset can be downloaded, ``synthesize_triplets`` generates deterministic
moving-texture triplets (the same PNGs as the JAX package's for the same
seed), so the harness runs anywhere.

CLI:
    python -m rrin_tpu_torch.eval --data triplets_root --ckpt w.npz [--batch 8]
    python -m rrin_tpu_torch.eval --synthesize 20 --data /tmp/trips   # make data
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    from rrin_tpu_torch._device import DeviceLike

FRAME_NAMES = ("im1.png", "im2.png", "im3.png")


def find_triplets(root: str) -> List[str]:
    """All directories under root (or root itself) holding im1/im2/im3."""
    out = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        if all(n in filenames for n in FRAME_NAMES):
            out.append(dirpath)
    return out


def image_hw(path: str) -> Tuple[int, int]:
    """(height, width) of an image, reading only the PNG header when
    possible (no full decode); falls back to cv2 for other formats."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
        w = int.from_bytes(head[16:20], "big")
        h = int.from_bytes(head[20:24], "big")
        return h, w
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img.shape[:2]


def load_triplet(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    import cv2

    frames = []
    for name in FRAME_NAMES:
        img = cv2.imread(os.path.join(path, name), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(os.path.join(path, name))
        frames.append(np.ascontiguousarray(img[:, :, ::-1]))
    return tuple(frames)  # type: ignore[return-value]


def synthesize_triplets(
    root: str, count: int = 8, hw: Tuple[int, int] = (256, 448),
    seed: int = 0, motion: float = 6.0,
) -> List[str]:
    """Deterministic synthetic triplets: smooth random textures translated by
    a random subpixel motion (im2 exactly midway), so a good interpolator
    scores high; for harness tests and regression tracking without the real
    dataset.

    ``motion`` bounds the per-step shift |dx|,|dy| in pixels (im1->im3
    endpoint motion is twice that); the training feed uses 6.0
    (``data.synthetic`` max_shift)."""
    import cv2

    h, w = hw
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(count):
        base = rng.random((h // 8, w // 8, 3)).astype(np.float32)
        tex = cv2.resize(base, (2 * w, 2 * h), interpolation=cv2.INTER_CUBIC)
        dx, dy = rng.uniform(-motion, motion, size=2)
        d = os.path.join(root, f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        mat0 = np.float32([[1, 0, w // 2], [0, 1, h // 2]])
        for j, name in enumerate(FRAME_NAMES):
            mat = mat0.copy()
            mat[0, 2] += dx * j
            mat[1, 2] += dy * j
            img = cv2.warpAffine(
                tex, mat[:2], (w, h), flags=cv2.INTER_LINEAR + cv2.WARP_INVERSE_MAP
            )
            cv2.imwrite(
                os.path.join(d, name),
                np.clip(img[:, :, ::-1] * 255.0, 0, 255).astype(np.uint8),
            )
        paths.append(d)
    return paths


def evaluate(
    params: Dict[str, Any],
    triplet_dirs: List[str],
    batch_size: int = 4,
    compute_dtype: str = "float32",
    use_pallas: bool = False,
    cfg=None,
    int8: bool = False,
    int8_margin: float = 1.2,
    int8_percentile: Optional[float] = None,
    quant_stats: Optional[Dict[str, Any]] = None,
    device: "DeviceLike" = "cuda",
) -> Dict[str, Any]:
    """PSNR/SSIM of predicted middle frames over a triplet set, on ``device``
    (default: the card; raises without one).

    Batches same-resolution triplets onto the device. ``int8`` calibrates
    activation ranges on the first batch OF EACH RESOLUTION GROUP
    (mixed-resolution sets never reuse ranges calibrated at a different
    shape) and scores the carried-int8 packed path, the eval-side quality
    gate for the ``--int8`` inference mode. ``int8_percentile`` calibrates at
    the P-th |x| percentile instead of the max. ``quant_stats`` (persisted
    calibration, ``params.load_calibration``) skips the calibration passes.
    Returns a structured report dict.
    """
    import torch

    from rrin_tpu_torch._device import resolve_device
    from rrin_tpu_torch.config import ModelConfig
    from rrin_tpu_torch.metrics import psnr, ssim
    from rrin_tpu_torch.models.rrin import (
        forward,
        forward_calibrate,
        scale_quant_stats,
    )
    from rrin_tpu_torch.ops.pad import pad_to_multiple, unpad

    dev = resolve_device(device)
    cfg = cfg or ModelConfig()
    cd = {"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype]
    if int8_percentile is not None and not 50.0 < int8_percentile <= 100.0:
        # The bound the pipeline enforces; a unit mistake (0.999 for 99.9 %)
        # would otherwise calibrate near the |x| MINIMUM and score a silently
        # meaningless int8 quality number.
        raise ValueError(
            "int8_percentile must be in (50, 100] (percent of "
            f"|activation| mass to keep), got {int8_percentile}"
        )
    preset_stats = quant_stats  # resolution-independent persisted ranges

    psnrs: List[float] = []
    ssims: List[float] = []
    per_triplet: List[Dict[str, Any]] = []
    t_start = time.perf_counter()
    n_frames = 0

    def on_device(frames: List[np.ndarray]) -> "torch.Tensor":
        return torch.from_numpy(np.stack(frames).astype(np.float32) / 255.0).to(dev)

    # Group by resolution (PNG-header read only; full triplets are loaded
    # lazily per batch below).
    by_res: Dict[Tuple[int, int], List[str]] = {}
    for d in triplet_dirs:
        hw = image_hw(os.path.join(d, FRAME_NAMES[0]))
        by_res.setdefault(hw, []).append(d)

    for res, dirs in by_res.items():
        # Per group: recalibrated each group. Calibration stats only apply
        # to the int8 path; a preset given without int8 must not silently
        # switch the scored path.
        quant_stats = preset_stats if int8 else None
        for i in range(0, len(dirs), batch_size):
            chunk = dirs[i: i + batch_size]
            trips = [load_triplet(d) for d in chunk]
            i0 = on_device([t[0] for t in trips])
            gt = on_device([t[1] for t in trips])
            i1 = on_device([t[2] for t in trips])
            i0p, hw = pad_to_multiple(i0, cfg.pad_multiple)
            i1p, _ = pad_to_multiple(i1, cfg.pad_multiple)
            if int8:
                from rrin_tpu_torch.models.unet import packed_supported

                if not packed_supported(i0p.shape[1], i0p.shape[2], cfg):
                    raise ValueError(
                        "int8 eval needs the packed fast path, which does "
                        f"not support {i0p.shape[1]}x{i0p.shape[2]} "
                        f"(resolution group {res})"
                    )
                if quant_stats is None:
                    _, st = forward_calibrate(
                        params, i0p, i1p, 0.5, cfg=cfg, compute_dtype=cd,
                        use_pallas=use_pallas,
                        quantile=(
                            None if int8_percentile is None
                            else int8_percentile / 100.0
                        ),
                        device=dev,
                    )
                    quant_stats = scale_quant_stats(st, int8_margin)
            with torch.no_grad():
                pred = forward(
                    params, i0p, i1p, 0.5, cfg=cfg, compute_dtype=cd,
                    use_pallas=use_pallas, packed=use_pallas or int8,
                    quant_stats=quant_stats, device=dev,
                )
            pred = unpad(pred, hw)
            p = psnr(pred, gt).cpu().tolist()
            s = ssim(pred, gt).cpu().tolist()
            psnrs.extend(p)
            ssims.extend(s)
            n_frames += len(chunk)
            for d, pv, sv in zip(chunk, p, s):
                per_triplet.append({"dir": d, "psnr": round(pv, 4), "ssim": round(sv, 5)})

    wall = time.perf_counter() - t_start
    return {
        "count": len(psnrs),
        "psnr_mean": round(float(np.mean(psnrs)), 4) if psnrs else None,
        "ssim_mean": round(float(np.mean(ssims)), 5) if ssims else None,
        # WALL rate of the quality harness: includes the kernels' first
        # build and load, so the first configuration evaluated in a process
        # absorbs costs later ones reuse. This field only sanity-checks the
        # harness; it is not a device throughput.
        "frames_per_sec_wall": round(n_frames / wall, 2) if wall > 0 else None,
        "wall_seconds": round(wall, 3),
        "per_triplet": per_triplet,
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="rrin-tpu-torch-eval")
    p.add_argument("--data", required=True, help="triplet root directory")
    p.add_argument("--ckpt", default=None, help=".npz or .pth weights")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--no-pallas", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="score the calibrated int8 packed path (the "
                   "quality gate for the pipeline's --int8 mode)")
    p.add_argument("--calib", default=None, metavar="NPZ",
                   help="with --int8: persisted calibration ranges "
                   "(params.save_calibration) instead of per-group "
                   "calibration")
    p.add_argument("--int8-percentile", type=float, default=None,
                   metavar="P",
                   help="with --int8: percentile-clipped calibration "
                   "(pipeline --int8-percentile): score its quality "
                   "impact before adopting it in production")
    p.add_argument("--synthesize", type=int, default=0, metavar="N",
                   help="generate N synthetic triplets into --data and exit")
    p.add_argument("--report", default=None, help="write JSON report here")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                   "runs the kernels' plain versions)")
    args = p.parse_args(argv)

    if args.synthesize:
        paths = synthesize_triplets(args.data, args.synthesize)
        print(f"[rrin-tpu-torch-eval] wrote {len(paths)} synthetic triplets to {args.data}")
        return 0

    import torch

    from rrin_tpu_torch.models.rrin import init_params
    from rrin_tpu_torch.params import load_params, load_torch_checkpoint

    if args.ckpt is None:
        print("[rrin-tpu-torch-eval] WARNING: random weights (smoke test only)",
              file=sys.stderr)
        params = init_params(torch.Generator().manual_seed(0), device=args.device)
    elif args.ckpt.endswith((".pth", ".tar", ".pt")):
        params = load_torch_checkpoint(args.ckpt, device=args.device)
    else:
        params = load_params(args.ckpt, device=args.device)

    dirs = find_triplets(args.data)
    if not dirs:
        print(f"error: no im1/im2/im3 triplets under {args.data}", file=sys.stderr)
        return 2
    preset = None
    if args.calib:
        from rrin_tpu_torch.params import load_calibration

        preset = load_calibration(args.calib, device=args.device)
    report = evaluate(
        params, dirs, batch_size=args.batch,
        compute_dtype="float32" if args.fp32 else "bfloat16",
        use_pallas=not args.no_pallas,
        int8=args.int8,
        int8_percentile=args.int8_percentile,
        quant_stats=preset,
        device=args.device,
    )
    summary = {k: v for k, v in report.items() if k != "per_triplet"}
    print(json.dumps(summary, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
