"""Image-pair tool of the port: interpolate the middle frame between two
still images (Vimeo-90K triplet style) and write it out.

    python -m rrin_tpu_torch.interp_image --im1 a.png --im3 b.png -o mid.png \
        [--t 0.5] [--ckpt w.npz] [--gt im2.png] [--device cpu]

With --gt, prints PSNR/SSIM of the prediction against the ground-truth
middle frame.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def interpolate_pair(params, im1, im3, t=0.5, cfg=None, compute_dtype="float32",
                     use_pallas: bool = False, int8: bool = False,
                     int8_margin: float = 1.2, device="cuda"):
    """im1/im3: HWC uint8 RGB -> HWC uint8 RGB interpolated frame, computed on
    ``device`` (default: the card; raises without one).

    ``int8`` calibrates activation ranges on this pair and runs the
    carried-int8 packed path (requires a packed-supported shape)."""
    import torch

    from rrin_tpu_torch._device import resolve_device
    from rrin_tpu_torch.config import ModelConfig
    from rrin_tpu_torch.models.rrin import forward, forward_calibrate, scale_quant_stats
    from rrin_tpu_torch.ops.pad import pad_to_multiple, unpad

    dev = resolve_device(device)
    cfg = cfg or ModelConfig()
    cd = {"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype]
    i0 = torch.from_numpy(im1.astype("float32") / 255.0)[None].to(dev)
    i1 = torch.from_numpy(im3.astype("float32") / 255.0)[None].to(dev)
    i0p, hw = pad_to_multiple(i0, cfg.pad_multiple)
    i1p, _ = pad_to_multiple(i1, cfg.pad_multiple)
    quant_stats = None
    if int8:
        from rrin_tpu_torch.models.unet import packed_supported

        if not packed_supported(i0p.shape[1], i0p.shape[2], cfg):
            raise ValueError(
                "int8 needs the packed fast path, which does not support "
                f"{i0p.shape[1]}x{i0p.shape[2]}"
            )
        _, st = forward_calibrate(params, i0p, i1p, t, cfg=cfg,
                                  compute_dtype=cd, use_pallas=use_pallas, device=dev)
        quant_stats = scale_quant_stats(st, int8_margin)
    with torch.no_grad():
        pred = forward(params, i0p, i1p, t, cfg=cfg, compute_dtype=cd,
                       use_pallas=use_pallas, packed=use_pallas or int8,
                       quant_stats=quant_stats, device=dev)
    pred = unpad(pred, hw)[0]
    # torch.round rounds half to even, as jnp.round does.
    return torch.round(pred.clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="rrin-tpu-torch-image")
    p.add_argument("--im1", required=True, help="first frame image")
    p.add_argument("--im3", required=True, help="third frame image")
    p.add_argument("--output", "-o", required=True, help="predicted middle frame")
    p.add_argument("--t", type=float, default=0.5)
    p.add_argument("--ckpt", default=None, help=".npz or .pth weights")
    p.add_argument("--gt", default=None, help="ground-truth middle frame (prints PSNR/SSIM)")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--no-pallas", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="calibrated int8 packed path (see cli.py --int8)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                   "runs the kernels' plain versions)")
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    im1 = cv2.imread(args.im1, cv2.IMREAD_COLOR)
    im3 = cv2.imread(args.im3, cv2.IMREAD_COLOR)
    if im1 is None or im3 is None:
        print("error: cannot read input images", file=sys.stderr)
        return 2
    if im1.shape != im3.shape:
        print(f"error: shape mismatch {im1.shape} vs {im3.shape}", file=sys.stderr)
        return 2

    import torch

    from rrin_tpu_torch.models.rrin import init_params
    from rrin_tpu_torch.params import load_params, load_torch_checkpoint

    if args.ckpt is None:
        print("[rrin-tpu-torch-image] WARNING: random weights (smoke test only)",
              file=sys.stderr)
        params = init_params(torch.Generator().manual_seed(0), device=args.device)
    elif args.ckpt.endswith((".pth", ".tar", ".pt")):
        params = load_torch_checkpoint(args.ckpt, device=args.device)
    else:
        params = load_params(args.ckpt, device=args.device)

    pred = interpolate_pair(
        params, im1[:, :, ::-1], im3[:, :, ::-1], t=args.t,
        compute_dtype="float32" if args.fp32 else "bfloat16",
        use_pallas=not args.no_pallas,
        int8=args.int8,
        device=args.device,
    )
    cv2.imwrite(args.output, pred[:, :, ::-1])

    if args.gt:
        from rrin_tpu_torch.metrics import psnr, ssim

        gt = cv2.imread(args.gt, cv2.IMREAD_COLOR)
        if gt is None:
            print("error: cannot read --gt image", file=sys.stderr)
            return 2
        a = torch.from_numpy(pred.astype(np.float32) / 255.0)[None].to(args.device)
        b = torch.from_numpy(
            np.ascontiguousarray(gt[:, :, ::-1]).astype(np.float32) / 255.0)[None].to(args.device)
        print(json.dumps({
            "psnr": round(float(psnr(a, b)[0]), 4),
            "ssim": round(float(ssim(a, b)[0]), 5),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
