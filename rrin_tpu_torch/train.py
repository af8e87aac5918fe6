"""Training of the port: losses, the train step, the Trainer and its CLI.

The JAX package's ``train.py`` on one card:

  * Charbonnier (smooth-L1), L1 and Laplacian-pyramid reconstruction
    losses, the same formulas.
  * ``train_step``: one update of the params in place. The cascade's forward
    runs the hand-written kernels (K1 at the bfloat16 conv sites; the warp
    pair with ``use_pallas``); the backward is the reference's VJP
    formulation run by autograd (cuDNN's dgrad and wgrad, the warp's gather
    and scatter-add), since the reference has no backward kernel. Nothing in
    a step copies from or to the host: the loss stays on the device.
  * Adamax (the paper's optimizer family) or Adam from ``torch.optim`` with
    optax's defaults, which they compute up to float32 rounding.

Over a mesh (``Trainer.create(mesh=)``, ``--data-parallel``): each data
shard of the batch runs the forward and the loss on its device, from copies
of the master params made in the autograd graph, so one backward sums every
shard's gradient into the master params; the mean of the equal shards' mean
losses is the full batch's. With a process group of more than one rank
(``parallel.distributed.initialize``) every step, over a mesh or on one
device, then averages the gradients over it; ``main`` gives each process
its rows of the group's batch. ``Trainer(spatial_dim=1)`` also cuts each
frame's rows over the mesh's spatial axis (``parallel.spatial``) and
gathers the prediction on the row's first device for the loss. The master
params and the optimizer stay on the mesh's first device.
"""

from __future__ import annotations

import functools
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from rrin_tpu_torch._device import DeviceLike, resolve_device
from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.models.rrin import TimeLike, forward, init_params
from rrin_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    Mesh,
    batch_sharding,
    replicate_params,
    shard,
)

Params = Dict[str, Any]
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain L1, one of the paper's training losses."""
    return torch.mean(torch.abs(pred - target))


def laplacian(pred: torch.Tensor, target: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Laplacian-pyramid L1 (the paper's perceptually weighted loss): L1
    between band-pass residuals at each pyramid level, weighted 2^level
    (coarse bands weigh more), plus the low-pass top at the next weight. The
    pyramid uses the model's own 2x average pool and bilinear upsample; a
    crop that is odd or small at a level stops the pyramid there."""
    from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear

    total = pred.new_zeros((), dtype=torch.float32)
    p, t = pred, target
    built = 0
    for _ in range(levels):
        if p.shape[1] % 2 or p.shape[2] % 2 or min(p.shape[1:3]) <= 2:
            break
        pd, td = avg_pool_2x(p), avg_pool_2x(t)
        lap_p = p - upsample_2x_bilinear(pd)
        lap_t = t - upsample_2x_bilinear(td)
        total = total + (2.0 ** built) * torch.mean(torch.abs(lap_p - lap_t))
        p, t = pd, td
        built += 1
    return total + (2.0 ** built) * torch.mean(torch.abs(p - t))


LOSSES = {"charbonnier": charbonnier, "l1": l1, "laplacian": laplacian}


def make_optimizer(learning_rate: float = 1e-4, kind: str = "adamax") -> OptimizerFactory:
    """A factory ``params -> torch.optim.Optimizer`` over the params'
    leaves: Adamax or Adam with optax's defaults (b1 0.9, b2 0.999, eps
    1e-8), the update rules of ``optax.adamax`` and ``optax.adam``."""
    opts = {"adamax": torch.optim.Adamax, "adam": torch.optim.Adam}
    if kind not in opts:
        raise ValueError(f"unknown optimizer: {kind}")
    return functools.partial(opts[kind], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The params' tensors in a fixed order (the nesting's key order)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


def loss_fn(
    params: Params,
    i0: torch.Tensor,
    gt: torch.Tensor,
    i1: torch.Tensor,
    t: TimeLike = 0.5,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    remat: bool = False,
    loss: str = "charbonnier",
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """The reconstruction loss of the cascade's prediction (a 0-d float32
    tensor on ``device``), differentiable in the params."""
    pred = forward(
        params, i0, i1, t, cfg=cfg, compute_dtype=compute_dtype,
        use_pallas=use_pallas, remat=remat, device=device,
    )
    return LOSSES[loss](pred, torch.as_tensor(gt).to(device=pred.device, dtype=torch.float32))


def train_step(
    params: Params,
    optimizer: torch.optim.Optimizer,
    i0: torch.Tensor,
    gt: torch.Tensor,
    i1: torch.Tensor,
    t: TimeLike = 0.5,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    remat: bool = False,
    loss: str = "charbonnier",
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """One update. ``optimizer`` was built over ``param_leaves(params)``
    (leaves that require grad) and holds its own state, so it takes the
    places of both the reference's ``opt_state`` and ``optimizer``. Updates
    the params in place and returns the loss as a 0-d tensor on the device
    (no host sync inside the step). With a process group of more than one
    rank, the gradients and the loss are averaged over it first."""
    optimizer.zero_grad(set_to_none=True)
    loss_v = loss_fn(
        params, i0, gt, i1, t, cfg=cfg, compute_dtype=compute_dtype,
        use_pallas=use_pallas, remat=remat, loss=loss, device=device,
    )
    loss_v.backward()
    loss_v = _average_over_processes(params, loss_v.detach())
    optimizer.step()
    return loss_v


def _average_over_processes(params: Params, loss_v: torch.Tensor) -> torch.Tensor:
    """With a process group of more than one rank, average the params'
    gradients (in place) and the loss over it: every rank then takes the
    same update. Returns the loss (as it was on one process)."""
    import torch.distributed as dist

    from rrin_tpu_torch.parallel.distributed import world_size

    n = world_size()
    if n == 1:
        return loss_v
    for leaf in param_leaves(params):
        if leaf.grad is not None:
            dist.all_reduce(leaf.grad)
            leaf.grad.div_(n)
    loss_v = loss_v.clone()
    dist.all_reduce(loss_v)
    return loss_v.div_(n)


def _shard_t(t: TimeLike, mesh: Mesh) -> List[TimeLike]:
    """``t`` per data shard: a scalar as it is, per-example times cut with
    the batch."""
    if isinstance(t, (int, float)) or torch.as_tensor(t).ndim == 0:
        return [t] * mesh.shape[DATA_AXIS]
    return shard(torch.as_tensor(t, dtype=torch.float32), batch_sharding(mesh)).data_shards()


def mesh_train_step(
    params: Params,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    i0, gt, i1,
    t: TimeLike = 0.5,
    cfg: ModelConfig = ModelConfig(),
    compute_dtype: torch.dtype = torch.float32,
    use_pallas: bool = False,
    remat: bool = False,
    loss: str = "charbonnier",
    spatial_dim: Optional[int] = None,
) -> torch.Tensor:
    """:func:`train_step` over a mesh: the batch is cut over the data axis
    and every shard's forward and loss run on its device, from copies of the
    master ``params`` (on the mesh's first device, where ``optimizer``
    keeps its state) made inside the autograd graph; one backward of the
    mean loss sums the gradients into the master params. With
    ``spatial_dim=1`` the rows of each frame are cut over the spatial axis
    too (``parallel.spatial``, the plain warp). Gradients are averaged over
    the process group when it has more than one rank. Returns the batch's
    loss as a 0-d tensor on the first device."""
    from rrin_tpu_torch.parallel.spatial import forward_spatial

    master = mesh.devices[0, 0]
    optimizer.zero_grad(set_to_none=True)
    i0s, gts, i1s = (shard(torch.as_tensor(a, dtype=torch.float32), batch_sharding(mesh))
                     for a in (i0, gt, i1))
    copies = replicate_params(mesh, params)  # differentiable copies; master's own leaves
    losses = []
    for d, (a, g, c, td) in enumerate(zip(i0s.data_shards(), gts.data_shards(),
                                         i1s.data_shards(), _shard_t(t, mesh))):
        if spatial_dim is not None:
            pred = forward_spatial(copies, a, c, td, list(mesh.devices[d]), cfg=cfg,
                                   compute_dtype=compute_dtype, remat=remat)
        else:
            pred = forward(copies[a.device], a, c, td, cfg=cfg, compute_dtype=compute_dtype,
                           use_pallas=use_pallas, remat=remat, device=a.device)
        losses.append(LOSSES[loss](pred, g).to(master))
    loss_v = torch.stack(losses).mean()
    loss_v.backward()
    loss_v = _average_over_processes(params, loss_v.detach())
    optimizer.step()
    return loss_v


def _trainable(params: Params, device: torch.device) -> Params:
    """A float32 copy of ``params`` on ``device`` whose leaves require grad
    (the optimizer updates them in place, so the caller's tensors stay as
    they are)."""
    if isinstance(params, dict):
        return {k: _trainable(v, device) for k, v in params.items()}
    return params.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)


@dataclass
class Trainer:
    """Bundles params, optimizer and step settings for a training run
    (checkpoint and resume through ``rrin_tpu_torch.params``). The optimizer
    updates ``params`` in place: an ``Interpolator`` built on them before
    training holds weight preps of the old values, so build a new one.

    With ``mesh`` a step runs :func:`mesh_train_step`; ``params`` and the
    optimizer are the master copy on the mesh's first device (what a
    checkpoint saves). ``spatial_dim`` is the dimension of (B, H, W, C) that
    the mesh's spatial axis cuts: 1 (H) or None; it needs a mesh."""

    params: Params
    optimizer: torch.optim.Optimizer
    cfg: ModelConfig = ModelConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    use_pallas: bool = False
    remat: bool = False
    mesh: Optional[Any] = None
    spatial_dim: Optional[int] = None
    step_count: int = 0
    loss: str = "charbonnier"  # see LOSSES (paper: laplacian / l1)
    device: DeviceLike = "cuda"

    def __post_init__(self):
        if self.spatial_dim not in (None, 1):
            raise ValueError(
                f"spatial_dim={self.spatial_dim}: the port cuts rows only, dimension 1 "
                "of (B, H, W, C)")
        if self.mesh is not None:
            self.device = self.mesh.devices[0, 0]

    @classmethod
    def create(
        cls,
        gen: Optional[torch.Generator] = None,
        learning_rate: float = 1e-4,
        optimizer: str = "adamax",
        cfg: ModelConfig = ModelConfig(),
        mesh: Optional[Any] = None,
        params: Optional[Params] = None,
        device: DeviceLike = "cuda",
        **kw,
    ) -> "Trainer":
        """A trainer on ``device`` (with ``mesh``: on its first device) from
        ``params`` (copied as float32 leaves that require grad) or, without
        them, from ``init_params(gen)`` (default: a CPU generator seeded with
        0)."""
        dev = mesh.devices[0, 0] if mesh is not None else resolve_device(device)
        if params is None:
            params = init_params(gen, cfg, device=dev)
        params = _trainable(params, dev)
        opt = make_optimizer(learning_rate, optimizer)(param_leaves(params))
        return cls(params=params, optimizer=opt, cfg=cfg, mesh=mesh, device=dev, **kw)

    def step(self, i0, gt, i1, t: TimeLike = 0.5) -> float:
        """One update on a batch (numpy arrays or tensors, moved to the
        trainer's device, or cut over the mesh); returns the loss as a float
        (a host sync). Under a mesh the batch must divide by the whole mesh
        size, as in the JAX package."""
        if self.mesh is not None and i0.shape[0] % self.mesh.devices.size:
            raise ValueError(
                f"batch size {i0.shape[0]} must be divisible by the mesh "
                f"size {self.mesh.devices.size} for data-parallel training"
            )
        if self.mesh is not None:
            loss = mesh_train_step(
                self.params, self.optimizer, self.mesh, i0, gt, i1, t, cfg=self.cfg,
                compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
                remat=self.remat, loss=self.loss, spatial_dim=self.spatial_dim,
            )
            self.step_count += 1
            return float(loss)
        dev = resolve_device(self.device)
        i0, gt, i1 = (torch.as_tensor(a).to(device=dev, dtype=torch.float32)
                      for a in (i0, gt, i1))
        loss = train_step(
            self.params, self.optimizer, i0, gt, i1, t, cfg=self.cfg,
            compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
            remat=self.remat, loss=self.loss, device=dev,
        )
        self.step_count += 1
        return float(loss)


def triplet_batches(
    root: str, batch_size: int, crop_hw: Tuple[int, int] = (256, 448),
    seed: int = 0, epochs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Random-crop batches from a Vimeo-style triplet directory tree.

    Yields (i0, gt, i1) float32 NHWC numpy batches in [0, 1], the crops of
    the JAX package's feed for the same seed and tree. Crops are aligned to
    the /16 padding requirement so no padding is needed in training.
    """
    ch, cw = crop_hw
    if ch % 16 or cw % 16:
        raise ValueError("crop dims must be multiples of 16")

    from rrin_tpu_torch.eval import FRAME_NAMES, find_triplets, image_hw, load_triplet

    # Undersized triplets are dropped once, up front (header-only reads), so
    # every batch has exactly batch_size items.
    all_dirs = find_triplets(root)
    if not all_dirs:
        raise FileNotFoundError(f"no triplets under {root}")
    dirs = []
    for d in all_dirs:
        h, w = image_hw(os.path.join(d, FRAME_NAMES[0]))
        if h >= ch and w >= cw:
            dirs.append(d)
    if len(dirs) < len(all_dirs):
        print(
            f"[rrin-tpu-torch-train] dropped {len(all_dirs) - len(dirs)} triplet(s) "
            f"smaller than the {ch}x{cw} crop",
            file=sys.stderr,
        )
    if len(dirs) < batch_size:
        raise ValueError(
            f"only {len(dirs)} usable triplet(s) under {root} for "
            f"batch_size={batch_size}"
        )
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(dirs))
        for i in range(0, len(dirs) - batch_size + 1, batch_size):
            ims = [load_triplet(dirs[j]) for j in order[i: i + batch_size]]
            b0, bg, b1 = [], [], []
            for im1, im2, im3 in ims:
                h, w = im1.shape[:2]
                y = rng.integers(0, h - ch + 1)
                x = rng.integers(0, w - cw + 1)
                sl = np.s_[y: y + ch, x: x + cw]
                b0.append(im1[sl])
                bg.append(im2[sl])
                b1.append(im3[sl])
            yield (
                np.stack(b0).astype(np.float32) / 255.0,
                np.stack(bg).astype(np.float32) / 255.0,
                np.stack(b1).astype(np.float32) / 255.0,
            )
        epoch += 1


def main(argv=None) -> int:
    """Training CLI: ``rrin-tpu-torch-train --data trips/ ...`` or
    ``--synthetic``."""
    import argparse

    from rrin_tpu_torch.params import save_params

    p = argparse.ArgumentParser(prog="rrin-tpu-torch-train")
    p.add_argument("--data", default=None, help="triplet root directory")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the on-device linear-motion triplet feed "
                   "(rrin_tpu_torch.data.synthetic, one device generator "
                   "seeded 0) instead of --data files: no host copy per step")
    p.add_argument("--loss", choices=sorted(LOSSES), default="charbonnier",
                   help="reconstruction loss (paper: laplacian / l1)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--crop", type=int, nargs=2, default=(256, 448))
    p.add_argument("--ckpt-out", default="rrin_tpu_ckpt.npz")
    p.add_argument("--init-from", default=None, help="warm start .npz/.pth")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="devices of this process for data parallelism; 0 = all "
                   "(with --device cpu: the CPU, listed that many times); "
                   "shrunk to the largest count that divides the process's "
                   "part of --batch")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True) and raise on a "
                   "non-finite loss: the PyTorch counterpart of jax_debug_nans; "
                   "slow, for debugging divergence")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize U-Nets under autograd "
                   "(torch.utils.checkpoint): fits much larger crops in memory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' "
                   "runs the kernels' plain versions)")
    args = p.parse_args(argv)

    # Validate before the 32M-param model and optimizer are built.
    if not (args.synthetic or args.data):
        p.error("one of --data or --synthetic is required")
    dev = resolve_device(args.device)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    from rrin_tpu_torch.parallel.distributed import initialize as dist_init

    ctx = dist_init()
    if ctx.process_count > 1:
        if args.batch % ctx.process_count:
            p.error(f"--batch {args.batch} does not divide over {ctx.process_count} "
                    "processes")
        print(f"[rrin-tpu-torch-train] multi-process: process {ctx.process_index}/"
              f"{ctx.process_count}, {ctx.global_device_count} devices")
    # --batch is the whole group's: every process draws the same batches and
    # trains on its own rows of each, and the steps average over the group.
    per = args.batch // ctx.process_count
    rows = slice(ctx.process_index * per, (ctx.process_index + 1) * per)

    mesh = None
    if args.data_parallel != 1:
        from rrin_tpu_torch.parallel.sharding import make_mesh

        n = args.data_parallel if args.data_parallel > 0 else (
            ctx.local_device_count if dev.type == "cuda" else 1)
        # The batch must divide over the mesh; shrink to the largest
        # compatible device count rather than failing mid-run.
        n = math.gcd(n, per)
        if n > 1:
            try:
                mesh = make_mesh(n_data=n, devices=None if dev.type == "cuda" else [dev] * n)
            except ValueError:
                mesh = None
        if mesh is not None and mesh.devices.size == 1:
            mesh = None  # single device: skip sharding machinery

    params = None
    if args.init_from:
        from rrin_tpu_torch.params import load_params, load_torch_checkpoint

        params = (
            load_torch_checkpoint(args.init_from, device=dev)
            if args.init_from.endswith((".pth", ".tar", ".pt"))
            else load_params(args.init_from, device=dev)
        )

    trainer = Trainer.create(
        learning_rate=args.lr, mesh=mesh, params=params, device=dev,
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
        remat=args.remat, loss=args.loss,
    )
    if args.synthetic:
        from rrin_tpu_torch.data import synthetic_triplet_batch

        def _synthetic_gen():
            gen = torch.Generator(device=dev).manual_seed(0)
            while True:
                yield synthetic_triplet_batch(gen, args.batch, tuple(args.crop), device=dev)

        batches = _synthetic_gen()
    else:
        batches = triplet_batches(args.data, args.batch, tuple(args.crop))
    t0 = time.perf_counter()
    for step in range(args.steps):
        i0, gt, i1 = (a[rows] for a in next(batches))
        loss = trainer.step(i0, gt, i1)
        if args.debug_nans and not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at step {step}")
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:6d}  loss {loss:.5f}  ({dt:.1f}s)", flush=True)
    save_params(args.ckpt_out, trainer.params)
    print(f"saved {args.ckpt_out} after {trainer.step_count} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
