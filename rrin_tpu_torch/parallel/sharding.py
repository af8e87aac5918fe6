"""Meshes of CUDA devices and the placement of batches and params on them.

The JAX package describes placement with a ``jax.sharding.Mesh`` and
``NamedSharding``s and lets XLA move the data; here the same names describe
it and also perform it, since nothing else will:

  * :class:`Mesh`: a 2-D array of ``torch.device``s shaped
    ``(n_data, n_spatial)`` on the axes ``(DATA_AXIS, SPATIAL_AXIS)``;
  * :func:`batch_sharding` / :func:`replicate`: a :class:`Sharding`, the mesh
    and one axis name (or None) per array dimension, as a ``PartitionSpec``;
  * :func:`shard_pairs`: the arrays cut by such a sharding and copied to the
    devices, each as a :class:`Sharded` that gathers back;
  * :func:`replicate_params`: one copy of a params tree per distinct device.

A mesh may list one device more than once (``make_mesh(devices=[cpu] * 4)``
in the tests, two shards of one card in ``chip_smoke.py``): each shard is
its own tensor all the same, and the params get one copy per distinct
device, which serving only reads. Training never writes a replica (see
``rrin_tpu_torch.train``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rrin_tpu_torch.parallel.distributed import local_devices

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
# Rows of a spatial shard come in whole blocks of this many (the U-Net's pad
# multiple): every 2x2 pool of the four levels then stays inside a shard.
ROW_BLOCK = 16


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(n_data, n_spatial)`` numpy object array of devices on the axes
    ``(DATA_AXIS, SPATIAL_AXIS)`` (``mesh.devices.size`` counts them);
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``
    does."""

    devices: np.ndarray
    axis_names: Tuple[str, str] = (DATA_AXIS, SPATIAL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() builds a mesh of CUDA devices and torch.cuda.is_available() "
            "is False; pass devices= to build one of other devices")
    return local_devices()


def make_mesh(
    n_data: int = 0,
    n_spatial: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A ('data', 'spatial') mesh. n_data=0 means "all remaining devices".

    ``devices`` defaults to every CUDA device of this process
    (``cuda:0 .. device_count() - 1``, or its share of them in a process
    group, ``distributed.local_devices``); without a GPU and without
    ``devices`` it raises. ``devices`` may list a device more than once.
    """
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else _default_devices())]
    if n_data <= 0:
        if len(devices) % n_spatial:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_spatial={n_spatial}"
            )
        n_data = len(devices) // n_spatial
    n = n_data * n_spatial
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    arr = arr.reshape(n_data, n_spatial)
    arr.flags.writeable = False
    return Mesh(arr)


@dataclass(frozen=True)
class Sharding:
    """Where an array goes on a mesh: ``spec`` names, per dimension, the mesh
    axis it is cut over (None: not cut), as a ``PartitionSpec``; an axis the
    spec does not name holds copies."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def dim_of(self, axis: str) -> Optional[int]:
        """The array dimension cut over ``axis``, or None."""
        return self.spec.index(axis) if axis in self.spec else None


def batch_sharding(
    mesh: Mesh, spatial_dim: Optional[int] = None, ndim: int = 4
) -> Sharding:
    """Sharding for batch-leading arrays: B over data, optionally one
    spatial dim over ``spatial``. ``ndim`` covers both (B,H,W,C) activations
    and the pipeline's (B,2,H,W,3) uint8 pair batches."""
    if spatial_dim is None:
        return Sharding(mesh, (DATA_AXIS,))
    spec = [DATA_AXIS] + [None] * (ndim - 1)
    spec[spatial_dim] = SPATIAL_AXIS
    return Sharding(mesh, tuple(spec))


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def row_cuts(size: int, n: int, block: int = ROW_BLOCK) -> List[int]:
    """The ``n + 1`` boundaries that cut ``size`` rows into ``n`` non-empty
    shards at multiples of ``block``, as even as whole blocks allow (the
    first shards take one block more; the last one takes the rows past the
    last whole block)."""
    blocks = size // block
    if n < 1 or blocks < n:
        raise ValueError(
            f"{size} rows cannot be cut into {n} non-empty shards of whole "
            f"{block}-row blocks")
    per, extra = divmod(blocks, n)
    cuts = [0]
    for i in range(n):
        cuts.append(cuts[-1] + (per + (i < extra)) * block)
    cuts[-1] = size
    return cuts


class Sharded:
    """An array cut over a mesh: ``shards[d][s]`` is the piece on
    ``mesh.devices[d, s]``, each its own tensor; where the spatial axis does
    not cut the array, ``shards[d]`` holds one piece, on the row's first
    device. ``gather()`` puts the whole array back together on the mesh's
    first device."""

    def __init__(self, sharding: Sharding, shards: List[List[torch.Tensor]],
                 shape: Tuple[int, ...]):
        self.sharding = sharding
        self.shards = shards
        self.shape = tuple(shape)

    def data_shards(self) -> List[torch.Tensor]:
        """One piece per data index, on the first device of its row (the
        whole spatial extent only when the spatial axis does not cut)."""
        return [row[0] for row in self.shards]

    def gather(self) -> torch.Tensor:
        dev = self.sharding.mesh.devices[0, 0]
        sd = self.sharding.dim_of(SPATIAL_AXIS)
        rows = [row[0].to(dev) if sd is None else torch.cat([p.to(dev) for p in row], dim=sd)
                for row in self.shards]
        dd = self.sharding.dim_of(DATA_AXIS)
        return rows[0] if dd is None else torch.cat(rows, dim=dd)


def _cut(a: torch.Tensor, dim: Optional[int], n: int, cuts=None) -> List[torch.Tensor]:
    if dim is None:
        return [a] * n
    if cuts is None:
        if a.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {a.shape[dim]} does not divide over {n} devices")
        return list(torch.chunk(a, n, dim=dim))
    return [a.narrow(dim, cuts[i], cuts[i + 1] - cuts[i]) for i in range(n)]


def shard(a: Any, sharding: Sharding) -> Sharded:
    """Cut ``a`` (numpy array or tensor) by ``sharding`` and copy each piece
    to its device (a piece that the spatial axis does not cut, to its row's
    first device only). The data axis must divide its dimension evenly; the
    spatial axis cuts at :func:`row_cuts`. Each piece is a tensor of its
    own, also where the mesh repeats a device, and every copy is made before
    the caller launches any work on them."""
    t = torch.as_tensor(a)
    mesh = sharding.mesh
    nd, ns = mesh.devices.shape
    dd, sd = sharding.dim_of(DATA_AXIS), sharding.dim_of(SPATIAL_AXIS)
    cuts = None if sd is None else row_cuts(t.shape[sd], ns)
    shards = [[p.to(mesh.devices[d, s], non_blocking=True, copy=True)
               for s, p in enumerate(_cut(piece, sd, ns, cuts) if sd is not None else [piece])]
              for d, piece in enumerate(_cut(t, dd, nd))]
    return Sharded(sharding, shards, tuple(t.shape))


def shard_pairs(mesh: Mesh, *arrays: Any, spatial_dim: Optional[int] = None):
    """Cut arrays with batch-DP (+optional spatial) sharding and put each
    piece on its device (:func:`shard`)."""
    out = tuple(
        shard(a, batch_sharding(mesh, spatial_dim, ndim=np.ndim(a)))
        for a in arrays
    )
    return out[0] if len(out) == 1 else out


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def replicate_params(mesh: Mesh, params: Any) -> Dict[torch.device, Any]:
    """One copy of ``params`` per distinct device of the mesh (device ->
    tree); a leaf already on its device is that copy."""
    return {dev: _tree_to(params, dev) for dev in dict.fromkeys(mesh.devices.flat)}
