"""Weight checkpointing and the state-dict converter of the port.

The params dict holds torch tensors in the JAX package's layout:
  ``params[<unet>][<block>][<conv>]["w"]``  (kh, kw, I, O)  (HWIO)
  ``params[...]["b"]``                      (O,)
On disk a checkpoint is a flat ``.npz`` with keys such as
``flow.down1.conv1.w``, HWIO, so one file loads in both packages. A
reference-layout torch ``state_dict`` (``<unet>.<block>.<conv>.weight`` in
OIHW, optional leading ``module.``) converts both ways.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Mapping

import numpy as np
import torch

from rrin_tpu_torch._device import DeviceLike, resolve_device

Params = Dict[str, Any]


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy() if v.is_floating_point() \
            else v.detach().cpu().numpy()
    return np.asarray(v)


def flatten_params(params: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> flat {'flow.down1.conv1.w': ndarray} (host arrays)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_params(v, prefix=key + "."))
        else:
            out[key] = _to_numpy(v)
    return out


def unflatten_params(flat: Mapping[str, Any]) -> Params:
    """Flat mapping -> nested dict of numpy arrays (see
    :func:`params_from_numpy` to place it on a device)."""
    out: Params = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_numpy(v)
    return out


def params_from_numpy(
    tree: Mapping[str, Any], device: DeviceLike = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Nested dict of arrays -> the port's params dict on ``device``.

    This is how the JAX package's parameters (``jax.tree.map(np.asarray,
    params)``: same nesting, HWIO weights) come across; no transposition is
    needed because the port keeps that layout.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(_to_numpy(node), copy=True)).to(
            device=dev, dtype=dtype)

    return conv(tree)


def save_params(path: str, params: Params) -> None:
    """Save weights as a flat ``.npz`` (HWIO, float32)."""
    np.savez(path, **flatten_params(params))


def load_params(
    path: str, device: DeviceLike = "cuda", dtype: torch.dtype = torch.float32
) -> Params:
    """Load a flat ``.npz`` written by either package onto ``device``."""
    with np.load(path) as data:
        tree = unflatten_params({k: data[k] for k in data.files})
    return params_from_numpy(tree, device=device, dtype=dtype)


CALIB_PREFIX = "__calib__."


def save_calibration(path: str, quant_stats: Params) -> None:
    """Persist int8 calibration stats (per-tensor |x| maxima from
    ``forward_calibrate``, usually already margin-scaled) as a flat ``.npz``
    with the JAX package's keys (``__calib__.<unet>.<site>``), so one file
    loads in both packages. The stats are per-tensor scalars, so one file
    serves every resolution."""
    flat = {CALIB_PREFIX + k: v for k, v in flatten_params(quant_stats).items()}
    np.savez(path, **flat)


def load_calibration(path: str, device: DeviceLike = "cuda") -> Params:
    """Inverse of :func:`save_calibration`, as float32 scalars on ``device``.
    Also accepts an ``.npz`` written without the prefix (plain flattened
    stats)."""
    with np.load(path) as data:
        flat = {(k[len(CALIB_PREFIX):] if k.startswith(CALIB_PREFIX) else k): data[k]
                for k in data.files}
    if not flat:
        raise ValueError(f"no calibration entries in {path}")
    return params_from_numpy(unflatten_params(flat), device=device)


def convert_torch_state_dict(
    state_dict: Mapping[str, Any], strict: bool = True,
    device: DeviceLike = "cuda",
) -> Params:
    """Convert a reference-layout torch state_dict to the params dict.

    Accepts torch tensors or numpy arrays as values; strips a ``module.``
    prefix; transposes conv weights OIHW -> HWIO.

    strict=True raises on any unrecognized key; strict=False skips
    non-weight entries (epoch counters, optimizer state) and reports them on
    stderr.
    """
    flat: Dict[str, np.ndarray] = {}
    skipped = []
    for key, val in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        arr = _to_numpy(val)
        if key.endswith(".weight") and arr.ndim == 4:
            flat[key[: -len(".weight")] + ".w"] = np.transpose(arr, (2, 3, 1, 0))
        elif key.endswith(".bias") and arr.ndim == 1:
            flat[key[: -len(".bias")] + ".b"] = arr
        elif strict:
            raise ValueError(
                f"unrecognized state_dict key: {key} (shape {arr.shape}); "
                "pass strict=False to skip non-weight entries"
            )
        else:
            skipped.append(key)
    if skipped:
        print(
            f"[rrin-tpu-torch] skipped {len(skipped)} non-weight state_dict "
            f"key(s): {', '.join(skipped[:8])}"
            + (" ..." if len(skipped) > 8 else ""),
            file=sys.stderr,
        )
    return params_from_numpy(unflatten_params(flat), device=device)


def load_torch_checkpoint(
    path: str, strict: bool = False, device: DeviceLike = "cuda"
) -> Params:
    """Load a reference ``.pth``/``.pth.tar`` checkpoint.

    Lenient by default: entries that are not conv weights/biases are skipped
    with a warning.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    return convert_torch_state_dict(obj, strict=strict, device=device)


def params_to_torch_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """Inverse converter (params dict -> reference-layout CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flatten_params(params).items():
        if key.endswith(".w"):
            out[key[:-2] + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1))))
        elif key.endswith(".b"):
            out[key[:-2] + ".bias"] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"unrecognized param key: {key}")
    return out
