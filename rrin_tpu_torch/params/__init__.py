"""Checkpoint save/load + state-dict converter of the port. Native
checkpoints are flat ``.npz`` files shared with the JAX package."""

from rrin_tpu_torch.params.checkpoint import (
    convert_torch_state_dict,
    flatten_params,
    load_calibration,
    load_params,
    load_torch_checkpoint,
    params_from_numpy,
    params_to_torch_state_dict,
    save_calibration,
    save_params,
    unflatten_params,
)

__all__ = [
    "save_params",
    "load_params",
    "save_calibration",
    "load_calibration",
    "flatten_params",
    "unflatten_params",
    "params_from_numpy",
    "convert_torch_state_dict",
    "load_torch_checkpoint",
    "params_to_torch_state_dict",
]
