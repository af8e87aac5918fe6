"""rrin_tpu_torch: the PyTorch/CUDA port of the RRIN frame-interpolation
framework, for one NVIDIA H100.

Given two consecutive video frames ``I0``, ``I1`` and a time ``t`` in (0, 1)
it synthesizes the intermediate frame through RRIN's four cascaded U-Nets
(coarse bidirectional flow, flow refinement, adaptive weight map, residue
refinement). Plain tensor code is PyTorch; the low-channel convolutions and
the backward warps run in CUDA kernels written by hand for ``sm_90a``
(``csrc/``), built at first use. Every entry point takes a ``device`` that
defaults to the card; ``device="cpu"`` runs the kernels' plain versions.

    >>> from rrin_tpu_torch import RRIN
    >>> net = RRIN.init(torch.Generator().manual_seed(0))
    >>> it = net(i0, i1, t=0.5)        # NHWC float32 in [0,1]
"""

from rrin_tpu_torch.config import ModelConfig
from rrin_tpu_torch.models.rrin import (
    RRIN,
    forward,
    forward_calibrate,
    forward_saturation,
    init_params,
    merge_quant_stats,
    prepare_packed_params,
    scale_quant_stats,
)

__version__ = "0.1.0"

# The JAX package's names.
__all__ = [
    "RRIN",
    "ModelConfig",
    "init_params",
    "forward",
    "forward_calibrate",
    "forward_saturation",
    "merge_quant_stats",
    "scale_quant_stats",
    "prepare_packed_params",
    "__version__",
]
