"""Frozen dataclass configs of the PyTorch port (same fields and defaults as
the JAX package's ``config.py``; kept as an own copy so the port imports
nothing of that package)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the RRIN cascade.

    Channel signatures of the four U-Nets:
      flow 6->4, refine 10->4, mask 16->2, final 9->3.
    """

    # Stem width; the encoder doubles it at each of the 4 pooling stages.
    base_width: int = 32
    # Encoder conv kernel sizes per stage (the stem is 7x7).
    stem_kernel: int = 7
    down_kernels: Tuple[int, int, int, int] = (5, 3, 3, 3)
    # LeakyReLU negative slope.
    leaky_slope: float = 0.1
    # grid_sample-compatible warp semantics (see ops/warp.py).
    align_corners: bool = False
    # Epsilon in the adaptive weighted blend.
    blend_eps: float = 1e-8
    # Spatial dims must be padded to a multiple of this (4 pooling stages).
    pad_multiple: int = 16

    @property
    def widths(self) -> Tuple[int, int, int, int, int]:
        w = self.base_width
        return (w, 2 * w, 4 * w, 8 * w, 16 * w)
