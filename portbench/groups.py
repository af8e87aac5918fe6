"""Groups of the device operations in a trace, by kernel name.

``group`` is ``_profile_group`` of the repository's chip smoke script,
copied. ``bucket`` folds a group and a name of the program's launch counter
(``rrin_tpu_torch._build.LAUNCHES``) into the same key, so that the launches
a trace recorded can be held against those the program counted.
"""

from __future__ import annotations

import re
from typing import Optional

_SM90_MODES = {"0": "conv_up_m_packed (K8)", "1": "conv_up_f_packed (K9)",
               "2": "conv_pool_packed (K7)", "3": "conv_up_packed (K6)",
               "4": "conv_packed (K5)"}

COPY = "copies host<->device"
PREP = "K5-K9 weight prep"
WARP = "warp (K2-K4)"
K1 = "conv_phase (K1, Hopper core)"
K1_STREAMED = "conv_phase (K1, Hopper core, streamed mode)"


def group(name: str, plain: bool = False) -> str:
    """The group of a kernel's name; on the plain path (``plain``) the Hopper
    core's bf16 DIRECT mode is K1."""
    low = name.lower()
    sm90 = re.search(
        r"conv_up_sm90_kernel<\s*\d+,\s*(?:\(.*?\))?(\d+),\s*(?:\(.*?\))?(\d+)", low)
    if sm90:  # conv_up_sm90_kernel<N, MODE, ET, K>, ET: 0 bf16, 1 int8, 2 float32
        if plain and sm90.group(1) == "4" and sm90.group(2) == "0":
            return K1
        return _SM90_MODES[sm90.group(1)] + {"0": "", "1": " int8", "2": " float32"}[
            sm90.group(2)]
    if "conv_up_prep_kernel" in low:
        return PREP
    if "conv_stream_sm90_kernel" in low:
        return K1_STREAMED
    if "warp_kernel" in low:
        return WARP
    if "memcpy" in low or "memset" in low:
        return COPY
    if any(t in low for t in ("xmma", "cudnn", "gemm", "cutlass", "nchwtonhwc", "nhwctonchw")):
        return "library convs"
    if "catarray" in low:
        return "torch.cat"
    return "elementwise PyTorch"


def is_conv(g: str) -> bool:
    """K1 and K5-K9, in every precision (not their weight prep)."""
    return g.startswith(("conv_packed", "conv_pool_packed", "conv_up", "conv_phase"))


def is_hand_written(g: str) -> bool:
    """A kernel of the program's ``csrc/``."""
    return is_conv(g) or g in (PREP, WARP)


def is_host_copy(name: str) -> bool:
    """A copy between host and device memory (not device to device)."""
    low = name.lower()
    return "memcpy" in low and ("htod" in low or "dtoh" in low)


def bucket(g: str) -> Optional[str]:
    """The key under which a hand-written kernel's group is counted: the
    group, with K1's two modes folded into one."""
    if not is_hand_written(g):
        return None
    return "conv_phase (K1)" if g.startswith("conv_phase") else g


_COUNTER_KERNELS = {"conv_packed": "4", "conv_pool_packed": "2", "conv_up_packed": "3",
                    "conv_up_m_packed": "0", "conv_up_f_packed": "1"}


def counter_bucket(key: str) -> str:
    """The bucket of a name of the program's launch counter."""
    if key == "conv_phase":
        return "conv_phase (K1)"
    if key == "conv_up_prep":
        return PREP
    if key.startswith("warp_"):
        return WARP
    for suffix, mode in (("_int8", " int8"), ("_f32", " float32"), ("", "")):
        base = key[: len(key) - len(suffix)] if suffix else key
        if key.endswith(suffix) and base in _COUNTER_KERNELS:
            return _SM90_MODES[_COUNTER_KERNELS[base]] + mode
    raise KeyError(f"unknown launch counter {key!r}")
