"""Ops of the port: backward warp, resize, padding (plain PyTorch) and the
wrappers of the hand-written CUDA kernels (conv_phase, warp_kernel)."""

from rrin_tpu_torch.ops.pad import pad_to_multiple, padded_size, unpad
from rrin_tpu_torch.ops.resize import avg_pool_2x, upsample_2x_bilinear
from rrin_tpu_torch.ops.warp import warp_bilinear, warp_blend, warp_pair

__all__ = [
    "pad_to_multiple",
    "padded_size",
    "unpad",
    "avg_pool_2x",
    "upsample_2x_bilinear",
    "warp_bilinear",
    "warp_pair",
    "warp_blend",
]
