"""Model layer: the shared U-Net block and the 4-U-Net RRIN cascade."""

from rrin_tpu_torch.models.rrin import RRIN, forward, init_params
from rrin_tpu_torch.models.unet import unet_apply, unet_init

__all__ = ["RRIN", "forward", "init_params", "unet_apply", "unet_init"]
