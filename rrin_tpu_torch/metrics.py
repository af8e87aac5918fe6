"""Image quality metrics of the port: PSNR and SSIM.

Plain tensor functions on ``(B, H, W, C)`` in ``[0, max_val]``, computed in
float32 on the device the inputs lie on, so a batched evaluation scores its
frames next to the model. SSIM follows Wang et al. 2004 with the standard
11x11 Gaussian window (sigma 1.5), C1=(0.01 L)^2, C2=(0.03 L)^2, as the JAX
package does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rrin_tpu_torch.ops.conv_phase import no_tf32


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB per batch item. pred/target: (B, H, W, C) in [0, max_val]."""
    mse = torch.mean((pred.to(torch.float32) - target.to(torch.float32)) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM per batch item. pred/target: (B, H, W, C) in [0, max_val].

    Separable 11x11 Gaussian filtering, valid padding (edges excluded, as in
    the standard implementation).
    """
    x = pred.to(torch.float32)
    y = target.to(torch.float32)
    c = x.shape[-1]
    win = torch.from_numpy(_gaussian_window()).to(x.device)
    kh = win.reshape(1, 1, 11, 1).expand(c, 1, 11, 1)
    kw = win.reshape(1, 1, 1, 11).expand(c, 1, 1, 11)

    def blur(v: torch.Tensor) -> torch.Tensor:
        # Two depthwise passes (H, then W) on NCHW. TF32 stays off: its
        # ~3-decimal-digit products destroy the blur(x*x) - mu^2 variance
        # cancellation below (sigma^2 comes out negative at the scale of C2
        # and SSIM can exceed 1), as the TPU's default conv precision did
        # in the JAX package before it asked for HIGHEST.
        v = v.permute(0, 3, 1, 2)
        v = F.conv2d(F.conv2d(v, kh, groups=c), kw, groups=c)
        return v.permute(0, 2, 3, 1)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    with no_tf32():
        mu_x = blur(x)
        mu_y = blur(y)
        mu_x2 = mu_x * mu_x
        mu_y2 = mu_y * mu_y
        mu_xy = mu_x * mu_y
        sigma_x2 = blur(x * x) - mu_x2
        sigma_y2 = blur(y * y) - mu_y2
        sigma_xy = blur(x * y) - mu_xy

    s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    )
    return torch.mean(s, dim=(1, 2, 3))
