"""Image and latent quality metrics for the end-to-end accuracy gate.

The JAX package's ``utils.metrics``: the reference's per-bitwidth
acceptance threshold (normalized MSE within 10^(-bits/2)) lifted to model
outputs, PSNR, and SSIM with a uniform window, over NHWC images in any
float dtype, computed in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["normalized_mse", "psnr", "ssim", "dynamic_loss_threshold"]


def dynamic_loss_threshold(num_bits: int) -> float:
    """The reference's acceptance threshold at ``num_bits``: 10^(-bits/2)."""
    return 10.0 ** (-num_bits / 2)


def normalized_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mse(a, b) / var(b), the reference's quantization-loss measure."""
    a, b = a.float(), b.float()
    return ((a - b) ** 2).mean() / torch.clamp_min(
        b.var(unbiased=False), 1e-12)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float | None = None
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB; ``data_range`` defaults to the
    range of the reference image ``b``."""
    a, b = a.float(), b.float()
    if data_range is None:
        data_range = b.max() - b.min()
    mse = ((a - b) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-20))


def _window_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Uniform win x win mean over the two spatial dims of NHWC, valid
    windows only."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1).permute(
        0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float | None = None,
         win: int = 7) -> torch.Tensor:
    """Mean structural similarity (Wang et al. 2004) with a uniform window
    over NHWC inputs, averaged over windows and channels."""
    a, b = a.float(), b.float()
    if data_range is None:
        data_range = b.max() - b.min()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _window_mean(a, win)
    mu_b = _window_mean(b, win)
    var_a = _window_mean(a * a, win) - mu_a ** 2
    var_b = _window_mean(b * b, win) - mu_b ** 2
    cov = _window_mean(a * b, win) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return (num / den).mean()
