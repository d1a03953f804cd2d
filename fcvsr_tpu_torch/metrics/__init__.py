"""Image-quality metrics of the port (numpy)."""

from .psnr_ssim import calculate_psnr, calculate_ssim

__all__ = ["calculate_psnr", "calculate_ssim"]
