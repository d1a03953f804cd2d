"""Image-quality metrics of the port (numpy): PSNR, SSIM, and tOF over
Farneback flows."""

from .farneback import calculate_tof, farneback_flow
from .psnr_ssim import calculate_psnr, calculate_ssim

__all__ = ["calculate_psnr", "calculate_ssim", "calculate_tof",
           "farneback_flow"]
