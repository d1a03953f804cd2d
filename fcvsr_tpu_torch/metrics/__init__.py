"""Image-quality metrics of the port (numpy): PSNR, SSIM, and tOF over
Farneback flows; LPIPS (``lpips``, torch), NIQE and BRISQUE (``noref``),
NRQM and PI (``nrqm``) and VMAF (``vmaf``, through ffmpeg) in their
modules."""

from .farneback import calculate_tof, farneback_flow
from .psnr_ssim import bgr2y, calculate_psnr, calculate_ssim, rgb2y

__all__ = ["calculate_psnr", "calculate_ssim", "calculate_tof",
           "farneback_flow", "bgr2y", "rgb2y"]
