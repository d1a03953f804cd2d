"""Functional ops of the port (channels-last tensors), and the wrappers of
its CUDA kernels.  Importing builds nothing: the kernel library is compiled
and loaded at the first launch on a CUDA tensor (``ops._native``)."""

from . import fused_conv, fused_dcn, fused_iac
from .corr import corr_lookup
from .dcn import modulated_deform_conv2d
from .freq import gaussian_band_masks, irfft_features, rfft_features, split_freq
from .resize import downsample2x_bilinear, resize_bilinear, upsample2x_bilinear
from .sac import iac, sac
from .warp import flow_warp, grid_sample_bilinear

__all__ = [
    "corr_lookup", "downsample2x_bilinear", "flow_warp", "gaussian_band_masks",
    "grid_sample_bilinear", "iac", "irfft_features", "launch_counts",
    "modulated_deform_conv2d", "reset_launch_counts", "resize_bilinear",
    "rfft_features", "sac", "split_freq", "upsample2x_bilinear",
]

# kernel name -> the wrappers that launch it (the IAC kernel has a
# materialised-kernel and a fused-prediction variant; its adjoint is two
# launches a call)
_WRAPPERS = {
    "iac": (fused_iac.warp_sac_fused, fused_iac.warp_sac_fused_kf),
    "iac_bwd": (fused_iac.warp_sac_bwd,),
    "conv3x3_pair": (fused_conv.conv3x3_pair,),
    "conv3x3": (fused_conv.conv3x3,),
    "dcn": (fused_dcn.modulated_deform_conv2d_fused,),
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, per kernel."""
    return {name: sum(f.launches for f in fns)
            for name, fns in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fns in _WRAPPERS.values():
        for f in fns:
            f.launches = 0
