"""Functional ops of the port (channels-last tensors), and the wrappers of
its CUDA kernels.  Importing builds nothing: the kernel library is compiled
and loaded at the first launch on a CUDA tensor (``ops._native``)."""

from . import fused_blockrcb, fused_conv, fused_dcn, fused_iac
from .corr import corr_lookup
from .dcn import modulated_deform_conv2d, modulated_deform_conv2d_vjp
from .freq import gaussian_band_masks, irfft_features, rfft_features, split_freq
from .resize import (downsample2x_bilinear, resize_bicubic, resize_bilinear,
                     upsample2x_bilinear)
from .sac import iac, sac
from .warp import flow_warp, grid_sample_bilinear

__all__ = [
    "corr_lookup", "downsample2x_bilinear", "flow_warp", "gaussian_band_masks",
    "grid_sample_bilinear", "iac", "irfft_features", "launch_counts",
    "modulated_deform_conv2d", "modulated_deform_conv2d_vjp",
    "reset_launch_counts", "resize_bicubic", "resize_bilinear",
    "rfft_features", "sac", "split_freq", "upsample2x_bilinear",
]

# kernel name -> the wrappers that launch it (the IAC kernel has a
# materialised-kernel and a fused-prediction variant; the resident chain
# is one launch for all iterations; the IAC adjoint and the DCN adjoint
# are one launch a call)
_WRAPPERS = {
    "iac": (fused_iac.warp_sac_fused, fused_iac.warp_sac_fused_kf),
    "iac_chain": (fused_iac.iac_fused_resident,),
    "iac_bwd": (fused_iac.warp_sac_bwd,),
    "conv3x3_pair": (fused_conv.conv3x3_pair,),
    "conv3x3_quad": (fused_conv.conv3x3_quad,),
    "conv3x3": (fused_conv.conv3x3,),
    "dcn": (fused_dcn.modulated_deform_conv2d_fused,),
    "dcn_bwd": (fused_dcn.modulated_deform_conv2d_fused_vjp,),
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, per kernel."""
    return {name: sum(f.launches for f in fns)
            for name, fns in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fns in _WRAPPERS.values():
        for f in fns:
            f.launches = 0
