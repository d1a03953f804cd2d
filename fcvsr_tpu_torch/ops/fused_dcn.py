"""Wrapper of the deformable conv kernel (``csrc/dcn.cu``).

Counterpart of ``fcvsr_tpu.ops.pallas_dcn.modulated_deform_conv2d_fused``,
exact where the TPU kernel samples from a window around each tile's mean
offset and clamps the deviations to 2 px.  Its plain version is
``ops.dcn.modulated_deform_conv2d``, which CPU tensors run under ordinary
autograd, for any configuration.  On a CUDA tensor the wrapper launches the
kernel, which takes the 3x3 / stride 1 / padding 1 / dilation 1 / groups 1
configuration that every model of the zoo uses, and raises on any other;
``modulated_deform_conv2d_fused.launches`` counts its launches.  The
kernel has no adjoint yet: on a CUDA tensor that autograd records the
wrapper raises.
"""

from __future__ import annotations

import torch

from . import _native
from .dcn import modulated_deform_conv2d

__all__ = ["modulated_deform_conv2d_fused"]


def modulated_deform_conv2d_fused(x, offset, mask, weight, bias=None,
                                  stride: int = 1, padding: int = 1,
                                  dilation: int = 1, groups: int = 1,
                                  deform_groups: int = 1):
    """DCNv2 (DCNv1 with ``mask=None``), channels-last.  x: (B, H, W, Cin);
    offset: (B, H, W, dg * 18), (dg, tap, [dy, dx]); mask: (B, H, W, dg * 9)
    or None; weight: HWIO (3, 3, Cin, Cout); bias: (Cout,) or None.
    Returns (B, H, W, Cout)."""
    if _native.on_cpu(x):
        return modulated_deform_conv2d(x, offset, mask, weight, bias, stride,
                                       padding, dilation, groups,
                                       deform_groups)
    if (stride, padding, dilation, groups) != (1, 1, 1, 1) \
            or tuple(weight.shape[:2]) != (3, 3):
        raise ValueError(
            "the DCN kernel takes 3x3 taps, stride 1, padding 1, dilation 1 "
            f"and groups 1; got kernel {tuple(weight.shape[:2])}, stride "
            f"{stride}, padding {padding}, dilation {dilation}, groups "
            f"{groups}")
    if _native.records(x, offset, mask, weight, bias):
        raise RuntimeError(
            "the DCN kernel has no backward on CUDA yet: run the forward "
            "under torch.no_grad() (serving), or train on the CPU")
    b, h, w, cin = x.shape
    dg = deform_groups
    if dg <= 0 or cin % dg:
        raise ValueError(f"deform_groups {dg} does not divide Cin {cin}")
    dev = x.device
    _native.require(x, "x", dev)
    _native.require(offset, "offset", dev, (b, h, w, dg * 18))
    if mask is not None:
        _native.require(mask, "mask", dev, (b, h, w, dg * 9))
    _native.require(weight, "weight", dev)
    if weight.shape[2] != cin:
        raise ValueError(f"weight has shape {tuple(weight.shape)}, expected "
                         f"(3, 3, {cin}, Cout)")
    cout = weight.shape[3]
    if bias is not None:
        _native.require(bias, "bias", dev, (cout,))
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    rc = lib.fcvsr_dcn3x3(
        x.data_ptr(), offset.data_ptr(), _native.ptr(mask), weight.data_ptr(),
        _native.ptr(bias), out.data_ptr(), b, h, w, cin, cout, dg,
        _native.stream_ptr(dev))
    _native.check(rc, "dcn3x3")
    modulated_deform_conv2d_fused.launches += 1
    return out


modulated_deform_conv2d_fused.launches = 0
