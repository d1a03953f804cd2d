"""Wrappers of the deformable conv kernel (``csrc/dcn.cu``) and its adjoint
(``csrc/dcn_bwd.cu``).

Counterpart of ``fcvsr_tpu.ops.pallas_dcn``'s
``modulated_deform_conv2d_fused`` and ``modulated_deform_conv2d_fused_vjp``,
exact where the TPU kernels sample from a window around each tile's mean
offset and clamp the deviations to 2 px.  The plain versions are
``ops.dcn.modulated_deform_conv2d`` and ``ops.dcn.modulated_deform_conv2d_vjp``
(autograd through it), which CPU tensors run, for any configuration.

On a CUDA tensor :func:`modulated_deform_conv2d_fused` launches the forward
kernel; when autograd records the call it runs :class:`DCNFn`, whose
forward is that launch and whose backward is
:func:`modulated_deform_conv2d_fused_vjp`, two launches of the adjoint.
Both kernels take the 3x3 / stride 1 / padding 1 / dilation 1 / groups 1
configuration that every model of the zoo uses, with any deform groups
dividing Cin, with or without a mask; on CUDA tensors any other kernel
size, stride, padding, dilation or groups raises, with or without
autograd.  ``modulated_deform_conv2d_fused.launches`` and
``modulated_deform_conv2d_fused_vjp.launches`` count launches.
"""

from __future__ import annotations

import torch

from . import _native
from .dcn import modulated_deform_conv2d, modulated_deform_conv2d_vjp

__all__ = ["modulated_deform_conv2d_fused", "modulated_deform_conv2d_fused_vjp",
           "DCNFn"]


def _check(x, offset, mask, weight, deform_groups: int):
    """Validate CUDA operands of the 3x3 kernels; returns (B, H, W, Cin,
    Cout)."""
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
    if tuple(weight.shape[:3]) != (3, 3, cin):
        raise ValueError(f"weight has shape {tuple(weight.shape)}, expected "
                         f"(3, 3, {cin}, Cout)")
    return b, h, w, cin, weight.shape[3]


class DCNFn(torch.autograd.Function):
    """The DCN under autograd: the forward kernel, saving its inputs; the
    backward is :func:`modulated_deform_conv2d_fused_vjp`, which dispatches
    on the saved tensors' device."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, deform_groups: int):
        out = modulated_deform_conv2d_fused(x, offset, mask, weight, bias,
                                            deform_groups=deform_groups)
        ctx.save_for_backward(x, offset, mask, weight, bias)
        ctx.deform_groups = deform_groups
        return out

    @staticmethod
    def backward(ctx, g):
        return modulated_deform_conv2d_fused_vjp(
            *ctx.saved_tensors, g.contiguous(),
            deform_groups=ctx.deform_groups) + (None,)


def modulated_deform_conv2d_fused(x, offset, mask, weight, bias=None,
                                  stride: int = 1, padding: int = 1,
                                  dilation: int = 1, groups: int = 1,
                                  deform_groups: int = 1):
    """DCNv2 (DCNv1 with ``mask=None``), channels-last.  x: (B, H, W, Cin);
    offset: (B, H, W, dg * 18), (dg, tap, [dy, dx]); mask: (B, H, W, dg * 9)
    or None; weight: HWIO (3, 3, Cin, Cout); bias: (Cout,) or None.
    Returns (B, H, W, Cout).  On a CUDA tensor that autograd records it
    runs :class:`DCNFn`."""
    if _native.on_cpu(x):
        return modulated_deform_conv2d(x, offset, mask, weight, bias, stride,
                                       padding, dilation, groups,
                                       deform_groups)
    if (stride, padding, dilation, groups) != (1, 1, 1, 1) \
            or tuple(weight.shape[:2]) != (3, 3):
        raise ValueError(
            "the DCN kernels take 3x3 taps, stride 1, padding 1, dilation 1 "
            f"and groups 1; got kernel {tuple(weight.shape[:2])}, stride "
            f"{stride}, padding {padding}, dilation {dilation}, groups "
            f"{groups}")
    if _native.records(x, offset, mask, weight, bias):
        return DCNFn.apply(x, offset, mask, weight, bias, deform_groups)
    b, h, w, cin, cout = _check(x, offset, mask, weight, deform_groups)
    dev = x.device
    if bias is not None:
        _native.require(bias, "bias", dev, (cout,))
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    with _native.launch_guard(x) as stream:
        rc = lib.fcvsr_dcn3x3(
            x.data_ptr(), offset.data_ptr(), _native.ptr(mask),
            weight.data_ptr(), _native.ptr(bias), out.data_ptr(), b, h, w,
            cin, cout, deform_groups, stream)
    _native.check(rc, "dcn3x3")
    modulated_deform_conv2d_fused.launches += 1
    return out


modulated_deform_conv2d_fused.launches = 0


def modulated_deform_conv2d_fused_vjp(x, offset, mask, weight, bias, g,
                                      deform_groups: int = 1):
    """Adjoint of the 3x3 DCN at the cotangent ``g`` (B, H, W, Cout), shapes
    as in :func:`modulated_deform_conv2d_fused`; ``bias`` only says whether
    there is one.  Returns (dx, doffset, dmask, dweight, dbias), dmask None
    without a mask and dbias None without a bias.  On CUDA tensors two
    launches (data, then weight adjoint); on CPU tensors the plain VJP."""
    if _native.on_cpu(x):
        return modulated_deform_conv2d_vjp(x, offset, mask, weight, bias, g,
                                           deform_groups)
    b, h, w, cin, cout = _check(x, offset, mask, weight, deform_groups)
    dev = x.device
    _native.require(g, "g", dev, (b, h, w, cout))
    dx, doff, dw = (torch.zeros_like(t) for t in (x, offset, weight))
    dmask = None if mask is None else torch.zeros_like(mask)
    db = None if bias is None else weight.new_zeros(cout)
    lib = _native.lib()
    with _native.launch_guard(x) as stream:
        rc = lib.fcvsr_dcn3x3_bwd_data(
            x.data_ptr(), offset.data_ptr(), _native.ptr(mask),
            weight.data_ptr(), g.data_ptr(), dx.data_ptr(), doff.data_ptr(),
            _native.ptr(dmask), b, h, w, cin, cout, deform_groups, stream)
        _native.check(rc, "dcn3x3_bwd (data adjoint)")
        modulated_deform_conv2d_fused_vjp.launches += 1
        rc = lib.fcvsr_dcn3x3_bwd_weight(
            x.data_ptr(), offset.data_ptr(), _native.ptr(mask), g.data_ptr(),
            dw.data_ptr(), _native.ptr(db), b, h, w, cin, cout,
            deform_groups, stream)
    _native.check(rc, "dcn3x3_bwd (weight adjoint)")
    modulated_deform_conv2d_fused_vjp.launches += 1
    return dx, doff, dmask, dw, db


modulated_deform_conv2d_fused_vjp.launches = 0
