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
:func:`modulated_deform_conv2d_fused_vjp`, one launch of the adjoint.
Both kernels take the 3x3 / stride 1 / padding 1 / dilation 1 / groups 1
configuration that every model of the zoo uses, with any deform groups
dividing Cin, with or without a mask; on CUDA tensors any other kernel
size, stride, padding, dilation or groups raises, with or without
autograd, and so does Cout above :data:`DCN_BWD_MAX_COUT` for the
adjoint.
``modulated_deform_conv2d_fused.launches`` and
``modulated_deform_conv2d_fused_vjp.launches`` count launches.

Both kernels multiply on the tensor cores in bf16 parts with float32 sums
(bf16x3: hi*hi + hi*lo + lo*hi, within 3 x 2^-16 of each product), the
route of the conv kernels (``ops.fused_conv``).
:func:`modulated_deform_conv2d_emulated` and
:func:`modulated_deform_conv2d_vjp_emulated` make the same products on the
CPU (tests/test_torch_dcn_tc.py holds them to the plain versions); no model
calls them.
"""

from __future__ import annotations

import torch

from . import _native
from .dcn import (deform_im2col, modulated_deform_conv2d,
                  modulated_deform_conv2d_vjp)
from .fused_conv import PAIR_ROUTES, _split

__all__ = ["modulated_deform_conv2d_fused", "modulated_deform_conv2d_fused_vjp",
           "DCNFn", "modulated_deform_conv2d_emulated",
           "modulated_deform_conv2d_vjp_emulated", "offsets_written_whole",
           "DCN_CHUNK", "DCN_BWD_MAX_COUT"]

# input channels a K step of the forward and a block of the adjoint
# (csrc/dcn.cuh kCk)
DCN_CHUNK = 64
# the adjoint holds a block's g tile and its weight slice, Cout padded to
# 64 or 128, in shared memory
DCN_BWD_MAX_COUT = 128


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


def offsets_written_whole(x, deform_groups: int) -> bool:
    """Whether the adjoint writes doffset and dmask whole (so they need no
    zeroing): when a deform group's width is a multiple of 4 and x's rows
    are 16-byte aligned (its corners are read as float4 runs), and no
    group crosses a 64-channel chunk (a block's), each (pixel, group, tap)
    is summed in one block and stored; otherwise each is added by
    atomics.  The C entry point refuses unzeroed buffers where they are
    not written whole (csrc/dcn_bwd.cu)."""
    cin = x.shape[-1]
    cg = cin // deform_groups
    if cg % 4 or x.data_ptr() % 16:
        return False
    return all(g * cg // DCN_CHUNK == ((g + 1) * cg - 1) // DCN_CHUNK
               for g in range(deform_groups))


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
    _check(x, offset, mask, weight, deform_groups)
    if bias is not None:
        _native.require(bias, "bias", x.device, (weight.shape[3],))
    out = launch_forward(_native.lib().fcvsr_dcn3x3, x, offset, mask, weight,
                         bias, deform_groups)
    modulated_deform_conv2d_fused.launches += 1
    return out


modulated_deform_conv2d_fused.launches = 0


def launch_forward(fn, x, offset, mask, weight, bias, deform_groups: int):
    """One launch of the forward entry point ``fn`` on checked operands
    (the wrapper's, or a variant's in ``benchmarks/dcn_ab.py``)."""
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    with _native.launch_guard(x) as stream:
        rc = fn(x.data_ptr(), offset.data_ptr(), _native.ptr(mask),
                weight.data_ptr(), _native.ptr(bias), out.data_ptr(), b, h, w,
                cin, cout, deform_groups, stream)
    _native.check(rc, "dcn3x3")
    return out


def modulated_deform_conv2d_fused_vjp(x, offset, mask, weight, bias, g,
                                      deform_groups: int = 1):
    """Adjoint of the 3x3 DCN at the cotangent ``g`` (B, H, W, Cout), shapes
    as in :func:`modulated_deform_conv2d_fused`; ``bias`` only says whether
    there is one.  Returns (dx, doffset, dmask, dweight, dbias), dmask None
    without a mask and dbias None without a bias.  On CUDA tensors one
    launch; on CPU tensors the plain VJP."""
    if _native.on_cpu(x):
        return modulated_deform_conv2d_vjp(x, offset, mask, weight, bias, g,
                                           deform_groups)
    b, h, w, cin, cout = _check(x, offset, mask, weight, deform_groups)
    if cout > DCN_BWD_MAX_COUT:
        raise ValueError(f"the DCN adjoint takes Cout <= {DCN_BWD_MAX_COUT}, "
                         f"got {cout}")
    _native.require(g, "g", x.device, (b, h, w, cout))
    out = launch_adjoint(_native.lib().fcvsr_dcn3x3_bwd, x, offset, mask,
                         weight, bias is not None, g, deform_groups)
    modulated_deform_conv2d_fused_vjp.launches += 1
    return out


modulated_deform_conv2d_fused_vjp.launches = 0


def launch_adjoint(fn, x, offset, mask, weight, has_bias: bool, g,
                   deform_groups: int):
    """One launch of the adjoint entry point ``fn`` on checked operands:
    dx, dweight and dbias, which blocks add into, zeroed (dweight and dbias
    in one buffer, one memset); doffset and dmask zeroed only where the
    kernel adds into them (:func:`offsets_written_whole`)."""
    cout = weight.shape[3]
    dx = torch.zeros_like(x)
    dwb = weight.new_zeros(weight.numel() + (cout if has_bias else 0))
    dw = dwb[:weight.numel()].view(weight.shape)
    db = dwb[weight.numel():] if has_bias else None
    whole = offsets_written_whole(x, deform_groups)
    new = torch.empty_like if whole else torch.zeros_like
    doff = new(offset)
    dmask = None if mask is None else new(mask)
    b, h, w, cin = x.shape
    with _native.launch_guard(x) as stream:
        rc = fn(x.data_ptr(), offset.data_ptr(), _native.ptr(mask),
                weight.data_ptr(), g.data_ptr(), dx.data_ptr(),
                doff.data_ptr(), _native.ptr(dmask), dw.data_ptr(),
                _native.ptr(db), b, h, w, cin, cout, deform_groups,
                int(not whole), stream)
    _native.check(rc, "dcn3x3_bwd")
    return dx, doff, dmask, dw, db


def _route_products(a, b, route: str, equation: str):
    """einsum(equation, a, b) as a tensor-core ``route`` makes it
    (``fused_conv.PAIR_ROUTES``): both factors rounded on their bits and
    split into hi and lo parts, the route's products summed in float32."""
    drop, products = PAIR_ROUTES[route]
    pa, pb = _split(a.float(), drop), _split(b.float(), drop)
    return sum(torch.einsum(equation, pa[i], pb[j]) for i, j in products)


def _cols(x, offset, mask, deform_groups: int):
    """m * s: the sampled values times the mask, (B, H, W, 9, Cin)."""
    cols = deform_im2col(x, offset, deform_groups=deform_groups)
    if mask is None:
        return cols
    b, h, w, k, cin = cols.shape
    m = mask.reshape(b, h, w, deform_groups, k).transpose(3, 4)
    return cols * m.repeat_interleave(cin // deform_groups, dim=-1)


def modulated_deform_conv2d_emulated(x, offset, mask, weight, bias=None,
                                     deform_groups: int = 1,
                                     route: str = "bf16x3"):
    """:func:`modulated_deform_conv2d` (3x3, stride 1, padding 1) with the
    contraction cols x W as ``route`` makes it; K7 takes "bf16x3".  The CPU
    test of the route (tests/test_torch_dcn_tc.py); no model calls it."""
    cols = _cols(x, offset, mask, deform_groups)
    out = _route_products(cols, weight.reshape(9, *weight.shape[2:]), route,
                          "bhwkc,kco->bhwo")
    return out if bias is None else out + bias


def modulated_deform_conv2d_vjp_emulated(x, offset, mask, weight, bias, g,
                                         deform_groups: int = 1,
                                         route: str = "bf16x3"):
    """:func:`modulated_deform_conv2d_vjp` with its two contractions as
    ``route`` makes them, as K8 does: u = g W^T, from which dx, doffset and
    dmask follow in float32 (they are the adjoint of cols = m s at u), and
    dW = cols^T g; dbias = sum of g.  Returns (dx, doffset, dmask,
    dweight, dbias) like the plain VJP.  The CPU test of the route; no model
    calls it."""
    w9 = weight.reshape(9, *weight.shape[2:])
    u = _route_products(g, w9, route, "bhwo,kco->bhwkc")
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_()
               for t in (x, offset, mask)]
        cols = _cols(*ins, deform_groups)
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(cols, live, u))
    dx, doff, dmask = (None if t is None else next(grads) for t in ins)
    dw = _route_products(cols.detach(), g, route, "bhwkc,bhwo->kco")
    db = None if bias is None else g.sum((0, 1, 2))
    return dx, doff, dmask, dw.reshape(weight.shape), db
