"""Deformable convolution v1/v2, the plain exact version (counterpart of
``fcvsr_tpu.ops.dcn``'s gather path, ``_gather_forward``).

    out(p) = bias + sum_k W_k * m_k(p) * x(p0 + k + dp_k(p))

with bilinear sampling and zero padding outside the frame.  Offset channels
are laid out (deform_group, k, [dy, dx]) and mask channels (deform_group, k),
as mmcv's ModulatedDeformConv2d reads them.  Each deform group samples only
its own Cin / deform_groups channels: the JAX package samples whole rows at
every group's positions, a TPU gather trick that costs deform_groups times
the memory.  All tensors are channels-last; the weight is HWIO.

This is the plain version of the CUDA kernels of ``ops.fused_dcn``: CPU
tensors run it, under ordinary autograd, and :func:`modulated_deform_conv2d_vjp`
(autograd through it) is the plain version of the adjoint kernel.
"""

from __future__ import annotations

import torch

from .warp import grid_sample_bilinear

__all__ = ["deform_im2col", "modulated_deform_conv2d", "deform_conv2d",
           "modulated_deform_conv2d_vjp"]


def deform_im2col(x, offset, kernel_size=(3, 3), stride: int = 1,
                  padding: int = 1, dilation: int = 1, deform_groups: int = 1):
    """Deformed samples of ``x`` (B, H, W, C) at ``offset`` (B, Ho, Wo,
    dg * K * 2).  Returns (B, Ho, Wo, K, C)."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    k = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dg = deform_groups
    cg = c // dg
    off = offset.reshape(b, ho, wo, dg, k, 2)

    def ar(n, step):
        return torch.arange(n, device=x.device, dtype=x.dtype) * step

    base_y = ar(ho, stride) - padding
    base_x = ar(wo, stride) - padding
    tap_y = ar(kh, dilation).repeat_interleave(kw)
    tap_x = ar(kw, dilation).repeat(kh)
    # sample positions (B, Ho, Wo, dg, K)
    py = base_y[:, None, None, None] + tap_y + off[..., 0]
    px = base_x[:, None, None] + tap_x + off[..., 1]
    # one gather per group over its own channels: (B * dg, Ho * Wo * K, cg)
    xg = x.reshape(b, h, w, dg, cg).permute(0, 3, 1, 2, 4) \
        .reshape(b * dg, h, w, cg)
    s = grid_sample_bilinear(
        xg, px.permute(0, 3, 1, 2, 4).reshape(b * dg, ho * wo * k),
        py.permute(0, 3, 1, 2, 4).reshape(b * dg, ho * wo * k))
    s = s.reshape(b, dg, ho, wo, k, cg).permute(0, 2, 3, 4, 1, 5)
    return s.reshape(b, ho, wo, k, c)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None,
                            stride: int = 1, padding: int = 1,
                            dilation: int = 1, groups: int = 1,
                            deform_groups: int = 1):
    """DCNv2 (DCNv1 with ``mask=None``).  x: (B, H, W, Cin); offset: (B, Ho,
    Wo, dg * K * 2); mask: (B, Ho, Wo, dg * K), already sigmoided, or None;
    weight: (kh, kw, Cin // groups, Cout).  Returns (B, Ho, Wo, Cout)."""
    kh, kw, cin_g, cout = weight.shape
    k = kh * kw
    cin = x.shape[-1]
    cols = deform_im2col(x, offset, (kh, kw), stride, padding, dilation,
                         deform_groups)                   # (B, Ho, Wo, K, Cin)
    b, ho, wo = cols.shape[:3]
    if mask is not None:
        m = mask.reshape(b, ho, wo, deform_groups, k).transpose(3, 4)
        cols = cols * m.repeat_interleave(cin // deform_groups, dim=-1)
    if groups == 1:
        out = cols.reshape(b * ho * wo, k * cin) @ weight.reshape(k * cin, cout)
    else:
        # group g reads input slice g and writes output channels
        # [g * opg, (g + 1) * opg)
        opg = cout // groups
        cols = cols.reshape(b * ho * wo, k, groups, cin_g)
        wk = weight.reshape(k, cin_g, groups, opg)
        out = torch.einsum("nkgc,kcgo->ngo", cols, wk)
    out = out.reshape(b, ho, wo, cout)
    return out if bias is None else out + bias


def deform_conv2d(x, offset, weight, bias=None, stride: int = 1,
                  padding: int = 1, dilation: int = 1, groups: int = 1,
                  deform_groups: int = 1):
    """DCNv1: :func:`modulated_deform_conv2d` without a mask."""
    return modulated_deform_conv2d(x, offset, None, weight, bias, stride,
                                   padding, dilation, groups, deform_groups)


def modulated_deform_conv2d_vjp(x, offset, mask, weight, bias, g,
                                deform_groups: int = 1):
    """The plain adjoint of the 3x3 / stride 1 / padding 1 configuration:
    ``torch.autograd.grad`` of :func:`modulated_deform_conv2d` at the
    cotangent ``g`` (B, H, W, Cout).  Returns (dx, doffset, dmask, dweight,
    dbias), dmask None without a mask and dbias None without a bias."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_()
               for t in (x, offset, mask, weight, bias)]
        out = modulated_deform_conv2d(*ins, deform_groups=deform_groups)
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(out, live, g))
    return tuple(None if t is None else next(grads) for t in ins)
