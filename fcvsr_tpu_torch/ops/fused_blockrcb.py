"""Wrapper of the BlockRCB level kernel (``csrc/blockrcb.cu``) and its plain
version.

Counterpart of ``benchmarks/microbench_blockrcb_kernel.py::block_rcb_rows``
in the JAX package: one BlockRCB level, the four chained 3x3 convs, the
ContextBlock and the residual, in one launch: K6's two conv-pair phases on
the tensor cores (one bf16 product a k step: the weights are rounded to
bf16), then the ContextBlock.  The JAX package keeps it as
an A/B benchmark against the unfused path and wires it into no model; so
does the port (``fcvsr_tpu_torch.benchmarks.microbench_blockrcb_kernel``).
There is no rows layout here: maps are NHWC (B, H, W, C) bf16, any H and W,
and weights are HWIO float32 as the other conv wrappers take them.

On a CUDA tensor :func:`block_rcb` launches the kernel (or raises); on a
CPU tensor it runs :func:`block_rcb_plain`.  ``block_rcb.launches`` counts
the launches; ``ops.launch_counts()`` counts the model paths' kernels, and no
model path runs this one.  Inference only: under autograd it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _native
from .fused_conv import PAIR_MAX_CHANNELS, _check_weight, _conv_plain

__all__ = ["block_rcb", "block_rcb_plain"]


def _bf16_weight(w):
    return w.to(torch.bfloat16).float()


def block_rcb_plain(x, wb0, bb0, wb1, bb1, wr0, wr1, w_mask, w_add0, w_add1,
                    ns_body: float = 0.1):
    """One BlockRCB level, rounding where the kernel rounds: every conv's
    weights to bf16 (sums in float32), a, y, a' and r stored as bf16, the
    logits and the pooled context taken from the bf16 r, one rounding of
    the output::

        a   = lrelu_ns_body(conv(x, wb0) + bb0)
        y   = conv(a, wb1) + bb1
        r   = conv(lrelu_0.2(conv(y, wr0)), wr1)
        ctx = sum_p softmax_p(r[p] . w_mask) r[p]
        out = y + lrelu_0.2(r + lrelu_0.2(ctx @ w_add0) @ w_add1)

    x: (B, H, W, C) bf16; wb0 (3, 3, C, C1), wb1 (3, 3, C1, C), wr0, wr1
    (3, 3, C, C); bb0 (C1,) and bb1 (C,) or None; w_mask (C,); w_add0,
    w_add1 (C, C) laid out (in, out).  Returns (B, H, W, C) bf16."""
    bf16 = torch.bfloat16
    a = F.leaky_relu(_conv_plain(x.float(), _bf16_weight(wb0), bb0),
                     ns_body).to(bf16)
    y = _conv_plain(a.float(), _bf16_weight(wb1), bb1).to(bf16)
    a = F.leaky_relu(_conv_plain(y.float(), _bf16_weight(wr0), None),
                     0.2).to(bf16)
    r = _conv_plain(a.float(), _bf16_weight(wr1), None).to(bf16).float()
    b, h, w, c = r.shape
    p = torch.softmax((r @ w_mask).reshape(b, h * w), dim=1)
    ctx = torch.einsum("bpc,bp->bc", r.reshape(b, h * w, c), p)
    t = F.leaky_relu(ctx @ w_add0, 0.2) @ w_add1
    return (y.float() + F.leaky_relu(r + t[:, None, None, :], 0.2)).to(bf16)


def block_rcb(x, wb0, bb0, wb1, bb1, wr0, wr1, w_mask, w_add0, w_add1,
              ns_body: float = 0.1, scratch=None):
    """:func:`block_rcb_plain`'s function in one cooperative launch on a
    CUDA tensor; the plain version on a CPU tensor.  bf16 maps only (a
    TypeError otherwise); serving only (it raises under autograd).  On the
    card C is at most 64 and C1 at most 128, what K2's loop takes (a
    ValueError beyond).  ``scratch``: (y, r), two (B, H, W, C) bf16
    buffers the kernel writes the level's y and r into (made when None),
    so that a caller can read them."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"block_rcb stores its maps as bfloat16, not "
                        f"{x.dtype}")
    if _native.records(x, wb0, bb0, wb1, bb1, wr0, wr1, w_mask, w_add0,
                       w_add1):
        raise RuntimeError(
            "block_rcb is a serving kernel with no backward: train through "
            "conv3x3_pair and the ContextBlock, or run under torch.no_grad()")
    if _native.on_cpu(x):
        return block_rcb_plain(x, wb0, bb0, wb1, bb1, wr0, wr1, w_mask,
                               w_add0, w_add1, ns_body)
    b, h, w, c = x.shape
    dev = x.device
    _native.require(x, "x", dev, dtype=x.dtype)
    c1 = _check_weight(wb0, bb0, c, "wb0", dev)
    for name, wt, bias, cin in (("wb1", wb1, bb1, c1), ("wr0", wr0, None, c),
                                ("wr1", wr1, None, c)):
        if _check_weight(wt, bias, cin, name, dev) != c:
            raise ValueError(f"{name} has shape {tuple(wt.shape)}, expected "
                             f"(3, 3, {cin}, {c})")
    _native.require(w_mask, "w_mask", dev, (c,))
    _native.require(w_add0, "w_add0", dev, (c, c))
    _native.require(w_add1, "w_add1", dev, (c, c))
    max_c, max_c1 = PAIR_MAX_CHANNELS[:2]  # its conv phases run K2's loop
    if c > max_c or c1 > max_c1:
        raise ValueError(f"block_rcb's kernel takes C up to {max_c} and C1 "
                         f"up to {max_c1}, not {c} and {c1}")
    if scratch is None:
        scratch = (torch.empty_like(x), torch.empty_like(x))
    for name, t in zip(("y", "r"), scratch):
        _native.require(t, f"scratch {name}", dev, x.shape, dtype=x.dtype)
    y, r = scratch
    out = torch.empty_like(x)
    lib = _native.lib()
    with _native.launch_guard(x) as stream:
        # one row of softmax partials a block of the launch and image
        grid = ctypes.c_int(0)
        _native.check(lib.fcvsr_blockrcb_grid(b, h, w, c, c1,
                                              ctypes.byref(grid)),
                      "blockrcb (grid)")
        part = torch.empty((grid.value, b, c + 2), device=dev,
                           dtype=torch.float32)
        rc = lib.fcvsr_blockrcb(
            x.data_ptr(), wb0.data_ptr(), _native.ptr(bb0), wb1.data_ptr(),
            _native.ptr(bb1), wr0.data_ptr(), wr1.data_ptr(),
            w_mask.data_ptr(), w_add0.data_ptr(), w_add1.data_ptr(),
            y.data_ptr(), r.data_ptr(), out.data_ptr(), part.data_ptr(),
            grid.value, b, h, w, c, c1, float(ns_body), stream)
    _native.check(rc, "blockrcb")
    block_rcb.launches += 1
    return out


block_rcb.launches = 0
