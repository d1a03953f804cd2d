"""Wrappers of the 3x3 conv kernels (``csrc/conv3x3.cu``) and their plain
versions.

Counterpart of ``fcvsr_tpu.ops.pallas_conv``'s ``conv3x3_rows`` (with
``conv3x3_rows_nhwc``) and ``conv3x3_pair_rows``.  The TPU kernels carry a
zero-ringed "rows" layout; here tensors stay NHWC and the kernels pad with
zeros themselves.  Weights are HWIO (3, 3, Cin, Cout), the layout the kernels
read; :func:`prep_weight` makes it from a torch OIHW weight once.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain version.  ``conv3x3.launches`` and
``conv3x3_pair.launches`` count kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _native

__all__ = ["conv3x3", "conv3x3_pair", "conv3x3_plain", "conv3x3_pair_plain",
           "prep_weight"]


def prep_weight(weight_oihw: torch.Tensor) -> torch.Tensor:
    """torch OIHW (Cout, Cin, 3, 3) -> contiguous HWIO (3, 3, Cin, Cout)."""
    return weight_oihw.permute(2, 3, 1, 0).contiguous()


def _conv_plain(x, w_hwio, bias):
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), bias,
                 padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x, w_hwio, bias=None, res=None, act: bool = False,
                  neg_slope: float = 0.2):
    """act(conv3x3_same(x) + bias + res), NHWC."""
    y = _conv_plain(x, w_hwio, bias)
    if res is not None:
        y = y + res
    return F.leaky_relu(y, neg_slope) if act else y


def conv3x3_pair_plain(x, w1, b1, w2, b2, ns1: float = 0.2):
    """conv2(leaky_relu_ns1(conv1(x) + b1)) + b2, NHWC, SAME zero padding of
    both convs."""
    return _conv_plain(F.leaky_relu(_conv_plain(x, w1, b1), ns1), w2, b2)


def _check_weight(w, b, cin, name, dev):
    _native.require(w, name, dev)
    if w.shape[:3] != (3, 3, cin):
        raise ValueError(f"{name} has shape {tuple(w.shape)}, expected "
                         f"(3, 3, {cin}, Cout)")
    if b is not None:
        _native.require(b, f"{name} bias", dev, (w.shape[3],))
    return w.shape[3]


def conv3x3(x, w_hwio, bias=None, res=None, act: bool = False,
            neg_slope: float = 0.2):
    """act(conv3x3_same(x) + bias + res).  x: (B, H, W, Cin); w_hwio:
    (3, 3, Cin, Cout); bias: (Cout,) or None; res: (B, H, W, Cout) or None,
    added before the optional leaky relu."""
    if _native.on_cpu(x):
        return conv3x3_plain(x, w_hwio, bias, res, act, neg_slope)
    b, h, w, cin = x.shape
    dev = x.device
    _native.require(x, "x", dev)
    cout = _check_weight(w_hwio, bias, cin, "w", dev)
    if res is not None:
        _native.require(res, "res", dev, (b, h, w, cout))
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    rc = lib.fcvsr_conv3x3(
        x.data_ptr(), w_hwio.data_ptr(), _native.ptr(bias), _native.ptr(res),
        out.data_ptr(), b, h, w, cin, cout, int(act), float(neg_slope),
        _native.stream_ptr(dev))
    _native.check(rc, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def conv3x3_pair(x, w1, b1, w2, b2, ns1: float = 0.2):
    """conv2(leaky_relu_ns1(conv1(x) + b1)) + b2 in one kernel, the
    intermediate on chip.  x: (B, H, W, Cin); w1: (3, 3, Cin, C1); w2:
    (3, 3, C1, Cout); b1/b2: (C1,)/(Cout,) or None."""
    if _native.on_cpu(x):
        return conv3x3_pair_plain(x, w1, b1, w2, b2, ns1)
    b, h, w, cin = x.shape
    dev = x.device
    _native.require(x, "x", dev)
    c1 = _check_weight(w1, b1, cin, "w1", dev)
    cout = _check_weight(w2, b2, c1, "w2", dev)
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    rc = lib.fcvsr_conv3x3_pair(
        x.data_ptr(), w1.data_ptr(), _native.ptr(b1), w2.data_ptr(),
        _native.ptr(b2), out.data_ptr(), b, h, w, cin, c1, cout, float(ns1),
        _native.stream_ptr(dev))
    _native.check(rc, "conv3x3_pair")
    conv3x3_pair.launches += 1
    return out


conv3x3_pair.launches = 0
