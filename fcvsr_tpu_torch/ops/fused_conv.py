"""Wrappers of the 3x3 conv kernels (``csrc/conv3x3.cu``,
``csrc/conv3x3_quad.cu``) and their plain versions.

Counterpart of ``fcvsr_tpu.ops.pallas_conv``'s ``conv3x3_rows`` (with
``conv3x3_rows_nhwc``), ``conv3x3_pair_rows`` and ``conv3x3_quad_rows``.  The TPU kernels carry a
zero-ringed "rows" layout; here tensors stay NHWC and the kernels pad with
zeros themselves.  Weights are HWIO (3, 3, Cin, Cout), the layout the kernels
read; :func:`prep_weight` makes it from a torch OIHW weight once.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain version, under ordinary autograd.  ``conv3x3.launches``,
``conv3x3_pair.launches`` and ``conv3x3_quad.launches`` count kernel
launches.

Storage: the maps (x, res, the outputs, and the pair's intermediate) are
float32 or bfloat16, weights and biases float32.  The quad kernel computes
in float32; the conv's and the pair's kernels multiply on the tensor cores,
in bf16 parts with float32 sums, within 3 x 2^-16 of each product
(:func:`conv3x3_emulated`, :func:`conv3x3_pair_emulated`).  All round where
they store; the plain versions compute in float32 and round at the same
handoffs: the pair's intermediate and each output.
bf16 and :func:`conv3x3_quad` are serving options: under autograd the
wrappers take float32 only and the quad raises.

Training: on a CUDA tensor that autograd records, a wrapper runs its
``autograd.Function`` (:class:`Conv3x3Fn`, :class:`Conv3x3PairFn`): the
forward is the kernel, the backward the exact conv VJP
(``aten.convolution_backward``, cuDNN).  No TPU kernel exists for a conv
backward: the JAX package trains with XLA's.  The pair's backward rebuilds
its intermediate ``lrelu(conv1(x) + b1)`` with one conv3x3 launch, so its
forward keeps only x (a pair costs one pair and one conv launch a step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _native

__all__ = ["conv3x3", "conv3x3_pair", "conv3x3_quad", "conv3x3_plain",
           "conv3x3_pair_plain", "conv3x3_quad_plain", "prep_weight",
           "conv3x3_emulated", "conv3x3_pair_emulated", "PAIR_ROUTES",
           "CONV_MAX_CIN", "PAIR_MAX_CHANNELS", "Conv3x3Fn", "Conv3x3PairFn"]


def prep_weight(weight_oihw: torch.Tensor) -> torch.Tensor:
    """torch OIHW (Cout, Cin, 3, 3) -> contiguous HWIO (3, 3, Cin, Cout)."""
    return weight_oihw.permute(2, 3, 1, 0).contiguous()


def _conv_plain(x, w_hwio, bias):
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), bias,
                 padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x, w_hwio, bias=None, res=None, act: bool = False,
                  neg_slope: float = 0.2):
    """act(conv3x3_same(x) + bias + res), NHWC, in x's storage type."""
    y = _conv_plain(x.float(), w_hwio, bias)
    if res is not None:
        y = y + res.float()
    return (F.leaky_relu(y, neg_slope) if act else y).to(x.dtype)


def conv3x3_pair_plain(x, w1, b1, w2, b2, ns1: float = 0.2):
    """conv2(leaky_relu_ns1(conv1(x) + b1)) + b2, NHWC, SAME zero padding of
    both convs; the intermediate and the output in x's storage type."""
    mid = F.leaky_relu(_conv_plain(x.float(), w1, b1), ns1).to(x.dtype)
    return _conv_plain(mid.float(), w2, b2).to(x.dtype)


def _round_bits(t, drop: int):
    """float32 ``t`` rounded to nearest even with its low ``drop`` mantissa
    bits cleared, on the bits: 16 gives bf16's 8 significant bits, 13
    TF32's 11."""
    bits = t.float().contiguous().view(torch.int32)
    bits = bits + ((1 << (drop - 1)) - 1) + ((bits >> drop) & 1)
    return (bits & ~((1 << drop) - 1)).view(torch.float32)


def _split(t, drop: int):
    """(hi, lo): ``t``'s rounding and the rounding of what is left."""
    hi = _round_bits(t, drop)
    return hi, _round_bits(t - hi, drop)


# route -> (low mantissa bits dropped, products: (map part, weight part),
# 0 the high part, 1 the low)
PAIR_ROUTES = {
    "tf32": (13, ((0, 0),)),
    "3xtf32": (13, ((0, 0), (0, 1), (1, 0))),
    "bf16": (16, ((0, 0),)),
    "bf16x3": (16, ((0, 0), (0, 1), (1, 0))),
    "bf16_w2": (16, ((0, 0), (0, 1))),
}


def _conv_route(a, w, bias, route: str):
    """conv3x3_same(a, w) + bias with the products a tensor-core route
    makes: the map and the weights rounded to TF32 or bf16 (on their bits,
    to nearest even), each split into its rounding (hi) and the rounding of
    the rest (lo), the route's products of the parts summed in float32
    (:data:`PAIR_ROUTES`; a product of two such parts is exact in
    float32)."""
    drop, products = PAIR_ROUTES[route]
    parts_a, parts_w = _split(a.float(), drop), _split(w, drop)
    y = sum(_conv_plain(parts_a[i], parts_w[j], None) for i, j in products)
    return y if bias is None else y + bias


def conv3x3_emulated(x, w_hwio, bias=None, res=None, act: bool = False,
                     neg_slope: float = 0.2, route: str = "bf16x3"):
    """:func:`conv3x3_plain` with its products as ``route`` makes them
    (:func:`_conv_route`).  K3's kernel takes "bf16x3" for float32 maps and
    "bf16_w2" for bf16 maps.  The CPU test of the route
    (tests/test_torch_conv_tc.py); no model calls it."""
    y = _conv_route(x, w_hwio, bias, route)
    if res is not None:
        y = y + res.float()
    return (F.leaky_relu(y, neg_slope) if act else y).to(x.dtype)


def conv3x3_pair_emulated(x, w1, b1, w2, b2, ns1: float = 0.2,
                          route: str = "bf16x3"):
    """:func:`conv3x3_pair_plain` with each conv's products as a tensor-core
    route makes them (:func:`_conv_route`).  K2's kernel takes "bf16x3" for
    float32 maps and "bf16_w2" for bf16 maps (whose parts are exact: their
    lo is 0).  The intermediate and the output are in x's storage type.
    The CPU test of the choice (tests/test_torch_conv_tc.py); no model
    calls it."""
    mid = F.leaky_relu(_conv_route(x, w1, b1, route), ns1).to(x.dtype)
    return _conv_route(mid, w2, b2, route).to(x.dtype)


def conv3x3_quad_plain(x, w1, b1, w2, b2, w3, b3, w4, b4, ns1: float = 0.1,
                       ns3: float = 0.2):
    """(y, out): y = conv3x3_pair_plain(x, w1, b1, w2, b2, ns1), out =
    conv3x3_pair_plain(y, w3, b3, w4, b4, ns3), a BlockRCB body."""
    y = conv3x3_pair_plain(x, w1, b1, w2, b2, ns1)
    return y, conv3x3_pair_plain(y, w3, b3, w4, b4, ns3)


def _conv_vjp(g, x, w_hwio, has_bias: bool, need_x: bool = True):
    """(dx, dw, db) of conv3x3_same(x, w) + b at the cotangent g, NHWC /
    HWIO; dx is None unless ``need_x``, db None without a bias."""
    gx, gw, gb = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
        w_hwio.permute(3, 2, 0, 1), [w_hwio.shape[3]] if has_bias else None,
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [need_x, True, has_bias])
    return (None if gx is None else gx.permute(0, 2, 3, 1),
            gw.permute(2, 3, 1, 0), gb)


def _lrelu_vjp(g, y, neg_slope: float):
    """The leaky relu's adjoint, masked by its output y (same sign as its
    input for a positive slope)."""
    return torch.where(y > 0, g, neg_slope * g)


class Conv3x3Fn(torch.autograd.Function):
    """:func:`conv3x3` under autograd: the kernel forward, the exact conv
    VJP backward."""

    @staticmethod
    def forward(ctx, x, w_hwio, bias, res, act: bool, neg_slope: float):
        out = conv3x3(x, w_hwio, bias, res, act, neg_slope)
        ctx.save_for_backward(x, w_hwio, out if act else None)
        ctx.has_bias, ctx.has_res = bias is not None, res is not None
        ctx.act, ctx.neg_slope = act, neg_slope
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_hwio, out = ctx.saved_tensors
        if ctx.act:
            g = _lrelu_vjp(g, out, ctx.neg_slope)
        gx, gw, gb = _conv_vjp(g, x, w_hwio, ctx.has_bias,
                               ctx.needs_input_grad[0])
        return gx, gw, gb, g if ctx.has_res else None, None, None


class Conv3x3PairFn(torch.autograd.Function):
    """:func:`conv3x3_pair` under autograd: the pair kernel forward; the
    backward rebuilds the intermediate with the conv3x3 kernel, then takes
    both convs' exact VJPs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ns1: float):
        out = conv3x3_pair(x, w1, b1, w2, b2, ns1)
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.has_b2, ctx.ns1 = b2 is not None, ns1
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        mid = conv3x3(x, w1, b1, act=True, neg_slope=ctx.ns1)
        gmid, gw2, gb2 = _conv_vjp(g, mid, w2, ctx.has_b2)
        gx, gw1, gb1 = _conv_vjp(_lrelu_vjp(gmid, mid, ctx.ns1), x, w1,
                                 b1 is not None, ctx.needs_input_grad[0])
        return gx, gw1, gb1, gw2, gb2, None


def _train_f32(x, name):
    if x.dtype != torch.float32:
        raise RuntimeError(
            f"{name} trains in float32, not {x.dtype}: bf16 storage is a "
            "serving option (run under torch.no_grad())")


def _check_weight(w, b, cin, name, dev):
    _native.require(w, name, dev)
    if w.shape[:3] != (3, 3, cin):
        raise ValueError(f"{name} has shape {tuple(w.shape)}, expected "
                         f"(3, 3, {cin}, Cout)")
    if b is not None:
        _native.require(b, f"{name} bias", dev, (w.shape[3],))
    return w.shape[3]


# the input channels K3's kernel takes (its shared memory holds four window
# rows of Cin and every tap's weights; csrc/conv3x3.cu)
CONV_MAX_CIN = 64


def conv3x3(x, w_hwio, bias=None, res=None, act: bool = False,
            neg_slope: float = 0.2):
    """act(conv3x3_same(x) + bias + res).  x: (B, H, W, Cin); w_hwio:
    (3, 3, Cin, Cout); bias: (Cout,) or None; res: (B, H, W, Cout) or None,
    added before the optional leaky relu.  On the card Cin is at most
    :data:`CONV_MAX_CIN` (larger raise).  On a CUDA tensor that autograd
    records it runs :class:`Conv3x3Fn`.  The kernel's products:
    :func:`conv3x3_emulated`."""
    if _native.on_cpu(x):
        return conv3x3_plain(x, w_hwio, bias, res, act, neg_slope)
    if _native.records(x, w_hwio, bias, res):
        _train_f32(x, "conv3x3")
        return Conv3x3Fn.apply(x, w_hwio, bias, res, act, neg_slope)
    b, h, w, cin = x.shape
    dev = x.device
    _native.require(x, "x", dev, dtype=x.dtype)
    cout = _check_weight(w_hwio, bias, cin, "w", dev)
    if cin > CONV_MAX_CIN:
        raise ValueError(f"conv3x3's kernel takes Cin up to {CONV_MAX_CIN}, "
                         f"got {cin}")
    if res is not None:
        _native.require(res, "res", dev, (b, h, w, cout), dtype=x.dtype)
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    with _native.launch_guard(x) as stream:
        rc = lib.fcvsr_conv3x3(
            x.data_ptr(), w_hwio.data_ptr(), _native.ptr(bias),
            _native.ptr(res), out.data_ptr(), b, h, w, cin, cout, int(act),
            float(neg_slope), _native.storage(x), stream)
    _native.check(rc, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


# the channels K2's kernel takes (its shared memory holds three window rows
# of Cin and three intermediate rows of C1; csrc/conv3x3.cu)
PAIR_MAX_CHANNELS = (64, 128, 64)


def conv3x3_pair(x, w1, b1, w2, b2, ns1: float = 0.2):
    """conv2(leaky_relu_ns1(conv1(x) + b1)) + b2 in one kernel, the
    intermediate on chip.  x: (B, H, W, Cin); w1: (3, 3, Cin, C1); w2:
    (3, 3, C1, Cout); b1/b2: (C1,)/(Cout,) or None.  On the card Cin, C1
    and Cout are at most :data:`PAIR_MAX_CHANNELS` (larger raise).  On a
    CUDA tensor that autograd records it runs :class:`Conv3x3PairFn`.
    The kernel's products: :func:`conv3x3_pair_emulated`."""
    if _native.on_cpu(x):
        return conv3x3_pair_plain(x, w1, b1, w2, b2, ns1)
    if _native.records(x, w1, b1, w2, b2):
        _train_f32(x, "conv3x3_pair")
        return Conv3x3PairFn.apply(x, w1, b1, w2, b2, ns1)
    b, h, w, cin = x.shape
    dev = x.device
    _native.require(x, "x", dev, dtype=x.dtype)
    c1 = _check_weight(w1, b1, cin, "w1", dev)
    cout = _check_weight(w2, b2, c1, "w2", dev)
    if any(c > m for c, m in zip((cin, c1, cout), PAIR_MAX_CHANNELS)):
        raise ValueError(
            f"conv3x3_pair's kernel takes (Cin, C1, Cout) up to "
            f"{PAIR_MAX_CHANNELS}, got {(cin, c1, cout)}")
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    with _native.launch_guard(x) as stream:
        rc = lib.fcvsr_conv3x3_pair(
            x.data_ptr(), w1.data_ptr(), _native.ptr(b1), w2.data_ptr(),
            _native.ptr(b2), out.data_ptr(), b, h, w, cin, c1, cout,
            float(ns1), _native.storage(x), stream)
    _native.check(rc, "conv3x3_pair")
    conv3x3_pair.launches += 1
    return out


conv3x3_pair.launches = 0


def conv3x3_quad(x, w1, b1, w2, b2, w3, b3, w4, b4, ns1: float = 0.1,
                 ns3: float = 0.2):
    """(y, out) of a BlockRCB body in one kernel: y = conv3x3_pair(x, w1,
    b1, w2, b2, ns1), out = conv3x3_pair(y, w3, b3, w4, b4, ns3), y kept
    on chip for the second pair and also returned (the RCB residual needs
    it).  x: (B, H, W, C); w1..w4 HWIO, each conv's Cin the previous one's
    Cout; biases (Cout,) or None.  Serving only: it raises under
    autograd."""
    if _native.on_cpu(x):
        return conv3x3_quad_plain(x, w1, b1, w2, b2, w3, b3, w4, b4, ns1, ns3)
    if _native.records(x, w1, b1, w2, b2, w3, b3, w4, b4):
        raise RuntimeError(
            "conv3x3_quad is a serving kernel with no backward: train "
            "through conv3x3_pair, or run under torch.no_grad()")
    b, h, w, cin = x.shape
    dev = x.device
    _native.require(x, "x", dev, dtype=x.dtype)
    c1 = _check_weight(w1, b1, cin, "w1", dev)
    c2 = _check_weight(w2, b2, c1, "w2", dev)
    c3 = _check_weight(w3, b3, c2, "w3", dev)
    cout = _check_weight(w4, b4, c3, "w4", dev)
    y = torch.empty((b, h, w, c2), device=dev, dtype=x.dtype)
    out = torch.empty((b, h, w, cout), device=dev, dtype=x.dtype)
    lib = _native.lib()
    with _native.launch_guard(x) as stream:
        rc = lib.fcvsr_conv3x3_quad(
            x.data_ptr(), w1.data_ptr(), _native.ptr(b1), w2.data_ptr(),
            _native.ptr(b2), w3.data_ptr(), _native.ptr(b3), w4.data_ptr(),
            _native.ptr(b4), y.data_ptr(), out.data_ptr(), b, h, w, cin, c1,
            c2, c3, cout, float(ns1), float(ns3), _native.storage(x), stream)
    _native.check(rc, "conv3x3_quad")
    conv3x3_quad.launches += 1
    return y, out


conv3x3_quad.launches = 0
