"""Wrappers of the IAC kernels (``csrc/iac.cu``, ``csrc/iac_chain.cu``,
``csrc/iac_bwd.cu``) and their plain versions.

Counterpart of ``fcvsr_tpu.ops.pallas_iac``'s ``warp_sac_fused``,
``iac_fused``, ``iac_fused_kf``, ``iac_fused_resident`` and
``iac_fused_vjp`` (here :class:`IACChainFn`).  One forward launch of
``iac.cu`` is one exact IAC iteration:

    out = leaky_relu_0.1(sac_k1,k1(flow_warp(feat, flow)) + feat_in)

with the activation skipped when ``act`` is False.  Unlike the TPU kernel
the warp is unbounded (no radius clamp) and nothing constrains H or W.
:func:`iac_fused_resident` runs the whole chain in one launch of
``iac_chain.cu``.  :func:`warp_sac_bwd` is the iteration's exact adjoint
without the residual and the activation, two launches (the SAC adjoint,
then the warp adjoint).

Storage: the serving wrappers take float32 or bfloat16 maps (feat, k, f0,
feat_in; the output has their type) and float32 flows, ``wsel`` and
``bsel``.  The kernels compute in float32 and round where they store; the
plain versions compute in float32 and round each iteration's output to
the maps' type, as the kernels store it.  With fused kernel prediction
the kernel multiplies f0 by Wsel on the tensor cores, in TF32 parts for
float32 maps and bf16 parts for bf16 maps, with float32 sums
(:func:`predict_kernels_emulated`; Wsel's parts are made once a weight
version by :func:`wsel_planes`).  On the card C is at most
:data:`IAC_MAX_CHANNELS` and C0 at most :data:`IAC_MAX_C0`.  bf16 is a
serving option: the training path (:class:`IACChainFn`, the adjoint) is
float32.

Training: on a CUDA tensor that autograd records, :func:`iac_fused` runs
:class:`IACChainFn`, whose forward launches the iterations and keeps each
one's input, and whose backward walks them in reverse: the activation mask
from the kernel's own outputs, the residual's adjoint, then the adjoint
kernels.  (The JAX package re-runs the forward in its VJP instead.)

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the plain version, under ordinary autograd.  ``warp_sac_fused``,
``warp_sac_fused_kf``, ``iac_fused_resident`` and ``warp_sac_bwd`` count
their launches in ``.launches``.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from . import _native
from .fused_conv import PAIR_ROUTES, _split
from .sac import sac
from .warp import flow_warp

__all__ = ["warp_sac_fused", "warp_sac_fused_kf", "warp_sac_bwd", "iac_fused",
           "iac_fused_kf", "iac_fused_resident", "IACChainFn",
           "warp_sac_plain", "iac_chain_plain", "warp_sac_vjp_plain",
           "predict_kernels", "predict_kernels_emulated", "wsel_planes",
           "IAC_MAX_CHANNELS", "IAC_MAX_C0"]

# what K1's kernel takes (csrc/iac.cu): its shared memory holds the warped
# tile of every channel; the prediction's B fragments stay in registers
IAC_MAX_CHANNELS = 128
IAC_MAX_C0 = 64


def predict_kernels(f0, wsel, bsel, it: int, channels: int):
    """k = f0 . wsel + bsel for iteration ``it``'s 3C columns.  f0:
    (B, H, W, C0); wsel: (C0, n*3C); bsel: (n*3C,)."""
    cols = slice(it * 3 * channels, (it + 1) * 3 * channels)
    return torch.einsum("bhwc,ck->bhwk", f0.float(), wsel[:, cols]) \
        + bsel[cols]


def predict_kernels_emulated(f0, wsel, bsel, it: int, channels: int,
                             route: str = "3xtf32"):
    """:func:`predict_kernels` with its products as a tensor-core ``route``
    makes them (``fused_conv.PAIR_ROUTES``): f0 and wsel rounded on their
    bits, split into hi and lo parts, the route's products summed in
    float32.  K1's kf kernel takes "3xtf32" for float32 f0 and "bf16_w2"
    for bf16 f0 (exact in bf16); "bf16x3" misses its bar (the CPU test of
    the route, tests/test_torch_iac_tc.py).  No model calls it."""
    drop, products = PAIR_ROUTES[route]
    cols = slice(it * 3 * channels, (it + 1) * 3 * channels)
    parts_f, parts_w = _split(f0.float(), drop), _split(wsel[:, cols], drop)
    k = sum(torch.einsum("bhwc,ck->bhwk", parts_f[i], parts_w[j])
            for i, j in products)
    return k + bsel[cols]


# (id(wsel), tf32) -> (weakref to wsel, its version, its planes)
_planes = {}


def wsel_planes(wsel, tf32: bool = False):
    """Wsel (C0, K) float32 as the kf kernel's B operand: (2, K, C0P),
    Wsel's transpose rounded (hi) and the rounding of what is left (lo), C0
    padded to C0P, a multiple of 16, with zeros; bfloat16, or with ``tf32``
    TF32 values in float32 (the float32 maps' route).  Made once a weight
    version: kept while ``wsel`` lives and is not written to."""
    key = (id(wsel), tf32)
    hit = _planes.get(key)
    if hit is not None and hit[0]() is wsel and hit[1] == wsel._version:
        return hit[2]
    for dead in [k for k, v in _planes.items() if v[0]() is None]:
        del _planes[dead]
    c0, n = wsel.shape
    wt = wsel.new_zeros((n, -(-c0 // 16) * 16))
    wt[:, :c0] = wsel.detach().t()
    planes = torch.stack(_split(wt, 13 if tf32 else 16))
    if not tf32:  # bf16 values already: the cast is exact
        planes = planes.bfloat16()
    _planes[key] = (weakref.ref(wsel), wsel._version, planes)
    return planes


def warp_sac_plain(feat, flow, k, feat_in, act: bool = True, it: int = 0):
    """The plain version: k (B, H, W, n*3C) tap-major, iteration ``it``;
    float32 arithmetic, the output rounded to feat's type."""
    c = feat.shape[-1]
    k1 = k[..., it * 3 * c:(it + 1) * 3 * c].float()
    out = sac(flow_warp(feat.float(), flow), k1, k1, 3, tap_major=True) \
        + feat_in.float()
    return (F.leaky_relu(out, 0.1) if act else out).to(feat.dtype)


def iac_chain_plain(feat_in, k, offsets, ac_num: int, act_last: bool = True):
    """The plain chain: ``ac_num`` :func:`warp_sac_plain` iterations, with
    feat_in the first source and every iteration's residual, each output
    rounded to feat_in's type."""
    cur = feat_in
    for i in range(ac_num):
        cur = warp_sac_plain(cur, offsets[i], k, feat_in,
                             _act(i, ac_num, act_last), i)
    return cur


def _check_common(feat, flow, feat_in):
    b, h, w, c = feat.shape
    dev, dt = feat.device, feat.dtype
    _native.require(feat, "feat", dev, dtype=dt)
    if c > IAC_MAX_CHANNELS:
        raise ValueError(f"the IAC kernel takes C up to {IAC_MAX_CHANNELS}, "
                         f"got {c}")
    _native.require(flow, "flow", dev, (b, h, w, 2))
    _native.require(feat_in, "feat_in", dev, (b, h, w, c), dtype=dt)
    return b, h, w, c


def _check_k(k, feat, it: int) -> int:
    """Validate the materialised kernels for iteration ``it``; returns
    their row length."""
    c = feat.shape[-1]
    _native.require(k, "k", feat.device, dtype=feat.dtype)
    k_ld = k.shape[-1]
    if k.shape[:3] != feat.shape[:3] or k_ld % (3 * c) or \
            not 0 <= it < k_ld // (3 * c):
        raise ValueError(f"k {tuple(k.shape)} holds no iteration {it} of "
                         f"3C={3 * c} kernels for feat {tuple(feat.shape)}")
    return k_ld


def warp_sac_fused(feat, flow, k, feat_in, act: bool = True, it: int = 0):
    """One IAC iteration.  feat/feat_in: (B, H, W, C); flow: (B, H, W, 2),
    [..., 0] = dx; k: (B, H, W, n*3C) tap-major kernels (channel
    tap*C + c inside each 3C block), iteration ``it``'s block used."""
    if _native.on_cpu(feat):
        return warp_sac_plain(feat, flow, k, feat_in, act, it)
    b, h, w, c = _check_common(feat, flow, feat_in)
    k_ld = _check_k(k, feat, it)
    out = torch.empty_like(feat)
    lib = _native.lib()
    with _native.launch_guard(feat) as stream:
        rc = lib.fcvsr_iac_step(
            feat.data_ptr(), flow.data_ptr(), k.data_ptr(), k_ld, it * 3 * c,
            None, None, 0, feat_in.data_ptr(), out.data_ptr(),
            b, h, w, c, int(act), _native.storage(feat), stream)
    _native.check(rc, "iac")
    warp_sac_fused.launches += 1
    return out


warp_sac_fused.launches = 0


def warp_sac_fused_kf(feat, flow, f0, wsel, bsel, feat_in, act: bool = True,
                      it: int = 0):
    """One IAC iteration with fused kernel prediction: the kernels are
    f0 . wsel + bsel, computed in the kernel (on the tensor cores:
    :func:`predict_kernels_emulated`).  f0: (B, H, W, C0), a map (feat's
    type); wsel: (C0, n*3C) and bsel: (n*3C,) float32, iteration ``it``'s
    3C columns used."""
    c = feat.shape[-1]
    if _native.on_cpu(feat):
        k = predict_kernels(f0, wsel, bsel, it, c)
        return warp_sac_plain(feat, flow, k, feat_in, act)
    b, h, w, c = _check_common(feat, flow, feat_in)
    dev = feat.device
    _native.require(f0, "f0", dev, dtype=feat.dtype)
    c0 = f0.shape[-1]
    _native.require(wsel, "wsel", dev)
    k_ld = wsel.shape[-1]
    _native.require(bsel, "bsel", dev, (k_ld,))
    if f0.shape[:3] != feat.shape[:3] or wsel.shape[0] != c0 or \
            k_ld % (3 * c) or not 0 <= it < k_ld // (3 * c):
        raise ValueError(f"f0 {tuple(f0.shape)} / wsel {tuple(wsel.shape)} "
                         f"do not fit feat {tuple(feat.shape)}, it={it}")
    if c0 > IAC_MAX_C0:
        raise ValueError(f"the IAC kernel's prediction takes C0 up to "
                         f"{IAC_MAX_C0}, got {c0}")
    planes = wsel_planes(wsel, tf32=feat.dtype == torch.float32)
    out = torch.empty_like(feat)
    lib = _native.lib()
    with _native.launch_guard(feat) as stream:
        rc = lib.fcvsr_iac_step(
            feat.data_ptr(), flow.data_ptr(), planes.data_ptr(), k_ld,
            it * 3 * c, f0.data_ptr(), bsel.data_ptr(), c0,
            feat_in.data_ptr(), out.data_ptr(), b, h, w, c, int(act),
            _native.storage(feat), stream)
    _native.check(rc, "iac (kf)")
    warp_sac_fused_kf.launches += 1
    return out


warp_sac_fused_kf.launches = 0


def warp_sac_vjp_plain(src, flow, k, gz, it: int = 0):
    """The plain adjoint: autograd through ``sac(flow_warp(src, flow))``
    with iteration ``it``'s kernels, no residual and no activation, at the
    cotangent ``gz``.  Returns (dsrc, dflow, dk), dk shaped like k and zero
    outside the iteration's 3C block."""
    c = src.shape[-1]
    with torch.enable_grad():
        src, flow, k = (t.detach().requires_grad_() for t in (src, flow, k))
        k1 = k[..., it * 3 * c:(it + 1) * 3 * c]
        z = sac(flow_warp(src, flow), k1, k1, 3, tap_major=True)
        return torch.autograd.grad(z, (src, flow, k), gz)


def warp_sac_bwd(src, flow, k, gz, it: int = 0, dk=None):
    """Adjoint of one IAC iteration without its residual and activation:
    (dsrc, dflow, dk) at the cotangent ``gz`` (B, H, W, C).  ``dk`` is a
    buffer shaped like k whose iteration-``it`` block is written (a zeroed
    one is made when None); the other blocks are left as they are."""
    c = src.shape[-1]
    cols = slice(it * 3 * c, (it + 1) * 3 * c)
    if _native.on_cpu(src):
        dsrc, dflow, dk_it = warp_sac_vjp_plain(src, flow, k, gz, it)
        if dk is None:
            return dsrc, dflow, dk_it
        dk[..., cols] = dk_it[..., cols]
        return dsrc, dflow, dk
    b, h, w, c = _check_common(src, flow, gz)
    dev = src.device
    k_ld = _check_k(k, src, it)
    if dk is None:
        dk = torch.zeros_like(k)
    _native.require(dk, "dk", dev, k.shape)
    dwarped = torch.empty_like(src)
    dsrc = torch.zeros_like(src)
    dflow = torch.empty_like(flow)
    lib = _native.lib()
    with _native.launch_guard(src) as stream:
        rc = lib.fcvsr_iac_bwd_sac(
            src.data_ptr(), flow.data_ptr(), k.data_ptr(), k_ld, it * 3 * c,
            gz.data_ptr(), dk.data_ptr(), dwarped.data_ptr(), b, h, w, c,
            stream)
        _native.check(rc, "iac_bwd (SAC adjoint)")
        warp_sac_bwd.launches += 1
        rc = lib.fcvsr_iac_bwd_warp(
            src.data_ptr(), flow.data_ptr(), dwarped.data_ptr(),
            dsrc.data_ptr(), dflow.data_ptr(), b, h, w, c, stream)
    _native.check(rc, "iac_bwd (warp adjoint)")
    warp_sac_bwd.launches += 1
    return dsrc, dflow, dk


warp_sac_bwd.launches = 0


def _act(i: int, ac_num: int, act_last: bool) -> bool:
    return i < ac_num - 1 or act_last


def _chain_forward(feat_in, k, offsets, ac_num: int, act_last: bool):
    """Every iteration's input and the last output: ac_num + 1 maps."""
    cur = [feat_in]
    for i in range(ac_num):
        cur.append(warp_sac_fused(cur[i], offsets[i], k, feat_in,
                                  act=_act(i, ac_num, act_last), it=i))
    return cur


def _chain_backward(cur, k, offsets, g, ac_num: int, act_last: bool):
    """Walk the iterations in reverse from the cotangent ``g`` of the last
    output; ``cur`` as :func:`_chain_forward` returns it.  The activation
    mask comes from each iteration's own output.  Returns (dfeat_in, dk,
    doffsets)."""
    c = cur[0].shape[-1]
    dk = torch.empty_like(k) if k.shape[-1] == ac_num * 3 * c \
        else torch.zeros_like(k)
    dfin = torch.zeros_like(cur[0])
    dflows = [None] * ac_num
    for i in reversed(range(ac_num)):
        gz = torch.where(cur[i + 1] > 0, g, 0.1 * g) \
            if _act(i, ac_num, act_last) else g.contiguous()
        dfin += gz  # the residual: feat_in is added in every iteration
        g, dflows[i], dk = warp_sac_bwd(cur[i], offsets[i], k, gz, i, dk)
    return dfin + g, dk, torch.stack(dflows)  # iteration 0 warps feat_in


class IACChainFn(torch.autograd.Function):
    """The IAC chain under autograd: forward through the IAC kernel, saving
    each iteration's input; backward by :func:`_chain_backward`, through
    the adjoint kernels on CUDA tensors and the plain adjoint on CPU ones
    (the counterpart of the JAX package's ``iac_fused_vjp``)."""

    @staticmethod
    def forward(ctx, feat_in, k, offsets, ac_num: int, act_last: bool):
        cur = _chain_forward(feat_in, k, offsets, ac_num, act_last)
        ctx.save_for_backward(k, offsets, *cur)
        ctx.ac_num, ctx.act_last = ac_num, act_last
        return cur[-1]

    @staticmethod
    def backward(ctx, g):
        k, offsets, *cur = ctx.saved_tensors
        dfin, dk, doff = _chain_backward(cur, k, offsets, g.contiguous(),
                                         ctx.ac_num, ctx.act_last)
        return dfin, dk, doff, None, None


def _chain_inputs(feat_in, pred_k, offsets, channels):
    if feat_in.shape[-1] != channels:
        raise ValueError(f"feat_in has {feat_in.shape[-1]} channels, "
                         f"expected {channels}")
    return feat_in.contiguous(), pred_k.contiguous(), offsets.contiguous()


def iac_fused(feat_in, pred_k_tap_major, offsets, ac_num: int, channels: int,
              act_last: bool = True):
    """IAC chain, one launch per iteration.  pred_k_tap_major:
    (B, H, W, ac_num*3C); offsets: (AC, B, H, W, 2).  On a CUDA tensor
    that autograd records it runs :class:`IACChainFn` (float32 only)."""
    feat_in, k, offsets = _chain_inputs(feat_in, pred_k_tap_major, offsets,
                                        channels)
    if not _native.on_cpu(feat_in) and _native.records(feat_in, k, offsets):
        if feat_in.dtype != torch.float32:
            raise RuntimeError(
                f"the IAC chain trains in float32, not {feat_in.dtype}: "
                "bf16 storage is a serving option (run under "
                "torch.no_grad())")
        return IACChainFn.apply(feat_in, k, offsets, ac_num, act_last)
    return _chain_forward(feat_in, k, offsets, ac_num, act_last)[-1]


def iac_fused_resident(feat_in, k, offsets, ac_num: int,
                       act_last: bool = True):
    """The whole IAC chain in one launch (``csrc/iac_chain.cu``), the
    counterpart of ``pallas_iac.iac_fused_resident``: the same function as
    :func:`iac_fused`, with the map kept between iterations in two scratch
    buffers instead of one launch an iteration.  feat_in: (B, H, W, C);
    k: (B, H, W, ac_num*3C) tap-major kernels of feat_in's type (float32
    or bfloat16); offsets: (AC, B, H, W, 2) float32.  Serving only: it
    raises under autograd."""
    if _native.on_cpu(feat_in):
        return iac_chain_plain(feat_in, k, offsets, ac_num, act_last)
    b, h, w, c = feat_in.shape
    dev, dt = feat_in.device, feat_in.dtype
    _native.require(feat_in, "feat_in", dev, dtype=dt)
    _native.require(k, "k", dev, (b, h, w, ac_num * 3 * c), dtype=dt)
    _native.require(offsets, "offsets", dev, (ac_num, b, h, w, 2))
    out = torch.empty_like(feat_in)
    bufs = torch.empty((2,) + tuple(feat_in.shape), device=dev, dtype=dt) \
        if ac_num > 1 else None
    lib = _native.lib()
    with _native.launch_guard(feat_in) as stream:
        rc = lib.fcvsr_iac_chain(
            feat_in.data_ptr(), offsets.data_ptr(), k.data_ptr(),
            _native.ptr(None if bufs is None else bufs[0]),
            _native.ptr(None if bufs is None else bufs[1]), out.data_ptr(),
            b, h, w, c, ac_num, int(act_last), _native.storage(feat_in),
            stream)
    _native.check(rc, "iac_chain")
    iac_fused_resident.launches += 1
    return out


iac_fused_resident.launches = 0


def iac_fused_kf(feat_in, f0, wsel, bsel, offsets, ac_num: int,
                 channels: int, act_last: bool = True):
    """IAC chain with fused kernel prediction.  f0: (B, H, W, C0) of
    feat_in's type; wsel: (C0, ac_num*3C) in tap-major column order and
    bsel: (ac_num*3C,), float32."""
    feat_in, f0, offsets = _chain_inputs(feat_in, f0, offsets, channels)
    wsel, bsel = wsel.contiguous(), bsel.contiguous()
    cur = feat_in
    for i in range(ac_num):
        cur = warp_sac_fused_kf(cur, offsets[i], f0, wsel, bsel, feat_in,
                                act=_act(i, ac_num, act_last), it=i)
    return cur
