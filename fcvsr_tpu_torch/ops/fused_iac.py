"""Wrappers of the IAC kernel (``csrc/iac.cu``) and its plain version.

Counterpart of ``fcvsr_tpu.ops.pallas_iac``'s ``warp_sac_fused``,
``iac_fused`` and ``iac_fused_kf``.  One launch is one exact IAC iteration:

    out = leaky_relu_0.1(sac_k1,k1(flow_warp(feat, flow)) + feat_in)

with the activation skipped when ``act`` is False.  Unlike the TPU kernel
the warp is unbounded (no radius clamp) and nothing constrains H, W or C.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain version.  ``warp_sac_fused.launches`` and
``warp_sac_fused_kf.launches`` count kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _native
from .sac import sac
from .warp import flow_warp

__all__ = ["warp_sac_fused", "warp_sac_fused_kf", "iac_fused", "iac_fused_kf",
           "warp_sac_plain", "predict_kernels"]


def predict_kernels(f0, wsel, bsel, it: int, channels: int):
    """k = f0 . wsel + bsel for iteration ``it``'s 3C columns.  f0:
    (B, H, W, C0); wsel: (C0, n*3C); bsel: (n*3C,)."""
    cols = slice(it * 3 * channels, (it + 1) * 3 * channels)
    return torch.einsum("bhwc,ck->bhwk", f0, wsel[:, cols]) + bsel[cols]


def warp_sac_plain(feat, flow, k, feat_in, act: bool = True, it: int = 0):
    """The plain version: k (B, H, W, n*3C) tap-major, iteration ``it``."""
    c = feat.shape[-1]
    k1 = k[..., it * 3 * c:(it + 1) * 3 * c]
    out = sac(flow_warp(feat, flow), k1, k1, 3, tap_major=True) + feat_in
    return F.leaky_relu(out, 0.1) if act else out


def _check_common(feat, flow, feat_in):
    b, h, w, c = feat.shape
    dev = feat.device
    _native.require(feat, "feat", dev)
    _native.require(flow, "flow", dev, (b, h, w, 2))
    _native.require(feat_in, "feat_in", dev, (b, h, w, c))
    return b, h, w, c


def warp_sac_fused(feat, flow, k, feat_in, act: bool = True, it: int = 0):
    """One IAC iteration.  feat/feat_in: (B, H, W, C); flow: (B, H, W, 2),
    [..., 0] = dx; k: (B, H, W, n*3C) tap-major kernels (channel
    tap*C + c inside each 3C block), iteration ``it``'s block used."""
    if _native.on_cpu(feat):
        return warp_sac_plain(feat, flow, k, feat_in, act, it)
    b, h, w, c = _check_common(feat, flow, feat_in)
    _native.require(k, "k", feat.device)
    k_ld = k.shape[-1]
    if k.shape[:3] != feat.shape[:3] or k_ld % (3 * c) or \
            not 0 <= it < k_ld // (3 * c):
        raise ValueError(f"k {tuple(k.shape)} holds no iteration {it} of "
                         f"3C={3 * c} kernels for feat {tuple(feat.shape)}")
    out = torch.empty_like(feat)
    lib = _native.lib()
    rc = lib.fcvsr_iac_step(
        feat.data_ptr(), flow.data_ptr(), k.data_ptr(), k_ld, it * 3 * c,
        None, None, 0, feat_in.data_ptr(), out.data_ptr(),
        b, h, w, c, int(act), _native.stream_ptr(feat.device))
    _native.check(rc, "iac")
    warp_sac_fused.launches += 1
    return out


warp_sac_fused.launches = 0


def warp_sac_fused_kf(feat, flow, f0, wsel, bsel, feat_in, act: bool = True,
                      it: int = 0):
    """One IAC iteration with fused kernel prediction: the kernels are
    f0 . wsel + bsel, computed in the kernel.  f0: (B, H, W, C0); wsel:
    (C0, n*3C); bsel: (n*3C,), iteration ``it``'s 3C columns used."""
    c = feat.shape[-1]
    if _native.on_cpu(feat):
        k = predict_kernels(f0, wsel, bsel, it, c)
        return warp_sac_plain(feat, flow, k, feat_in, act)
    b, h, w, c = _check_common(feat, flow, feat_in)
    dev = feat.device
    _native.require(f0, "f0", dev)
    c0 = f0.shape[-1]
    _native.require(wsel, "wsel", dev)
    k_ld = wsel.shape[-1]
    _native.require(bsel, "bsel", dev, (k_ld,))
    if f0.shape[:3] != feat.shape[:3] or wsel.shape[0] != c0 or \
            k_ld % (3 * c) or not 0 <= it < k_ld // (3 * c):
        raise ValueError(f"f0 {tuple(f0.shape)} / wsel {tuple(wsel.shape)} "
                         f"do not fit feat {tuple(feat.shape)}, it={it}")
    out = torch.empty_like(feat)
    lib = _native.lib()
    rc = lib.fcvsr_iac_step(
        feat.data_ptr(), flow.data_ptr(), wsel.data_ptr(), k_ld, it * 3 * c,
        f0.data_ptr(), bsel.data_ptr(), c0, feat_in.data_ptr(),
        out.data_ptr(), b, h, w, c, int(act), _native.stream_ptr(dev))
    _native.check(rc, "iac (kf)")
    warp_sac_fused_kf.launches += 1
    return out


warp_sac_fused_kf.launches = 0


def iac_fused(feat_in, pred_k_tap_major, offsets, ac_num: int, channels: int,
              act_last: bool = True):
    """IAC chain, one launch per iteration.  pred_k_tap_major:
    (B, H, W, ac_num*3C); offsets: (AC, B, H, W, 2)."""
    if feat_in.shape[-1] != channels:
        raise ValueError(f"feat_in has {feat_in.shape[-1]} channels, "
                         f"expected {channels}")
    feat_in = feat_in.contiguous()
    k = pred_k_tap_major.contiguous()
    offsets = offsets.contiguous()
    cur = feat_in
    for i in range(ac_num):
        cur = warp_sac_fused(cur, offsets[i], k, feat_in,
                             act=i < ac_num - 1 or act_last, it=i)
    return cur


def iac_fused_kf(feat_in, f0, wsel, bsel, offsets, ac_num: int,
                 channels: int, act_last: bool = True):
    """IAC chain with fused kernel prediction.  f0: (B, H, W, C0); wsel:
    (C0, ac_num*3C) in tap-major column order; bsel: (ac_num*3C,)."""
    if feat_in.shape[-1] != channels:
        raise ValueError(f"feat_in has {feat_in.shape[-1]} channels, "
                         f"expected {channels}")
    feat_in = feat_in.contiguous()
    f0, wsel, bsel = f0.contiguous(), wsel.contiguous(), bsel.contiguous()
    offsets = offsets.contiguous()
    cur = feat_in
    for i in range(ac_num):
        cur = warp_sac_fused_kf(cur, offsets[i], f0, wsel, bsel, feat_in,
                                act=i < ac_num - 1 or act_last, it=i)
    return cur
