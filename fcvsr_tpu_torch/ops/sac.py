"""Separable / iterative adaptive convolution (counterpart of
``fcvsr_tpu.ops.sac``).

SAC filters each pixel and channel with its own 3-tap kernel, vertically and
then horizontally, with replicate borders.  The reference applies
``kernel1`` in both passes (a bug that shipped checkpoints were trained
with); ``kernel1_both`` keeps it.  IAC iterates warp -> SAC -> + input ->
leaky-relu(0.1).

``iac`` goes through ``ops.fused_iac``: one CUDA kernel launch per
iteration (or one for the whole chain) on a CUDA tensor, its plain version
on a CPU tensor.
"""

from __future__ import annotations

import torch

__all__ = ["sac", "iac"]


def _directional_pass(x: torch.Tensor, k: torch.Tensor, ksize: int, axis: int,
                      tap_major: bool = False) -> torch.Tensor:
    """One adaptive-filter pass along H (axis=1) or W (axis=2) of
    x (B, H, W, C) with k (B, H, W, C*ksize): channel ``c*ksize + tap``, or
    ``tap*C + c`` when ``tap_major``.  Replicate borders."""
    b, h, w, c = x.shape
    pad = (ksize - 1) // 2
    size = x.shape[axis]
    idx = torch.arange(-pad, size + pad, device=x.device).clamp(0, size - 1)
    xp = x.index_select(axis, idx)
    kt = None if tap_major else k.reshape(b, h, w, c, ksize)
    out = torch.zeros_like(x)
    for tap in range(ksize):
        kk = k[..., tap * c:(tap + 1) * c] if tap_major else kt[..., tap]
        out = out + xp.narrow(axis, tap, size) * kk
    return out


def sac(x: torch.Tensor, kernel1: torch.Tensor, kernel2: torch.Tensor,
        ksize: int = 3, kernel1_both: bool = True,
        tap_major: bool = False) -> torch.Tensor:
    """Separable adaptive convolution: vertical pass, then horizontal.
    x: (B, H, W, C); kernel1/kernel2: (B, H, W, C*ksize)."""
    out = _directional_pass(x, kernel1, ksize, axis=1, tap_major=tap_major)
    k_h = kernel1 if kernel1_both else kernel2
    return _directional_pass(out, k_h, ksize, axis=2, tap_major=tap_major)


def iac(feat_in: torch.Tensor, pred_k, offsets: torch.Tensor, ac_num: int,
        channels: int, act_last: bool = True, k_parts=None,
        chain: str = "periter") -> torch.Tensor:
    """Iterative adaptive convolution in the configuration FCVSR runs: 3
    taps, kernel1 in both passes, tap-major kernel1 halves only.

    feat_in: (B, H, W, C); pred_k: (B, H, W, ac_num*3C), channel tap*C + c
    inside each iteration's 3C block; offsets: (AC, B, H, W, 2) flows.
    ``k_parts = (f0, wsel, bsel)`` replaces pred_k (then None) by its
    factors: k = f0 . wsel + bsel, computed inside the IAC kernel.
    ``chain``: 'periter' launches one kernel an iteration; 'resident' runs
    the whole chain in one launch (materialised kernels only, serving
    only), the JAX package's ``set_iac_chain`` as an argument.
    """
    # fused_iac's plain version is built on ``sac`` above
    from . import fused_iac

    if chain not in ("periter", "resident"):
        raise ValueError(f"chain is 'periter' or 'resident', not {chain!r}")
    if chain == "resident":
        if k_parts is not None:
            raise ValueError("the resident IAC chain takes materialised "
                             "kernels, not k_parts")
        feat_in, k, offsets = fused_iac._chain_inputs(feat_in, pred_k,
                                                      offsets, channels)
        return fused_iac.iac_fused_resident(feat_in, k, offsets, ac_num,
                                            act_last)
    if k_parts is None:
        return fused_iac.iac_fused(feat_in, pred_k, offsets, ac_num, channels,
                                   act_last=act_last)
    if pred_k is not None:
        raise ValueError("k_parts replaces pred_k: pass pred_k=None")
    f0, wsel, bsel = k_parts
    return fused_iac.iac_fused_kf(feat_in, f0, wsel, bsel, offsets, ac_num,
                                  channels, act_last=act_last)
