"""Flow warping by bilinear sampling (counterpart of ``fcvsr_tpu.ops.warp``).

Reference semantics: ``F.grid_sample(mode='bilinear', align_corners=True)``
after the normalisation round-trip of the reference ``flow_warp``, i.e.
sampling at absolute pixel ``(x + dx, y + dy)``.  With ``padding_mode=
'zeros'`` out-of-frame corner taps contribute zero (written as four gathers
over a zero-ringed copy of the map); with ``'border'`` the coordinates clamp
to the frame's edge, as SPyNet warps.  ``interpolation='nearest'`` samples
the nearest pixel instead (``grid_sample(mode='nearest')``: coordinates
round half to even, as ``std::nearbyint`` and ``jnp.round`` do), as FTVSR
tracks its locations.  The order of operations is the JAX op's.  All
tensors are channels-last (B, H, W, C).
"""

from __future__ import annotations

import torch

__all__ = ["flow_warp", "grid_sample_bilinear", "grid_sample_nearest"]


def _gather_hw(x: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """x[b, iy[b, p], ix[b, p], :] -> (B, P, C); indices already in range."""
    b, h, w, c = x.shape
    idx = (iy * w + ix).unsqueeze(-1).expand(-1, -1, c)
    return torch.gather(x.reshape(b, h * w, c), 1, idx)


def grid_sample_bilinear(x: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``x`` (B, H, W, C) at absolute pixel coordinates ``px``/``py``
    (B, P), bilinear, with ``padding_mode`` 'zeros' or 'border'.  Returns
    (B, P, C)."""
    b, h, w, _ = x.shape
    if padding_mode == "border":
        px = px.clamp(0.0, w - 1)
        py = py.clamp(0.0, h - 1)
        src, ring = x, 0
    elif padding_mode == "zeros":
        # a one-pixel zero ring: an out-of-frame corner clamps onto it and
        # reads 0
        src, ring = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)), 1
        px = px.clamp(-1.5, w + 0.5)
        py = py.clamp(-1.5, h + 0.5)
    else:
        raise ValueError(f"padding_mode {padding_mode!r}: 'zeros' or 'border'")
    hs, ws = src.shape[1:3]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = x0.long() + ring
    y0i = y0.long() + ring

    def corner(yi, xi, wgt):
        v = _gather_hw(src, yi.clamp(0, hs - 1), xi.clamp(0, ws - 1))
        return v * wgt.unsqueeze(-1)

    out = corner(y0i, x0i, (1 - fy) * (1 - fx))
    out = out + corner(y0i, x0i + 1, (1 - fy) * fx)
    out = out + corner(y0i + 1, x0i, fy * (1 - fx))
    out = out + corner(y0i + 1, x0i + 1, fy * fx)
    return out


def grid_sample_nearest(x: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                        padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``x`` (B, H, W, C) at the pixels nearest to ``px``/``py``
    (B, P), half to even; with ``padding_mode`` 'zeros' a pixel outside the
    frame reads 0, with 'border' the coordinates clamp to the frame.
    Returns (B, P, C)."""
    b, h, w, _ = x.shape
    if padding_mode == "border":
        xi = torch.round(px.clamp(0.0, w - 1)).long()
        yi = torch.round(py.clamp(0.0, h - 1)).long()
        return _gather_hw(x, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
    if padding_mode != "zeros":
        raise ValueError(f"padding_mode {padding_mode!r}: 'zeros' or 'border'")
    # the zero ring: a coordinate outside the frame rounds onto it
    src = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    xi = torch.round(px.clamp(-1.0, float(w))).long() + 1
    yi = torch.round(py.clamp(-1.0, float(h))).long() + 1
    return _gather_hw(src, yi.clamp(0, h + 1), xi.clamp(0, w + 1))


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros",
              interpolation: str = "bilinear") -> torch.Tensor:
    """Warp ``x`` (B, H, W, C) by ``flow`` (B, H, W, 2), [..., 0] = dx,
    [..., 1] = dy: out(y, x) = x sampled at (y + dy, x + dx), bilinear or
    (``interpolation='nearest'``) at the nearest pixel."""
    b, h, w, c = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=x.dtype, device=x.device),
        torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
    px = (gx + flow[..., 0]).reshape(b, h * w)
    py = (gy + flow[..., 1]).reshape(b, h * w)
    if interpolation == "nearest":
        out = grid_sample_nearest(x, px, py, padding_mode)
    elif interpolation == "bilinear":
        out = grid_sample_bilinear(x, px, py, padding_mode)
    else:
        raise ValueError(f"interpolation {interpolation!r}: 'bilinear' or "
                         "'nearest'")
    return out.reshape(b, h, w, c)
