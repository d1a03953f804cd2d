"""Batched sliding-window and tiled serving (counterpart of
``fcvsr_tpu.models.inference``).

* :func:`sliding_window_sr` restores every frame of a clip, its windows
  ``batch_windows`` at a time through one forward: the same outputs as a
  forward per frame.
* :func:`tiled_sr` restores one window of a frame too large to serve whole
  as overlapping tiles in one batched forward, cropping each SR tile's
  overlap ring and stitching.  FCVSR is not shift-invariant (MFFR's band
  split is a global FFT), so tiling deviates from the whole-frame forward
  within a bound that ``overlap`` >= 32 keeps in the ``--fast`` class.

Both take and return numpy arrays, move the inputs to ``device`` (the
model's, CUDA by default; no fallback) and run without autograd.
``sliding_window_sr(bf16=True)`` runs the whole model in bf16
(``utils.precision.bf16_apply`` on a cast copy of the model), as the JAX
package's does.  ``tiled_sr(group=...)`` spreads the tiles over the ranks
of a process group, as the JAX package's ``mesh`` branch spreads them over
devices: the same result as one process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pipelines import padded_window_indices
from ..parallel import gather_results, make_mesh, rank_share
from ..utils.precision import bf16_apply, cast_params

__all__ = ["sliding_window_sr", "tiled_sr"]

SCALE = 4


@torch.no_grad()
def _forward(model, x: np.ndarray, device, bf16: bool = False) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    out = bf16_apply(model, x) if bf16 else model(x)
    return out.float().cpu().numpy()


def sliding_window_sr(model, clip: np.ndarray, window: int = 7,
                      batch_windows: int = 8, padding: str = "replicate",
                      device="cuda", bf16: bool = False) -> np.ndarray:
    """clip: (T, H, W, C) float32 in [0, 1] -> (T, 4H, 4W, C).  Each frame's
    window of ``window`` frames (edges ``padding``-padded), ``batch_windows``
    windows a forward; the last batch is filled by repeating its last
    window, as the JAX package fills it.  ``bf16``: the whole model in
    bf16, its weights cast once for the clip; the output float32."""
    t = clip.shape[0]
    idx = np.stack([padded_window_indices(i, t, window, padding)
                    for i in range(t)])
    windows = np.transpose(clip[idx], (0, 1, 4, 2, 3)).astype(np.float32)
    nb = batch_windows
    pad_to = -(-t // nb) * nb
    if pad_to != t:
        windows = np.concatenate(
            [windows, np.repeat(windows[-1:], pad_to - t, axis=0)])
    if bf16:
        model = cast_params(model)
    out = np.concatenate([_forward(model, windows[s:s + nb], device, bf16)
                          for s in range(0, pad_to, nb)])[:t]
    return np.transpose(out, (0, 2, 3, 1))


def tiled_sr(model, window: np.ndarray, tile: int = 272, overlap: int = 32,
             device="cuda", group=None) -> np.ndarray:
    """window: (T, C, H, W) or (1, T, C, H, W) float32 in [0, 1] -> (1, C,
    4H, 4W).  The frame is padded by edge replication (zeros would bleed
    black into the overlap ring) to a grid of ``tile`` x ``tile`` tiles a
    step of ``tile - 2 * overlap`` apart; all tiles run as one batched
    forward; each SR tile keeps its interior (its outer ring too where it
    is the frame's border), stitched in place.  With a process group
    (``torch.distributed.group.WORLD`` for the default one), every rank
    gives the same window and model: the tiles are padded to a multiple of
    the world size by repeating the last, each rank forwards its
    contiguous share, and every rank stitches the shares gathered in tile
    order, the padding dropped."""
    x = np.asarray(window, np.float32)
    if x.ndim == 4:
        x = x[None]
    b, _, c, h, w = x.shape
    if b != 1:
        raise ValueError(f"tiled_sr serves one window, not a batch of {b}")
    step = tile - 2 * overlap
    if step <= 0:
        raise ValueError(f"tile {tile} must exceed 2 * overlap {overlap}")
    ny = max(1, -(-(h - 2 * overlap) // step))
    nx = max(1, -(-(w - 2 * overlap) // step))
    hp, wp = step * ny + 2 * overlap, step * nx + 2 * overlap
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, hp - h), (0, wp - w)),
                mode="edge")
    grid = [(iy, ix) for iy in range(ny) for ix in range(nx)]
    tiles = np.stack([xp[0, :, :, iy * step:iy * step + tile,
                         ix * step:ix * step + tile] for iy, ix in grid])
    if group is None:
        out = _forward(model, tiles, device)
    else:
        mesh = make_mesh(device, group)
        n = len(tiles)
        pad = -n % mesh.size
        if pad:
            tiles = np.concatenate([tiles, np.repeat(tiles[-1:], pad, 0)])
        local = _forward(model, rank_share(tiles, mesh), device)
        out = gather_results(local, group).reshape(-1, *local.shape[1:])[:n]
    s = SCALE
    sr = np.zeros((1, c, s * hp, s * wp), np.float32)
    for k, (iy, ix) in enumerate(grid):
        y0, x0 = iy * step, ix * step
        cy0 = 0 if iy == 0 else overlap
        cy1 = tile if iy == ny - 1 else tile - overlap
        cx0 = 0 if ix == 0 else overlap
        cx1 = tile if ix == nx - 1 else tile - overlap
        sr[0, :, s * (y0 + cy0):s * (y0 + cy1),
           s * (x0 + cx0):s * (x0 + cx1)] = \
            out[k][:, s * cy0:s * cy1, s * cx0:s * cx1]
    return sr[:, :, :s * h, :s * w]
