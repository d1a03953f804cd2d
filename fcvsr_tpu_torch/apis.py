"""High-level inference API (counterpart of ``fcvsr_tpu.apis``)."""

from __future__ import annotations

import numpy as np
import torch

from .data.pipelines import padded_window_indices

__all__ = ["pad_sequence", "restoration_video_inference"]


def pad_sequence(frames: np.ndarray, window_size: int) -> np.ndarray:
    """Mirror-pad a (T, ...) clip by window_size // 2 at both ends, with the
    reference's reflection that skips the frames next to each edge: the head
    is ``frames[1+p : 1+2p]`` flipped, the tail ``frames[-1-2p : -1-p]``
    flipped."""
    half = window_size // 2
    if half == 0:
        return frames
    head = frames[1 + half:1 + 2 * half][::-1]
    tail = frames[-1 - 2 * half:-1 - half][::-1]
    return np.concatenate([head, frames, tail], axis=0)


@torch.no_grad()
def restoration_video_inference(model, frames: np.ndarray, window_size: int = 7,
                                batch_windows: int = 1,
                                padding: str = "replicate",
                                device=None) -> np.ndarray:
    """SR every frame of a clip through a windowed model.

    frames: (T, H, W, C) float32 in [0, 1].  Frame t is the centre of the
    ``window_size`` frames around it, padded at the clip ends by
    ``padding``; ``batch_windows`` windows go through the model at once.
    Returns (T, 4H, 4W, C)."""
    if window_size <= 0:
        raise ValueError("only windowed models are served (window_size > 0)")
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device
    t = frames.shape[0]
    idx = np.stack([padded_window_indices(i, t, window_size, padding)
                    for i in range(t)])
    windows = np.transpose(frames[idx], (0, 1, 4, 2, 3)).astype(np.float32)
    outs = []
    for s in range(0, t, batch_windows):
        x = torch.from_numpy(np.ascontiguousarray(
            windows[s:s + batch_windows])).to(device)
        outs.append(model(x).cpu().numpy())
    return np.transpose(np.concatenate(outs, 0), (0, 2, 3, 1))
