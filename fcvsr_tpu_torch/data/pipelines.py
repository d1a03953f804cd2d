"""Frame-index generation and paired augmentations (the port's own copy of
the parts of ``fcvsr_tpu.data.pipelines`` it uses).

* ``padded_window_indices`` - mmedit ``GenerateFrameIndiceswithPadding``:
  the sliding window around each centre frame, padded at the clip edges.
* ``segment_indices``       - ``GenerateSegmentIndices``: a random-start
  contiguous training segment.
* ``paired_random_crop``    - ``PairedRandomCrop``: an LR patch and the
  aligned x4 GT patch.
* ``paired_flip_rotate``    - hflip / vflip / transpose, applied to LR and GT
  together.
* ``generate_coordinate_and_cell`` - ``GenerateCoordinateAndCell``: LIIF's
  training queries.

Numpy only, drawing from a ``np.random.Generator`` in the JAX package's
order, so one seed gives both packages the same crops and flips.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["padded_window_indices", "segment_indices", "paired_random_crop",
           "paired_flip_rotate", "to_float", "generate_coordinate_and_cell"]


def padded_window_indices(center: int, num_frames: int, window: int,
                          padding: str = "replicate") -> list[int]:
    """Window of ``window`` frame indices centred at ``center`` within a clip
    of ``num_frames``, edge-padded per mmedit semantics."""
    n = num_frames - 1
    half = window // 2
    out = []
    for i in range(center - half, center + half + 1):
        if i < 0:
            if padding == "replicate":
                j = 0
            elif padding == "reflection":
                j = -i
            elif padding == "reflection_circle":
                j = center + half - i
            elif padding == "circle":
                j = window + i
            else:
                raise ValueError(f"unknown padding {padding}")
        elif i > n:
            if padding == "replicate":
                j = n
            elif padding == "reflection":
                j = n * 2 - i
            elif padding == "reflection_circle":
                j = (center - half) - (i - n)
            elif padding == "circle":
                j = i - window
            else:
                raise ValueError(f"unknown padding {padding}")
        else:
            j = i
        out.append(j)
    return out


def segment_indices(rng: np.random.Generator, num_frames: int,
                    seq_len: int, interval: int = 1) -> list[int]:
    """Random fixed-length contiguous (strided) segment of a clip."""
    max_start = num_frames - seq_len * interval
    if max_start < 0:
        raise ValueError("clip too short for requested segment")
    start = int(rng.integers(0, max_start + 1))
    return list(range(start, start + seq_len * interval, interval))


def paired_random_crop(rng: np.random.Generator, lr_frames: np.ndarray,
                       gt_frames: np.ndarray, lr_patch: int,
                       scale: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Crop aligned patches: LR (T, H, W, C) -> (T, p, p, C);
    GT -> (T, p*scale, p*scale, C)."""
    h, w = lr_frames.shape[1:3]
    top = int(rng.integers(0, h - lr_patch + 1))
    left = int(rng.integers(0, w - lr_patch + 1))
    lr = lr_frames[:, top:top + lr_patch, left:left + lr_patch]
    gt = gt_frames[:, top * scale:(top + lr_patch) * scale,
                   left * scale:(left + lr_patch) * scale]
    return lr, gt


def paired_flip_rotate(rng: np.random.Generator, lr: np.ndarray,
                       gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Random hflip / vflip / transpose applied to both (T, H, W, C)
    stacks."""
    if rng.random() < 0.5:
        lr = lr[:, :, ::-1]
        gt = gt[:, :, ::-1]
    if rng.random() < 0.5:
        lr = lr[:, ::-1]
        gt = gt[:, ::-1]
    if rng.random() < 0.5:
        lr = lr.transpose(0, 2, 1, 3)
        gt = gt.transpose(0, 2, 1, 3)
    return np.ascontiguousarray(lr), np.ascontiguousarray(gt)


def to_float(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1]."""
    return frames_u8.astype(np.float32) / 255.0


def generate_coordinate_and_cell(rng: np.random.Generator, gt: np.ndarray,
                                 sample_quantity: int | None = None):
    """LIIF training queries (mmedit pipelines/generate_assistant.py
    ``GenerateCoordinateAndCell``): pixel-centre coords in [-1, 1], constant
    cell sizes (2/H, 2/W), optionally subsampled to ``sample_quantity``
    random positions with the matching GT values.

    gt: (H, W, C) float -> (coord (Q, 2) float32 (y, x), cell (Q, 2),
    target (Q, C)).
    """
    h, w, c = gt.shape
    ys = (-1 + 1.0 / h) + (2.0 / h) * np.arange(h, dtype=np.float32)
    xs = (-1 + 1.0 / w) + (2.0 / w) * np.arange(w, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    coord = np.stack([gy, gx], axis=-1).reshape(-1, 2)
    target = gt.reshape(-1, c).astype(np.float32)
    if sample_quantity is not None and sample_quantity < coord.shape[0]:
        idx = rng.choice(coord.shape[0], sample_quantity, replace=False)
        coord = coord[idx]
        target = target[idx]
    cell = np.empty_like(coord)
    cell[:, 0] = 2.0 / h
    cell[:, 1] = 2.0 / w
    return coord, cell, target
