"""Paired LR / GT clip folders (the port's own copy of the parts of
``fcvsr_tpu.data.datasets`` it uses): ``lr_root/{seq}/{frame}.png`` beside
the same names under ``gt_root``, iterated as test windows or sampled as
training windows or sequences.  Numpy and PIL only."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .pipelines import (padded_window_indices, paired_flip_rotate,
                        paired_random_crop, segment_indices, to_float)

__all__ = ["load_image", "ClipFolderDataset"]


def load_image(path: str, grayscale: bool = False) -> np.ndarray:
    """PNG/JPG -> uint8 (H, W, C) array (C=1 for grayscale)."""
    from PIL import Image

    img = Image.open(path)
    if grayscale:
        return np.asarray(img.convert("L"), np.uint8)[..., None]
    return np.asarray(img.convert("RGB"), np.uint8)


def _list_frames(seq_dir: str) -> List[str]:
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    names = sorted(n for n in os.listdir(seq_dir) if n.lower().endswith(exts))
    return [os.path.join(seq_dir, n) for n in names]


@dataclass
class ClipFolderDataset:
    """Paired LR/GT folder dataset: lr_root/{seq}/{frame}.png and the same
    names in gt_root."""

    lr_root: str
    gt_root: Optional[str] = None
    window: int = 7
    scale: int = 4
    grayscale: bool = False
    padding: str = "replicate"
    sequences: Optional[Sequence[str]] = None

    def __post_init__(self):
        if self.sequences is None:
            self.sequences = sorted(
                d for d in os.listdir(self.lr_root)
                if os.path.isdir(os.path.join(self.lr_root, d)))

    def seq_frames(self, seq: str) -> Tuple[List[str], Optional[List[str]]]:
        lr = _list_frames(os.path.join(self.lr_root, seq))
        gt = (_list_frames(os.path.join(self.gt_root, seq))
              if self.gt_root else None)
        return lr, gt

    def iter_test_windows(self, seq: str) -> Iterator[tuple]:
        """Yield (center_idx, lr_window_u8 (T,H,W,C), gt_u8 or None)."""
        lr_paths, gt_paths = self.seq_frames(seq)
        frames = [load_image(p, self.grayscale) for p in lr_paths]
        for i in range(len(frames)):
            idx = padded_window_indices(i, len(frames), self.window,
                                        self.padding)
            window = np.stack([frames[j] for j in idx])
            gt = load_image(gt_paths[i], self.grayscale) if gt_paths else None
            yield i, window, gt

    def sample_train_window(self, rng: np.random.Generator,
                            lr_patch: int = 64):
        """Random sequence, window, aligned crop and flips.  Returns
        (lr (T,p,p,C) f32, gt_center (P,P,C) f32) in [0, 1]."""
        seq = self.sequences[int(rng.integers(len(self.sequences)))]
        lr_paths, gt_paths = self.seq_frames(seq)
        if not gt_paths:
            raise ValueError("training needs gt_root")
        idx = segment_indices(rng, len(lr_paths), self.window)
        lr = np.stack([load_image(lr_paths[j], self.grayscale) for j in idx])
        center = idx[self.window // 2]
        gt = load_image(gt_paths[center], self.grayscale)[None]
        lr, gt = paired_random_crop(rng, lr, gt, lr_patch, self.scale)
        lr, gt = paired_flip_rotate(rng, lr, gt)
        return to_float(lr), to_float(gt[0])

    def sample_train_sequence(self, rng: np.random.Generator,
                              lr_patch: int = 64):
        """Random window with per-frame GT, for recurrent models (mmedit's
        SRREDSMultipleGTDataset): the sequence, segment, aligned crop and
        flips drawn from ``rng`` in the JAX package's order.  Returns
        (lr (T,p,p,C) f32, gt (T,P,P,C) f32) in [0, 1]."""
        seq = self.sequences[int(rng.integers(len(self.sequences)))]
        lr_paths, gt_paths = self.seq_frames(seq)
        if not gt_paths:
            raise ValueError("training needs gt_root")
        idx = segment_indices(rng, len(lr_paths), self.window)
        lr = np.stack([load_image(lr_paths[j], self.grayscale) for j in idx])
        gt = np.stack([load_image(gt_paths[j], self.grayscale) for j in idx])
        lr, gt = paired_random_crop(rng, lr, gt, lr_patch, self.scale)
        lr, gt = paired_flip_rotate(rng, lr, gt)
        return to_float(lr), to_float(gt)
