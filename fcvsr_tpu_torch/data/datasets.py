"""Training and test data (the port's own copy of the parts of
``fcvsr_tpu.data.datasets`` it uses), numpy and PIL only:

* ``ClipFolderDataset`` - paired LR / GT clip folders,
  ``lr_root/{seq}/{frame}.png`` beside the same names under ``gt_root``,
  iterated as test windows or sampled as training windows or sequences.
* ``Vimeo90KDataset`` - Vimeo-90K septuplets listed by a meta-info file
  (``meta_info_Vimeo90K_*.txt``, a key ``00001/0001`` a line), each key a
  folder of 7 frames under both roots, sampled with centre-frame GT."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .pipelines import (padded_window_indices, paired_flip_rotate,
                        paired_random_crop, segment_indices, to_float)

__all__ = ["load_image", "ClipFolderDataset", "Vimeo90KDataset"]


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


@dataclass
class Vimeo90KDataset:
    """Vimeo-90K septuplets through a meta-info list: the first word of
    each non-blank line of ``meta_file`` is a key, ``lr_root/<key>/`` and
    ``gt_root/<key>/`` hold its frames (RGB)."""

    lr_root: str
    gt_root: str
    meta_file: str
    scale: int = 4

    def __post_init__(self):
        with open(self.meta_file) as f:
            self.keys = [ln.split()[0] for ln in f if ln.strip()]

    def load(self, key: str):
        """(lr (T, h, w, 3), gt (T, H, W, 3)) uint8 of one septuplet."""
        lr = np.stack([load_image(p) for p in
                       _list_frames(os.path.join(self.lr_root, key))])
        gt = np.stack([load_image(p) for p in
                       _list_frames(os.path.join(self.gt_root, key))])
        return lr, gt

    def sample_train(self, rng: np.random.Generator, lr_patch: int = 64):
        """A random septuplet, an aligned crop and flips, drawn from ``rng``
        in the JAX package's order.  Returns (lr (T,p,p,3) f32, gt_center
        (P,P,3) f32) in [0, 1]."""
        key = self.keys[int(rng.integers(len(self.keys)))]
        lr, gt = self.load(key)
        gtc = gt[lr.shape[0] // 2][None]
        lr, gtc = paired_random_crop(rng, lr, gtc, lr_patch, self.scale)
        lr, gtc = paired_flip_rotate(rng, lr, gtc)
        return to_float(lr), to_float(gtc[0])
