"""Training and test data (the port's own copy of the parts of
``fcvsr_tpu.data.datasets`` it uses), numpy and PIL only:

* ``ClipFolderDataset`` - paired LR / GT clip folders,
  ``lr_root/{seq}/{frame}.png`` beside the same names under ``gt_root``,
  iterated as test windows or sampled as training windows or sequences.
* ``Vimeo90KDataset`` - Vimeo-90K septuplets listed by a meta-info file
  (``meta_info_Vimeo90K_*.txt``, a key ``00001/0001`` a line), each key a
  folder of 7 frames under both roots, sampled with centre-frame GT.
* ``AnnotationDataset`` - an annotation file's clips (mmedit's
  SRVid4Dataset: lines ``calendar 41 (576,720,3)``) as clip folders.
* ``CVCPClipCache`` - the CVCP recipe's RAM cache (CVSR_train's
  CDVL_Dataset): every frame held as uint8, random windows with
  centre-frame GT.
* ``SideInfoClipCache`` - the HEVC coding-prior clips (CVSR_train's
  CDVL_sideInfo_Dataset): frames and side information cached, windows
  sampled with their motion vectors, residue, partition map and
  unfiltered prediction.
* ``MM522Dataset`` - MMCNN's MM520/522 training set (a meta file of
  clip/frame keys, two validation partitions, interval augmentation and
  random reversal).

Every sampler draws from the ``np.random.Generator`` it is given, in the
JAX package's order, so one generator (a rank's stream under
``--multihost``) gives both packages the same samples."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .pipelines import (padded_window_indices, paired_flip_rotate,
                        paired_random_crop, segment_indices, to_float)

__all__ = ["load_image", "ClipFolderDataset", "Vimeo90KDataset",
           "AnnotationDataset", "CVCPClipCache", "SideInfoClipCache",
           "MM522Dataset"]


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


_ANN_RE = re.compile(r"^(\S+)\s+(\d+)\s+\((\d+),(\d+),(\d+)\)")


@dataclass
class AnnotationDataset:
    """Clips named by an annotation file (Vid4 / REDS4: lines ``name
    frames (h,w,c)``) under paired LR / GT roots."""

    lr_root: str
    gt_root: str
    ann_file: str
    window: int = 7
    scale: int = 4
    padding: str = "replicate"

    def clips(self) -> List[Tuple[str, int, Tuple[int, int, int]]]:
        """(name, frames, (h, w, c)) of every annotation line that parses."""
        out = []
        with open(self.ann_file) as f:
            for line in f:
                m = _ANN_RE.match(line.strip())
                if m:
                    name, n, h, w, c = m.group(1), *map(int, m.group(2, 3, 4,
                                                                   5))
                    out.append((name, n, (h, w, c)))
        return out

    def as_folder(self) -> ClipFolderDataset:
        """The annotated clips as a ``ClipFolderDataset``, in file order."""
        return ClipFolderDataset(
            lr_root=self.lr_root, gt_root=self.gt_root, window=self.window,
            scale=self.scale, padding=self.padding,
            sequences=[c[0] for c in self.clips()])


def _load_clip(root: str, seq: str, grayscale: bool) -> np.ndarray:
    return np.stack([load_image(p, grayscale)
                     for p in _list_frames(os.path.join(root, seq))])


class CVCPClipCache:
    """The CVCP recipe's RAM cache: every LR and HR frame of ``sequences``
    loaded once as uint8, then random ``window``-frame windows with
    centre-frame GT."""

    def __init__(self, lr_root: str, hr_root: str, sequences: Sequence[str],
                 window: int = 7, grayscale: bool = True):
        self.window = window
        self.lr_clips = [_load_clip(lr_root, s, grayscale) for s in sequences]
        self.hr_clips = [_load_clip(hr_root, s, grayscale) for s in sequences]

    def sample(self, rng: np.random.Generator, lr_patch: int = 128,
               scale: int = 4):
        """A random clip, window, aligned crop and flips.  Returns (lr
        (T,p,p,C) f32, gt_center (P,P,C) f32) in [0, 1]."""
        ci = int(rng.integers(len(self.lr_clips)))
        lr_clip, hr_clip = self.lr_clips[ci], self.hr_clips[ci]
        idx = segment_indices(rng, len(lr_clip), self.window)
        lr = lr_clip[idx]
        gt = hr_clip[idx[self.window // 2]][None]
        lr, gt = paired_random_crop(rng, lr, gt, lr_patch, scale)
        lr, gt = paired_flip_rotate(rng, lr, gt)
        return to_float(lr), to_float(gt[0])


class SideInfoClipCache:
    """HEVC coding-prior clips: per sequence, LR / HR Y frames and the side
    information under ``side_root/<seq>/``: ``MV_l0/NNNNN_mvl0.npy``,
    ``Residue/NNNNN_res.npy`` (both clipped to int8),
    ``Partition_Map/NNNNN_M_mask.png`` and
    ``pred_unfiltered/NNNNN_unflt.png``, all cached once.

    ``sample`` returns a dict for SIDECVSR: ``lrs`` (T,p,p,1), ``mvs``
    (T,p,p,2) raw, ``residue`` ((r + 128) / 255), ``partition`` and
    ``unfiltered`` (T,p,p,1) in [0, 1], ``gt`` (4p,4p,1) of the centre
    frame; a random crop, no flips."""

    def __init__(self, lr_root: str, hr_root: str, side_root: str,
                 sequences: Sequence[str], window: int = 7,
                 frames_per_seq: int = 32):
        self.window = window
        self.clips = []
        for seq in sequences:
            lr = _load_clip(lr_root, seq, True)
            hr = _load_clip(hr_root, seq, True)
            side = os.path.join(side_root, seq)

            def side_npy(sub, suffix):
                return np.stack([np.clip(np.load(os.path.join(
                    side, sub, f"{i:05d}_{suffix}.npy")), -128,
                    127).astype(np.int8) for i in range(lr.shape[0])])

            def side_png(sub, suffix):
                return np.stack([load_image(os.path.join(
                    side, sub, f"{i:05d}_{suffix}.png"), True)[..., 0]
                    for i in range(lr.shape[0])])

            self.clips.append(dict(
                lr=lr, hr=hr, mv=side_npy("MV_l0", "mvl0"),
                res=side_npy("Residue", "res"),
                pm=side_png("Partition_Map", "M_mask"),
                uf=side_png("pred_unfiltered", "unflt")))

    def sample(self, rng: np.random.Generator, lr_patch: int = 64,
               scale: int = 4) -> dict:
        clip = self.clips[int(rng.integers(len(self.clips)))]
        idx = segment_indices(rng, clip["lr"].shape[0], self.window)
        h, w = clip["lr"].shape[1:3]
        top = int(rng.integers(0, h - lr_patch + 1))
        left = int(rng.integers(0, w - lr_patch + 1))

        def crop(a):
            return a[idx][:, top:top + lr_patch, left:left + lr_patch]

        center = idx[self.window // 2]
        return {
            "lrs": to_float(crop(clip["lr"])),
            "mvs": crop(clip["mv"]).astype(np.float32),
            "residue": (crop(clip["res"]).astype(np.float32)[..., None]
                        + 128.0) / 255.0,
            "partition": to_float(crop(clip["pm"])[..., None]),
            "unfiltered": to_float(crop(clip["uf"])[..., None]),
            "gt": to_float(clip["hr"][center,
                                      top * scale:(top + lr_patch) * scale,
                                      left * scale:(left + lr_patch) * scale]),
        }


@dataclass
class MM522Dataset:
    """MMCNN's MM520/522 training set.  Keys come from a meta file of
    slash-separated lines ``root/sub/.../clipA/clipB/frame``: the trailing
    ``clipA/clipB/frame``, its frames under ``{lq,gt}_root/clipA/clipB/``.
    ``val_partition`` 'official' leaves out clips 240-269 (as REDS does),
    'eval' the clip 'eval_000'.  Training windows take a random interval of
    ``interval_list`` and, with ``random_reverse``, run backwards half the
    time."""

    lq_root: str
    gt_root: str
    meta_file: str
    num_input_frames: int = 7
    scale: int = 4
    val_partition: str = "official"
    interval_list: Tuple[int, ...] = (1,)
    random_reverse: bool = False

    def __post_init__(self):
        if self.val_partition == "eval":
            val = {"eval_000"}
        elif self.val_partition == "official":
            val = {f"{v:03d}" for v in range(240, 270)}
        else:
            raise ValueError(
                f"Wrong validation partition {self.val_partition}. "
                "Supported ones are ['official', 'eval'].")
        self.keys = []
        with open(self.meta_file) as f:
            for line in f:
                parts = line.strip().split("/")
                if len(parts) < 3:
                    continue
                key = "/".join(parts[-3:])
                if key.split("/")[0] not in val:
                    self.keys.append(key)

    def sample_train_window(self, rng: np.random.Generator,
                            lr_patch: int = 64):
        """A centre-GT training window.  Returns (lr (T,p,p,C), gt
        (P,P,C)) f32 in [0, 1]."""
        key = self.keys[int(rng.integers(len(self.keys)))]
        clip = os.path.dirname(key)
        lr_paths = _list_frames(os.path.join(self.lq_root, clip))
        gt_paths = _list_frames(os.path.join(self.gt_root, clip))
        interval = int(self.interval_list[
            int(rng.integers(len(self.interval_list)))])
        idx = segment_indices(rng, len(lr_paths), self.num_input_frames,
                              interval)
        if self.random_reverse and rng.uniform() < 0.5:
            idx = idx[::-1]
        lr = np.stack([load_image(lr_paths[j]) for j in idx])
        gt = load_image(gt_paths[idx[len(idx) // 2]])[None]
        lr, gt = paired_random_crop(rng, lr, gt, lr_patch, self.scale)
        lr, gt = paired_flip_rotate(rng, lr, gt)
        return to_float(lr), to_float(gt[0])
