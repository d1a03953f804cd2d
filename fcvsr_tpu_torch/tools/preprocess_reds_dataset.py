"""REDS dataset preparation: LMDB authoring, the train/val merge and
sub-image extraction (counterpart of ``tools/preprocess_reds_dataset.py``,
after the reference's
``tools/data/super-resolution/reds/preprocess_reds_dataset.py``).

``make_lmdb`` packs a PNG frame tree into the canonical ``.lmdb`` folder
(``data.mdb``, ``lock.mdb`` and ``meta_info.txt`` with ``key.png (h,w,c)
level`` lines, keys ``<sequence>_<frame>``, or the name alone with
``key_style='flat'``), written by the port's pure-Python
``data.lmdb_writer.LmdbWriter``; ``merge_train_val`` renumbers the val
sequences to 240+ inside the train folder; ``extract_subimages`` cuts
overlapped sub-images (the DIV2K and DF2K_OST scripts use it).  PNG
coding is PIL's, so the files equal the JAX tool's byte for byte.  Host
only.

    python -m fcvsr_tpu_torch.tools.preprocess_reds_dataset \\
        --data-path FRAMES --lmdb-path out.lmdb [--expect-shape 720x1280]
"""

from __future__ import annotations

import argparse
import io
import os
import re
import shutil

import numpy as np

__all__ = ["main", "make_lmdb", "merge_train_val", "extract_subimages"]


def make_lmdb(data_path: str, lmdb_path: str, compress_level: int = 1,
              expect_shape: tuple | None = None,
              key_style: str = "seq_frame"):
    """Pack every PNG under ``data_path`` (sorted by path) into the LMDB
    folder ``lmdb_path``, which must not exist.  ``key_style``:
    'seq_frame' = '<sequence>_<frame>' (REDS video trees); 'flat' = the
    image name without its extension (DIV2K/DF2K sub-image folders, the
    reference's ``prepare_keys_div2k``).  ``expect_shape`` (h, w) refuses
    other frames."""
    from PIL import Image

    from ..data.lmdb_writer import LmdbWriter

    if os.path.exists(lmdb_path):
        raise FileExistsError(f"{lmdb_path} already exists")
    img_paths = sorted(os.path.join(root, f)
                       for root, _, files in os.walk(data_path)
                       for f in files if f.endswith(".png"))
    if not img_paths:
        raise FileNotFoundError(f"no PNGs under {data_path}")

    writer = LmdbWriter(lmdb_path)
    meta_lines = []
    for path in img_paths:
        folder = os.path.basename(os.path.dirname(path))
        name = os.path.splitext(os.path.basename(path))[0]
        key = name if key_style == "flat" else f"{folder}_{name}"
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        h, w, c = img.shape
        if expect_shape is not None and (h, w) != tuple(expect_shape):
            raise ValueError(f"{path}: shape {(h, w)} != {expect_shape}")
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG",
                                  compress_level=compress_level)
        writer.put(key.encode("ascii"), buf.getvalue())
        meta_lines.append(f"{key}.png ({h},{w},{c}) {compress_level}\n")
    writer.close()
    with open(os.path.join(lmdb_path, "meta_info.txt"), "w") as f:
        f.writelines(meta_lines)
    print(f"wrote {len(img_paths)} frames to {lmdb_path}", flush=True)


def merge_train_val(train_path: str, val_path: str):
    """Move the REDS val sequences 000..029 into the train folder as
    240..269 (the reference's preprocess_reds_dataset.py:116-140)."""
    for seq in sorted(os.listdir(val_path)):
        src = os.path.join(val_path, seq)
        if os.path.isdir(src):
            shutil.move(src, os.path.join(train_path, f"{int(seq) + 240:03d}"))
    print(f"merged val sequences into {train_path}", flush=True)


def extract_subimages(input_folder: str, save_folder: str,
                      crop_size: int = 480, step: int = 240,
                      thresh_size: int = 0, compress_level: int = 3):
    """Cut each PNG of ``input_folder`` into overlapped ``crop_size``
    squares at ``step``, with a last window flush against each edge when
    the remainder exceeds ``thresh_size`` (the reference's DIV2K
    ``extract_subimages`` / ``worker``), saved as
    ``<name>_s{idx:03d}.png`` (``x2``..``x8`` taken out of the name) in the
    new folder ``save_folder``."""
    from PIL import Image

    if os.path.exists(save_folder):
        raise FileExistsError(f"{save_folder} already exists")
    os.makedirs(save_folder)
    names = sorted(f for f in os.listdir(input_folder) if f.endswith(".png"))
    if not names:
        raise FileNotFoundError(f"no PNGs under {input_folder}")
    count = 0
    for fname in names:
        img = np.asarray(Image.open(os.path.join(input_folder, fname)))
        name = re.sub("x[2348]", "", os.path.splitext(fname)[0])
        h, w = img.shape[:2]
        h_space = list(range(0, h - crop_size + 1, step))
        if h - (h_space[-1] + crop_size) > thresh_size:
            h_space.append(h - crop_size)
        w_space = list(range(0, w - crop_size + 1, step))
        if w - (w_space[-1] + crop_size) > thresh_size:
            w_space.append(w - crop_size)
        idx = 0
        for y in h_space:
            for x in w_space:
                idx += 1
                Image.fromarray(img[y:y + crop_size, x:x + crop_size]).save(
                    os.path.join(save_folder, f"{name}_s{idx:03d}.png"),
                    compress_level=compress_level)
                count += 1
    print(f"wrote {count} sub-images to {save_folder}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="pack REDS frames into LMDB")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--lmdb-path", required=True)
    ap.add_argument("--compress-level", type=int, default=1)
    ap.add_argument("--expect-shape", default="",
                    help="HxW to enforce (e.g. 720x1280); empty = any")
    args = ap.parse_args(argv)
    shape = tuple(map(int, args.expect_shape.split("x"))) \
        if args.expect_shape else None
    make_lmdb(args.data_path, args.lmdb_path, args.compress_level, shape)


if __name__ == "__main__":
    main()
