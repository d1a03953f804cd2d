"""DIV2K dataset preparation: overlapped sub-images and their LMDBs
(counterpart of ``tools/preprocess_div2k_dataset.py``, after the
reference's ``tools/data/super-resolution/div2k/preprocess_div2k_dataset.py``,
``main_extract_subimages`` and ``make_lmdb_for_div2k``).

The HR folder is cut at ``--crop-size`` / ``--step`` / ``--thresh-size``
and each ``LR_bicubic/X{scale}`` folder at those values divided by the
scale; with ``--make-lmdb`` each ``_sub`` folder is packed, keys the
sub-image names (``preprocess_reds_dataset.make_lmdb``, 'flat').  One
process, PIL (the reference's thread pool only overlaps file I/O: the
files are the same).  Host only.

    python -m fcvsr_tpu_torch.tools.preprocess_div2k_dataset \\
        --data-root /data/DIV2K [--scales 2 3 4] [--crop-size 480] \\
        [--step 240] [--thresh-size 0] [--make-lmdb]
"""

from __future__ import annotations

import argparse
import os

from .preprocess_reds_dataset import extract_subimages, make_lmdb

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="DIV2K sub-images and LMDBs")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--scales", nargs="*", type=int, default=[2, 3, 4])
    ap.add_argument("--crop-size", type=int, default=480)
    ap.add_argument("--step", type=int, default=240)
    ap.add_argument("--thresh-size", type=int, default=0)
    ap.add_argument("--compression-level", type=int, default=3)
    ap.add_argument("--make-lmdb", action="store_true",
                    help="also pack each _sub folder into a .lmdb")
    args = ap.parse_args(argv)

    root = args.data_root
    jobs = [(os.path.join(root, "DIV2K_train_HR"),
             os.path.join(root, "DIV2K_train_HR_sub"),
             os.path.join(root, "DIV2K_train_HR_sub.lmdb"), 1)]
    for s in args.scales:
        jobs.append((os.path.join(root, f"DIV2K_train_LR_bicubic/X{s}"),
                     os.path.join(root, f"DIV2K_train_LR_bicubic/X{s}_sub"),
                     os.path.join(root,
                                  f"DIV2K_train_LR_bicubic_X{s}_sub.lmdb"),
                     s))
    for src, dst, lmdb_path, s in jobs:
        extract_subimages(src, dst, crop_size=args.crop_size // s,
                          step=args.step // s,
                          thresh_size=args.thresh_size // s,
                          compress_level=args.compression_level)
        if args.make_lmdb:
            make_lmdb(dst, lmdb_path, key_style="flat")


if __name__ == "__main__":
    main()
