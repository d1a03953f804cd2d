"""DF2K_OST dataset preparation, RealBasicVSR's single-image training pool
(counterpart of ``tools/preprocess_df2k_ost_dataset.py``, after the
reference's ``preprocess_df2k_ost_dataset.py`` under
``tools/data/super-resolution/df2k_ost/``): GT-only sub-images from
``df2k_ost/GT`` (the degradations are made while training,
``data.degradations``), and with ``--make-lmdb`` their LMDB, keys the
sub-image names.  Host only.

    python -m fcvsr_tpu_torch.tools.preprocess_df2k_ost_dataset \\
        --data-root /data [--crop-size 400] [--step 200] [--thresh-size 0] \\
        [--make-lmdb]
"""

from __future__ import annotations

import argparse
import os

from .preprocess_reds_dataset import extract_subimages, make_lmdb

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="DF2K_OST sub-images and LMDB")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--crop-size", type=int, default=400)
    ap.add_argument("--step", type=int, default=200)
    ap.add_argument("--thresh-size", type=int, default=0)
    ap.add_argument("--compression-level", type=int, default=3)
    ap.add_argument("--make-lmdb", action="store_true")
    args = ap.parse_args(argv)

    src = os.path.join(args.data_root, "df2k_ost", "GT")
    dst = os.path.join(args.data_root, "df2k_ost", "GT_sub")
    extract_subimages(src, dst, crop_size=args.crop_size, step=args.step,
                      thresh_size=args.thresh_size,
                      compress_level=args.compression_level)
    if args.make_lmdb:
        make_lmdb(dst, os.path.join(args.data_root, "df2k_ost",
                                    "GT_sub.lmdb"), key_style="flat")


if __name__ == "__main__":
    main()
