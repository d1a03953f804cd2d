"""Publish weights: strip the training state, stamp a content hash
(counterpart of ``tools/publish_model.py``, mmcv's convention: drop the
optimizer, append the first 8 hex digits of the file's sha256 to its
name).

    python -m fcvsr_tpu_torch.tools.publish_model \\
        --ckpt work_dirs/<name>/ckpt --out fcvsr_qp37 [--ema]
    python -m fcvsr_tpu_torch.tools.publish_model --ckpt W.pth|W.npz --out X

The input is a port training checkpoint, a directory of them (its newest,
``utils.checkpoint.latest_checkpoint``), or a ``.pt``, ``.pth`` or
``.npz`` weights file (``utils.checkpoint.read_weights``: a raw
state_dict, mmcv's ``{"state_dict": ...}`` or DataParallel's keys);
``--ema`` takes a checkpoint's EMA weights where it holds them.  The
output is a ``torch.save``d state_dict under the reference key names,
which are the port's own, written through a temporary file and named
``<out>-<sha256[:8]>.pth``: what ``cli --torch-checkpoint`` and
``tools.validate_released_ckpt`` read, and what ``load_state_dict(
strict=True)`` takes.  Host only.
"""

from __future__ import annotations

import argparse
import hashlib
import os

import torch

from ..utils.checkpoint import latest_checkpoint, read_weights

__all__ = ["main", "publish", "load_params"]


def load_params(ckpt: str, use_ema: bool = False) -> dict:
    """The weights in ``ckpt`` (a file, or a directory's newest
    ``iter_<step>.pt``) under their reference names, on the CPU."""
    path = ckpt
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no iter_<step>.pt checkpoint in {ckpt}")
    return read_weights(path, ema=use_ema)


def publish(ckpt: str, out: str, use_ema: bool = False) -> str:
    """Write ``ckpt``'s weights to ``<out>-<sha256[:8]>.pth``; returns that
    path."""
    params = {k: v.detach().contiguous()
              for k, v in load_params(ckpt, use_ema).items()}
    tmp = out + ".tmp.pth"
    torch.save(params, tmp)
    with open(tmp, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    final = f"{out}-{digest}.pth"
    os.replace(tmp, final)
    return final


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="publish port weights")
    ap.add_argument("--ckpt", required=True,
                    help="a port checkpoint (iter_<step>.pt), a directory "
                         "of them, or a .pt/.pth/.npz weights file")
    ap.add_argument("--out", required=True, help="output basename")
    ap.add_argument("--ema", action="store_true",
                    help="publish the EMA weights when present")
    args = ap.parse_args(argv)
    final = publish(args.ckpt, args.out, args.ema)
    n = len(torch.load(final, map_location="cpu", weights_only=True))
    print(f"published {final} ({n} tensors)", flush=True)
    return final


if __name__ == "__main__":
    main()
