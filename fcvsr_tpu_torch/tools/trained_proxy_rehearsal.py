"""Rehearsal of released-weight PSNR validation on trained weights
(counterpart of ``tools/trained_proxy_rehearsal.py``).

The reference's released FCVSR weights are not reachable from here, so
this runs the whole validation path on the strongest proxy there is: the
port's FCVSR-S at RGB width (the ``fcvsr_s_redsLD_QP37`` topology),
trained for ``--steps`` steps on synthetic clips (``build_clips``) by the
port's own train step (``train.trainer``: Adam, mean Charbonnier on random
crops, as the JAX tool's loop), then

1. saved with ``torch.save(model.state_dict())``, as CVSR_train releases
   weights;
2. evaluated in this process by ``cli.evaluate_sequence``, as ``cli``
   averages it (each sequence's mean PSNR on Y, then their mean);
3. handed to ``tools.validate_released_ckpt`` (``read_weights``, a new
   model, the serving CLI) with ``--expected-psnr`` that number and the
   release tolerance, 0.01 dB.

Exit 0 only on a PASS.  It trains and serves on the card unless
``--device cpu``.

    python -m fcvsr_tpu_torch.tools.trained_proxy_rehearsal [--steps 300] \\
        [--seed 0] [--tolerance 0.01] [--lr-size 24,32] [--frames 10] \\
        [--seqs 2] [--lr-patch 16] [--batch 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["main", "rehearse", "build_clips", "train_proxy", "eval_psnr",
           "PRESET"]

PRESET = "fcvsr_s_redsLD_QP37"


def build_clips(root: str, rng: np.random.Generator, n_seqs: int,
                n_frames: int, lh: int, lw: int) -> None:
    """Synthetic paired RGB clips under ``root/{lr,gt}/seq_<s>/``: a smooth
    drifting GT with a little noise, the LR its exact 4x4 area mean (the
    JAX tool's ``build_clips``, draw for draw), so that a few training
    steps move the PSNR."""
    from PIL import Image

    for s in range(n_seqs):
        lr_dir = os.path.join(root, "lr", f"seq_{s}")
        gt_dir = os.path.join(root, "gt", f"seq_{s}")
        os.makedirs(lr_dir), os.makedirs(gt_dir)
        base = rng.uniform(0, 255, (lh + 8, lw + 8, 3)).astype(np.float32)
        # band-limit by box-blurring the random field a few times
        for _ in range(3):
            base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                    + np.roll(base, -1, 0) + np.roll(base, -1, 1)) / 5.0
        for i in range(n_frames):
            crop = base[i % 4: i % 4 + lh, i % 3: i % 3 + lw]
            gt = np.kron(crop, np.ones((4, 4, 1), np.float32))
            gt += rng.uniform(-3, 3, gt.shape).astype(np.float32)
            gt = np.clip(gt, 0, 255)
            lr = gt.reshape(lh, 4, lw, 4, 3).mean((1, 3))
            Image.fromarray(gt.astype(np.uint8)).save(
                os.path.join(gt_dir, f"{i:08d}.png"))
            Image.fromarray(lr.astype(np.uint8)).save(
                os.path.join(lr_dir, f"{i:08d}.png"))


def train_proxy(model, ds, rng: np.random.Generator, steps: int,
                lr_patch: int, batch: int, device, lr: float = 1e-4):
    """``steps`` updates of ``model`` by the port's train step: Adam
    (0.9, 0.999) at a constant ``lr``, mean Charbonnier, ``batch`` random
    windows of ``lr_patch`` LR pixels a step.  Returns the first and the
    last loss."""
    from ..train.cli import sample_batch
    from ..train.trainer import TrainState, make_train_step

    state = TrainState(model, lambda step: lr, betas=(0.9, 0.999))
    step = make_train_step(state, "charbonnier_mean")
    model.train()
    losses = []
    for it in range(steps):
        lrs, gt = sample_batch(rng, ds, batch, lr_patch)
        losses.append(float(step(torch.from_numpy(lrs).to(device),
                                 torch.from_numpy(gt).to(device))["loss"]))
        if it % 50 == 0:
            print(f"  step {it}: loss {losses[-1]:.5f}", flush=True)
    return losses[0], losses[-1]


def eval_psnr(model, cfg, ds, seqs, device) -> float:
    """The PSNR ``cli`` reports for ``model`` over ``seqs``: each
    sequence's mean over its frames (``cli.evaluate_sequence``, the
    config's channel conversion and border), then their mean."""
    from .. import cli

    model.eval()
    return float(np.mean([cli.evaluate_sequence(
        model, ds, seq, convert_to=cfg.eval.convert_to,
        crop_border=cfg.eval.crop_border, device=device, tof=False)["psnr"]
        for seq in seqs]))


def rehearse(argv=None) -> dict:
    """The rehearsal of :func:`main`'s arguments; returns its summary (the
    JSON line's ``trained_proxy_rehearsal``), ``parity_rc`` the validation
    tool's exit code."""
    ap = argparse.ArgumentParser(
        description="trained-proxy rehearsal of released-weight validation")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=0.01)
    ap.add_argument("--lr-size", default="24,32")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--seqs", type=int, default=2)
    ap.add_argument("--lr-patch", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from .. import cli, profiling
    from ..data import ClipFolderDataset
    from ..utils.config import preset
    from . import validate_released_ckpt

    device = profiling.need_device(args.device)
    lh, lw = (int(v) for v in args.lr_size.split(","))
    rng = np.random.default_rng(args.seed)
    cfg = preset(PRESET)
    with tempfile.TemporaryDirectory() as td:
        build_clips(td, rng, args.seqs, args.frames, lh, lw)
        lr_root, gt_root = os.path.join(td, "lr"), os.path.join(td, "gt")
        ds = ClipFolderDataset(lr_root=lr_root, gt_root=gt_root,
                               window=cfg.model.num_frames,
                               grayscale=cfg.model.in_channels == 1,
                               padding=cfg.data.window_padding)
        model = cli.build_model(cfg, args.seed, device)
        t0 = time.perf_counter()
        loss0, loss1 = train_proxy(model, ds, rng, args.steps, args.lr_patch,
                                   args.batch, device)
        train_s = time.perf_counter() - t0
        print(f"trained {args.steps} steps in {train_s:.1f} s: loss "
              f"{loss0:.5f} -> {loss1:.5f}", flush=True)
        pth = os.path.join(td, "FCVSR_S_trained_proxy.pth")
        torch.save(model.state_dict(), pth)
        expected = eval_psnr(model, cfg, ds, ds.sequences, device)
        print(f"in-process eval PSNR: {expected:.6f} dB", flush=True)
        verdict = validate_released_ckpt.validate(
            [pth, "--preset", PRESET, "--lr-root", lr_root,
             "--gt-root", gt_root, "--expected-psnr", repr(expected),
             "--tolerance", str(args.tolerance), "--device", args.device,
             "--no-tof"])
    return {"steps": args.steps, "loss_first": loss0, "loss_last": loss1,
            "psnr_db": expected, "validated_psnr_db": verdict["psnr"],
            "delta_db": verdict["delta_db"], "tolerance_db": args.tolerance,
            "train_s": train_s, "device": str(device),
            "parity_rc": verdict["rc"], "pass": verdict["rc"] == 0}


def main(argv=None) -> int:
    """Run :func:`rehearse`, print its JSON line; exit 0 only on a PASS."""
    summary = rehearse(argv)
    print(json.dumps({"trained_proxy_rehearsal": summary}), flush=True)
    return summary["parity_rc"]


if __name__ == "__main__":
    sys.exit(main())
