"""Training entry point of the port (counterpart of ``train.py`` for the
FCVSR models), on one device:

    python -m fcvsr_tpu_torch.train.cli --preset fcvsr_cvcpLD_QP22 \\
        --lr-root LR --gt-root GT --work-dir work_dirs [--total-iters N]

It samples batches of 7-frame LR windows and centre GT patches from the clip
folders (numpy, seeded), runs forward, loss, backward and one Adam update a
step, and keeps ``<work_dir>/<name>/``: ``config.json``, ``train_log.csv``
(one line per ``log_interval`` steps: step, loss and, on a CUDA device, the
median CUDA-event ms per step over the interval) and ``ckpt/iter_<step>.pt``
every ``ckpt_interval`` steps and at the end.  It resumes from the newest
checkpoint there unless ``--resume-from`` or ``--load-from`` says otherwise.
Weights start random, from the seed.  MGAA trains with materialised
kernels (``k_fused`` is inference only).  ``--device`` defaults to cuda and
does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ..cli import build_model
from ..data import ClipFolderDataset
from ..utils.checkpoint import (load_weights, restore_checkpoint,
                                save_checkpoint)
from ..utils.config import ExperimentConfig, preset
from .lr_schedule import build_schedule
from .trainer import TrainState, make_train_step

__all__ = ["main", "sample_batch"]


def sample_batch(rng: np.random.Generator, dataset: ClipFolderDataset,
                 batch_size: int, lr_patch: int):
    """(lrs (B, T, C, p, p), gt (B, C, 4p, 4p)) float32, drawn as the JAX
    package's ``train.sample_batch`` draws them.  :func:`main` draws one
    batch and drops it before its loop, as the JAX CLI draws the batch that
    initialises its state, so step i of both trains on the same batch."""
    lrs, gts = [], []
    for _ in range(batch_size):
        lr, gt = dataset.sample_train_window(rng, lr_patch)
        lrs.append(np.transpose(lr, (0, 3, 1, 2)))
        gts.append(np.transpose(gt, (2, 0, 1)))
    return np.stack(lrs), np.stack(gts)


def _config(args) -> ExperimentConfig:
    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    elif args.preset:
        cfg = preset(args.preset)
    else:
        raise SystemExit("need --preset or --config")
    for flag, section, key in (
            ("lr_root", "data", "lr_root"), ("gt_root", "data", "gt_root"),
            ("work_dir", None, "work_dir"),
            ("total_iters", "train", "total_iters"),
            ("batch_size", "data", "batch_size"),
            ("lr_patch", "data", "lr_patch"),
            ("load_from", "train", "load_from"),
            ("resume_from", "train", "resume_from")):
        value = getattr(args, flag)
        if value:
            setattr(getattr(cfg, section) if section else cfg, key, value)
    if args.seed is not None:
        cfg.train.seed = args.seed
    if cfg.model.name not in ("fcvsr", "fcvsr_s"):
        raise ValueError(f"the port trains fcvsr and fcvsr_s, not "
                         f"{cfg.model.name}")
    return cfg


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="fcvsr_tpu_torch training")
    parser.add_argument("--preset", type=str, default="")
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--lr-root", type=str, default="")
    parser.add_argument("--gt-root", type=str, default="")
    parser.add_argument("--work-dir", type=str, default="")
    parser.add_argument("--total-iters", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=0)
    parser.add_argument("--lr-patch", type=int, default=0)
    parser.add_argument("--load-from", type=str, default="",
                        help="weights only: a port .pt or a reference-keyed "
                             ".npz state_dict; starts at step 0")
    parser.add_argument("--resume-from", type=str, default="",
                        help="full state from a checkpoint file or dir")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the weights and the data sampling "
                             "(default: the config's)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = _config(args)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (pass --device cpu to train on the CPU)")
    work_dir = os.path.join(cfg.work_dir, cfg.name)
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    model = build_model(cfg, cfg.train.seed, device)
    state = TrainState(model, build_schedule(cfg.train),
                       betas=cfg.train.betas, use_ema=cfg.train.use_ema)
    ckpt_dir = os.path.join(work_dir, "ckpt")
    if cfg.train.load_from:
        load_weights(cfg.train.load_from, model)
        start = 0
    elif cfg.train.resume_from:
        start = restore_checkpoint(cfg.train.resume_from, state,
                                   required=True)
    else:
        start = restore_checkpoint(ckpt_dir, state)

    dataset = ClipFolderDataset(lr_root=cfg.data.lr_root,
                                gt_root=cfg.data.gt_root,
                                window=cfg.model.num_frames,
                                grayscale=cfg.model.in_channels == 1,
                                padding=cfg.data.window_padding)
    # as in the JAX CLI, the data stream starts from the seed on every run,
    # resumed runs included, and its first batch (JAX initialises its state
    # with it) is not trained on
    rng = np.random.default_rng(cfg.train.seed)
    sample_batch(rng, dataset, cfg.data.batch_size, cfg.data.lr_patch)
    step = make_train_step(state, cfg.train.loss)
    timed = device.type == "cuda"
    losses, events, pending = [], [], []
    with open(os.path.join(work_dir, "train_log.csv"), "a", newline="") as f:
        log = csv.writer(f)
        for it in range(start, cfg.train.total_iters):
            lrs, gt = (torch.from_numpy(a).to(device) for a in sample_batch(
                rng, dataset, cfg.data.batch_size, cfg.data.lr_patch))
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            losses.append(step(lrs, gt)["loss"])
            if timed:
                ev[1].record()
                events.append(ev)
                pending.append(ev)
            if (it + 1) % cfg.train.log_interval == 0 or \
                    it + 1 == cfg.train.total_iters:
                loss = float(losses[-1])
                med = float(np.median(_ms(pending))) if pending else None
                pending = []
                log.writerow([it + 1, loss, "" if med is None else med])
                f.flush()
                print(f"iter {it + 1}/{cfg.train.total_iters} loss {loss:.5f}"
                      + ("" if med is None else f" {med:.2f} ms/step"),
                      flush=True)
            if (it + 1) % cfg.train.ckpt_interval == 0:
                save_checkpoint(ckpt_dir, state)
    save_checkpoint(ckpt_dir, state)
    print("training complete", flush=True)
    return {"start": start, "step": state.step,
            "losses": [float(v) for v in losses],
            "ms_per_step": _ms(events) if timed else None,
            "device": torch.cuda.get_device_name(device) if timed else "cpu",
            "work_dir": work_dir}


def _ms(events) -> list:
    """CUDA-event ms of each (start, end) pair (synchronises)."""
    if events:
        events[-1][1].synchronize()
    return [a.elapsed_time(b) for a, b in events]


if __name__ == "__main__":
    main()
