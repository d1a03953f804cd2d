"""Training entry point of the port (counterpart of ``train.py`` for the
FCVSR models), on one device:

    python -m fcvsr_tpu_torch.train.cli --preset fcvsr_cvcpLD_QP22 \\
        --lr-root LR --gt-root GT --work-dir work_dirs [--total-iters N]
    python -m fcvsr_tpu_torch.train.cli --preset fcvsr_vimeoLD_QP22 \\
        --lr-root LR --gt-root GT --meta-file meta_info_Vimeo90K_train.txt \\
        [--val-lr-root VLR --val-gt-root VGT] [--tensorboard]

It samples batches of 7-frame LR windows and centre GT patches (numpy,
seeded) from the clip folders, or from Vimeo-90K septuplets when the
dataset is ``vimeo`` and a meta file is given (``build_dataset``, as
``train.py`` chooses), runs forward, loss, backward and one Adam update a
step, and keeps ``<work_dir>/<name>/``: ``config.json``,
``train_log.csv`` and ``ckpt/iter_<step>.pt`` every ``ckpt_interval``
steps and at the end.  The CSV has a row ``step, loss, ms`` every
``log_interval`` steps and at the last (ms: on a CUDA device the median
CUDA-event ms a step over the interval, where the JAX CLI writes the
interval's wall seconds), and, with ``--val-lr-root`` and
``--val-gt-root``, a row ``step, eval_psnr, PSNR`` every
``eval_interval`` steps: the PSNR over the first 8 windows of the first
validation sequence (:func:`run_eval`, the JAX CLI's ``run_eval``).
``--tensorboard`` also writes ``train/loss``, ``train/iters_per_sec`` and
``eval/psnr`` to ``<work_dir>/<name>/tb``; the CSV stays the record.  It
resumes from the newest checkpoint there unless ``--resume-from`` or
``--load-from`` says otherwise.  Weights start random, from the seed.
MGAA trains with materialised kernels (``k_fused`` is inference only).

``--fast`` and ``--warp-impl`` are the JAX CLI's flags: there they route
training through the Pallas kernels, both directions.  On the card the
port always trains through its exact kernels (the IAC iteration, the
conv pair and conv, the IAC adjoint), so both flags select what already
runs and change nothing.  ``--device`` defaults to cuda and does not fall
back to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..cli import build_model
from ..data import ClipFolderDataset, Vimeo90KDataset
from ..metrics import calculate_psnr
from ..utils.checkpoint import (load_weights, restore_checkpoint,
                                save_checkpoint)
from ..utils.config import ExperimentConfig, preset
from .lr_schedule import build_schedule
from .trainer import TrainState, make_train_step

__all__ = ["main", "sample_batch", "build_dataset", "run_eval"]


def build_dataset(cfg):
    """Vimeo-90K septuplets when the dataset is ``vimeo`` and a meta file
    is given, else the clip folders, as ``train.py`` chooses."""
    d = cfg.data
    if d.dataset == "vimeo" and d.meta_file:
        return Vimeo90KDataset(d.lr_root, d.gt_root, d.meta_file)
    return ClipFolderDataset(lr_root=d.lr_root, gt_root=d.gt_root,
                             window=cfg.model.num_frames,
                             grayscale=cfg.model.in_channels == 1,
                             padding=d.window_padding)


def sample_batch(rng: np.random.Generator, dataset, batch_size: int,
                 lr_patch: int):
    """(lrs (B, T, C, p, p), gt (B, C, 4p, 4p)) float32, drawn as the JAX
    package's ``train.sample_batch`` draws them: a window of the clip
    folders, or a septuplet of a dataset without windows (Vimeo-90K).
    :func:`main` draws one batch and drops it before its loop, as the JAX
    CLI draws the batch that initialises its state, so step i of both
    trains on the same batch."""
    draw = getattr(dataset, "sample_train_window", None) or \
        dataset.sample_train
    lrs, gts = [], []
    for _ in range(batch_size):
        lr, gt = draw(rng, lr_patch)
        lrs.append(np.transpose(lr, (0, 3, 1, 2)))
        gts.append(np.transpose(gt, (2, 0, 1)))
    return np.stack(lrs), np.stack(gts)


@torch.no_grad()
def run_eval(model, cfg, val_lr_root: str, val_gt_root: str,
             device) -> float:
    """The mean PSNR of the model's SR over the first 8 windows of the first
    validation sequence (the JAX CLI's ``run_eval``: SR clipped to [0, 255],
    against the GT frame, on every channel).  The model runs in eval mode
    on ``device``, one window a forward, and returns to train mode."""
    ds = ClipFolderDataset(lr_root=val_lr_root, gt_root=val_gt_root,
                           window=cfg.model.num_frames,
                           grayscale=cfg.model.in_channels == 1)
    model.eval()
    psnrs = []
    for i, window, gt in ds.iter_test_windows(ds.sequences[0]):
        x = np.transpose(window.astype(np.float32) / 255.0, (0, 3, 1, 2))
        sr = model(torch.from_numpy(x[None]).to(device))[0]
        sr255 = np.clip(sr.float().cpu().numpy().transpose(1, 2, 0) * 255,
                        0, 255)
        psnrs.append(calculate_psnr(sr255, gt.astype(np.float32)))
        if i >= 7:
            break
    model.train()
    return float(np.mean(psnrs))


def _make_tb(work_dir: str, enabled: bool):
    """TensorBoard scalars beside the CSV (the JAX CLI's ``_make_tb``):
    a ``SummaryWriter`` on ``<work_dir>/tb``, or None when not asked or
    when ``torch.utils.tensorboard`` does not import."""
    if not enabled:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        print("[tb] torch.utils.tensorboard unavailable; skipping",
              flush=True)
        return None
    return SummaryWriter(os.path.join(work_dir, "tb"))


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
            ("meta_file", "data", "meta_file"),
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
    parser.add_argument("--meta-file", type=str, default="",
                        help="Vimeo-90K meta-info list (dataset vimeo): "
                             "train on its septuplets")
    parser.add_argument("--work-dir", type=str, default="")
    parser.add_argument("--total-iters", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=0)
    parser.add_argument("--lr-patch", type=int, default=0)
    parser.add_argument("--val-lr-root", type=str, default="",
                        help="periodic eval sequence dir (LR), every "
                             "eval_interval steps")
    parser.add_argument("--val-gt-root", type=str, default="")
    parser.add_argument("--load-from", type=str, default="",
                        help="weights only: a port .pt or a reference-keyed "
                             ".npz state_dict; starts at step 0")
    parser.add_argument("--resume-from", type=str, default="",
                        help="full state from a checkpoint file or dir")
    parser.add_argument("--fast", action="store_true",
                        help="the JAX CLI's fused-kernel training; on the "
                             "card the port always trains through its "
                             "exact kernels (IAC iteration, conv pair and "
                             "conv, IAC adjoint), so this changes nothing")
    parser.add_argument("--warp-impl", type=str, default="",
                        choices=["", "gather", "pallas"],
                        help="the JAX CLI's FCVSR warp override; the port "
                             "has one warp, its exact IAC kernel, which "
                             "both values select")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also log scalars to <work_dir>/<name>/tb")
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

    model = build_model(cfg, cfg.train.seed, device).train()
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

    dataset = build_dataset(cfg)
    # as in the JAX CLI, the data stream starts from the seed on every run,
    # resumed runs included, and its first batch (JAX initialises its state
    # with it) is not trained on
    rng = np.random.default_rng(cfg.train.seed)
    sample_batch(rng, dataset, cfg.data.batch_size, cfg.data.lr_patch)
    step = make_train_step(state, cfg.train.loss)
    timed = device.type == "cuda"
    evals = bool(args.val_lr_root and args.val_gt_root)
    tb = _make_tb(work_dir, args.tensorboard)
    losses, events, pending, psnrs = [], [], [], []
    steps, t0 = 0, time.time()
    with open(os.path.join(work_dir, "train_log.csv"), "a", newline="") as f:
        log = csv.writer(f)
        for it in range(start, cfg.train.total_iters):
            lrs, gt = (torch.from_numpy(a).to(device) for a in sample_batch(
                rng, dataset, cfg.data.batch_size, cfg.data.lr_patch))
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            losses.append(step(lrs, gt)["loss"])
            steps += 1
            if timed:
                ev[1].record()
                events.append(ev)
                pending.append(ev)
            if (it + 1) % cfg.train.log_interval == 0 or \
                    it + 1 == cfg.train.total_iters:
                loss = float(losses[-1])
                med = float(np.median(_ms(pending))) if pending else None
                dt = time.time() - t0
                log.writerow([it + 1, loss, "" if med is None else med])
                f.flush()
                print(f"iter {it + 1}/{cfg.train.total_iters} loss {loss:.5f}"
                      + ("" if med is None else f" {med:.2f} ms/step")
                      + f" ({steps / dt:.2f} it/s)", flush=True)
                if tb is not None:
                    tb.add_scalar("train/loss", loss, it + 1)
                    tb.add_scalar("train/iters_per_sec", steps / dt, it + 1)
                pending, steps = [], 0
                t0 = time.time()
            if (it + 1) % cfg.train.ckpt_interval == 0:
                save_checkpoint(ckpt_dir, state)
            if evals and (it + 1) % cfg.train.eval_interval == 0:
                psnr = run_eval(model, cfg, args.val_lr_root,
                                args.val_gt_root, device)
                psnrs.append((it + 1, psnr))
                print(f"[eval] iter {it + 1} PSNR {psnr:.4f}", flush=True)
                log.writerow([it + 1, "eval_psnr", psnr])
                f.flush()
                if tb is not None:
                    tb.add_scalar("eval/psnr", psnr, it + 1)
    if tb is not None:
        tb.close()
    save_checkpoint(ckpt_dir, state)
    print("training complete", flush=True)
    return {"start": start, "step": state.step,
            "losses": [float(v) for v in losses],
            "ms_per_step": _ms(events) if timed else None,
            "eval_psnr": psnrs,
            "device": torch.cuda.get_device_name(device) if timed else "cpu",
            "work_dir": work_dir}


def _ms(events) -> list:
    """CUDA-event ms of each (start, end) pair (synchronises)."""
    if events:
        events[-1][1].synchronize()
    return [a.elapsed_time(b) for a, b in events]


if __name__ == "__main__":
    main()
