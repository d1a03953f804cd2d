"""Training entry point of the port (counterpart of ``train.py``: the
FCVSR, FTVSR and TTVSR models, and the GAN family), on one device or
data-parallel over GPUs:

    python -m fcvsr_tpu_torch.train.cli --preset fcvsr_cvcpLD_QP22 \\
        --lr-root LR --gt-root GT --work-dir work_dirs [--total-iters N]
    python -m fcvsr_tpu_torch.train.cli --preset fcvsr_vimeoLD_QP22 \\
        --lr-root LR --gt-root GT --meta-file meta_info_Vimeo90K_train.txt \\
        [--val-lr-root VLR --val-gt-root VGT] [--tensorboard]
    python -m fcvsr_tpu_torch.train.cli --preset ftvsr_cvcpLD_QP22 \\
        --lr-root LR --gt-root GT       (or --config with model.name ttvsr)
    torchrun --nproc-per-node 4 -m fcvsr_tpu_torch.train.cli --multihost \\
        --preset fcvsr_cvcpLD_QP22 --lr-root LR --gt-root GT
    python -m fcvsr_tpu_torch.train.cli --multihost --coordinator HOST:PORT \\
        --num-processes N --process-id I --preset ...   (one per rank)

It samples batches of 7-frame LR windows and centre GT patches (numpy,
seeded) from the clip folders, or from Vimeo-90K septuplets when the
dataset is ``vimeo`` and a meta file is given (``build_dataset``, as
``train.py`` chooses); FTVSR and TTVSR, which restore every frame, take
the GT of every frame of their window (``sample_batch``) and their loss
runs over all of them.  A step runs forward, loss, backward and one Adam
update, and the CLI keeps ``<work_dir>/<name>/``: ``config.json``,
``train_log.csv`` and ``ckpt/iter_<step>.pt`` every ``ckpt_interval``
steps and at the end.  The CSV has a row ``step, loss, ms`` every
``log_interval`` steps and at the last (ms: on a CUDA device the median
CUDA-event ms a step over the interval, where the JAX CLI writes the
interval's wall seconds), and, with ``--val-lr-root`` and
``--val-gt-root``, a row ``step, eval_psnr, PSNR`` every
``eval_interval`` steps: the PSNR over the first 8 windows of the first
validation sequence, of the window's centre frame for FTVSR and TTVSR
(:func:`run_eval`, the JAX CLI's ``run_eval``).
``--tensorboard`` also writes ``train/loss``, ``train/iters_per_sec`` and
``eval/psnr`` to ``<work_dir>/<name>/tb``; the CSV stays the record.  It
resumes from the newest checkpoint there unless ``--resume-from`` or
``--load-from`` says otherwise.  Weights start random, from the seed.
MGAA trains with materialised kernels (``k_fused`` is inference only).

RealBasicVSR, GLEAN and DIC (``--preset realbasicvsr_reds``,
``realbasicvsr_wogan_reds``, ``glean_cat_8x``, ``dic_celeba``,
``dic_gan_celeba``) train through :func:`run_gan_training`, the JAX CLI's
``run_gan_training``: a generator and a discriminator (the U-Net,
StyleGAN2's or LightCNN; none in the ``wogan`` and ``dic_celeba``
recipes), each with its own constant-lr Adam (``train.lr`` and
``gan.disc_lr``, ``train.betas``; no schedule, though the presets name
one), one ``models.GANRestorer`` step a batch.  DIC trains at scale 8,
GLEAN at ``out_size // in_size``, RealBasicVSR at 4; the image families
(GLEAN, DIC) take the centre frame of each window.  With
``data.degradations`` (the RealBasicVSR recipes) the GT clips are read at
scale 1 and the LQ is made from them by ``data.degradations``'s chain,
whose generators are seeded from ``train.seed`` (the JAX package draws
them from the unseeded global streams).  The CSV gets ``step`` and the
sorted losses every ``log_interval`` steps; checkpoints
(``utils.checkpoint.save_gan_checkpoint``) every ``ckpt_interval`` and at
the end; a rerun resumes from the newest.

``--multihost`` (``train.py``'s data-parallel path, ``train.py:365-379``
and ``:454-495``) joins a process group (``parallel.initialize_multihost``:
NCCL, each rank on its card, or Gloo with ``--device cpu``; the three
flags, or torchrun's environment without them; no fallback to one
process) and trains the pixel-loss models under DDP
(``trainer.make_train_step(group=...)``).  The global batch is rounded
down to a multiple of the world size and each rank draws its share from
its own stream, ``np.random.default_rng(seed + rank)``, dropping its
first batch as one process does; the CSV's loss is the mean over ranks
of their losses, the global batch's.  Rank 0 alone writes
``config.json``, the CSV, the checkpoints and TensorBoard and runs the
evaluation, while the others wait at a barrier; every rank restores a
resumed run.  W ranks train as the JAX CLI's ``--multihost`` run of W
processes with one device each; a JAX process that holds N devices draws
one stream for all of them.  The GAN presets refuse ``--multihost``:
``train.py`` runs its single-device GAN trainer on every process
(``train.py:141-147``, ``:417-419``).

``--fast`` and ``--warp-impl`` are the JAX CLI's flags: there they route
training through the Pallas kernels, both directions.  On the card the
port always trains through its exact kernels (the IAC iteration, the
conv pair and conv, the IAC adjoint), so both flags select what already
runs and change nothing.  ``--device`` defaults to cuda and does not fall
back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import random
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import cli
from ..data import ClipFolderDataset, Vimeo90KDataset
from ..metrics import calculate_psnr
from ..models import (DICNet, FTVSRNet, GANRestorer, GLEANStyleGANv2,
                      LightCNN, RealBasicVSRNet, StyleGAN2Discriminator,
                      TTVSRNet, UNetDiscriminatorWithSpectralNorm,
                      init_weights)
from ..parallel import (Mesh, initialize_multihost, make_mesh, shard_batch,
                        shutdown)
from ..parallel.dist import barrier
from ..utils.checkpoint import (load_weights, restore_checkpoint,
                                restore_gan_checkpoint, save_checkpoint,
                                save_gan_checkpoint)
from ..utils.config import ExperimentConfig, preset
from .gan_losses import gan_loss
from .lr_schedule import build_schedule
from .trainer import TrainState, make_train_step

__all__ = ["main", "train", "sample_batch", "local_batch_size",
           "build_dataset", "build_model",
           "build_discriminator", "gan_scale", "gan_sampler", "gan_trainer",
           "run_gan_training",
           "run_eval", "SEQUENCE_MODELS", "GAN_MODELS"]

# the recurrent models that restore (and train on) every frame of a window
SEQUENCE_MODELS = ("ftvsr", "ttvsr")
# the models that train through run_gan_training
GAN_MODELS = ("realbasicvsr", "glean", "dic")
GAN_MULTIHOST = (
    "--multihost trains the pixel-loss models only: train.py runs its "
    "single-device GAN trainer on every process (train.py:141-147, "
    ":417-419), so a GAN preset has no data-parallel path to follow; "
    "train it without --multihost")


def _seeded(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def build_model(cfg, seed: int, device) -> torch.nn.Module:
    """The config's model with seeded random weights, on ``device``, as
    ``train.py::build_model`` builds it: FCVSR through the serving CLI's
    ``build_model``; FTVSR and TTVSR at ``mid_channels = n_feats``, with
    ``num_blocks`` when the config sets it (else the model's 72 or 60);
    RealBasicVSR at ``mid_channels = n_feats`` (``num_blocks`` for both its
    propagation and cleaning trunks when set); GLEAN at ``in_size`` (32) ->
    ``out_size`` (256), ``n_feats`` RRDB channels, ``num_blocks`` RRDBs
    (23); DIC at ``n_feats``, ``hg_num_keypoints``, ``num_steps`` and
    ``num_blocks`` when set."""
    m = cfg.model
    if m.name in SEQUENCE_MODELS:
        kw = {"mid_channels": m.n_feats}
        if m.num_blocks:
            kw["num_blocks"] = m.num_blocks
        model = (FTVSRNet if m.name == "ftvsr" else TTVSRNet)(**kw)
    elif m.name == "realbasicvsr":
        kw = {"mid_channels": m.n_feats}
        if m.num_blocks:
            kw["num_propagation_blocks"] = m.num_blocks
            kw["num_cleaning_blocks"] = m.num_blocks
        model = RealBasicVSRNet(**kw)
    elif m.name == "glean":
        model = GLEANStyleGANv2(in_size=m.in_size or 32,
                                out_size=m.out_size or 256,
                                rrdb_channels=m.n_feats,
                                num_rrdbs=m.num_blocks or 23)
    elif m.name == "dic":
        kw = {"mid_channels": m.n_feats,
              "hg_num_keypoints": m.hg_num_keypoints}
        if m.num_steps:
            kw["num_steps"] = m.num_steps
        if m.num_blocks:
            kw["num_blocks"] = m.num_blocks
        model = DICNet(**kw)
    else:
        return cli.build_model(cfg, seed, device)
    return _seeded(model, seed, device)


def build_discriminator(cfg, seed: int, device):
    """The GAN recipe's discriminator with seeded random weights (None for
    ``gan.disc == 'none'``), as ``train.py::_build_discriminator``: the
    U-Net at ``max(n_feats, 8)`` channels, StyleGAN2's at ``out_size``
    (256), or LightCNN."""
    d = cfg.gan.disc
    if d == "none":
        return None
    if d == "unet_sn":
        disc = UNetDiscriminatorWithSpectralNorm(
            mid_channels=max(cfg.model.n_feats, 8))
    elif d == "stylegan2":
        disc = StyleGAN2Discriminator(in_size=cfg.model.out_size or 256)
    elif d == "lightcnn":
        disc = LightCNN()
    else:
        raise ValueError(f"unknown discriminator {d}")
    return _seeded(disc, seed, device)


def gan_scale(cfg) -> int:
    """The GAN family's SR scale: 8 for DIC, ``out_size // in_size`` for
    GLEAN, else 4."""
    if cfg.model.name == "dic":
        return 8
    if cfg.model.name == "glean":
        return (cfg.model.out_size or 256) // (cfg.model.in_size or 32)
    return 4


def gan_sampler(cfg):
    """``sample(rng) -> (lq, gt)`` float32 numpy batches, as the JAX CLI's
    ``run_gan_training`` draws them: with ``data.degradations``, GT
    sequences read at scale 1 (LR patches of ``4 lr_patch``) and their LQ
    made by the degradation chain, (B, T, 3, p, p) and (B, T, 3, 4p, 4p);
    else RealBasicVSR's LR / GT sequences, or for the image families the
    centre LR frame of a window and its GT, (B, 3, p, p) and (B, 3, sp,
    sp).  The sampler's ``degrade_seconds`` accumulates the host seconds
    spent in the chain."""
    from ..data.degradations import (degrade_sequence,
                                     realbasicvsr_degradation_chain)

    d, t = cfg.data, cfg.model.num_frames
    video = cfg.model.name == "realbasicvsr"
    if d.degradations:
        chain = realbasicvsr_degradation_chain(
            rs=np.random.RandomState(cfg.train.seed),
            py_rng=random.Random(cfg.train.seed))
        ds = ClipFolderDataset(lr_root=d.gt_root, gt_root=d.gt_root,
                               window=t, scale=1)
    else:
        ds = ClipFolderDataset(lr_root=d.lr_root, gt_root=d.gt_root,
                               window=t, scale=gan_scale(cfg))

    def sample(rng):
        lqs, gts = [], []
        for _ in range(d.batch_size):
            if d.degradations:
                gt, _ = ds.sample_train_sequence(rng, 4 * d.lr_patch)
                t0 = time.perf_counter()
                lq = degrade_sequence(chain, gt, 4)
                sample.degrade_seconds += time.perf_counter() - t0
                lqs.append(np.transpose(lq, (0, 3, 1, 2)))
                gts.append(np.transpose(gt, (0, 3, 1, 2)))
            elif video:
                lq, gt = ds.sample_train_sequence(rng, d.lr_patch)
                lqs.append(np.transpose(lq, (0, 3, 1, 2)))
                gts.append(np.transpose(gt, (0, 3, 1, 2)))
            else:
                lq, gt = ds.sample_train_window(rng, d.lr_patch)
                lqs.append(np.transpose(lq[lq.shape[0] // 2], (2, 0, 1)))
                gts.append(np.transpose(gt, (2, 0, 1)))
        return np.stack(lqs), np.stack(gts)

    sample.degrade_seconds = 0.0
    return sample


def _dic_generator_loss(gen, disc, gan):
    """DIC's generator loss in the JAX CLI: every feedback step's SR
    against the GT (L1 times ``pixel_loss_weight``), plus the GAN loss of
    the last SR when there is a discriminator.  No landmark (align) loss:
    the folder data has no landmarks."""

    def loss_fn(lq, gt):
        sr_list, _ = gen(lq)
        logs, total = {}, 0.0
        for k, sr in enumerate(sr_list):
            lp = (sr - gt).abs().mean() * gan.pixel_loss_weight
            logs[f"loss_pixel_v{k}"] = lp
            total = total + lp
        last = sr_list[-1].permute(0, 2, 3, 1)
        if disc is not None:
            lg = gan_loss(disc(last), True, gan.gan_type,
                          loss_weight=gan.gan_loss_weight)
            total, logs["loss_gan"] = total + lg, lg
        return total, logs, last.detach()

    return loss_fn


def gan_trainer(cfg, device):
    """(``GANRestorer``, the generator's Adam, the discriminator's or None)
    of a GAN recipe, the models seeded from ``train.seed`` (the
    discriminator from ``train.seed + 1``) on ``device``; DIC's restorer
    takes the JAX CLI's DIC loss (and its defaults otherwise, as there)."""
    gen = build_model(cfg, cfg.train.seed, device).train()
    disc = build_discriminator(cfg, cfg.train.seed + 1, device)
    betas = tuple(cfg.train.betas)
    g_opt = torch.optim.Adam(gen.parameters(), lr=cfg.train.lr, betas=betas,
                             eps=1e-8)
    d_opt = None if disc is None else torch.optim.Adam(
        disc.parameters(), lr=cfg.gan.disc_lr, betas=betas, eps=1e-8)
    g = cfg.gan
    if cfg.model.name == "dic":
        restorer = GANRestorer(gen, disc, gan_type=g.gan_type)
        restorer.generator_loss = _dic_generator_loss(gen, disc, g)
    else:
        restorer = GANRestorer(
            gen, disc, gan_type=g.gan_type,
            gan_loss_weight=g.gan_loss_weight,
            pixel_loss_weight=g.pixel_loss_weight,
            cleaning_loss_weight=g.cleaning_loss_weight
            if cfg.model.name == "realbasicvsr" else 0.0,
            disc_steps=g.disc_steps, disc_init_steps=g.disc_init_steps,
            relativistic=g.relativistic)
    return restorer, g_opt, d_opt


def run_gan_training(cfg, args, device) -> dict:
    """Train a GAN recipe (RealBasicVSR, GLEAN, DIC) as the JAX CLI's
    ``run_gan_training`` does: the data stream from ``train.seed``, its
    first batch drawn and dropped (JAX initialises with it), a generator
    seeded with ``train.seed`` and a discriminator with ``train.seed + 1``,
    constant-lr Adams, auto-resume from ``<work_dir>/<name>/ckpt``."""
    if cfg.train.load_from or cfg.train.resume_from:
        raise ValueError("the GAN trainer resumes from its work dir only "
                         "(as the JAX CLI's run_gan_training): drop "
                         "--load-from / --resume-from")
    work_dir = os.path.join(cfg.work_dir, cfg.name)
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    rng = np.random.default_rng(cfg.train.seed)
    sample = gan_sampler(cfg)
    sample(rng)
    restorer, g_opt, d_opt = gan_trainer(cfg, device)
    step = restorer.make_train_step(g_opt, d_opt)
    ckpt_dir = os.path.join(work_dir, "ckpt")
    start = restore_gan_checkpoint(ckpt_dir, restorer, g_opt, d_opt)

    timed = device.type == "cuda"
    tb = _make_tb(work_dir, getattr(args, "tensorboard", False))
    history, events, sample_s, degrade_s = [], [], [], []
    t0 = time.time()
    with open(os.path.join(work_dir, "train_log.csv"), "a", newline="") as f:
        log = csv.writer(f)
        for it in range(start, cfg.train.total_iters):
            d0, h0 = sample.degrade_seconds, time.perf_counter()
            lq, gt = (torch.from_numpy(a).to(device) for a in sample(rng))
            sample_s.append(time.perf_counter() - h0)
            degrade_s.append(sample.degrade_seconds - d0)
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            logs = step(lq, gt)
            if timed:
                ev[1].record()
                events.append(ev)
            history.append(logs)
            if (it + 1) % cfg.train.log_interval == 0:
                vals = {k: float(v) for k, v in sorted(logs.items())}
                print(f"iter {it + 1}/{cfg.train.total_iters} " + " ".join(
                    f"{k} {v:.5f}" for k, v in vals.items()), flush=True)
                log.writerow([it + 1] + list(vals.values()))
                f.flush()
                if tb is not None:
                    for k, v in vals.items():
                        tb.add_scalar(f"train/{k}", v, it + 1)
            if (it + 1) % cfg.train.ckpt_interval == 0 or \
                    it + 1 == cfg.train.total_iters:
                save_gan_checkpoint(ckpt_dir, it + 1, restorer, g_opt, d_opt)
    if tb is not None:
        tb.close()
    print(f"training complete ({time.time() - t0:.1f}s)", flush=True)
    return {"start": start, "step": max(start, cfg.train.total_iters),
            "counter": restorer.counter,
            "logs": [{k: float(v) for k, v in h.items()} for h in history],
            "ms_per_step": _ms(events) if timed else None,
            "sample_seconds": sample_s, "degrade_seconds": degrade_s,
            "device": torch.cuda.get_device_name(device) if timed else "cpu",
            "work_dir": work_dir}


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
                 lr_patch: int, sequence: bool = False):
    """(lrs (B, T, C, p, p), gt (B, C, 4p, 4p)) float32, drawn as the JAX
    package's ``train.sample_batch`` draws them: a window of the clip
    folders, or a septuplet of a dataset without windows (Vimeo-90K); with
    ``sequence`` (FTVSR, TTVSR) a window with the GT of every frame, gt
    (B, T, C, 4p, 4p).  :func:`main` draws one batch and drops it before
    its loop, as the JAX CLI draws the batch that initialises its state,
    so step i of both trains on the same batch."""
    if sequence:
        if not hasattr(dataset, "sample_train_sequence"):
            raise ValueError(
                f"{type(dataset).__name__} has no per-frame GT windows "
                "(sample_train_sequence), which FTVSR and TTVSR train on: "
                "give the clip folders, without a meta file")
        draw, gt_axes = dataset.sample_train_sequence, (0, 3, 1, 2)
    else:
        draw = getattr(dataset, "sample_train_window", None) or \
            dataset.sample_train
        gt_axes = (2, 0, 1)
    lrs, gts = [], []
    for _ in range(batch_size):
        lr, gt = draw(rng, lr_patch)
        lrs.append(np.transpose(lr, (0, 3, 1, 2)))
        gts.append(np.transpose(gt, gt_axes))
    return np.stack(lrs), np.stack(gts)


def local_batch_size(batch: int, world: int) -> int:
    """This rank's share of the global batch ``batch`` over ``world``
    ranks, cut as ``train.py:459-466`` cuts it: the global batch rounded
    down to a multiple of the world size (at least the world size; the JAX
    CLI rounds to its devices, one a rank here), then divided by it."""
    if batch % world:
        batch = max(world, batch // world * world)
        print(f"[train] batch rounded to {batch} for {world} ranks",
              flush=True)
    return batch // world


@torch.no_grad()
def run_eval(model, cfg, val_lr_root: str, val_gt_root: str,
             device) -> float:
    """The mean PSNR of the model's SR over the first 8 windows of the first
    validation sequence (the JAX CLI's ``run_eval``: SR clipped to [0, 255],
    against the GT frame, on every channel; FTVSR's and TTVSR's SR is the
    centre frame of their output).  The model runs in eval mode on
    ``device``, one window a forward, and returns to train mode."""
    ds = ClipFolderDataset(lr_root=val_lr_root, gt_root=val_gt_root,
                           window=cfg.model.num_frames,
                           grayscale=cfg.model.in_channels == 1)
    model.eval()
    psnrs = []
    for i, window, gt in ds.iter_test_windows(ds.sequences[0]):
        x = np.transpose(window.astype(np.float32) / 255.0, (0, 3, 1, 2))
        sr = model(torch.from_numpy(x[None]).to(device))[0]
        if cfg.model.name in SEQUENCE_MODELS:
            sr = sr[sr.shape[0] // 2]
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
    if cfg.model.name not in ("fcvsr", "fcvsr_s") + SEQUENCE_MODELS + \
            GAN_MODELS:
        raise ValueError(f"unknown model {cfg.model.name}")
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
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (NCCL under --multihost) or cpu (Gloo)")
    parser.add_argument("--multihost", action="store_true",
                        help="train data-parallel (DDP) over the ranks of a "
                             "process group, a process and a device each")
    parser.add_argument("--coordinator", type=str, default="",
                        help="rank 0's rendezvous, host:port; with "
                             "--num-processes and --process-id (without the "
                             "three, torchrun's environment)")
    parser.add_argument("--num-processes", type=int, default=0)
    parser.add_argument("--process-id", type=int, default=-1)
    args = parser.parse_args(argv)
    cfg = _config(args)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (pass --device cpu to train on the CPU)")
    if cfg.model.name in GAN_MODELS:
        if args.multihost:
            raise ValueError(GAN_MULTIHOST)
        return run_gan_training(cfg, args, device)
    if not args.multihost:
        return train(cfg, args, Mesh(device))
    initialize_multihost(
        args.coordinator or None, args.num_processes or None,
        args.process_id if args.process_id >= 0 else None,
        device=device.type)
    if not dist.is_initialized():
        raise RuntimeError("--multihost: no process group formed; give "
                           "--coordinator, --num-processes and --process-id, "
                           "or launch under torchrun")
    try:
        return train(cfg, args, make_mesh(device, dist.group.WORLD))
    finally:
        shutdown()


def _on_lead(mesh: Mesh, fn):
    """``fn()`` on rank 0 alone (its result there, None elsewhere); in a
    process group the other ranks wait for it at a barrier."""
    out = fn() if mesh.rank == 0 else None
    if mesh.group is not None:
        barrier(mesh.group)
    return out


def train(cfg, args, mesh: Mesh) -> dict:
    """Train a pixel-loss model (FCVSR, FTVSR, TTVSR) on ``mesh``: one
    device (``Mesh(device)``), or this rank of a process group, whose ranks
    step together under DDP (``mesh.group``).  See the module's note."""
    device, lead = mesh.device, mesh.rank == 0
    work_dir = os.path.join(cfg.work_dir, cfg.name)
    if lead:
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
    sequence = cfg.model.name in SEQUENCE_MODELS
    batch = local_batch_size(cfg.data.batch_size, mesh.size)
    # as in the JAX CLI, each rank's data stream starts from the seed plus
    # its rank on every run, resumed runs included, and its first batch
    # (JAX initialises its state with it) is not trained on
    rng = np.random.default_rng(cfg.train.seed + mesh.rank)
    sample_batch(rng, dataset, batch, cfg.data.lr_patch, sequence)
    step = make_train_step(state, cfg.train.loss, group=mesh.group)
    timed = device.type == "cuda"
    evals = bool(args.val_lr_root and args.val_gt_root)
    tb = _make_tb(work_dir, args.tensorboard) if lead else None
    losses, events, pending, psnrs = [], [], [], []
    steps, t0 = 0, time.time()
    with open(os.path.join(work_dir, "train_log.csv"), "a", newline="") \
            if lead else contextlib.nullcontext() as f:
        log = csv.writer(f) if lead else None
        for it in range(start, cfg.train.total_iters):
            lrs, gt = shard_batch(sample_batch(
                rng, dataset, batch, cfg.data.lr_patch, sequence), mesh)
            if timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            losses.append(step(lrs, gt)["loss"])
            steps += 1
            if timed:
                ev[1].record()
                events.append(ev)
                pending.append(ev)
            if lead and ((it + 1) % cfg.train.log_interval == 0 or
                         it + 1 == cfg.train.total_iters):
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
                _on_lead(mesh, lambda: save_checkpoint(ckpt_dir, state))
            if evals and (it + 1) % cfg.train.eval_interval == 0:
                psnr = _on_lead(mesh, lambda: run_eval(
                    model, cfg, args.val_lr_root, args.val_gt_root, device))
                if lead:
                    psnrs.append((it + 1, psnr))
                    print(f"[eval] iter {it + 1} PSNR {psnr:.4f}",
                          flush=True)
                    log.writerow([it + 1, "eval_psnr", psnr])
                    f.flush()
                    if tb is not None:
                        tb.add_scalar("eval/psnr", psnr, it + 1)
    if tb is not None:
        tb.close()
    _on_lead(mesh, lambda: save_checkpoint(ckpt_dir, state))
    if lead:
        print("training complete", flush=True)
    return {"start": start, "step": state.step,
            "losses": [float(v) for v in losses],
            "ms_per_step": _ms(events) if timed else None,
            "eval_psnr": psnrs, "rank": mesh.rank, "world_size": mesh.size,
            "batch": batch,
            "device": torch.cuda.get_device_name(device) if timed else "cpu",
            "work_dir": work_dir}


def _ms(events) -> list:
    """CUDA-event ms of each (start, end) pair (synchronises)."""
    if events:
        events[-1][1].synchronize()
    return [a.elapsed_time(b) for a, b in events]


if __name__ == "__main__":
    main()
