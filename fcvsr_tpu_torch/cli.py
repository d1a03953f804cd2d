"""Evaluation / FPS entry point of the port (counterpart of ``test.py``).

  sliding-window evaluation with PSNR / SSIM / tOF:
    python -m fcvsr_tpu_torch.cli --preset fcvsr_cvcpLD_QP22 \
        --lr-root LR --gt-root GT [--save-dir OUT] [--seqs a,b]
  trained weights (else random ones, made from ``--seed``):
    ... --checkpoint work_dirs/<name>/ckpt [--config <run>/config.json]
    ... --torch-checkpoint weights.pth   (or a reference-keyed .npz)
  FPS mode (1 x 7 x C x 272 x 480):
    python -m fcvsr_tpu_torch.cli --preset fcvsr_cvcpLD_QP22 --fps
  either one in the deployment configuration, or with the fused variants:
    ... --fast [--iac-chain resident] [--scnet-fuse quad]

``--checkpoint`` takes a port checkpoint file (``iter_<step>.pt``, its
model weights) or a directory, whose newest checkpoint serves;
``--torch-checkpoint`` a reference state_dict, ``.pth`` (raw, mmcv's
``state_dict`` wrapper with ``generator.`` keys, or DataParallel's
``module.`` keys) or ``.npz``; it wins over ``--checkpoint``, as in
``test.py``.  Both load through ``utils.checkpoint.load_weights``, strict.
``--config`` reads an ``ExperimentConfig`` JSON (a training run's
``config.json``) in place of ``--preset``.

By default the model serves the exact float32 path.  ``--fast`` sets the
flags of the JAX package's ``test.py --fast`` (:data:`FAST`): MGAA batched,
fused kernel prediction (``k_fused``: 130.57 against 137.17 ms/frame for
materialised kernels, alone, in turns, on an H100 80GB HBM3 at 700 W,
PERF.md), the folded tail, and bf16 storage of the IAC chain, SCNet, the
MGAA head and MFFR.  ``--iac-chain resident`` runs each IAC chain in one
launch (materialised kernels, so it turns ``k_fused`` off) and
``--scnet-fuse quad`` each BlockRCB body in one, as
``benchmarks/fps_fullmodel.py`` selects them.  Odd input sizes are
zero-padded to the /4 grid (270 -> 272 rows) and the SR output is cropped
back.  Times are CUDA-event times after a warm-up forward, on a CUDA device
only.  The JSON line names the weights and the flags served with.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .data import ClipFolderDataset
from .metrics import calculate_psnr, calculate_ssim, calculate_tof
from .models import FCVSRNet, init_weights
from .utils.checkpoint import latest_checkpoint, load_weights
from .utils.config import ExperimentConfig, preset

__all__ = ["main", "pad_to_multiple", "evaluate_sequence", "fps_benchmark",
           "build_model", "serving_flags", "EXACT", "FAST"]

# FCVSRNet's serving flags on the exact float32 path, its defaults
EXACT = dict(batch_mgaa=False, k_fused=False, tail_impl="xla",
             iac_chain="periter", iac_dtype="f32", scnet_dtype="f32",
             scnet_fuse="pair", head_dtype="f32", mffr_dtype="f32",
             tail_dtype="f32")

# the JAX package's --fast (test.py:183-187): MGAA batched with its f/b
# ConvBlks, fused kernel prediction, the folded tail, bf16 storage of the
# IAC chain, of SCNet (its 'rows_bf16'), of MGAA's spectral head and of
# MFFR; the tail stays float32
FAST = dict(batch_mgaa=True, k_fused=True, tail_impl="folded",
            iac_dtype="bf16", scnet_dtype="bf16", head_dtype="bf16",
            mffr_dtype="bf16")


def pad_to_multiple(x: np.ndarray, mult: int = 4):
    """Zero-pad (T, H, W, C) bottom/right to a /mult grid, as the reference
    harness pads 270 -> 272 rows.  Returns (padded, (H, W))."""
    h, w = x.shape[1:3]
    ph, pw = (mult - h % mult) % mult, (mult - w % mult) % mult
    if ph or pw:
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)))
    return x, (h, w)


def serving_flags(fast: bool = False, iac_chain: str = "periter",
                  scnet_fuse: str = "pair") -> dict:
    """FCVSRNet's serving flags for the CLI's options: :data:`FAST` with
    ``fast``; the resident chain turns ``k_fused`` off."""
    flags = dict(FAST) if fast else {}
    if iac_chain != "periter":
        flags.update(iac_chain=iac_chain, k_fused=False)
    if scnet_fuse != "pair":
        flags["scnet_fuse"] = scnet_fuse
    return flags


def build_model(cfg, seed: int, device, **flags) -> FCVSRNet:
    """The preset's model with seeded random weights and the serving
    ``flags`` (FCVSRNet's keywords), in eval mode on ``device``."""
    kw = dict(n_feats=cfg.model.n_feats, in_channels=cfg.model.in_channels,
              num_frames=cfg.model.num_frames, **flags)
    if cfg.model.name == "fcvsr":
        model = FCVSRNet(**kw)
    elif cfg.model.name == "fcvsr_s":
        model = FCVSRNet.small(**kw)
    else:
        raise ValueError(f"the port serves fcvsr and fcvsr_s, not "
                         f"{cfg.model.name}")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _load_model_weights(model, checkpoint: str = "",
                       torch_checkpoint: str = "") -> dict:
    """Load the CLI's weights into ``model``: ``torch_checkpoint`` (a
    reference ``.pth`` or ``.npz``) if given, else ``checkpoint`` (a port
    checkpoint file, or a directory's newest).  Returns what was served,
    for the summary (empty when neither is given: the seeded weights)."""
    if torch_checkpoint:
        load_weights(torch_checkpoint, model)
        return {"torch_checkpoint": os.path.abspath(torch_checkpoint)}
    if not checkpoint:
        return {}
    path = checkpoint
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no iter_<step>.pt checkpoint in "
                                    f"{checkpoint}")
    load_weights(path, model)
    return {"checkpoint": os.path.abspath(path)}


def _timed_forward(model, x, times):
    """Forward; on CUDA appends the CUDA-event time in ms to ``times``."""
    if x.device.type != "cuda":
        return model(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    y = model(x)
    end.record()
    torch.cuda.synchronize(x.device)
    times.append(start.elapsed_time(end))
    return y


def _timed_tof(*args):
    t0 = time.perf_counter()
    return calculate_tof(*args), time.perf_counter() - t0


@torch.no_grad()
def evaluate_sequence(model, ds, seq, scale=4, convert_to="Y",
                      crop_border=0, save_dir=None, channel_order="rgb",
                      device="cuda", tof=True):
    """SR every frame of ``seq`` through its sliding window; PSNR / SSIM
    against the GT where present, and (with ``tof``) tOF over consecutive
    (SR, GT) pairs, as ``test.py`` computes them.  tOF's flows are numpy
    Farneback on the host, run on a pool of threads (the host's cores, at
    most 8) once the sequence's forwards are done (run beside them, they
    take the host from the launches and slow the forwards, PERF.md), so
    the sequence's SR and GT frames are kept until then.
    ``ms_per_frame`` is the median CUDA-event time of a forward after one
    warm-up forward (None off CUDA); ``forwards`` counts model calls,
    warm-up included; ``tof_seconds`` sums the pairs' host
    seconds and ``tof_wall_seconds`` is the pool's wall time;
    ``psnr_frames`` is each frame's PSNR, in order."""
    psnrs, ssims, pairs, times = [], [], [], []
    forwards = 0
    prev_sr255 = prev_gt255 = None
    for i, window, gt in ds.iter_test_windows(seq):
        window, (h, w) = pad_to_multiple(window)
        x = torch.from_numpy(np.ascontiguousarray(np.transpose(
            window.astype(np.float32) / 255.0, (0, 3, 1, 2))[None])).to(device)
        if forwards == 0 and x.device.type == "cuda":
            model(x)  # warm-up: kernel build and library load
            forwards += 1
        sr = _timed_forward(model, x, times)[0].cpu().numpy()
        forwards += 1
        sr = np.transpose(sr, (1, 2, 0))[:h * scale, :w * scale]
        sr255 = np.clip(sr * 255.0, 0, 255)
        if save_dir:
            from PIL import Image

            os.makedirs(os.path.join(save_dir, seq), exist_ok=True)
            arr = sr255.astype(np.uint8)
            Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr).save(
                os.path.join(save_dir, seq, f"{i:08d}.png"))
        if gt is not None:
            gt255 = gt.astype(np.float32)
            conv = convert_to if sr255.shape[-1] == 3 else None
            psnrs.append(calculate_psnr(sr255, gt255, crop_border, conv,
                                        channel_order))
            ssims.append(calculate_ssim(sr255, gt255, crop_border, conv,
                                        channel_order))
            if tof and prev_sr255 is not None:
                pairs.append((sr255, gt255, prev_sr255, prev_gt255, conv,
                              channel_order))
            prev_sr255, prev_gt255 = sr255, gt255
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        tofs = list(pool.map(lambda p: _timed_tof(*p), pairs))
    tof_wall = time.perf_counter() - t0
    return {
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "tof": float(np.mean([v for v, _ in tofs])) if tofs else None,
        "tof_seconds": float(sum(t for _, t in tofs)),
        "tof_wall_seconds": tof_wall,
        "psnr_frames": [float(v) for v in psnrs],
        "frames": len(psnrs),
        "forwards": forwards,
        "ms_per_frame": float(np.median(times)) if times else None,
    }


@torch.no_grad()
def fps_benchmark(model, h=272, w=480, c=1, n_iter=20, warmup=2, seed=0,
                  device="cuda", t=7, frames_per_forward=1):
    """Median CUDA-event ms of one (1, t, c, h, w) forward after ``warmup``
    forwards, per restored frame: a windowed model restores 1 frame a
    forward, a recurrent one all ``t`` (``frames_per_forward``); and the
    peak device memory allocated over the forwards.  Needs a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("fps_benchmark times a CUDA device; got "
                           f"{device}")
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (1, t, c, h, w)).astype(np.float32)).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(warmup):
        model(x)
    times = []
    for _ in range(n_iter):
        _timed_forward(model, x, times)
    times = [ms / frames_per_forward for ms in times]
    ms = float(np.median(times))
    return {"ms_per_frame": ms, "fps": 1000.0 / ms, "n_iter": n_iter,
            "ms_min": float(np.min(times)), "ms_max": float(np.max(times)),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="fcvsr_tpu_torch evaluation")
    parser.add_argument("--preset", type=str, default="fcvsr_redsLD_QP37")
    parser.add_argument("--config", type=str, default="",
                        help="an ExperimentConfig JSON, in place of "
                             "--preset")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="a port checkpoint (iter_<step>.pt) or a "
                             "directory of them (the newest serves)")
    parser.add_argument("--torch-checkpoint", type=str, default="",
                        help="a reference state_dict: .pth (raw, mmcv or "
                             "DataParallel) or .npz")
    parser.add_argument("--lr-root", type=str, default="")
    parser.add_argument("--gt-root", type=str, default="")
    parser.add_argument("--save-dir", type=str, default="")
    parser.add_argument("--seqs", type=str, default="",
                        help="comma-separated subset of sequences")
    parser.add_argument("--fps", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights (without "
                             "--checkpoint or --torch-checkpoint)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fast", action="store_true",
                        help="the deployment flags of test.py --fast: "
                             "batch_mgaa, k_fused, the folded tail, and "
                             "bf16 storage of the IAC chain, SCNet, the "
                             "MGAA head and MFFR")
    parser.add_argument("--no-tof", action="store_true",
                        help="skip tOF (numpy Farneback flows on the "
                             "host, the slowest metric)")
    parser.add_argument("--iac-chain", default="periter",
                        choices=["periter", "resident"],
                        help="resident: each IAC chain in one launch "
                             "(materialised kernels: turns k_fused off)")
    parser.add_argument("--scnet-fuse", default="pair",
                        choices=["pair", "quad"],
                        help="quad: each BlockRCB body in one launch")
    args = parser.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = preset(args.preset)
    if args.lr_root:
        cfg.data.lr_root = args.lr_root
    if args.gt_root:
        cfg.data.gt_root = args.gt_root
    flags = serving_flags(args.fast, args.iac_chain, args.scnet_fuse)
    model = build_model(cfg, args.seed, args.device, **flags)
    weights = _load_model_weights(model, args.checkpoint,
                                 args.torch_checkpoint) or {"seed": args.seed}
    flags = model.serving_flags()
    dev_name = (torch.cuda.get_device_name(torch.device(args.device))
                if torch.device(args.device).type == "cuda" else "cpu")

    if args.fps:
        r = fps_benchmark(model, c=cfg.model.in_channels, device=args.device)
        r["device"] = dev_name
        r["flags"] = flags
        r["weights"] = weights
        print(json.dumps(r), flush=True)
        return r

    ds = ClipFolderDataset(lr_root=cfg.data.lr_root,
                           gt_root=cfg.data.gt_root or None,
                           window=cfg.model.num_frames,
                           grayscale=cfg.model.in_channels == 1,
                           padding=cfg.data.window_padding)
    seqs = args.seqs.split(",") if args.seqs else ds.sequences
    results = {}
    for seq in seqs:
        r = evaluate_sequence(model, ds, seq, convert_to=cfg.eval.convert_to,
                              crop_border=cfg.eval.crop_border,
                              save_dir=args.save_dir or None,
                              device=args.device, tof=not args.no_tof)
        results[seq] = r
        line = f"{seq}: {r['frames']} frames"
        if r["psnr"] is not None:
            line += f"  PSNR {r['psnr']:.4f}  SSIM {r['ssim']:.4f}"
        if r["tof"] is not None:
            line += f"  tOF {r['tof']:.4f}"
        if r["ms_per_frame"] is not None:
            line += f"  {r['ms_per_frame']:.3f} ms/frame on {dev_name}"
        print(line, flush=True)
    avg = {}
    for key in ("psnr", "ssim", "tof", "ms_per_frame"):
        vals = [r[key] for r in results.values() if r[key] is not None]
        avg[key] = float(np.mean(vals)) if vals else None
    summary = {"average": avg, "per_sequence": results, "device": dev_name,
               "flags": flags, "weights": weights, "config": cfg.name}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
