"""Evaluation / FPS entry point of the port (counterpart of ``test.py``).

  sliding-window evaluation with PSNR / SSIM:
    python -m fcvsr_tpu_torch.cli --preset fcvsr_cvcpLD_QP22 \
        --lr-root LR --gt-root GT [--save-dir OUT] [--seqs a,b]
  FPS mode (1 x 7 x C x 272 x 480):
    python -m fcvsr_tpu_torch.cli --preset fcvsr_cvcpLD_QP22 --fps
  either one in the deployment configuration, or with the fused variants:
    ... --fast [--iac-chain resident] [--scnet-fuse quad]

Weights are random, made from ``--seed`` (checkpoint loading comes later).
By default the model serves the exact float32 path with materialised SAC
kernels: on the H100 the IAC kernel's fused kernel prediction (``k_fused``)
measured slower than F.1 plus the materialised-kernel launches (PERF.md).
``--fast`` sets the flags the JAX package's ``test.py --fast`` sets, as far
as the port has them (:data:`FAST`); its bf16 MGAA head and MFFR
(``head_dtype``, ``mffr_dtype``) are not ported yet.  ``--iac-chain
resident`` runs each IAC chain in one launch (materialised kernels, so it
turns ``k_fused`` off) and ``--scnet-fuse quad`` each BlockRCB body in one,
as ``benchmarks/fps_fullmodel.py`` selects them.  Odd input sizes are
zero-padded to the /4 grid (270 -> 272 rows) and the SR output is cropped
back.  Times are CUDA-event times after a warm-up forward, on a CUDA device
only.  The JSON line names the flags served with.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .data import ClipFolderDataset
from .metrics import calculate_psnr, calculate_ssim
from .models import FCVSRNet, init_weights
from .utils.config import preset

__all__ = ["main", "pad_to_multiple", "evaluate_sequence", "fps_benchmark",
           "build_model", "serving_flags", "EXACT", "FAST"]

# FCVSRNet's serving flags on the exact float32 path, its defaults
EXACT = dict(batch_mgaa=False, k_fused=False, tail_impl="xla",
             iac_chain="periter", iac_dtype="f32", scnet_dtype="f32",
             scnet_fuse="pair")

# the flags of the JAX package's --fast (test.py) that the port has: MGAA
# batched with its f/b ConvBlks, fused kernel prediction, the folded tail,
# bf16 storage of the IAC chain and of SCNet (its 'rows_bf16')
FAST = dict(batch_mgaa=True, k_fused=True, tail_impl="folded",
            iac_dtype="bf16", scnet_dtype="bf16")


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


@torch.no_grad()
def evaluate_sequence(model, ds, seq, scale=4, convert_to="Y",
                      crop_border=0, save_dir=None, channel_order="rgb",
                      device="cuda"):
    """SR every frame of ``seq`` through its sliding window; PSNR / SSIM
    against the GT where present.  ``ms_per_frame`` is the median CUDA-event
    time of a forward after one warm-up forward (None off CUDA);
    ``forwards`` counts model calls, warm-up included."""
    psnrs, ssims, times = [], [], []
    forwards = 0
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
    return {
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
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
    parser.add_argument("--lr-root", type=str, default="")
    parser.add_argument("--gt-root", type=str, default="")
    parser.add_argument("--save-dir", type=str, default="")
    parser.add_argument("--seqs", type=str, default="",
                        help="comma-separated subset of sequences")
    parser.add_argument("--fps", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fast", action="store_true",
                        help="the deployment flags of test.py --fast that "
                             "the port has: batch_mgaa, k_fused, the folded "
                             "tail, bf16 IAC and SCNet storage (the bf16 "
                             "MGAA head and MFFR are not ported yet)")
    parser.add_argument("--iac-chain", default="periter",
                        choices=["periter", "resident"],
                        help="resident: each IAC chain in one launch "
                             "(materialised kernels: turns k_fused off)")
    parser.add_argument("--scnet-fuse", default="pair",
                        choices=["pair", "quad"],
                        help="quad: each BlockRCB body in one launch")
    args = parser.parse_args(argv)

    cfg = preset(args.preset)
    flags = serving_flags(args.fast, args.iac_chain, args.scnet_fuse)
    model = build_model(cfg, args.seed, args.device, **flags)
    flags = model.serving_flags()
    dev_name = (torch.cuda.get_device_name(torch.device(args.device))
                if torch.device(args.device).type == "cuda" else "cpu")

    if args.fps:
        r = fps_benchmark(model, c=cfg.model.in_channels, device=args.device)
        r["device"] = dev_name
        r["flags"] = flags
        print(json.dumps(r), flush=True)
        return r

    ds = ClipFolderDataset(lr_root=args.lr_root, gt_root=args.gt_root or None,
                           window=cfg.model.num_frames,
                           grayscale=cfg.model.in_channels == 1,
                           padding=cfg.data.window_padding)
    seqs = args.seqs.split(",") if args.seqs else ds.sequences
    results = {}
    for seq in seqs:
        r = evaluate_sequence(model, ds, seq, convert_to=cfg.eval.convert_to,
                              crop_border=cfg.eval.crop_border,
                              save_dir=args.save_dir or None,
                              device=args.device)
        results[seq] = r
        line = f"{seq}: {r['frames']} frames"
        if r["psnr"] is not None:
            line += f"  PSNR {r['psnr']:.4f}  SSIM {r['ssim']:.4f}"
        if r["ms_per_frame"] is not None:
            line += f"  {r['ms_per_frame']:.3f} ms/frame on {dev_name}"
        print(line, flush=True)
    avg = {}
    for key in ("psnr", "ssim", "ms_per_frame"):
        vals = [r[key] for r in results.values() if r[key] is not None]
        avg[key] = float(np.mean(vals)) if vals else None
    summary = {"average": avg, "per_sequence": results, "device": dev_name,
               "flags": flags}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
