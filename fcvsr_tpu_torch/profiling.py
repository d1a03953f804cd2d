"""Where the serving forward's and the training step's time goes, on one
GPU.

    python -m fcvsr_tpu_torch.profiling [--preset fcvsr_cvcpLD_QP22]
        [--reps 10] [--out chiprun_out/profile.json]
        [--fast] [--iac-chain resident] [--scnet-fuse quad]

At the FPS shape (1 x 7 x C x 272 x 480), seeded random weights, TF32 off:
  1. stages: the CUDA-event time of each stage of ``FCVSRNet.forward``
     (forward hooks on its children), median over ``--reps`` forwards,
     with the serving flags that ``--fast``, ``--iac-chain`` and
     ``--scnet-fuse`` select as the CLI's do (the exact path without).
     ``rest`` is the forward less the stages: conv_last0, the bilinear base,
     pixel shuffles and glue;
  2. device: ``torch.profiler`` over 3 forwards: device time and launches by
     kernel name, device busy time (the union of kernel intervals) against
     the host's wall time, and the idle share.  The profiler's own host cost
     is in the wall time, so the idle share is an upper bound;
  3. serving: the exact path with materialised kernels, with fused kernel
     prediction (``k_fused``), ``--fast``, and ``--fast`` with the
     resident IAC chain and the quad SCNet bodies, on the same weights, the
     forwards interleaved, median ms of each;
then at the preset's training batch and LR patch (random data), on the
exact path:
  4. train: CUDA-event ms of the forward with the loss, the backward and
     the Adam update, median over ``--reps`` steps after a warm-up step;
  5. train device: ``torch.profiler`` over 2 steps, as in 2.
One JSON line per phase; ``--out`` also gets the whole kernel tables.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .cli import EXACT, FAST, build_model, serving_flags
from .train.losses import LOSSES
from .train.lr_schedule import build_schedule
from .train.trainer import TrainState
from .utils.config import preset

__all__ = ["cuda_ms", "bound", "card", "need_device", "stage_times",
           "device_profile", "serving_compare", "train_step_times",
           "train_profile", "main"]

# FCVSRNet children timed as stages; the tail convs are summed as one
STAGES = {"feat_extract": "feat_extract", "MGAA": "MGAA",
          "MFFRblock": "MFFR", "rconcat1": "rconcat", "rconcat2": "rconcat",
          "recorb1": "SCNet", "upconv1_L3": "tail convs",
          "upconv1_L2": "tail convs", "upconv1_L2_2": "tail convs",
          "upconv_fuse": "tail convs", "recorb0": "tail convs",
          "upconv1": "tail convs", "upconv2": "tail convs"}


# NVIDIA's published H100 SXM peaks (data sheet, dense, at 700 W): HBM
# bytes/s, float32 flop/s outside the tensor cores, and bf16 flop/s on the
# tensor cores (bf16 operands, float32 sums)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12


def cuda_ms(fns, reps: int = 7, warmup: int = 2) -> list:
    """Median CUDA-event ms of each callable, the callables timed in
    turns."""
    for f in fns:
        for _ in range(warmup):
            f()
    times = [[] for _ in fns]
    for _ in range(reps):
        for f, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def bound(nbytes: float, flops: float, flop_s: float = F32_FLOP_S):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    ``flop_s``, the card's peak for the operands' type (float32 by
    default; ``BF16_FLOP_S`` where both factors are bf16)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def need_device(name: str) -> torch.device:
    """An entry point's ``--device`` argument as a device; ``cuda`` without
    a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (pass --device cpu for the plain versions)")
    return dev


def _mark(dev):
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else (b - a) * 1e3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def stage_times(model, x, reps: int = 10, warmup: int = 2) -> dict:
    """Median ms of each stage and of the whole forward over ``reps``
    forwards; MGAA's three calls are ``MGAA.0`` .. ``MGAA.2``."""
    dev = x.device
    marks, handles = [], []
    for name, child in model.named_children():
        if name not in STAGES:
            continue
        handles.append(child.register_forward_pre_hook(
            lambda m, a, name=name: marks.append((name, "start", _mark(dev)))))
        handles.append(child.register_forward_hook(
            lambda m, a, o, name=name: marks.append((name, "end", _mark(dev)))))
    try:
        for _ in range(warmup):
            model(x)
        runs = []
        for _ in range(reps):
            marks.clear()
            t0 = _mark(dev)
            model(x)
            t1 = _mark(dev)
            _sync(dev)
            run, calls, start = {"forward": _ms(t0, t1)}, {}, None
            for name, kind, mk in marks:
                if kind == "start":
                    start = mk
                    continue
                key = STAGES[name]
                if name == "MGAA":
                    key = f"MGAA.{calls.get(name, 0)}"
                    calls[name] = calls.get(name, 0) + 1
                run[key] = run.get(key, 0.0) + _ms(start, mk)
            run["rest"] = run["forward"] - sum(
                v for k, v in run.items() if k != "forward")
            runs.append(run)
    finally:
        for h in handles:
            h.remove()
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


@torch.no_grad()
def device_profile(model, x, n: int = 3) -> dict:
    """``torch.profiler`` over ``n`` forwards: per-forward device time and
    launches by kernel name, busy and wall ms per forward, idle share.
    Device fields are None when the profiler saw no device activity."""
    return _profile(lambda: model(x), x.device, n)


def _profile(run, dev, n: int) -> dict:
    """``torch.profiler`` over ``n`` calls of ``run`` after one unprofiled
    call; per call: device ms and launches by kernel name, busy and wall
    ms, idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    _sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3 / n
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        ms, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (e - s) / 1e3 / n, count + 1)
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    kernels = sorted(({"name": k, "ms": v[0], "launches": v[1] / n}
                      for k, v in by_name.items()), key=lambda r: -r["ms"])
    busy_ms = busy / 1e3 / n if spans else None
    return {"wall_ms": wall, "busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / wall,
            "kernels": kernels}


# phase 3's serving configurations: name -> flags over the exact path
VARIANTS = {"materialised": {}, "k_fused": dict(k_fused=True), "fast": FAST,
            "fast_resident_quad": serving_flags(True, "resident", "quad")}


@torch.no_grad()
def serving_compare(model, x, reps: int = 10, warmup: int = 2,
                    variants=None) -> dict:
    """Median ms per forward of each variant (name -> serving flags over
    the exact path; by default materialised kernels and ``k_fused``), same
    weights, forwards interleaved; the model's flags are restored."""
    dev = x.device
    variants = variants or {k: VARIANTS[k] for k in ("materialised",
                                                     "k_fused")}
    keep = model.serving_flags()
    times = {name: [] for name in variants}
    try:
        for flags in variants.values():
            model.set_serving_flags(**{**EXACT, **flags})
            for _ in range(warmup):
                model(x)
        for _ in range(reps):
            for name, flags in variants.items():
                model.set_serving_flags(**{**EXACT, **flags})
                t0 = _mark(dev)
                model(x)
                t1 = _mark(dev)
                _sync(dev)
                times[name].append(_ms(t0, t1))
    finally:
        model.set_serving_flags(**keep)
    return {name: {"median_ms": float(np.median(ts)),
                   "min_ms": float(np.min(ts)), "max_ms": float(np.max(ts))}
            for name, ts in times.items()}


def _train_step(state, loss_fn, lrs, gt, marks=None):
    """One training step; with ``marks`` a list, appends the three phase
    boundaries' marks after the first."""
    dev = lrs.device
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model(lrs), gt)
    if marks is not None:
        marks.append(_mark(dev))
    loss.backward()
    if marks is not None:
        marks.append(_mark(dev))
    state.apply_gradients()
    if marks is not None:
        marks.append(_mark(dev))


def train_step_times(state, loss_fn, lrs, gt, reps: int = 5,
                     warmup: int = 1) -> dict:
    """Median ms of the forward with the loss, the backward, the update and
    the whole step, over ``reps`` steps after ``warmup``."""
    dev = lrs.device
    for _ in range(warmup):
        _train_step(state, loss_fn, lrs, gt)
    runs = []
    for _ in range(reps):
        marks = [_mark(dev)]
        _train_step(state, loss_fn, lrs, gt, marks)
        _sync(dev)
        t = [_ms(a, b) for a, b in zip(marks, marks[1:])]
        runs.append({"forward_loss": t[0], "backward": t[1], "update": t[2],
                     "step": sum(t)})
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def train_profile(state, loss_fn, lrs, gt, n: int = 2) -> dict:
    """``torch.profiler`` over ``n`` training steps (see :func:`_profile`)."""
    return _profile(lambda: _train_step(state, loss_fn, lrs, gt), lrs.device,
                    n)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", type=str, default="fcvsr_cvcpLD_QP22")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--height", type=int, default=272)
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, default="")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--iac-chain", default="periter",
                        choices=["periter", "resident"])
    parser.add_argument("--scnet-fuse", default="pair", choices=["pair", "quad"])
    args = parser.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = need_device(args.device)
    cfg = preset(args.preset)
    model = build_model(cfg, args.seed, dev, **serving_flags(
        args.fast, args.iac_chain, args.scnet_fuse))
    x = torch.from_numpy(np.random.default_rng(args.seed).uniform(
        0, 1, (1, 7, cfg.model.in_channels, args.height, args.width))
        .astype(np.float32)).to(dev)
    gpu = card() if dev.type == "cuda" else "cpu"
    shape = list(x.shape)
    report = {"preset": args.preset, "shape": shape, "card": gpu,
              "flags": model.serving_flags(),
              "stages_ms": stage_times(model, x, args.reps)}
    print("[stages] " + json.dumps(report), flush=True)
    prof = device_profile(model, x)
    report["device"] = prof
    print("[device] " + json.dumps({**{k: v for k, v in prof.items()
                                        if k != "kernels"},
                                     "top_kernels": prof["kernels"][:12],
                                     "card": gpu}), flush=True)
    report["serving"] = serving_compare(model, x, args.reps,
                                        variants=VARIANTS)
    print("[serving] " + json.dumps({"shape": shape, "card": gpu,
                                      **report["serving"]}), flush=True)

    b, p, c = cfg.data.batch_size, cfg.data.lr_patch, cfg.model.in_channels
    rng = np.random.default_rng(args.seed)
    lrs = torch.from_numpy(rng.uniform(0, 1, (b, 7, c, p, p))
                           .astype(np.float32)).to(dev)
    gt = torch.from_numpy(rng.uniform(0, 1, (b, c, 4 * p, 4 * p))
                          .astype(np.float32)).to(dev)
    model.set_serving_flags(**EXACT)  # the serving flags have no backward
    state = TrainState(model, build_schedule(cfg.train), cfg.train.betas)
    loss_fn = LOSSES[cfg.train.loss]
    train_shape = list(lrs.shape)
    report["train"] = train_step_times(state, loss_fn, lrs, gt, args.reps)
    print("[train] " + json.dumps({"shape": train_shape, "card": gpu,
                                    **report["train"]}), flush=True)
    prof = train_profile(state, loss_fn, lrs, gt)
    report["train_device"] = prof
    print("[train_device] " + json.dumps(
        {**{k: v for k, v in prof.items() if k != "kernels"},
         "top_kernels": prof["kernels"][:16], "shape": train_shape,
         "card": gpu}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
