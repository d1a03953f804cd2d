"""Where the serving forward's time goes, on one GPU.

    python -m fcvsr_tpu_torch.profiling [--preset fcvsr_cvcpLD_QP22]
        [--reps 10] [--out chiprun_out/profile.json]

At the FPS shape (1 x 7 x C x 272 x 480), seeded random weights, TF32 off:
  1. stages: the CUDA-event time of each stage of ``FCVSRNet.forward``
     (forward hooks on its children), median over ``--reps`` forwards.
     ``rest`` is the forward less the stages: conv_last0, the bilinear base,
     pixel shuffles and glue;
  2. device: ``torch.profiler`` over 3 forwards: device time and launches by
     kernel name, device busy time (the union of kernel intervals) against
     the host's wall time, and the idle share.  The profiler's own host cost
     is in the wall time, so the idle share is an upper bound;
  3. serving: materialised kernels against fused kernel prediction
     (``k_fused``) on the same weights, the forwards interleaved, median ms
     of each.
One JSON line per phase; ``--out`` also gets the whole kernel table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .cli import build_model

__all__ = ["stage_times", "device_profile", "serving_compare", "main"]

# FCVSRNet children timed as stages; the tail convs are summed as one
STAGES = {"feat_extract": "feat_extract", "MGAA": "MGAA",
          "MFFRblock": "MFFR", "rconcat1": "rconcat", "rconcat2": "rconcat",
          "recorb1": "SCNet", "upconv1_L3": "tail convs",
          "upconv1_L2": "tail convs", "upconv1_L2_2": "tail convs",
          "upconv_fuse": "tail convs", "recorb0": "tail convs",
          "upconv1": "tail convs", "upconv2": "tail convs"}


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = x.device
    model(x)
    _sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model(x)
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


@torch.no_grad()
def serving_compare(model, x, reps: int = 10, warmup: int = 2) -> dict:
    """Median ms per forward with materialised kernels and with ``k_fused``,
    same weights, forwards interleaved; ``model.MGAA.k_fused`` is restored."""
    dev = x.device
    keep = model.MGAA.k_fused
    times = {False: [], True: []}
    try:
        for kf in (False, True):
            model.MGAA.k_fused = kf
            for _ in range(warmup):
                model(x)
        for _ in range(reps):
            for kf in (False, True):
                model.MGAA.k_fused = kf
                t0 = _mark(dev)
                model(x)
                t1 = _mark(dev)
                _sync(dev)
                times[kf].append(_ms(t0, t1))
    finally:
        model.MGAA.k_fused = keep
    return {name: {"median_ms": float(np.median(ts)),
                   "min_ms": float(np.min(ts)), "max_ms": float(np.max(ts))}
            for name, ts in (("materialised", times[False]),
                             ("k_fused", times[True]))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", type=str, default="fcvsr_cvcpLD_QP22")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--height", type=int, default=272)
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out", type=str, default="")
    args = parser.parse_args(argv)

    from fcvsr_tpu.utils.config import preset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = preset(args.preset)
    model = build_model(cfg, args.seed, dev)
    x = torch.from_numpy(np.random.default_rng(args.seed).uniform(
        0, 1, (1, 7, cfg.model.in_channels, args.height, args.width))
        .astype(np.float32)).to(dev)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    shape = list(x.shape)
    report = {"preset": args.preset, "shape": shape, "card": card,
              "stages_ms": stage_times(model, x, args.reps)}
    print("[stages] " + json.dumps(report), flush=True)
    prof = device_profile(model, x)
    report["device"] = prof
    print("[device] " + json.dumps({**{k: v for k, v in prof.items()
                                        if k != "kernels"},
                                     "top_kernels": prof["kernels"][:12],
                                     "card": card}), flush=True)
    report["serving"] = serving_compare(model, x, args.reps)
    print("[serving] " + json.dumps({"shape": shape, "card": card,
                                      **report["serving"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
