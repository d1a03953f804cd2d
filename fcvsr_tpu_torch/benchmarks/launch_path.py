"""Time the host path of a kernel launch: the toolchain probe's kernel (K12,
``tools.gpu_probe.scale2``: o = 2 x on an (8, 128) float32 tensor, 8 KB of
work) against ``torch.mul``, which computes the same.

    python fcvsr_tpu_torch/benchmarks/launch_path.py [--n 200] [--reps 7]
        [--out PATH]

  warm  N calls back to back between one pair of CUDA events: ms a call,
        and the host's microseconds a call (the loop's enqueue, before the
        synchronisation); the two in turns, the median of ``--reps``;
  cold  one call between an event pair recorded on an idle device (the
        way ``profiling.cuda_ms`` times every kernel of chip_smoke's phase
        2), the median of 21 after 2 warm-ups, in turns.

Run as a file, it times the checkout it lies in: a copy of it in another
checkout times that checkout's wrapper.  One JSON line; ``--out`` also
gets it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

__all__ = ["measure", "main"]


def measure(n: int = 200, reps: int = 7) -> dict:
    """The warm and cold times of K12's wrapper and of ``torch.mul`` on one
    (8, 128) float32 tensor of cuda:0."""
    import numpy as np
    import torch

    from fcvsr_tpu_torch.tools import gpu_probe

    dev = torch.device("cuda", 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 128)).astype(np.float32)).to(dev)
    if not torch.equal(gpu_probe.scale2(x), torch.mul(x, 2.0)):
        raise RuntimeError("scale2 differs from torch.mul")
    calls = {"torch.mul": lambda: torch.mul(x, 2.0),
             "scale2": lambda: gpu_probe.scale2(x)}

    def timed(fn, count):
        """(device ms a call, host µs a call) of ``count`` calls between
        one event pair recorded on an idle device."""
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / count, host / count * 1e6

    warm = {name: [] for name in calls}
    for _ in range(reps + 1):  # the first round warms up
        for name, fn in calls.items():
            warm[name].append(timed(fn, n))
    cold = {name: [] for name in calls}
    for fn in calls.values():
        for _ in range(2):
            fn()
    for _ in range(21):
        for name, fn in calls.items():
            cold[name].append(timed(fn, 1)[0])
    med = statistics.median
    res = {"calls_a_loop": n, "reps": reps,
           "warm_ms": {k: med(m for m, _ in v[1:]) for k, v in warm.items()},
           "warm_host_us": {k: med(h for _, h in v[1:])
                            for k, v in warm.items()},
           "cold_ms": {k: med(v) for k, v in cold.items()}}
    res["warm_over_mul"] = res["warm_ms"]["scale2"] \
        / res["warm_ms"]["torch.mul"]
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("launch_path: torch.cuda.is_available() is False")
    res = measure(args.n, args.reps)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    if __package__ in (None, ""):  # run as a file: this checkout's package
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    main()
