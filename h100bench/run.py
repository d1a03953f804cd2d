"""Run one cell of the benchmark once, from the root of a checkout:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or ``python3 -m h100bench.run ...``).  The last line of standard output is
the result, one JSON object; the numbers the check compared, each beside
its limit, are the last lines of standard error and the result's last key.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; if JAX or the JAX package is loaded once the
window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

# modules that must not be loaded: JAX and the JAX package, compared by
# whole top-level names (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "fcvsr_tpu")

# the build and kernel caches, at fixed paths inside the checkout (the
# port builds its kernel library into fcvsr_tpu_torch/_build/ itself)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules():
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in FORBIDDEN)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = str(_ROOT / "h100bench" / "_cache" / sub)
    os.environ["USE_FLAX"] = "0"

    import torch

    from h100bench import harness

    # one process with few threads: the host's share of the work is
    # Python's launch path and copies, and idle intra-op threads that spin
    # take cores from it on a shared host
    torch.set_num_threads(1)

    bench = harness.load_benchmark(_ROOT)
    cell = harness.find(bench["workloads"], args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded, and must not be: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
