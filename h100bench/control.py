"""Read a cell's check over many seeds in one process: the program's
numbers and the control's, from which the limits in ``limits/`` are set.

    python3 -m h100bench.control --workload <cell> --seeds 11,12,13
        [--control-seeds 11,12,13] [--seconds 3] [--out FILE]

Each seed is one run of the cell as ``run.py`` makes it (set-up, a short
window at the cell's own load, the check), with ``--seconds`` the window.
On the seeds of ``--control-seeds`` the control is read too: the reference
in TF32 (the precision below the configuration's float32 with TF32 off)
in the program's place, against the reference.  One JSON line a seed, then
a summary: the largest program reading and the smallest control reading of
each number.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from h100bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(_ROOT)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                             device, t0, control=seed in controls)
        row = {"seed": seed, "program": {k: c["value"] for k, c in
                                         r["checks"].items()},
               "control": r.get("control"), "metrics": r["metrics"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["program"]
    summary = {"workload": args.workload,
               "card": torch.cuda.get_device_name(device),
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in keys},
               "control_min": {k: min((r["control"][k] for r in rows
                                       if r["control"]), default=None)
                               for k in keys}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
