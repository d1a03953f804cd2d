"""One-command PSNR validation of released reference weights on the card
(counterpart of ``tools/validate_released_ckpt.py``).

The reference releases its trained FCVSR weights on Baidu pan only, so
this tool waits for the day a weights file appears: point it at the file
and the LD-compressed clips, and it serves them through the port's
evaluation (``fcvsr_tpu_torch.cli --torch-checkpoint``, sliding windows,
PSNR / SSIM / tOF), prints the table and one JSON line,
``{"checkpoint_validation": {...}}``, and, with ``--expected-psnr``,
holds the average PSNR to it within ``--tolerance`` dB (0.01, the
release tolerance).

    python -m fcvsr_tpu_torch.tools.validate_released_ckpt \\
        FCVSR_REDS_LD37.pth --lr-root /data/REDS4_LD37/lr \\
        --gt-root /data/REDS4/gt \\
        [--preset fcvsr_redsLD_QP37] [--expected-psnr 30.51] \\
        [--tolerance 0.01] [--seqs 000,011,015,020] [--fast] [--device cpu]

Weights: what ``utils.checkpoint.read_weights`` reads, a raw state_dict
(``torch.save(model.state_dict())``, CVSR_train's release format), mmcv's
``{"state_dict": ..., "meta": ...}`` with ``generator.`` keys, or an
``.npz`` under the same names; only ``torch.load(weights_only=True)``.
Exit codes: 2 when the file is missing, 1 when the PSNR is outside the
tolerance, else 0.  ``--fast`` serves the deployment flags, which are not
the parity path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils.checkpoint import read_weights

__all__ = ["main", "validate"]


def validate(argv=None) -> dict:
    """The validation of :func:`main`'s arguments: the JSON line's
    ``checkpoint_validation`` verdict, with the exit code as ``rc``."""
    ap = argparse.ArgumentParser(
        description="validate released reference weights on the card")
    ap.add_argument("weights", help=".pth/.pt torch checkpoint or .npz")
    ap.add_argument("--preset", default="fcvsr_redsLD_QP37")
    ap.add_argument("--lr-root", required=True)
    ap.add_argument("--gt-root", required=True)
    ap.add_argument("--seqs", default="",
                    help="comma-separated sequence subset (default: all)")
    ap.add_argument("--expected-psnr", type=float, default=None,
                    help="reference-side PSNR to compare against")
    ap.add_argument("--tolerance", type=float, default=0.01,
                    help="max |delta| dB for a PASS")
    ap.add_argument("--save-dir", default="")
    ap.add_argument("--fast", action="store_true",
                    help="the deployment flags (cli --fast): not the "
                         "parity path, which is the exact one")
    ap.add_argument("--no-tof", action="store_true",
                    help="skip tOF (the host's Farneback flows)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if not os.path.exists(args.weights):
        print(f"weights file not found: {args.weights}\n"
              "The reference releases them via Baidu pan only "
              "(QZ1-boy/FCVSR README); download out-of-band, then re-run. "
              "Either the raw CVSR_train state_dict (.pth) or an mmedit "
              "checkpoint works.", file=sys.stderr)
        return {"rc": 2, "missing": args.weights}
    print(f"loaded {len(read_weights(args.weights))} tensors from "
          f"{args.weights}", flush=True)

    from .. import cli

    argv = ["--preset", args.preset, "--torch-checkpoint", args.weights,
            "--lr-root", args.lr_root, "--gt-root", args.gt_root,
            "--device", args.device]
    if args.seqs:
        argv += ["--seqs", args.seqs]
    if args.save_dir:
        argv += ["--save-dir", args.save_dir]
    if args.fast:
        argv += ["--fast"]
    if args.no_tof:
        argv += ["--no-tof"]
    summary = cli.main(argv)

    psnr = summary["average"]["psnr"]
    verdict = {"psnr": round(psnr, 4), "device": summary["device"], "rc": 0}
    if args.expected_psnr is not None:
        delta = psnr - args.expected_psnr
        verdict.update(expected=args.expected_psnr, delta_db=round(delta, 4),
                       tolerance=args.tolerance,
                       parity=bool(abs(delta) <= args.tolerance))
        verdict["rc"] = 0 if verdict["parity"] else 1
    return verdict


def main(argv=None) -> int:
    """Run :func:`validate`, print its JSON line; return its exit code."""
    verdict = validate(argv)
    if "missing" not in verdict:
        print(json.dumps({"checkpoint_validation": verdict}), flush=True)
    return verdict["rc"]


if __name__ == "__main__":
    sys.exit(main())
