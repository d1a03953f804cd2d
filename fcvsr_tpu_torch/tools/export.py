"""Export the serving forward as a ``torch.export`` program (counterpart of
``tools/export_aot.py``, which serialises a ``jax.export`` of the jitted
forward).

    python -m fcvsr_tpu_torch.tools.export --preset fcvsr_s_redsLD_QP37 \\
        --height 184 --width 320 --out fcvsr_s.pt2 \\
        [--weights W.pth|W.npz] [--device cpu]

The program is FCVSRNet's exact serving forward (``cli.EXACT``) at a fixed
(1, 7, C, H, W) input, with the preset's model and random weights (seed 0),
or ``--weights`` (``utils.checkpoint.read_weights``: a port checkpoint, a
reference ``.pth`` or ``.npz``), traced with ``torch.export.export``
(non-strict) on ``--device`` (the card by default) and written by
``torch.export.save``.  Its kernels are the custom ops ``fcvsr::iac_fused``
(K1), ``fcvsr::conv3x3_pair`` (K2) and ``fcvsr::conv3x3`` (K3): a graph
node each, which launch (and count their launches) when the program runs.
The ``--fast`` and resident / quad paths and the zoo's DCN launch
kernels that are not such ops yet, so only the exact path exports.

Reload, on a device of the export's kind:

    import torch
    import fcvsr_tpu_torch.ops           # registers the fcvsr:: ops
    program = torch.export.load("fcvsr_s.pt2").module()
    with torch.no_grad():
        sr = program(lr_window)          # (1, 7, C, H, W) -> (1, C, 4H, 4W)
"""

from __future__ import annotations

import argparse
import collections
import os

import torch

__all__ = ["main", "export_model", "op_counts"]


def export_model(cfg, h: int, w: int, weights: str = "", device="cuda"):
    """(the ``ExportedProgram`` of ``cfg``'s model at (1, T, C, h, w), the
    eager model it traced).  The parameters stop requiring grad, so that
    the forward takes the serving launches."""
    from .. import cli
    from ..utils.checkpoint import load_weights

    model = cli.build_model(cfg, 0, device)
    if weights:
        load_weights(weights, model)
    model.requires_grad_(False)
    x = torch.zeros((1, cfg.model.num_frames, cfg.model.in_channels, h, w),
                    device=device)
    return torch.export.export(model, (x,), strict=False), model


def op_counts(program) -> dict:
    """{op: nodes} of the ``fcvsr::`` custom ops in an exported program's
    graph."""
    return dict(collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("fcvsr.")))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="torch.export of FCVSR serving")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default="",
                    help="a port checkpoint, a reference .pth or an .npz "
                         "(default: random weights, seed 0)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from .. import profiling
    from ..utils.config import preset

    device = profiling.need_device(args.device)
    program, _ = export_model(preset(args.preset), args.height, args.width,
                              args.weights, device)
    torch.export.save(program, args.out)
    out = {"out": args.out, "bytes": os.path.getsize(args.out),
           "ops": op_counts(program), "device": str(device)}
    print(f"exported {args.out} ({out['bytes']} bytes, fcvsr ops "
          f"{out['ops']}, on {device})", flush=True)
    return out


if __name__ == "__main__":
    main()
