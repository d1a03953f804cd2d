"""A/B of one BlockRCB level: the fused kernel against the unfused path.

    python -m fcvsr_tpu_torch.benchmarks.microbench_blockrcb_kernel \\
        [--c1 128] [--h 272 --w 480 --c 64] [--seed 0] [--device cuda]

Counterpart of the JAX package's ``benchmarks/microbench_blockrcb_kernel.py``
(its ``_ab_main``).  One level at 272x480x64, bf16 maps, the input
uniform(-1, 1) and the weights N(0, 0.2) drawn from ``--seed`` in that
script's order; ``--c1`` sets the width of the first conv (FCVSR's is 128).

  fused    ``ops.fused_blockrcb.block_rcb``: the whole level in one
           cooperative launch (K11: K6's two wgmma phases, then the
           ContextBlock), every conv's weights rounded to bf16;
  unfused  ``models.scnet_rows.block_rcb_level`` with ``fuse='pair'`` on a
           ``blocks.BlockRCB`` holding the same weights: two conv-pair
           launches (K2, float32 weights), then the ContextBlock, the leaky
           relu and the add in PyTorch.

On a CUDA device both are timed with CUDA events (the median of 7 after 2
warm-ups, the two in turns).  One JSON line: both times, the least time the
card could take for the level (the larger of its bytes over the memory rate
and its operations over the bf16 tensor-core rate, since the fused level
multiplies bf16 maps by bf16-rounded weights on the tensor cores), the same
bound at the float32 FMA pipes' rate beside it, the max abs deviation of
fused from unfused and its ratio to max|unfused|, and the card's name and
power limit.  ``--device cpu`` runs both plain versions, for the tests, and times
nothing.  Without a CUDA device the default ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.blocks import BlockRCB
from ..models.scnet_rows import block_rcb_level
from ..ops.fused_blockrcb import block_rcb
from ..profiling import BF16_FLOP_S, bound, card, cuda_ms, need_device
from ..utils.convert import block_rcb_args

__all__ = ["seeded_level", "level_work", "main"]


def seeded_level(seed: int, h: int, w: int, c: int, c1: int):
    """(x (1, h, w, c) bf16, a BlockRCB(c, c1 // c) holding the seeded
    weights) on the CPU, drawn as the JAX benchmark draws them."""
    if c1 % c:
        raise ValueError(f"c1 ({c1}) must be a multiple of c ({c})")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, h, w, c))).to(torch.bfloat16)

    def arr(*shape):
        return torch.from_numpy(rng.normal(0, 0.2, shape).astype(np.float32))

    wb0, bb0 = arr(3, 3, c, c1), arr(c1)
    wb1, bb1 = arr(3, 3, c1, c), arr(c)
    wr0, wr1 = arr(3, 3, c, c), arr(3, 3, c, c)
    wm, a0, a1 = arr(c), arr(c, c), arr(c, c)
    blk = BlockRCB(c, width_multiplier=c1 // c)
    body0, body1, rcb = blk.body[0], blk.body[2], blk.body[3]
    gc = rcb.gcnet
    oihw = lambda hwio: hwio.permute(3, 2, 0, 1)  # noqa: E731
    with torch.no_grad():
        for conv, wt in ((body0, wb0), (body1, wb1), (rcb.body[0], wr0),
                         (rcb.body[2], wr1)):
            conv.weight.copy_(oihw(wt))
        body0.bias.copy_(bb0)
        body1.bias.copy_(bb1)
        gc.conv_mask.weight.copy_(wm.reshape(1, c, 1, 1))
        gc.channel_add_conv[0].weight.copy_(a0.t()[:, :, None, None])
        gc.channel_add_conv[2].weight.copy_(a1.t()[:, :, None, None])
    return x, blk.eval()


def level_work(b: int, h: int, w: int, c: int, c1: int):
    """(bytes, flops) of a level: x read and out written once (bf16), the
    float32 weights; 2 flops a multiply-add of the four convs, plus about
    7 a value for the ContextBlock's logits, pooling and output."""
    px = b * h * w
    macs = 9 * (c * c1 + c1 * c + 2 * c * c)
    return (2 * 2 * px * c + 4 * (macs + c1 + 3 * c + 2 * c * c),
            2 * px * macs + 7 * px * c + 4 * c * c)


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--h", type=int, default=272)
    parser.add_argument("--w", type=int, default=480)
    parser.add_argument("--c", type=int, default=64)
    parser.add_argument("--c1", type=int, default=0,
                        help="width of the first conv (default: --c)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    c1 = args.c1 or args.c
    dev = need_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, blk = seeded_level(args.seed, args.h, args.w, args.c, c1)
    x, blk = x.to(dev), blk.to(dev)
    kw = block_rcb_args(blk)

    def fused():
        return block_rcb(x, **kw)

    def unfused():
        return block_rcb_level(blk, x, "pair")

    got, ref = fused().float(), unfused()
    dev_max = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    work = level_work(1, args.h, args.w, args.c, c1)
    bound_ms, bound_by = bound(*work, BF16_FLOP_S)
    report = dict(shape=[1, args.h, args.w, args.c], c1=c1, seed=args.seed,
                  device=str(dev), finite=bool(torch.isfinite(got).all()),
                  max_abs_dev=dev_max, max_abs_unfused=scale,
                  rel_dev=dev_max / scale if scale else float("inf"),
                  fused_ms=None, unfused_ms=None, bound_ms=bound_ms,
                  bound_by=bound_by, f32_pipes_bound_ms=bound(*work)[0],
                  card=None)
    if dev.type == "cuda":
        report["fused_ms"], report["unfused_ms"] = cuda_ms([fused, unfused])
        report["card"] = card()
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
