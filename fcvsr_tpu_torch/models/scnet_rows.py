"""SCNet served through the 3x3 conv kernels (counterpart of
``fcvsr_tpu.models.scnet_rows``).

Runs ``blocks.SCNet``'s parameters with every 3x3 conv on a kernel
of ``ops.fused_conv``: each BlockRCB body is two pair launches (body0 ->
lrelu 0.1 -> body1, then the RCB's body.0 -> lrelu 0.2 -> body.2), or with
``fuse='quad'`` one quad launch of both, and each group ends with one conv
launch carrying the group residual.  Per SCGroup and frame that is 18 pair
(or 9 quad) and 3 conv launches.  The 1x1 convs, the context
block and the bilinear exchange stay PyTorch ops, as they were XLA ops
outside the Pallas kernels.  There is no rows layout on the GPU: tensors
stay NHWC and the kernels zero-pad themselves.  Under autograd the same
calls go through the kernels' autograd Functions (``ops.fused_conv``), with
the weights made from the live parameters.

``dtype='bf16'`` stores the chain's maps as bfloat16 (the counterpart of
the JAX package's ``scnet_impl='rows_bf16'``): the inputs, every kernel's
output and each BlockRCB's output are rounded to bf16; the PyTorch ops
between the kernels (the context block, the 1x1 convs, the bilinear
exchange, the residual sums) compute in float32 on the widened maps; the
outputs are float32.  bf16 inputs (the whole model in bf16,
``utils.precision``) take bf16 storage whatever ``dtype`` says, and the
outputs are bf16.  ``fuse='quad'`` and bf16 are serving options: they
raise under autograd.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..ops import _native
import torch

from ..ops.fused_conv import conv3x3, conv3x3_pair, conv3x3_quad, prep_weight
from ..ops.resize import downsample2x_bilinear, upsample2x_bilinear

__all__ = ["scnet_apply", "block_rcb_level", "hwio", "conv_bias"]


def hwio(conv):
    """The conv's weight in the kernels' HWIO layout.  Under autograd it is
    made from the live weight on every call, so the weight gets its
    gradient, and while ``torch.export`` traces, so that the graph makes it
    from its parameter; otherwise it is prepared once and re-made only when
    the weight changes."""
    w = conv.weight
    if _native.records(w) or _native.traced(w):
        return prep_weight(w)
    key = (w.data_ptr(), w._version, w.device)
    cached = conv.__dict__.get("_hwio")
    if cached is None or cached[0] != key:
        cached = (key, prep_weight(w.detach()))
        conv.__dict__["_hwio"] = cached
    return cached[1]


def conv_bias(conv):
    """The conv's bias: live under autograd, detached otherwise."""
    b = conv.bias
    if b is None or _native.records(b):
        return b
    return b.detach()


def cross_scale(down, up, xs, res):
    """BlockRCB's exchange over the [L1, L2, L3] pyramid: each level adds
    its own body output, the level above projected and halved, and the
    level below projected and doubled."""
    dn = [res[0]] + [downsample2x_bilinear(down(r)) for r in res[:-1]]
    upd = [upsample2x_bilinear(up(r)) for r in res[1:]] + [res[-1]]
    return [x + r + d + u for x, r, d, u in zip(xs, res, dn, upd)]


def block_rcb_level(blk, x, fuse: str = "pair"):
    """One level of a BlockRCB's body on the kernels: y = body1(lrelu_0.1(
    body0(x))), r = the RCB's conv pair of y, then y + lrelu_0.2(
    ContextBlock(r)), in float32.  ``fuse`` 'pair' (two pair launches) or
    'quad' (one quad launch); the maps in x's storage type."""
    body0, body1, rcb = blk.body[0], blk.body[2], blk.body[3]
    r0, r1 = rcb.body[0], rcb.body[2]
    if fuse == "quad":
        y, r = conv3x3_quad(x, hwio(body0), conv_bias(body0), hwio(body1),
                            conv_bias(body1), hwio(r0), None, hwio(r1),
                            None, ns1=0.1, ns3=0.2)
    else:
        y = conv3x3_pair(x, hwio(body0), conv_bias(body0), hwio(body1),
                         conv_bias(body1), ns1=0.1)
        r = conv3x3_pair(y, hwio(r0), None, hwio(r1), None, ns1=0.2)
    return y.float() + F.leaky_relu(rcb.gcnet(r.float()), 0.2)


def _block_rcb(blk, xs, fuse: str):
    res = [block_rcb_level(blk, x, fuse) for x in xs]
    return cross_scale(blk.down[0], blk.up[0], xs, res)


STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


def scnet_apply(scnet, xs, fuse: str = "pair", dtype: str = "f32"):
    """SCNet forward over NHWC [L1, L2, L3] through the conv kernels:
    ``fuse`` 'pair' or 'quad' for the BlockRCB bodies, ``dtype`` 'f32' or
    'bf16' for the maps between the kernels (bf16 inputs: bf16).  Returns
    maps of the inputs' type."""
    if fuse not in ("pair", "quad") or dtype not in STORAGE:
        raise ValueError(f"fuse is 'pair' or 'quad' and dtype 'f32' or "
                         f"'bf16', not {fuse!r} and {dtype!r}")
    if (fuse, dtype) != ("pair", "f32") and \
            _native.records(*xs, *scnet.parameters()):
        raise RuntimeError(
            f"SCNet(fuse={fuse!r}, dtype={dtype!r}) is inference only: the "
            "quad kernel and bf16 storage have no backward.  Train with "
            "fuse='pair' and dtype='f32', or run under torch.no_grad()")
    out_dt = xs[0].dtype
    st = torch.bfloat16 if out_dt == torch.bfloat16 else STORAGE[dtype]
    xs = [x.to(st).contiguous() for x in xs]
    res = list(xs)
    for group in scnet.body:
        gin = res
        for blk in group.body:
            res = [r.to(st).contiguous() for r in _block_rcb(blk, res, fuse)]
        w, b = hwio(group.conv), conv_bias(group.conv)
        res = [conv3x3(r, w, b, res=x) for x, r in zip(gin, res)]
    return [(x.float() + r.float()).to(out_dt) for x, r in zip(xs, res)]
