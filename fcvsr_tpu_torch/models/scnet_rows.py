"""SCNet served through the 3x3 conv kernels (counterpart of
``fcvsr_tpu.models.scnet_rows``).

Runs ``blocks.SCNet``'s parameters with every 3x3 conv on a kernel
of ``ops.fused_conv``: each BlockRCB body is two pair launches (body0 ->
lrelu 0.1 -> body1, then the RCB's body.0 -> lrelu 0.2 -> body.2), and each
group ends with one conv launch carrying the group residual.  Per SCGroup
and frame that is 18 pair and 3 conv launches.  The 1x1 convs, the context
block and the bilinear exchange stay PyTorch ops, as they were XLA ops
outside the Pallas kernels.  There is no rows layout on the GPU: tensors
stay NHWC and the kernels zero-pad themselves.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..ops.fused_conv import conv3x3, conv3x3_pair, prep_weight
from ..ops.resize import downsample2x_bilinear, upsample2x_bilinear

__all__ = ["scnet_apply", "hwio"]


def hwio(conv):
    """The conv's weight in the kernels' HWIO layout, prepared once and
    re-made only when the weight changes."""
    w = conv.weight
    key = (w.data_ptr(), w._version, w.device)
    cached = conv.__dict__.get("_hwio")
    if cached is None or cached[0] != key:
        cached = (key, prep_weight(w.detach()))
        conv.__dict__["_hwio"] = cached
    return cached[1]


def _bias(conv):
    return None if conv.bias is None else conv.bias.detach()


def cross_scale(down, up, xs, res):
    """BlockRCB's exchange over the [L1, L2, L3] pyramid: each level adds
    its own body output, the level above projected and halved, and the
    level below projected and doubled."""
    dn = [res[0]] + [downsample2x_bilinear(down(r)) for r in res[:-1]]
    upd = [upsample2x_bilinear(up(r)) for r in res[1:]] + [res[-1]]
    return [x + r + d + u for x, r, d, u in zip(xs, res, dn, upd)]


def _block_rcb(blk, xs):
    body0, body1, rcb = blk.body[0], blk.body[2], blk.body[3]
    r0, r1 = rcb.body[0], rcb.body[2]
    res = []
    for x in xs:
        y = conv3x3_pair(x, hwio(body0), _bias(body0), hwio(body1),
                         _bias(body1), ns1=0.1)
        r = conv3x3_pair(y, hwio(r0), None, hwio(r1), None, ns1=0.2)
        res.append(y + F.leaky_relu(rcb.gcnet(r), 0.2))
    return cross_scale(blk.down[0], blk.up[0], xs, res)


def scnet_apply(scnet, xs):
    """SCNet forward over NHWC [L1, L2, L3] through the conv kernels."""
    xs = [x.contiguous() for x in xs]
    res = list(xs)
    for group in scnet.body:
        gin = res
        for blk in group.body:
            res = [r.contiguous() for r in _block_rcb(blk, res)]
        w, b = hwio(group.conv), _bias(group.conv)
        res = [conv3x3(r, w, b, res=x) for x, r in zip(gin, res)]
    return [x + r for x, r in zip(xs, res)]
