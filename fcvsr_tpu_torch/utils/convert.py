"""Weights from the JAX package: flax params -> the port's ``state_dict``
(counterpart of ``fcvsr_tpu.utils.torch_import``, in the other direction).

FCVSR's names map through :func:`flax_to_torch_key`, the port's own copy of
the JAX package's key map; the zoo's (EDVR, BasicVSR, BasicVSR++, IconVSR,
TDAN, SPyNet) through patterns onto mmedit's names.  Kernels and DCN weights go from HWIO to OIHW,
PReLU's ``alpha`` becomes ``weight`` (1,) and DivEnh's ``a``/``b`` become
(C, 1, 1).

:func:`block_rcb_args_from_jax` and :func:`block_rcb_args` give the
arguments of the BlockRCB level kernel (``ops.fused_blockrcb.block_rcb``)
from the JAX benchmark's ``block_rcb_rows`` arguments and from a port
``BlockRCB``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "flax_to_torch_key",
           "block_rcb_args_from_jax", "block_rcb_args"]

_TOP_CONVS = {
    "feat_extract": "feat_extract.0", "rconcat1": "rconcat1",
    "rconcat2": "rconcat2", "recorb0": "recorb0", "upconv1_L2": "upconv1_L2",
    "upconv1_L2_2": "upconv1_L2_2", "upconv1_L3": "upconv1_L3",
    "upconv1": "upconv1", "upconv2": "upconv2", "conv_last0": "conv_last0",
    "upconv_fuse": "upconv_fuse",
}
_MGAA = {
    "convfuse0": "MGAA.convfuse.0", "convfuse1": "MGAA.convfuse.2",
    "convfuse2": "MGAA.convfuse.4",
    "convcorr0": "MGAA.convcorr.0", "convcorr1": "MGAA.convcorr.2",
    "convcorr2": "MGAA.convcorr.4",
    "convcrt0": "MGAA.convcrt.0", "convcrt1": "MGAA.convcrt.2",
    "conv_KP": "MGAA.conv_KP", "F0": "MGAA.F.0", "F1": "MGAA.F.1",
    "conv3": "MGAA.conv3",
}
_GCNET = {"conv_mask": "conv_mask", "add0": "channel_add_conv.0",
          "add1": "channel_add_conv.2"}


def _ca(base: str, part: str) -> str:
    return f"{base}.conv_du.{0 if part == 'down' else 2}"


def flax_to_torch_key(path: str) -> str | None:
    """Map a '/'-joined flax param path (without the trailing kernel/bias
    leaf) to the reference torch module name, or None if it has none."""
    p = path.split("/")
    if p[0] in _TOP_CONVS and p[1:2] == ["Conv_0"]:
        return _TOP_CONVS[p[0]]
    if p[0] == "lrelu":
        return "lrelu"
    if p[0] == "MGAA":
        if p[1] in _MGAA:
            return _MGAA[p[1]]
        if p[1].startswith("mconv"):
            base = f"MGAA.MConvB.{int(p[1][len('mconv'):])}"
            if p[2] in ("conv1", "conv2", "relu"):
                return f"{base}.{p[2]}"
            if p[2] == "CA":
                return _ca(f"{base}.CA", p[3])
        return None
    if p[0] == "MFFRblock":
        if p[1] == "ca":
            return _ca("MFFRblock.ca", p[2])
        if p[1].startswith("divenh"):
            base = f"MFFRblock.DivEnh_block.{int(p[1][len('divenh'):])}"
            if len(p) == 2:  # leaf params a/b live directly on the module
                return base
            if p[2] == "ca":
                return _ca(f"{base}.ca", p[3])
        return None
    if p[0] == "recorb1":  # SCNet
        base = f"recorb1.body.{int(p[1][len('group'):])}"
        if p[2] == "conv":
            return f"{base}.conv"
        base = f"{base}.body.{int(p[2][len('block'):])}"
        sub = {"body0": "body.0", "body1": "body.2", "down": "down.0",
               "up": "up.0"}
        if p[3] in sub:
            return f"{base}.{sub[p[3]]}"
        if p[3] == "rcb":
            r = f"{base}.body.3"
            if p[4] in ("body0", "body1"):
                return f"{r}.{sub[p[4]]}"
            if p[4] == "gcnet":
                return f"{r}.gcnet.{_GCNET[p[5]]}"
    return None


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# The zoo: (flax module path without its Conv_0, port module name) patterns
# of mmedit's names, matched whole.
_SPYNET = [(rf"level(\d)/conv{i}", rf"basic_module.\1.basic_module.{2 * i}")
           for i in range(5)]
_TAIL = [(r"(upsample[12])/upsample_conv", r"\1.upsample_conv"),
         (r"(conv_hr|conv_last)", r"\1")]
_EDVR = _TAIL + [
    (r"conv_first", "conv_first"),
    (r"extract(\d+)/(conv[12])", r"feature_extraction.\1.\2"),
    (r"recon(\d+)/(conv[12])", r"reconstruction.\1.\2"),
    (r"(feat_l[23]_conv[12])", r"\1.conv"),
    (r"pcd_alignment/(offset_conv[123]|feat_conv)_(l[123])",
     r"pcd_alignment.\1.\2.conv"),
    (r"pcd_alignment/dcn_pack_(l[123])", r"pcd_alignment.dcn_pack.\1"),
    (r"pcd_alignment/dcn_pack_(l[123])/conv_offset",
     r"pcd_alignment.dcn_pack.\1.conv_offset"),
    (r"pcd_alignment/(cas_offset_conv[12])", r"pcd_alignment.\1.conv"),
    (r"pcd_alignment/cas_dcnpack", "pcd_alignment.cas_dcnpack"),
    (r"pcd_alignment/cas_dcnpack/conv_offset",
     "pcd_alignment.cas_dcnpack.conv_offset"),
    (r"fusion/(temporal_attn[12]|spatial_attn5|spatial_attn_add2)",
     r"fusion.\1"),
    (r"fusion/(feat_fusion|spatial_attn[1-4]|spatial_attn_l[1-3]"
     r"|spatial_attn_add1)", r"fusion.\1.conv"),
]
_BRANCH = r"(backward_[12]|forward_[12])"
_BASICVSR_PP = _TAIL + [
    (rf"spynet/{p}", rf"spynet.{t}") for p, t in _SPYNET] + [
    (r"(feat_extract|reconstruction)/input_conv", r"\1.main.0"),
    (r"(feat_extract|reconstruction)/block(\d+)/(conv[12])",
     r"\1.main.2.\2.\3"),
    (rf"{_BRANCH}/backbone/input_conv", r"backbone.\1.main.0"),
    (rf"{_BRANCH}/backbone/block(\d+)/(conv[12])",
     r"backbone.\1.main.2.\2.\3"),
    (rf"{_BRANCH}/deform_align", r"deform_align.\1")] + [
    (rf"{_BRANCH}/deform_align/conv_offset{i}",
     rf"deform_align.\1.conv_offset.{2 * i}") for i in range(4)]


_SPYNET_IN = [(rf"spynet/{p}", rf"spynet.{t}") for p, t in _SPYNET]
# BasicVSR's scans name the trunks backward/resblocks, forward/resblocks
_BASICVSR = _TAIL + _SPYNET_IN + [
    (r"(backward|forward)/resblocks/input_conv", r"\1_resblocks.main.0"),
    (r"(backward|forward)/resblocks/block(\d+)/(conv[12])",
     r"\1_resblocks.main.2.\2.\3"),
    (r"fusion", "fusion")]
_ICONVSR = _TAIL + _SPYNET_IN + [
    (rf"edvr/{p}", rf"edvr.{t}") for p, t in _EDVR[len(_TAIL):]
    if not p.startswith("recon")] + [
    (r"(backward|forward)_fusion", r"\1_fusion"),
    (r"(backward|forward)_resblocks/input_conv", r"\1_resblocks.main.0"),
    (r"(backward|forward)_resblocks/block(\d+)/(conv[12])",
     r"\1_resblocks.main.2.\2.\3")]
_TDAN = [
    (r"feat_conv", "feat_extract.0.conv"),
    (r"pre(\d+)/(conv[12])", r"feat_extract.1.\1.\2"),
    (r"agg_conv", "feat_aggregate.0"),
    (r"agg_dcn([12])", r"feat_aggregate.\1"),
    (r"agg_dcn([12])/conv_offset", r"feat_aggregate.\1.conv_offset"),
    (r"(align_[12])", r"\1"), (r"(align_[12])/conv_offset", r"\1.conv_offset"),
    (r"to_rgb", "to_rgb"),
    (r"rec_conv", "reconstruct.0.conv"),
    (r"post(\d+)/(conv[12])", r"reconstruct.1.\1.\2"),
    (r"up1/upsample_conv", "reconstruct.2.upsample_conv"),
    (r"up2/upsample_conv", "reconstruct.3.upsample_conv"),
    (r"final", "reconstruct.4")]


def _zoo_key(patterns, path: str) -> str | None:
    """The port module name of a flax module path, or None."""
    for pat, template in patterns:
        m = re.fullmatch(pat, path)
        if m is not None:
            return m.expand(template)
    return None


def _zoo_state_dict(tree: Mapping, patterns) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        v = np.asarray(value, dtype=np.float32)
        mod = path[:-1][:-1] if path[-2:-1] == ("Conv_0",) else path[:-1]
        base = _zoo_key(patterns, "/".join(mod))
        if base is None or path[-1] not in ("kernel", "weight", "bias"):
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        # conv kernels and DCN weights are HWIO; the port keeps OIHW
        out[f"{base}.{'bias' if path[-1] == 'bias' else 'weight'}"] = \
            torch.tensor(v if path[-1] == "bias" else v.transpose(3, 2, 0, 1))
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax FCVSRNet, EDVRNet, BasicVSRNet, BasicVSRPlusPlus, IconVSR,
    TDANNet or SpyNet param tree (``{'params': ...}`` or its inside,
    numpy-convertible leaves; the model is told by its top-level names)
    onto the port's ``state_dict`` keys.  Raises ``KeyError`` on a param it
    cannot map."""
    tree = params.get("params", params)
    for marker, patterns in (("pcd_alignment", _EDVR), ("edvr", _ICONVSR),
                             ("align_1", _TDAN), ("backward", _BASICVSR),
                             ("spynet", _BASICVSR_PP), ("level0", _SPYNET)):
        if marker in tree:
            return _zoo_state_dict(tree, patterns)
    out: Dict[str, torch.Tensor] = {}
    divenh = {}
    for path, value in _flatten(tree):
        v = np.asarray(value, dtype=np.float32)
        base = flax_to_torch_key("/".join(path[:-1]))
        leaf = path[-1]
        if base is None:
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        if leaf == "kernel":
            out[f"{base}.weight"] = torch.tensor(v.transpose(3, 2, 0, 1))
        elif leaf == "bias":
            out[f"{base}.bias"] = torch.tensor(v)
        elif leaf == "alpha":
            out[f"{base}.weight"] = torch.tensor(v.reshape(1))
        elif leaf in ("a", "b"):
            out[f"{base}.{leaf}"] = torch.tensor(v.reshape(-1, 1, 1))
            divenh[base] = v.size
        else:
            raise KeyError(f"unknown JAX param leaf {'/'.join(path)}")
    # DivEnh.Conv is never called by the forward and the JAX tree has no
    # param for it; zeros fill it so that load_state_dict(strict=True) holds.
    for base, c in divenh.items():
        out[f"{base}.Conv.weight"] = torch.zeros(c, c, 3, 3)
        out[f"{base}.Conv.bias"] = torch.zeros(c)
    return out


def _from_cat3(w3) -> torch.Tensor:
    """The JAX conv kernels' cat3 layout (3, Cout, 3 Cin), ``w3[dy, co,
    dx Cin + ci] = W[dy, dx, ci, co]`` (``pallas_conv.prep_weight``), back
    to HWIO (3, 3, Cin, Cout)."""
    w3 = np.asarray(w3, np.float32)
    kh, cout, k = w3.shape
    if kh != 3 or k % 3:
        raise ValueError(f"not a cat3 weight: {w3.shape}")
    return torch.from_numpy(np.ascontiguousarray(
        w3.reshape(3, cout, 3, k // 3).transpose(0, 2, 3, 1)))


def _vec(v):
    return None if v is None else torch.from_numpy(
        np.ascontiguousarray(np.asarray(v, np.float32).reshape(-1)))


def block_rcb_args_from_jax(wb0, bb0, wb1, bb1, wr0, wr1, w_mask, w_add0,
                            w_add1) -> dict:
    """``block_rcb_rows``'s weights (cat3 convs, (C,) biases or None, the
    (C,) mask and the (C, C) MLP matrices) as ``block_rcb``'s keyword
    arguments: HWIO float32 CPU tensors."""
    return dict(wb0=_from_cat3(wb0), bb0=_vec(bb0), wb1=_from_cat3(wb1),
                bb1=_vec(bb1), wr0=_from_cat3(wr0), wr1=_from_cat3(wr1),
                w_mask=_vec(w_mask),
                w_add0=torch.from_numpy(np.array(w_add0, np.float32)),
                w_add1=torch.from_numpy(np.array(w_add1, np.float32)))


def block_rcb_args(blk) -> dict:
    """A port ``BlockRCB``'s weights as ``block_rcb``'s keyword arguments,
    on the module's device: HWIO convs, the ContextBlock's 1x1 mask (C,)
    and MLP matrices (C, C) laid out (in, out)."""
    from ..models.scnet_rows import conv_bias, hwio

    body0, body1, rcb = blk.body[0], blk.body[2], blk.body[3]
    gc = rcb.gcnet
    return dict(wb0=hwio(body0), bb0=conv_bias(body0), wb1=hwio(body1),
                bb1=conv_bias(body1), wr0=hwio(rcb.body[0]),
                wr1=hwio(rcb.body[2]),
                w_mask=gc.conv_mask.weight.detach()[0, :, 0, 0].contiguous(),
                w_add0=gc.channel_add_conv[0].weight.detach()[:, :, 0, 0]
                .t().contiguous(),
                w_add1=gc.channel_add_conv[2].weight.detach()[:, :, 0, 0]
                .t().contiguous())
