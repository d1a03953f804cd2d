"""Weights from the JAX package: flax params -> the port's ``state_dict``
(counterpart of ``fcvsr_tpu.utils.torch_import``, in the other direction).

FCVSR's names map through :func:`flax_to_torch_key`, the port's own copy of
the JAX package's key map; the zoo's (EDVR, BasicVSR++, SPyNet) through
patterns onto mmedit's names.  Kernels and DCN weights go from HWIO to OIHW,
PReLU's ``alpha`` becomes ``weight`` (1,) and DivEnh's ``a``/``b`` become
(C, 1, 1).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "flax_to_torch_key"]

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
    """Map a flax FCVSRNet, EDVRNet, BasicVSRPlusPlus or SpyNet param tree
    (``{'params': ...}`` or its inside, numpy-convertible leaves; the model
    is told by its top-level names) onto the port's ``state_dict`` keys.
    Raises ``KeyError`` on a param it cannot map."""
    tree = params.get("params", params)
    for marker, patterns in (("pcd_alignment", _EDVR),
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
