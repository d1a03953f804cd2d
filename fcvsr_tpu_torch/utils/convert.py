"""Weights from the JAX package: flax params -> the port's ``state_dict``
(counterpart of ``fcvsr_tpu.utils.torch_import``, in the other direction).

Names map through :func:`flax_to_torch_key`, the port's own copy of the JAX
package's key map.  Kernels go from HWIO to OIHW, PReLU's ``alpha`` becomes
``weight`` (1,) and DivEnh's ``a``/``b`` become (C, 1, 1).
"""

from __future__ import annotations

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


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax FCVSRNet param tree (``{'params': ...}`` or its inside,
    numpy-convertible leaves) onto the port's ``state_dict`` keys.  Raises
    ``KeyError`` on a param it cannot map."""
    tree = params.get("params", params)
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
