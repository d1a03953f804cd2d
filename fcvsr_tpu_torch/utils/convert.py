"""Weights from the JAX package: flax params -> the port's ``state_dict``
(counterpart of ``fcvsr_tpu.utils.torch_import``, in the other direction).

Names map through ``fcvsr_tpu.utils.torch_import.flax_to_torch_key``.
Kernels go from HWIO to OIHW, PReLU's ``alpha`` becomes ``weight`` (1,) and
DivEnh's ``a``/``b`` become (C, 1, 1).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from fcvsr_tpu.utils import torch_import

__all__ = ["state_dict_from_jax"]


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
        base = torch_import.flax_to_torch_key("/".join(path[:-1]))
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
