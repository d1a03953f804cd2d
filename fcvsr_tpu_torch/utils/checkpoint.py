"""Training checkpoints of the port (counterpart of
``fcvsr_tpu.utils.checkpoint``, with ``torch.save`` in place of orbax).

A checkpoint is ``<ckpt_dir>/iter_<step>.pt`` holding ``{"model":
state_dict, "optimizer": Adam's state_dict, "ema": {name: tensor} or None,
"step": updates taken}``, written to a temporary file and renamed, so a
run that is cut leaves no half-written checkpoint.  Loading uses
``torch.load(weights_only=True)``: tensors and plain containers only.

Three ways to start a run, as the JAX CLI has them (train.py:473-493):
auto-resume from the work dir's newest checkpoint; ``--resume-from`` a
checkpoint (file or directory), full state; ``--load-from`` weights only,
from a port ``.pt`` (a state_dict or a checkpoint) or a reference-keyed
``.npz`` state_dict, with a fresh optimizer at step 0.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_checkpoint", "restore_checkpoint",
           "load_weights"]

_CKPT = re.compile(r"^iter_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, state) -> str:
    """Write ``state`` (a ``TrainState``) as ``iter_<state.step>.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"iter_{state.step}.pt")
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the most updates in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(ckpt_dir)
             if (m := _CKPT.match(name))]
    return os.path.join(ckpt_dir, max(found)[1]) if found else None


def restore_checkpoint(path: str, state, required: bool = False) -> int:
    """Load a checkpoint file, or a directory's newest, into ``state``;
    returns the step to start from (0 when a directory holds none and
    ``required`` is False)."""
    if os.path.isdir(path) or not os.path.exists(path):
        found = latest_checkpoint(path)
        if found is None:
            if required:
                raise FileNotFoundError(f"no checkpoint at {path}")
            return 0
        path = found
    state.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
    return state.step


def load_weights(path: str, model: torch.nn.Module) -> None:
    """Weights only, strict: a port ``.pt`` (a state_dict or a checkpoint's
    ``model``) or a reference-keyed ``.npz`` state_dict (mmedit's
    ``generator.`` and DataParallel's ``module.`` prefixes dropped)."""
    if path.endswith(".npz"):
        sd = {}
        with np.load(path) as arrays:
            for key in arrays.files:
                name = key
                for prefix in ("generator.", "module."):
                    if name.startswith(prefix):
                        name = name[len(prefix):]
                sd[name] = torch.from_numpy(np.asarray(arrays[key], np.float32))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in sd and "step" in sd:
            sd = sd["model"]
    model.load_state_dict(sd, strict=True)
