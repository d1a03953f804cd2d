"""Training checkpoints of the port (counterpart of
``fcvsr_tpu.utils.checkpoint``, with ``torch.save`` in place of orbax).

A checkpoint is ``<ckpt_dir>/iter_<step>.pt`` holding ``{"model":
state_dict, "optimizer": Adam's state_dict, "ema": {name: tensor} or None,
"step": updates taken}``, written to a temporary file and renamed, so a
run that is cut leaves no half-written checkpoint.  Loading uses
``torch.load(weights_only=True)``: tensors and plain containers only.

Three ways to start a run, as the JAX CLI has them (train.py:473-493):
auto-resume from the work dir's newest checkpoint; ``--resume-from`` a
checkpoint (file or directory), full state; ``--load-from`` weights only
(:func:`load_weights`), with a fresh optimizer at step 0.  The serving CLI
loads weights the same way (``cli.py --checkpoint`` / ``--torch-checkpoint``).

The GAN trainer's checkpoints (:func:`save_gan_checkpoint`, the JAX
package's ``save_gan_checkpoint``) are ``iter_<step>.pt`` too: ``{"model":
the generator's state_dict, "optimizer": its Adam's, "discriminator",
"d_optimizer": the discriminator's and its Adam's (absent in the
generator-only ``wogan`` stage), "counter": the restorer's step counter,
"step"}``; ``read_weights`` reads the generator from one.  The GAN trainer
auto-resumes from its work dir (:func:`restore_gan_checkpoint`), as the
JAX CLI does; that path has no ``--load-from`` or ``--resume-from``.

Weights cross to the JAX package under the reference key names, which are
the port's own: :func:`export_npz` writes them as the ``.npz`` that
``fcvsr_tpu.utils.torch_import.convert_torch_state_dict`` (and ``test.py
--torch-checkpoint``) reads.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_checkpoint", "restore_checkpoint",
           "save_gan_checkpoint", "restore_gan_checkpoint", "load_weights",
           "read_weights", "export_npz"]

_CKPT = re.compile(r"^iter_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, state) -> str:
    """Write ``state`` (a ``TrainState``) as ``iter_<state.step>.pt``."""
    return _save(ckpt_dir, state.step, state.state_dict())


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


def _save(ckpt_dir: str, step: int, payload: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"iter_{step}.pt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_gan_checkpoint(ckpt_dir: str, step: int, restorer, g_opt,
                        d_opt=None) -> str:
    """Write a ``GANRestorer``'s generator and discriminator, both Adams,
    its counter and ``step`` as ``iter_<step>.pt``; the discriminator's
    entries are left out when it has none."""
    payload = {"model": restorer.generator.state_dict(),
               "optimizer": g_opt.state_dict(),
               "counter": restorer.counter, "step": int(step)}
    if restorer.discriminator is not None:
        payload["discriminator"] = restorer.discriminator.state_dict()
        payload["d_optimizer"] = d_opt.state_dict()
    return _save(ckpt_dir, step, payload)


def restore_gan_checkpoint(path: str, restorer, g_opt, d_opt=None) -> int:
    """Load a GAN checkpoint file, or a directory's newest, into the
    restorer and its optimisers; returns the step to start from (0 when a
    directory holds none)."""
    if os.path.isdir(path) or not os.path.exists(path):
        path = latest_checkpoint(path)
        if path is None:
            return 0
    sd = torch.load(path, map_location="cpu", weights_only=True)
    restorer.generator.load_state_dict(sd["model"])
    g_opt.load_state_dict(sd["optimizer"])
    if restorer.discriminator is not None:
        restorer.discriminator.load_state_dict(sd["discriminator"])
        d_opt.load_state_dict(sd["d_optimizer"])
    restorer.counter = int(sd["counter"])
    return int(sd["step"])


def _strip(name: str) -> str:
    """A reference key without DataParallel's ``module.`` and mmedit's
    ``generator.`` prefixes (in that order, as
    ``tools/export_torch_ckpt.py`` strips them)."""
    for prefix in ("module.", "generator."):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


def read_weights(path: str) -> dict:
    """The state_dict in ``path``, on the CPU, under the port's (the
    reference's) key names.

    * ``.npz``: a reference-keyed state_dict (``tools/export_torch_ckpt.py``
      or :func:`export_npz`).
    * Anything else goes through ``torch.load(weights_only=True)``: a port
      checkpoint (its ``model``), a port or reference state_dict, mmcv's
      ``{"state_dict": ..., "meta": ...}`` with the ``generator.`` prefix,
      or DataParallel's ``module.`` prefix.  Entries that are not tensors
      are dropped.  A file that needs more than ``weights_only`` (pickled
      objects) is refused: it is not loaded again without it."""
    if path.endswith(".npz"):
        with np.load(path) as arrays:
            return {_strip(k): torch.from_numpy(np.asarray(arrays[k],
                                                           np.float32))
                    for k in arrays.files}
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{path} does not load with torch.load(weights_only=True), the "
            f"only way this reads a checkpoint ({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''})") from e
    if not isinstance(raw, dict):
        raise ValueError(f"{path} holds a {type(raw).__name__}, not a "
                         "state_dict")
    if "model" in raw and "step" in raw:
        raw = raw["model"]
    elif isinstance(raw.get("state_dict"), dict):
        raw = raw["state_dict"]
    sd = {_strip(k): v for k, v in raw.items() if isinstance(v, torch.Tensor)}
    if not sd:
        raise ValueError(f"no tensors found in {path}")
    return sd


def load_weights(path: str, model: torch.nn.Module) -> None:
    """Weights only, strict: :func:`read_weights` of ``path`` into
    ``model``."""
    model.load_state_dict(read_weights(path), strict=True)


def export_npz(model: torch.nn.Module, path: str) -> str:
    """Write ``model``'s state_dict as a float32 ``.npz`` under its
    (reference) key names, the form ``convert_torch_state_dict`` reads.
    Returns the path."""
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in model.state_dict().items()})
    return path if path.endswith(".npz") else path + ".npz"
