"""The rank's device and the world, its share of a batch, and replicated
modules (counterpart of ``fcvsr_tpu.parallel.mesh``).

The JAX package spans a 1-D ``data`` mesh over every device and lets XLA
insert the gradient psum; here each process is one rank on one device,
and ``DistributedDataParallel`` all-reduces the gradients
(``train.trainer.make_train_step(group=...)``).  So :class:`Mesh` is this
rank's device, its rank and the world size; :func:`shard_batch` places
this rank's local share of the global batch on its device and keeps it
there (the per-host data contract of the JAX ``shard_batch``, the
reference's DistributedSampler); :func:`rank_share` cuts a rank's
contiguous share out of a batch every rank holds whole; :func:`replicate`
broadcasts a module's parameters and buffers from rank 0, where the JAX
package relies on every host deriving the same values from the seed.
``data_parallel_shardings`` has no counterpart: DDP takes no shardings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "shard_batch", "rank_share", "data_parallel",
           "replicate"]


@dataclass(frozen=True)
class Mesh:
    """This rank's device, its rank and the number of ranks of ``group``
    (the default group when None)."""

    device: torch.device
    rank: int = 0
    size: int = 1
    group: Any = None


def make_mesh(device="cuda", group=None) -> Mesh:
    """The rank's device (the current card for 'cuda', which
    ``initialize_multihost`` picked, or the CPU) and the world of ``group``;
    without a process group, rank 0 of 1."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if group is not None:
            raise RuntimeError("a process group was given, but this process "
                               "belongs to none")
        return Mesh(dev)
    return Mesh(dev, dist.get_rank(group), dist.get_world_size(group), group)


def shard_batch(batch, mesh: Mesh):
    """This rank's local share of the global batch (a dict, list or tuple
    of arrays, or one array) as tensors on the rank's device."""
    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(mesh.device)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(put(v) for v in batch)
    return put(batch)


def rank_share(x, mesh: Mesh):
    """The rank's contiguous share of ``x``'s leading axis, which must be a
    multiple of the world size (a numpy array or a tensor, not copied)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} "
                         "ranks")
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def data_parallel(module: torch.nn.Module, group=None):
    """``module`` under ``DistributedDataParallel`` over ``group`` (the
    default group when None) on its parameters' device: the parameters and
    buffers broadcast from rank 0 at construction, the gradients averaged
    over the ranks in buckets during the backward.  The graph is static
    (``static_graph``): the parameters the loss does not reach, as
    FCVSR's unused DivEnh convs, keep no gradient, as without DDP."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group, static_graph=True)


def replicate(module: torch.nn.Module,
              mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank of ``mesh``'s group, in place; returns the module.  Without a
    process group, the module as it is."""
    if not dist.is_initialized():
        return module
    group = mesh.group if mesh is not None else None
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if dist.get_backend(group) == "nccl":
                dist.broadcast(t.data, src, group=group)
            else:
                buf = t.data.cpu()
                dist.broadcast(buf, src, group=group)
                t.data.copy_(buf)
    return module
