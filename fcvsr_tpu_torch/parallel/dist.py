"""Process groups, metric reduction and result gathering (counterpart of
``fcvsr_tpu.parallel.dist``) on ``torch.distributed``.

* :func:`initialize_multihost` joins this process to a group: NCCL when
  it trains on a card (its card ``cuda:LOCAL_RANK``, or ``process_id %
  device_count``, made current first), Gloo on the CPU.  Given a
  coordinator, a world size and a rank it rendezvouses there (``host:port``
  over TCP, or any ``tcp://`` / ``file://`` URL); given none it reads
  torchrun's environment (``env://``: ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), as the JAX package
  discovers a pod's topology; with neither it is a no-op returning 0, as
  the JAX package's is for one process.  A group of one forms when the
  flags ask for it, so that DDP's machinery runs at world size 1 (the JAX
  package forms none: one process needs no collectives).  Nothing falls
  back: a backend that is missing, a rendezvous or a collective that
  outlasts ``TIMEOUT_S`` raises.
* :func:`psum_metrics` - the mean over ranks of scalar metrics, one
  ``all_reduce`` of the values stacked in sorted-name order.
* :func:`gather_results` - every rank's array, stacked in rank order on
  every rank (the JAX package's ``process_allgather``); the identity
  without a group.
* :func:`spawn` - ``fn(rank, world_size, *args)`` in ``world_size`` new
  processes on this host, their results returned in rank order; a rank
  that fails or outlasts the timeout fails the call and the rest are
  stopped.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "shutdown", "barrier", "psum_metrics",
           "gather", "gather_results", "spawn", "TIMEOUT_S"]

TIMEOUT_S = 600.0  # a rendezvous or a collective that outlasts it raises

_AVAILABLE = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: str = "cuda") -> int:
    """Join the default process group (see the module's note); returns this
    process's rank.  ``device`` is 'cuda' (NCCL, the rank's card made
    current) or 'cpu' (Gloo); ``backend`` overrides the pick (two ranks on
    one card need Gloo: NCCL refuses them)."""
    flags = (coordinator_address, num_processes, process_id)
    if all(v is None for v in flags):
        if "WORLD_SIZE" not in os.environ:
            return 0
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(v is None for v in flags):
        raise ValueError("give the coordinator, the number of processes and "
                         "the process id together, or none of them (then "
                         "torchrun's environment is read)")
    else:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in [0, {world})")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost on cuda: torch.cuda.is_available() "
                               "is False (pass device cpu for Gloo)")
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in _AVAILABLE or not _AVAILABLE[backend]():
        raise RuntimeError(f"torch.distributed backend {backend} is not "
                           "available in this build of PyTorch")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    return rank


def shutdown() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _comm_device(group) -> torch.device:
    """Where a collective's tensors must lie: NCCL's on the current card,
    Gloo's on the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the default one when None)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def psum_metrics(metrics: Dict[str, torch.Tensor],
                 group=None) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over the ranks of ``group`` (the default
    group when None), float32 on the metrics' device: one ``all_reduce`` of
    the values stacked in sorted-name order.  Without a process group, the
    values themselves."""
    names = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                        for k in names])
    if dist.is_initialized():
        home = vals.device
        vals = vals.to(_comm_device(group))
        dist.all_reduce(vals, group=group)
        vals = (vals / dist.get_world_size(group)).to(home)
    return {k: vals[i] for i, k in enumerate(names)}


def gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(world_size, *t.shape): every rank's ``t`` (each of the same shape
    and dtype) in rank order, on every rank, on ``t``'s device."""
    src = t.detach().to(_comm_device(group)).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)


def gather_results(local: np.ndarray, group=None) -> np.ndarray:
    """Every rank's ``local`` array stacked in rank order, (world_size,
    *local.shape), on every rank (collect_results' all_gather, without the
    tmpdir pickles).  Without a process group: ``local`` itself."""
    if not dist.is_initialized():
        return local
    return gather(torch.from_numpy(np.ascontiguousarray(local)),
                  group).numpy()


def _run_rank(job: str, rank: int, world_size: int, results) -> None:
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        out = fn(rank, world_size, *args)
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    # pickled here: tensors in the queue itself would travel as shared
    # memory that dies with this process
    results.put((rank, True, pickle.dumps(out)))


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes
    (the spawn start method: ``fn`` and ``args`` go by pickle, ``fn`` by its
    import path) and return their results in rank order.  ``fn`` joins a
    group itself (:func:`initialize_multihost`).  A rank that raises, dies
    or has not returned within ``timeout_s`` fails the call with its
    traceback; the other ranks are stopped.  ``fn`` and ``args`` reach the
    ranks through a file: a start that pipes them blocks for good once
    they outgrow the pipe and the child has died before reading them."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_run_rank, daemon=True,
                             args=(job, rank, world_size, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        return _collect(procs, results, timeout_s)


def _collect(procs, results, timeout_s: float) -> list:
    """The ranks' results in rank order (see :func:`spawn`); every rank
    has exited or been killed on return."""
    world_size = len(procs)
    done: dict = {}
    deadline = time.monotonic() + timeout_s
    grace = 10.0  # for ranks that returned to exit; the rest are killed
    try:
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(world_size) if r not in done]
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:  # its result may still be in the pipe: one more look
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            done[rank] = pickle.loads(payload)
    finally:
        for r, p in enumerate(procs):
            p.join(timeout=grace if r in done else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [done[r] for r in range(world_size)]
