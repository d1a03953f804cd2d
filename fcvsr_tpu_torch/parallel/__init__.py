"""Data parallelism across GPUs (counterpart of ``fcvsr_tpu.parallel``) on
``torch.distributed``: DDP on NCCL over cards, Gloo on the CPU."""

from .dist import (gather, gather_results, initialize_multihost,
                   psum_metrics, shutdown, spawn)
from .mesh import (Mesh, data_parallel, make_mesh, rank_share, replicate,
                   shard_batch)

__all__ = ["Mesh", "make_mesh", "shard_batch", "rank_share", "replicate",
           "data_parallel", "initialize_multihost", "shutdown",
           "psum_metrics", "gather", "gather_results", "spawn"]
