"""Rank functions of the port's multi-process CPU tests
(``tests/test_torch_multihost.py``), run by ``fcvsr_tpu_torch.parallel.spawn``
in fresh processes: this module imports torch and the port only.  Every
rank runs torch on one thread and joins its group through a FileStore under
the test's ``tmp_path`` (the training CLI's ranks through its own flags)."""

import numpy as np
import torch
import torch.distributed as dist

from fcvsr_tpu_torch.models import FCVSRNet, init_weights
from fcvsr_tpu_torch.models.inference import tiled_sr
from fcvsr_tpu_torch.parallel import (gather_results, initialize_multihost,
                                      make_mesh, psum_metrics, rank_share,
                                      replicate, shutdown)
from fcvsr_tpu_torch.train.trainer import (TrainState, make_eval_step,
                                           make_train_step)

# the smallest FCVSR whose JAX gradient compiles in about 10 s on the CPU
SMALL = dict(n_feats=16, sc_groups=1, ac_num=1, freq_inv=4, up_ksize=1)
SEED, LR, STEPS = 5, 1e-3, 2
LOSSES = ("charbonnier_sum", "charbonnier_mean")


def small_fcvsr(seed: int = SEED) -> FCVSRNet:
    return init_weights(FCVSRNet(**SMALL), torch.Generator().manual_seed(seed))


def global_batch(n: int = 2, h: int = 16, w: int = 16):
    """(lrs (n, 7, 1, h, w), gt (n, 1, 4h, 4w)) float32, seeded."""
    rng = np.random.default_rng(3)
    return (rng.uniform(0, 1, (n, 7, 1, h, w)).astype(np.float32),
            rng.uniform(0, 1, (n, 1, 4 * h, 4 * w)).astype(np.float32))


def params(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def train_steps(lrs, gt, loss: str, group=None) -> dict:
    """STEPS Adam steps of the seeded small FCVSR with EMA on (lrs, gt):
    the parameters after each step, the reported losses and the EMA."""
    model = small_fcvsr()
    state = TrainState(model, lambda s: LR, use_ema=True)
    step = make_train_step(state, loss, group=group)
    out = {"params": [], "losses": []}
    for _ in range(STEPS):
        out["losses"].append(float(step(torch.from_numpy(lrs),
                                        torch.from_numpy(gt))["loss"]))
        out["params"].append(params(model))
    out["ema"] = {k: v.numpy().copy() for k, v in state.ema.items()}
    return out


def two_ranks(rank: int, world: int, store: str, window: np.ndarray) -> dict:
    """Everything the 2-rank tests hold, from one group: the DDP steps on
    the rank's share under both losses, the metric mean and the gather,
    a module replicated from rank 0, the sharded eval step and
    ``tiled_sr`` over the ranks."""
    torch.set_num_threads(1)
    initialize_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        group = dist.group.WORLD
        mesh = make_mesh("cpu", group)
        lrs, gt = global_batch()
        share = rank_share(lrs, mesh), rank_share(gt, mesh)
        out = {"steps": {loss: train_steps(*share, loss, group)
                         for loss in LOSSES}}
        out["psum"] = {k: float(v) for k, v in psum_metrics(
            {"loss": rank + 1.5, "psnr": 30.0 + 3 * rank}, group).items()}
        out["gather"] = gather_results(
            np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank, group)
        own = small_fcvsr(SEED + rank)  # each rank its own weights
        out["own"] = params(own)
        out["replicated"] = params(replicate(own, mesh))
        model = small_fcvsr().eval()
        out["eval"] = make_eval_step(model, group)(
            torch.from_numpy(lrs)).numpy()
        out["tiled"] = tiled_sr(model, window, tile=32, overlap=8,
                                device="cpu", group=group)
        return out
    finally:
        shutdown()


def cli_rank(rank: int, world: int, runs: list) -> list:
    """``train.cli.main`` on each argv of ``runs`` in turn ('{rank}' in an
    argument becomes the rank), recording every step's batch, the rank's
    own loss of it before the step and what the CLI returns."""
    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.train.losses import LOSSES as FNS

    torch.set_num_threads(1)
    seen = []
    make = train_cli.make_train_step

    def recording(state, loss, **kw):
        step = make(state, loss, **kw)

        def run(lrs, gt):
            with torch.no_grad():
                own = float(FNS[loss](state.model(lrs), gt))
            seen.append((lrs.numpy().copy(), gt.numpy().copy(), own))
            return step(lrs, gt)
        return run

    train_cli.make_train_step = recording
    outs = []
    for argv in runs:
        seen.clear()
        out = train_cli.main([a.format(rank=rank) for a in argv])
        out["seen"] = list(seen)
        outs.append(out)
    return outs
