"""The port's data parallelism at 2 ranks on the CPU (Gloo), against the
JAX package and against the port's own single process.

* One group of 2 ranks (``tests/torch_rank_workers.py::two_ranks``, spawned
  once for the module, rendezvous on a FileStore under ``tmp_path``) takes
  2 DDP steps with EMA of a small FCVSR (``torch_rank_workers.SMALL``) on
  its share of a 2-sample batch, under ``charbonnier_sum`` and
  ``charbonnier_mean``: both ranks hold the same parameters bit for bit,
  and they are one process's steps on the whole batch; the first step is
  JAX's ``make_train_step(model, mesh=make_mesh(jax.devices()[:2]))`` on
  the same batch and converted weights.
* ``psum_metrics`` and ``gather_results`` at 2 ranks against the JAX
  helpers run in 2 ``jax.distributed`` processes on the same values: the
  mean, and the arrays stacked in rank order.
* ``replicate`` gives every rank rank 0's weights; the same seed gives
  every process the same weights anyway, as the JAX package relies on.
* The sharded eval step and ``tiled_sr`` over the 2 ranks (3 tiles,
  padded to 4) against one process and JAX's ``tiled_sr(mesh=...)``.
* The training CLI at 2 ranks (``--multihost``, TCP on a port found by
  binding 0): each rank trains on ``train.py``'s per-host stream, rank 0
  alone writes, the logged loss is the ranks' mean, a resumed run restores
  on every rank, and rank 0's checkpoint loads in one process and in
  ``cli.py``; a GAN preset refuses ``--multihost``.

The process groups run in the background from the module's first test
on (two ``spawn`` calls on threads, the JAX helpers' processes), while
the JAX steps compile in this process.

Bars, measured first: the 2 ranks against one process on the whole batch
after each step, ``WHOLE_RTOL`` of the parameters' norm and
``TENSOR_RTOL`` of each tensor's (measured 1.1e-6 and 3.6e-5 under the
summed loss, 6.7e-8 and 1.1e-6 under the mean: Adam's first steps divide
each gradient by its own magnitude, so elements whose gradients lie
within float32 noise of 0 move by up to 2% of lr otherwise when the batch
sums in another order); the first step against JAX's ``JAX_STEP_RTOL`` of
the update's norm (measured 7.5e-5); outputs against one process 1e-5 and
against JAX ``ATOL`` (measured 1.5e-7).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import train as jax_train
from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.models.inference import tiled_sr as j_tiled_sr
from fcvsr_tpu.parallel import make_mesh as j_make_mesh
from fcvsr_tpu.parallel import replicate as j_replicate
from fcvsr_tpu.parallel import shard_batch as j_shard_batch
from fcvsr_tpu.train.trainer import TrainState as JTrainState
from fcvsr_tpu.train.trainer import make_train_step as j_make_train_step
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch import cli
from fcvsr_tpu_torch.models.inference import tiled_sr
from fcvsr_tpu_torch.parallel import spawn
from fcvsr_tpu_torch.train import cli as train_cli
from tests import torch_rank_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0
TENSOR_RTOL, WHOLE_RTOL = 1e-4, 1e-5
JAX_STEP_RTOL = 3e-4
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread here and in every rank (OMP_NUM_THREADS is
    inherited): the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _window(t=7, h=32, w=64) -> np.ndarray:
    """A band-limited (1, t, 1, h, w) window in [0, 1]."""
    small = np.random.default_rng(14).uniform(0, 1, (t, 1, h // 4, w // 4))
    x = F.interpolate(torch.from_numpy(small.astype(np.float32)),
                      size=(h, w), mode="bilinear", align_corners=False)
    return x.numpy()[None]


@pytest.fixture(scope="module")
def background(one_thread, tmp_path_factory):
    """The module's process groups, started at once: the 2 ranks of
    ``torch_rank_workers.two_ranks`` and those of the training CLI (each
    ``spawn`` on a thread of its own), and the 2 JAX processes of the
    helpers.  Tests wait for what they read."""
    tmp = tmp_path_factory.mktemp("multihost")
    window = _window()
    cli_root = tmp / "cli"
    runs = _cli_runs(cli_root)
    worker = tmp / "jax_helpers.py"
    worker.write_text(_JAX_HELPERS)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    port = str(_free_port())
    helpers = [subprocess.Popen([sys.executable, str(worker), str(i), port,
                                 REPO], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
               for i in range(2)]
    with ThreadPoolExecutor(2) as pool:
        yield types.SimpleNamespace(
            window=window, cli_root=cli_root, helpers=helpers,
            ranks=pool.submit(spawn, W.two_ranks, 2,
                              (str(tmp / "store"), window), TIMEOUT_S),
            cli=pool.submit(spawn, W.cli_rank, 2, (runs,), TIMEOUT_S))
        for p in helpers:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def jax_small():
    jm = JFCVSRNet(**W.SMALL)
    return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 7, 1, 16, 16), jnp.float32))


def _rel(got: dict, ref: dict) -> dict:
    return {k: float(np.linalg.norm(got[k] - r) / max(np.linalg.norm(r),
                                                     1e-30))
            for k, r in ref.items()}


def _whole(got: dict, ref: dict) -> float:
    num = sum(np.sum((got[k] - r) ** 2) for k, r in ref.items())
    return float(np.sqrt(num / sum(np.sum(r ** 2) for r in ref.values())))


def test_ddp_step_is_jax_mesh_step(background, jax_small):
    """charbonnier_sum, the CVCP recipe's loss: the port scales each rank's
    loss by the world size so that DDP's mean is the whole batch's
    gradient, which XLA's psum gives JAX."""
    jm, shapes = jax_small
    model = W.small_fcvsr()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_torch_state_dict(sd, shapes)
    tx = optax.adam(W.LR, b1=0.9, b2=0.99)
    mesh = j_make_mesh(jax.devices()[:2])
    state = j_replicate(JTrainState(step=jnp.zeros((), jnp.int32),
                                    params=params, opt_state=tx.init(params),
                                    tx=tx), mesh)
    lrs, gt = W.global_batch()
    batch = j_shard_batch({"lrs": lrs, "gt": gt}, mesh)
    step = j_make_train_step(jm, "charbonnier_sum", mesh=mesh, donate=False)
    # XLA's backend optimisation off: it only slows this one-off compile
    new, metrics = step.lower(state, batch["lrs"], batch["gt"]).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(
        state, batch["lrs"], batch["gt"])
    got = background.ranks.result()[0]["steps"]["charbonnier_sum"]
    np.testing.assert_allclose(got["losses"][0], float(metrics["loss"]),
                               rtol=1e-5)
    flat = jax.tree_util.tree_leaves_with_path
    before = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat(params)}
    ref = {jax.tree_util.keystr(p): np.asarray(v) - before[
        jax.tree_util.keystr(p)] for p, v in flat(new.params)}
    port = convert_torch_state_dict(got["params"][0], shapes)
    upd = {jax.tree_util.keystr(p): np.asarray(v) - before[
        jax.tree_util.keystr(p)] for p, v in flat(port)}
    num = np.sqrt(sum(np.sum((upd[k] - r) ** 2) for k, r in ref.items()))
    den = np.sqrt(sum(np.sum(r ** 2) for r in ref.values()))
    print("update deviation", num / den)
    assert num / den <= JAX_STEP_RTOL


def test_eval_step_and_tiled_sr_over_two_ranks(background, jax_small):
    window = background.window
    model = W.small_fcvsr().eval()
    lrs, _ = W.global_batch()
    with torch.no_grad():
        whole = model(torch.from_numpy(lrs)).numpy()
    one = tiled_sr(model, window, tile=32, overlap=8, device="cpu")
    jm, shapes = jax_small
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, shapes)
    ref = j_tiled_sr(jm, params, window, tile=32, overlap=8,
                     mesh=j_make_mesh(jax.devices()[:2]))
    assert one.shape == ref.shape == (1, 1, 128, 256)
    for o in background.ranks.result():
        np.testing.assert_allclose(o["eval"], whole, rtol=0, atol=1e-5)
        np.testing.assert_allclose(o["tiled"], one, rtol=0, atol=1e-5)
        print("tiled against JAX", np.abs(o["tiled"] - ref).max())
        np.testing.assert_allclose(o["tiled"], ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("loss", W.LOSSES)
def test_two_ranks_step_as_one_process_on_the_whole_batch(background, loss):
    outs = background.ranks.result()
    r0, r1 = (o["steps"][loss] for o in outs)
    ref = W.train_steps(*W.global_batch(), loss)
    for i in range(W.STEPS):
        for k, v in r0["params"][i].items():  # DDP keeps the replicas equal
            np.testing.assert_array_equal(v, r1["params"][i][k])
        rel = _rel(r0["params"][i], ref["params"][i])
        whole = _whole(r0["params"][i], ref["params"][i])
        print(loss, "step", i, "worst tensor", max(rel.values()), "whole",
              whole)
        assert max(rel.values()) <= TENSOR_RTOL and whole <= WHOLE_RTOL, rel
    rel = _rel(r0["ema"], ref["ema"])
    assert max(rel.values()) <= TENSOR_RTOL, rel
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-6)


_JAX_HELPERS = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[3])
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid, port = int(sys.argv[1]), sys.argv[2]
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from fcvsr_tpu.parallel import make_mesh
    from fcvsr_tpu.parallel.dist import gather_results, psum_metrics
    m = psum_metrics({"loss": jnp.float32(pid + 1.5),
                      "psnr": jnp.float32(30.0 + 3 * pid)}, make_mesh())
    g = gather_results(np.arange(6, dtype=np.float32).reshape(2, 3)
                       + 10 * pid)
    print(json.dumps({"psum": {k: float(v) for k, v in m.items()},
                      "gather": np.asarray(g).tolist()}))
""")


def test_psum_metrics_and_gather_results_match_jax_helpers(background):
    refs = []
    for p in background.helpers:
        out, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err
        refs.append(json.loads(out.strip().splitlines()[-1]))
    for ref, got in zip(refs, background.ranks.result()):
        assert got["psum"] == pytest.approx(ref["psum"], rel=1e-7)
        assert got["psum"] == {"loss": 2.0, "psnr": 31.5}
        np.testing.assert_array_equal(got["gather"],
                                      np.asarray(ref["gather"], np.float32))


def test_replicate_gives_every_rank_rank_zeros_weights(background):
    r0, r1 = background.ranks.result()
    seeded = W.params(W.small_fcvsr(W.SEED))
    assert any(not np.array_equal(r0["own"][k], r1["own"][k]) for k in seeded)
    for k, v in seeded.items():
        # one seed, one set of weights in every process (the JAX package's
        # replication), and replicate broadcasts rank 0's
        np.testing.assert_array_equal(r0["own"][k], v)
        np.testing.assert_array_equal(r0["replicated"][k], v)
        np.testing.assert_array_equal(r1["replicated"][k], v)


def _write_clip(root, n=8, h=20, w=24):
    from PIL import Image

    rng = np.random.default_rng(8)
    for seq in ("a", "b"):
        for sub, scale in (("lr", 1), ("gt", 4)):
            d = root / sub / seq
            d.mkdir(parents=True)
            for i in range(n):
                img = rng.integers(0, 256, (h * scale, w * scale, 3),
                                   np.uint8)
                Image.fromarray(img).save(d / f"{i:08d}.png")


CLI_PRESET = "fcvsr_s_redsLD_QP37"  # charbonnier_mean, RGB; 16 features
CLI_SEED, CLI_BATCH, CLI_PATCH = 3, 3, 12


def _train_py_stream(root, rank: int, world: int, n: int):
    """The first n batches ``train.py`` draws on process ``rank`` of
    ``world`` (one device each): its stream ``seed + rank``, the global
    batch rounded to a multiple of the devices, then cut to the share."""
    import types

    b = CLI_BATCH
    if b % world:
        b = max(world, b // world * world)
    cfg = types.SimpleNamespace(
        model=types.SimpleNamespace(name="fcvsr_s"),
        data=types.SimpleNamespace(batch_size=b // world,
                                   lr_patch=CLI_PATCH))
    data = JClipFolderDataset(lr_root=str(root / "lr"),
                              gt_root=str(root / "gt"), window=7)
    rng = np.random.default_rng(CLI_SEED + rank)
    return [jax_train.sample_batch(rng, data, cfg) for _ in range(n)]


def _cli_args(root) -> list:
    """One process's training CLI arguments on the clip under ``root``."""
    return ["--config", str(root / "cfg.json"), "--device", "cpu",
            "--lr-root", str(root / "lr"), "--gt-root", str(root / "gt"),
            "--seed", str(CLI_SEED), "--batch-size", str(CLI_BATCH),
            "--lr-patch", str(CLI_PATCH)]


def _cli_runs(root) -> list:
    """The clip and config under ``root``, and the 2 ranks' CLI runs: a
    fresh step, each rank told its own work dir (so that a file rank 1
    wrote would show), then a run of both resumed from rank 0's."""
    from fcvsr_tpu_torch.utils.config import preset

    _write_clip(root)
    cfg = preset(CLI_PRESET)
    cfg.model.n_feats = 16
    (root / "cfg.json").write_text(cfg.to_json())
    ranks = _cli_args(root) + ["--multihost", "--num-processes", "2",
                               "--process-id", "{rank}"]
    return [ranks + ["--coordinator", f"127.0.0.1:{_free_port()}",
                     "--work-dir", str(root / "work{rank}"),
                     "--total-iters", "1"],
            ranks + ["--coordinator", f"127.0.0.1:{_free_port()}",
                     "--work-dir", str(root / "work0"),
                     "--total-iters", "2"]]


def test_train_cli_at_two_ranks(background):
    root = background.cli_root
    outs = background.cli.result()
    assert not (root / "work1").exists()
    run = root / "work0" / CLI_PRESET
    assert sorted(os.listdir(run)) == ["ckpt", "config.json",
                                       "train_log.csv"]
    assert sorted(os.listdir(run / "ckpt")) == ["iter_1.pt", "iter_2.pt"]
    for rank, (fresh, resumed) in enumerate(outs):
        assert (fresh["start"], fresh["step"]) == (0, 1)
        assert (resumed["start"], resumed["step"]) == (1, 2)
        assert fresh["world_size"] == 2 and fresh["batch"] == 1
        # each run draws its rank's stream from the seed and drops its
        # first batch: both train on train.py's second batch
        ref = _train_py_stream(root, rank, 2, 2)[1]
        for seen in (fresh["seen"], resumed["seen"]):
            assert len(seen) == 1
            for got, want in zip(seen[0][:2], ref):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    with open(run / "train_log.csv") as f:
        rows = [r.split(",") for r in f.read().split()]
    assert [int(r[0]) for r in rows] == [1, 2]
    for i, row in enumerate(rows):
        mean = np.mean([outs[r][i]["seen"][0][2] for r in (0, 1)])
        assert float(row[1]) == pytest.approx(mean, rel=1e-6)
        assert outs[0][i]["losses"] == outs[1][i]["losses"] == [
            pytest.approx(float(row[1]), rel=1e-7)]

    ckpt = run / "ckpt" / "iter_2.pt"
    keys = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    assert not any(k.startswith("module.") for k in keys)
    served = cli.main(["--config", str(run / "config.json"), "--checkpoint",
                       str(ckpt), "--device", "cpu", "--no-tof"])
    assert served["weights"] == {"checkpoint": str(ckpt)}
    assert np.isfinite(served["average"]["psnr"])
    one = train_cli.main(_cli_args(root) + ["--work-dir", str(root / "work0"),
                                            "--total-iters", "3"])
    assert (one["start"], one["step"], one["world_size"]) == (2, 3, 1)


def test_gan_preset_refuses_multihost(tmp_path):
    with pytest.raises(ValueError, match=r"train\.py:141-147"):
        train_cli.main(["--preset", "glean_cat_8x", "--device", "cpu",
                        "--multihost", "--work-dir", str(tmp_path)])
    assert not dist.is_initialized()


def test_multihost_without_a_group_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = ["--preset", CLI_PRESET, "--device", "cpu", "--multihost",
            "--work-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no process group"):
        train_cli.main(args)
    with pytest.raises(ValueError, match="together"):
        train_cli.main(args + ["--num-processes", "2"])
    assert not dist.is_initialized()
