"""The port's training slice against the JAX package, on the CPU.

* ``loss.backward()`` of FCVSR-S (32 features, 16x16 LR, Y and RGB) against
  ``jax.value_and_grad`` of the same Charbonnier loss on the same weights,
  per parameter tensor: ||g_port - g_jax|| <= 1e-3 ||g_jax||.  The sums run
  in other orders, and a leaky relu whose input lies within f32 noise of 0
  takes the other branch in one framework (one such flip moves an SCNet
  block's gradients by ~1e-3 of their norm).  Every parameter JAX trains
  gets a non-zero gradient; only DivEnh's dead conv, which JAX lacks, has
  none.
* Adam, its schedule and the EMA against optax and the JAX TrainState on
  the same gradients, to 1e-6; the schedules at their milestones.
* The kernels' autograd Functions on CPU tensors against autograd through
  the plain versions (their forwards run the plain versions here).
* Data sampling bit for bit, the copied config / metrics / key map, the
  training CLI with resume, and the port's import hygiene.
"""

import functools
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fcvsr_tpu_torch
from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu.metrics import psnr_ssim as j_psnr_ssim
from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.train import losses as j_losses
from fcvsr_tpu.train import lr_schedule as j_sched
from fcvsr_tpu.train.trainer import TrainState as JTrainState
from fcvsr_tpu.utils import config as j_config
from fcvsr_tpu.utils.torch_import import (convert_torch_state_dict,
                                          flax_to_torch_key as j_key)
from fcvsr_tpu_torch.data import ClipFolderDataset
from fcvsr_tpu_torch.metrics import psnr_ssim
from fcvsr_tpu_torch.models import FCVSRNet, init_weights
from fcvsr_tpu_torch.ops import fused_conv, launch_counts
from fcvsr_tpu_torch.train import losses, lr_schedule
from fcvsr_tpu_torch.train.cli import main as train_main
from fcvsr_tpu_torch.train.trainer import TrainState
from fcvsr_tpu_torch.utils import config
from fcvsr_tpu_torch.utils.convert import flax_to_torch_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the tests that train: the suite runs in
    several worker processes at once, and torch's thread pool in each of
    them oversubscribes the cores (6 training steps then took 391 s instead
    of 4 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_small(cin: int, nf: int = 32):
    """The JAX FCVSR-S and the shapes of its params, traced, not run."""
    jm = JFCVSRNet.small(in_channels=cin, n_feats=nf)
    return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 7, cin, 16, 16), jnp.float32))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("cin", [1, 3])
def test_model_grads_match_jax(cin):
    """Seed 5 is one at which no channel attention's ReLU is dead on these
    inputs: at 32 features a CALayer has 2 hidden channels, and when both
    are negative its two convs get no gradient in either framework."""
    nf, seed = 32, 5
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, 7, cin, 16, 16)).astype(np.float32)
    gt = rng.uniform(0, 1, (1, cin, 64, 64)).astype(np.float32)
    model = init_weights(FCVSRNet.small(in_channels=cin, n_feats=nf),
                         torch.Generator().manual_seed(seed))
    jm, shapes = _jax_small(cin, nf)
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, shapes)
    # XLA's backend optimisation off: it only slows this one-off compile
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: j_losses.charbonnier_sum(jm.apply(p, jnp.asarray(x)),
                                           jnp.asarray(gt)))).lower(
        params).compile({"xla_backend_optimization_level": 0,
                         "xla_llvm_disable_expensive_passes": True})(params)

    loss = losses.charbonnier_sum(model(torch.from_numpy(x)),
                                  torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    no_grad = [k for k, p in model.named_parameters() if p.grad is None]
    assert all(".Conv." in k and "DivEnh" in k for k in no_grad), no_grad
    got = convert_torch_state_dict(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
         for k, p in model.named_parameters()}, shapes)
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for key, r in ref.items():
        g = got[key]
        assert np.any(r) and np.any(g), f"{key}: no gradient"
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel <= 1e-3, f"{key}: relative error {rel}"


def test_k_fused_refuses_autograd():
    model = init_weights(FCVSRNet.small(n_feats=16, k_fused=True),
                         torch.Generator().manual_seed(0))
    x = torch.rand(1, 7, 1, 8, 8)
    with pytest.raises(RuntimeError, match="inference only"):
        model(x)
    with torch.no_grad():
        assert model(x).shape == (1, 1, 32, 32)


def test_weights_are_live_under_grad_and_cached_without():
    """Under autograd MGAA's selected rows and the SCNet HWIO weights carry
    the parameters' history; without it they are the detached caches that
    serving uses."""
    from fcvsr_tpu_torch.models.scnet_rows import conv_bias, hwio

    model = FCVSRNet.small(n_feats=16)
    conv = model.recorb1.body[0].conv
    with torch.no_grad():
        w0, sel0 = hwio(conv), model.MGAA.sel_weights()
        assert hwio(conv) is w0 and model.MGAA.sel_weights()[0] is sel0[0]
        assert not conv_bias(conv).requires_grad
    live = hwio(conv)
    assert live.requires_grad and live.grad_fn is not None
    assert conv_bias(conv) is conv.bias
    wsel, wsel_t, bsel = model.MGAA.sel_weights()
    assert wsel.requires_grad and wsel_t.requires_grad and bsel.requires_grad
    (wsel.sum() + bsel.sum()).backward()
    f1 = model.MGAA.F[1]
    assert f1.weight.grad[model.MGAA.sel].eq(1).all()
    assert f1.weight.grad.sum() == len(model.MGAA.sel) * f1.weight.shape[1]


@pytest.mark.parametrize("bias,res,act", [(True, True, False),
                                          (False, False, True)])
def test_conv_function_grads_match_plain(bias, res, act):
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * 0.3).requires_grad_()

    x, w, b, r = t(2, 7, 9, 8), t(3, 3, 8, 6), t(6), t(2, 7, 9, 6)
    ins = [x, w] + ([b] if bias else []) + ([r] if res else [])
    args = (x, w, b if bias else None, r if res else None, act, 0.2)
    g = torch.from_numpy(rng.standard_normal((2, 7, 9, 6)).astype(np.float32))
    got = torch.autograd.grad(fused_conv.Conv3x3Fn.apply(*args), ins, g)
    ref = torch.autograd.grad(fused_conv.conv3x3_plain(*args), ins, g)
    for a, e in zip(got, ref):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False])
def test_pair_function_grads_match_plain(bias):
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * 0.3).requires_grad_()

    x, w1, b1, w2, b2 = t(2, 7, 9, 8), t(3, 3, 8, 10), t(10), t(3, 3, 10, 8), t(8)
    args = (x, w1, b1 if bias else None, w2, b2 if bias else None, 0.1)
    ins = [a for a in args[:5] if a is not None]
    g = torch.from_numpy(rng.standard_normal((2, 7, 9, 8)).astype(np.float32))
    got = torch.autograd.grad(fused_conv.Conv3x3PairFn.apply(*args), ins, g)
    ref = torch.autograd.grad(fused_conv.conv3x3_pair_plain(*args), ins, g)
    for a, e in zip(got, ref):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(0, 1, (2, 1, 8, 8)).astype(np.float32)
            for _ in range(2))
    b[0, 0, 0, :4] = a[0, 0, 0, :4]  # exact matches: the eps term alone
    for port, ref in ((losses.charbonnier_sum, j_losses.charbonnier_sum),
                      (losses.charbonnier, j_losses.charbonnier)):
        np.testing.assert_allclose(
            float(port(torch.from_numpy(a), torch.from_numpy(b))),
            float(ref(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_schedules_match_jax():
    steps = [0, 1, 1999, 2000, 2001, 5999, 6000, 10000, 120001]
    pairs = [
        (lr_schedule.multistep(0.5e-5, [2000, 6000, 10000, 120000], 0.25),
         j_sched.multistep(0.5e-5, [2000, 6000, 10000, 120000], 0.25)),
        (lr_schedule.cosine_restart(2e-4, [6000, 4000], [1.0, 0.5], 1e-7),
         j_sched.cosine_restart(2e-4, [6000, 4000], [1.0, 0.5], 1e-7)),
        (lr_schedule.linear_decay(1e-4, 6000), j_sched.linear_decay(1e-4, 6000)),
    ]
    for port, ref in pairs:
        # JAX evaluates in f32: near min_lr its sums keep ~1e-11 absolute
        np.testing.assert_allclose([port(s) for s in steps],
                                   [float(ref(s)) for s in steps], rtol=1e-6,
                                   atol=1e-11)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))


def test_adam_and_ema_match_optax():
    """Three updates from the same gradients, the lr dropping between them
    (milestones 1 and 2): the port's TrainState against the JAX one."""
    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    sched = dict(base_lr=1e-2, milestones=[1, 2], gamma=0.25)
    tx = optax.adam(j_sched.multistep(**sched), b1=0.9, b2=0.99)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                     opt_state=tx.init(jp), tx=tx,
                     ema_params=jax.tree.map(jnp.copy, jp))
    model = _Params(p0)
    state = TrainState(model, lr_schedule.multistep(**sched), (0.9, 0.99),
                       use_ema=True)
    for g in grads:
        js = js.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    assert state.step == int(js.step) == 3
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(js.params[k]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.ema[k].numpy(),
                                   np.asarray(js.ema_params[k]), rtol=0,
                                   atol=1e-6)


def _write_clip(root, n=8, h=20, w=24, c=1, seqs=("a", "b")):
    from PIL import Image

    rng = np.random.default_rng(8)
    for seq in seqs:
        for sub, scale in (("lr", 1), ("gt", 4)):
            d = os.path.join(root, sub, seq)
            os.makedirs(d)
            for i in range(n):
                img = rng.integers(0, 256, (h * scale, w * scale, c), np.uint8)
                Image.fromarray(img[..., 0] if c == 1 else img).save(
                    os.path.join(d, f"{i:08d}.png"))


@pytest.mark.parametrize("c", [1, 3])
def test_sampling_matches_jax_bit_for_bit(tmp_path, c):
    _write_clip(str(tmp_path), c=c)
    kw = dict(lr_root=str(tmp_path / "lr"), gt_root=str(tmp_path / "gt"),
              grayscale=c == 1)
    port, ref = ClipFolderDataset(**kw), JClipFolderDataset(**kw)
    rp, rr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        for a, b in zip(port.sample_train_window(rp, 12),
                        ref.sample_train_window(rr, 12)):
            np.testing.assert_array_equal(a, b)
    for (i, wa, ga), (j, wb, gb) in zip(port.iter_test_windows("b"),
                                        ref.iter_test_windows("b")):
        assert i == j
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ga, gb)


def test_copied_config_metrics_and_key_map_match_jax():
    for name in config.PRESET_NAMES:
        port, ref = config.preset(name), j_config.preset(name)
        for section in ("model", "data", "train", "eval"):
            for k, v in vars(getattr(port, section)).items():
                assert getattr(getattr(ref, section), k) == v, (name, k)
    cfg = config.ExperimentConfig.from_json(j_config.preset(
        "fcvsr_s_redsLD_QP27").to_json())
    assert cfg.train.betas == (0.9, 0.99) and cfg.model.name == "fcvsr_s"

    rng = np.random.default_rng(10)
    a, b = (rng.uniform(0, 255, (24, 20, 3)) for _ in range(2))
    for conv in (None, "Y"):
        assert psnr_ssim.calculate_psnr(a, b, 2, conv) == \
            j_psnr_ssim.calculate_psnr(a, b, 2, conv)
        assert psnr_ssim.calculate_ssim(a, b, 0, conv) == \
            j_psnr_ssim.calculate_ssim(a, b, 0, conv)

    paths = {"/".join(str(k.key) for k in p[1:-1])
             for p, _ in jax.tree_util.tree_leaves_with_path(_jax_small(1)[1])}
    assert len(paths) > 150
    for path in sorted(paths) + ["MGAA/nope", "recorb1/group0/block0/x"]:
        assert flax_to_torch_key(path) == j_key(path), path


def test_train_cli_trains_resumes_and_loads(tmp_path, one_torch_thread):
    _write_clip(str(tmp_path))
    base = ["--preset", "fcvsr_s_cvcpLD_QP37", "--device", "cpu",
            "--lr-root", str(tmp_path / "lr"), "--gt-root",
            str(tmp_path / "gt"), "--work-dir", str(tmp_path / "work"),
            "--batch-size", "2", "--lr-patch", "12"]
    before = launch_counts()
    first = train_main(base + ["--total-iters", "2"])
    ckpt = tmp_path / "work" / "fcvsr_s_cvcpLD_QP37" / "ckpt"
    assert first["start"] == 0 and first["step"] == 2
    assert len(first["losses"]) == 2 and np.isfinite(first["losses"]).all()
    assert first["ms_per_step"] is None  # no device time off CUDA
    assert (ckpt / "iter_2.pt").is_file()
    sd = torch.load(ckpt / "iter_2.pt", weights_only=True)
    assert set(sd) == {"model", "optimizer", "ema", "step"} and sd["step"] == 2

    again = train_main(base + ["--total-iters", "3"])
    assert again["start"] == 2 and again["step"] == 3
    explicit = train_main(base + ["--total-iters", "4", "--resume-from",
                                  str(ckpt / "iter_2.pt")])
    assert explicit["start"] == 2 and explicit["step"] == 4
    assert explicit["losses"][0] == pytest.approx(again["losses"][0], rel=1e-6)

    # weights only, from a reference-keyed .npz with mmedit's prefix
    npz = tmp_path / "ref.npz"
    np.savez(npz, **{f"generator.{k}": v.numpy()
                     for k, v in sd["model"].items()})
    warm = train_main(base + ["--total-iters", "1", "--load-from", str(npz),
                              "--work-dir", str(tmp_path / "warm")])
    assert warm["start"] == 0 and warm["step"] == 1
    assert warm["losses"][0] == pytest.approx(again["losses"][0], rel=1e-6)
    log = (ckpt.parent / "train_log.csv").read_text().split()
    assert [line.split(",")[0] for line in log] == ["2", "3", "4"]
    assert launch_counts() == before


def test_train_cli_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--preset", "fcvsr_s_cvcpLD_QP37", "--work-dir",
                    str(tmp_path)])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, in a fresh interpreter:
    neither jax nor the JAX package (nor anything of ``native/``) gets
    imported."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        fcvsr_tpu_torch.__path__, "fcvsr_tpu_torch."))
    assert "fcvsr_tpu_torch.train.cli" in mods and len(mods) > 20
    assert {"fcvsr_tpu_torch.parallel.dist", "fcvsr_tpu_torch.parallel.mesh",
            "fcvsr_tpu_torch.data.lmdb_reader",
            "fcvsr_tpu_torch.data.lmdb_writer",
            "fcvsr_tpu_torch.models.sidecvsr",
            "fcvsr_tpu_torch.models.fcvsr_tfdc",
            "fcvsr_tpu_torch.models.raft",
            "fcvsr_tpu_torch.models.blocks_ext",
            "fcvsr_tpu_torch.models.sisr", "fcvsr_tpu_torch.models.liif",
            "fcvsr_tpu_torch.models.ttsr",
            "fcvsr_tpu_torch.models.duf",
            "fcvsr_tpu_torch.metrics.lpips", "fcvsr_tpu_torch.metrics.noref",
            "fcvsr_tpu_torch.metrics.nrqm", "fcvsr_tpu_torch.metrics.vmaf",
            "fcvsr_tpu_torch.data.native_loader",
            "fcvsr_tpu_torch.utils.visualize"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'fcvsr_tpu',\n"
            "       'native') or m.startswith(('jax.', 'fcvsr_tpu.',\n"
            "                                  'native.'))]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_profiling_train_phases_on_cpu(one_torch_thread):
    """The profiling script's training phases at a tiny size: the phases
    add up to the step, and the profiled steps update the model."""
    from fcvsr_tpu_torch import profiling

    model = init_weights(FCVSRNet.small(n_feats=16),
                         torch.Generator().manual_seed(11))
    state = TrainState(model, lr_schedule.multistep(1e-3, [10]))
    rng = np.random.default_rng(11)
    lrs = torch.from_numpy(rng.uniform(0, 1, (2, 7, 1, 8, 8))
                           .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (2, 1, 32, 32)).astype(np.float32))
    times = profiling.train_step_times(state, losses.charbonnier_sum, lrs, gt,
                                       reps=2)
    assert set(times) == {"forward_loss", "backward", "update", "step"}
    assert times["step"] == pytest.approx(
        times["forward_loss"] + times["backward"] + times["update"], rel=0.5)
    prof = profiling.train_profile(state, losses.charbonnier_sum, lrs, gt,
                                   n=1)
    assert prof["wall_ms"] > 0 and prof["busy_ms"] is None
    assert state.step == 1 + 2 + 1 + 1
