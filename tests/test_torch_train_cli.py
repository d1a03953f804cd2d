"""Training what ``train.py`` trains, through the port's ``train/cli.py``, on
the CPU: Vimeo-90K septuplets through a meta file, periodic evaluation,
TensorBoard and the JAX CLI's ``--fast`` / ``--warp-impl`` flags.

* ``Vimeo90KDataset.sample_train`` and ``train_cli.sample_batch`` draw the
  JAX package's crops and flips, bit for bit, for one seed.
* ``train_cli.main`` on a tiny Vimeo-style tree (FCVSR-S, RGB, 16 px LR
  patches, 3 steps, ``eval_interval`` 2 and ``log_interval`` 1 from a JAX
  config, ``--tensorboard --fast --warp-impl pallas``) writes the rows the
  JAX CLI writes in its order (a loss row each step, the ``eval_psnr`` row
  after step 2's) and an event file with the JAX CLI's scalars.
* Its eval PSNR equals the JAX CLI's ``run_eval`` (train.py:502-534, its
  steps here with the JAX package's dataset, model and PSNR) on the same
  weights, the step-2 checkpoint carried by ``export_npz``, within 1e-3 dB.

Torch runs on one thread; the JAX forward is jitted once.
"""

import csv
import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jax_train
from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu.data import Vimeo90KDataset as JVimeo90KDataset
from fcvsr_tpu.metrics import calculate_psnr as j_psnr
from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.utils.config import preset as j_preset
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch.data import Vimeo90KDataset
from fcvsr_tpu_torch.models import FCVSRNet
from fcvsr_tpu_torch.train import cli as train_cli
from fcvsr_tpu_torch.utils.checkpoint import export_npz, load_weights

PRESET = "fcvsr_s_vimeoLD_QP37"
PATCH = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(path, img):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Vimeo-style tree (3 septuplets of 7 frames, LR 20x24, GT x4, a
    meta file naming 2 of them) and a validation clip (8 frames, LR
    16x16)."""
    root = str(tmp_path_factory.mktemp("vimeo"))
    rng = np.random.default_rng(41)
    keys = ["00001/0001", "00001/0002", "00002/0001"]
    for key in keys:
        for i in range(7):
            lr = rng.integers(0, 256, (20, 24, 3), np.uint8)
            _png(os.path.join(root, "lr", key, f"im{i + 1}.png"), lr)
            _png(os.path.join(root, "gt", key, f"im{i + 1}.png"),
                 np.kron(lr, np.ones((4, 4, 1), np.uint8)))
    meta = os.path.join(root, "meta_info.txt")
    with open(meta, "w") as f:
        f.write(f"{keys[0]} (256,448,3)\n\n{keys[2]} (256,448,3)\n")
    smooth = rng.uniform(0, 255, (11, 6, 6, 3))
    for i in range(8):
        gt = np.kron(smooth[i:i + 4].mean(0), np.ones((11, 11, 1)))[:64, :64]
        gt = np.clip(gt + rng.normal(0, 4, gt.shape), 0, 255)
        lr = gt.reshape(16, 4, 16, 4, 3).mean((1, 3))
        for sub, img in (("val_lr", lr), ("val_gt", gt)):
            _png(os.path.join(root, sub, "seq", f"{i:08d}.png"),
                 img.astype(np.uint8))
    return root, meta


def test_vimeo_draws_the_jax_crops(tree):
    root, meta = tree
    port = Vimeo90KDataset(os.path.join(root, "lr"), os.path.join(root, "gt"),
                           meta)
    ref = JVimeo90KDataset(os.path.join(root, "lr"), os.path.join(root, "gt"),
                           meta)
    assert port.keys == ref.keys == ["00001/0001", "00002/0001"]
    rp, rj = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        for a, b in zip(port.sample_train(rp, PATCH),
                        ref.sample_train(rj, PATCH)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    cfg = j_preset(PRESET)
    cfg.data.lr_root, cfg.data.gt_root = ref.lr_root, ref.gt_root
    cfg.data.meta_file, cfg.data.lr_patch = meta, PATCH
    cfg.data.batch_size = 3
    jax_ds = jax_train.build_dataset(cfg)
    port_cfg = train_cli._config(types.SimpleNamespace(
        config="", preset=PRESET, lr_root=ref.lr_root, gt_root=ref.gt_root,
        meta_file=meta, work_dir="", total_iters=0, batch_size=0,
        lr_patch=PATCH, load_from="", resume_from="", seed=None))
    assert isinstance(jax_ds, JVimeo90KDataset)
    assert isinstance(train_cli.build_dataset(port_cfg), Vimeo90KDataset)
    rp, rj = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(2):
        for a, b in zip(train_cli.sample_batch(rp, port, 3, PATCH),
                        jax_train.sample_batch(rj, ref, cfg)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trained(tree):
    root, meta = tree
    cfg = j_preset(PRESET)
    cfg.train.eval_interval, cfg.train.ckpt_interval = 2, 2
    cfg.train.log_interval = 1
    cfg.work_dir = os.path.join(root, "work")
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    out = train_cli.main([
        "--config", path, "--device", "cpu", "--lr-root",
        os.path.join(root, "lr"), "--gt-root", os.path.join(root, "gt"),
        "--meta-file", meta, "--batch-size", "2", "--lr-patch", str(PATCH),
        "--total-iters", "3", "--val-lr-root", os.path.join(root, "val_lr"),
        "--val-gt-root", os.path.join(root, "val_gt"), "--tensorboard",
        "--fast", "--warp-impl", "pallas"])
    return root, out


def test_train_cli_writes_the_jax_clis_rows(trained):
    root, out = trained
    assert out["start"] == 0 and out["step"] == 3
    with open(os.path.join(out["work_dir"], "train_log.csv")) as f:
        rows = list(csv.reader(f))
    assert [r[:2] if r[1] == "eval_psnr" else r[:1] for r in rows] == \
        [["1"], ["2"], ["2", "eval_psnr"], ["3"]]
    psnr = float(rows[2][2])
    assert out["eval_psnr"] == [(2, psnr)] and 5 < psnr < 60
    for r, loss in zip([rows[0], rows[1], rows[3]], out["losses"]):
        assert float(r[1]) == pytest.approx(loss, rel=1e-6)
    ckpts = sorted(os.listdir(os.path.join(out["work_dir"], "ckpt")))
    assert ckpts == ["iter_2.pt", "iter_3.pt"]

    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    events = glob.glob(os.path.join(out["work_dir"], "tb", "events.*"))
    assert len(events) == 1
    acc = EventAccumulator(events[0])
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert sorted(tags) == ["eval/psnr", "train/iters_per_sec", "train/loss"]
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2, 3]
    assert [(e.step, e.value) for e in acc.Scalars("eval/psnr")] == \
        [(2, pytest.approx(psnr, abs=1e-4))]


def test_eval_psnr_matches_the_jax_clis_run_eval(trained, tmp_path):
    root, out = trained
    model = FCVSRNet.small(in_channels=3).eval()
    load_weights(os.path.join(out["work_dir"], "ckpt", "iter_2.pt"), model)
    npz = export_npz(model, str(tmp_path / "iter_2.npz"))
    jm = JFCVSRNet.small(in_channels=3)
    params = convert_torch_state_dict(
        dict(np.load(npz)),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 7, 3, 16, 16), jnp.float32)))
    # train.py's run_eval, its steps with the JAX package's pieces
    ds = JClipFolderDataset(lr_root=os.path.join(root, "val_lr"),
                            gt_root=os.path.join(root, "val_gt"), window=7,
                            grayscale=False)
    fwd = jax.jit(lambda p, v: jm.apply(p, v))
    psnrs = []
    for i, window, gt in ds.iter_test_windows(ds.sequences[0]):
        x = jnp.asarray(np.transpose(
            window.astype(np.float32) / 255.0, (0, 3, 1, 2))[None])
        sr = np.asarray(fwd(params, x))[0]
        sr255 = np.clip(np.transpose(sr, (1, 2, 0)) * 255, 0, 255)
        psnrs.append(j_psnr(sr255, gt.astype(np.float32)))
        if i >= 7:
            break
    assert len(psnrs) == 8
    assert out["eval_psnr"][0][1] == pytest.approx(float(np.mean(psnrs)),
                                                   abs=1e-3)
