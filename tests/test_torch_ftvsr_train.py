"""Training FTVSR and TTVSR through the port's ``train/cli.py``, as
``train.py`` trains them, on the CPU.

* The 7 FTVSR presets equal the JAX package's field by field, and
  ``ExperimentConfig.from_json`` keeps a JAX config's ``model.num_blocks``
  (it dropped it before: the parent's ``ModelConfig`` had no such field).
* ``sample_batch(..., sequence=True)`` draws ``train.sample_batch``'s
  arrays for FTVSR (a window with the GT of every frame) from one seed.
* ``train_cli.main`` trains ``ftvsr_cvcpLD_QP22`` from a JAX config (cut
  to mid 8, ``num_blocks`` 2 and 2-frame windows, so a step is seconds on
  one thread: SPyNet on FTVSR's x4 outputs is most of it) and the same
  config with ``model.name`` ttvsr: 2 steps with an eval row at step 2,
  then a resume to step 3.  TTVSR's eval PSNR is the centre frame's,
  recomputed from the step-2 checkpoint.
* A Vimeo-90K meta file, whose septuplets have no per-frame GT windows,
  is refused with a ValueError (the JAX CLI raises an AttributeError).

Torch runs on one thread.
"""

import csv
import os

import numpy as np
import pytest
import torch

import train as jax_train
from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu.utils.config import ExperimentConfig as JExperimentConfig
from fcvsr_tpu.utils.config import preset as j_preset
from fcvsr_tpu_torch.data import ClipFolderDataset
from fcvsr_tpu_torch.metrics import calculate_psnr
from fcvsr_tpu_torch.models import FTVSRNet
from fcvsr_tpu_torch.train import cli as train_cli
from fcvsr_tpu_torch.utils import config
from fcvsr_tpu_torch.utils.checkpoint import load_weights

PRESET = "ftvsr_cvcpLD_QP22"
FTVSR_PRESETS = ["ftvsr_cvcp", "ftvsr_cvcpLD_QP22", "ftvsr_cvcpLD_QP27",
                 "ftvsr_cvcpLD_QP32", "ftvsr_cvcpLD_QP37", "ftvsr_reds4",
                 "ftvsr_vimeo90k"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(path, img):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img.astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A training clip (9 frames, LR 64x64 RGB, GT x4) and a validation
    clip (2 frames of the same size), LR the GT's 4x4 block mean."""
    root = str(tmp_path_factory.mktemp("ftvsr"))
    rng = np.random.default_rng(3)
    smooth = rng.uniform(0, 255, (12, 9, 9, 3))
    for sub, n in (("", 9), ("val_", 2)):
        for i in range(n):
            gt = np.kron(smooth[i:i + 3].mean(0), np.ones((29, 29, 1)))
            gt = np.clip(gt[:256, :256] + rng.normal(0, 4, (256, 256, 3)),
                         0, 255)
            lr = gt.reshape(64, 4, 64, 4, 3).mean((1, 3))
            _png(os.path.join(root, f"{sub}lr", "clip", f"{i:08d}.png"), lr)
            _png(os.path.join(root, f"{sub}gt", "clip", f"{i:08d}.png"), gt)
    return root


def test_ftvsr_presets_match_jax():
    assert [n for n in config.PRESET_NAMES if n.startswith("ftvsr")] == \
        FTVSR_PRESETS
    for name in FTVSR_PRESETS:
        port, ref = config.preset(name), j_preset(name)
        for section in ("model", "data", "train", "eval"):
            for k, v in vars(getattr(port, section)).items():
                assert getattr(getattr(ref, section), k) == v, (name, k)
        assert (port.model.name, port.model.num_frames, port.data.batch_size,
                port.data.lr_patch) == ("ftvsr", 7, 1, 64)


def test_from_json_keeps_num_blocks():
    ref = JExperimentConfig()
    ref.model.name, ref.model.num_blocks = "ttvsr", 3
    cfg = config.ExperimentConfig.from_json(ref.to_json())
    assert (cfg.model.name, cfg.model.num_blocks) == ("ttvsr", 3)
    assert config.ExperimentConfig().model.num_blocks == 0


def test_sample_batch_draws_the_jax_sequences(tree):
    cfg = j_preset(PRESET)
    cfg.data.batch_size, cfg.data.lr_patch = 2, 16
    lr, gt = os.path.join(tree, "lr"), os.path.join(tree, "gt")
    ref = JClipFolderDataset(lr_root=lr, gt_root=gt, window=7)
    port = ClipFolderDataset(lr_root=lr, gt_root=gt, window=7)
    rp, rj = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        got = train_cli.sample_batch(rp, port, 2, 16, sequence=True)
        want = jax_train.sample_batch(rj, ref, cfg)
        assert got[0].shape == (2, 7, 3, 16, 16)
        assert got[1].shape == (2, 7, 3, 64, 64)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _config(tree, name, preset=PRESET):
    cfg = j_preset(preset)
    cfg.model.name, cfg.model.n_feats = name, 8
    cfg.model.num_blocks, cfg.model.num_frames = 2, 2
    cfg.train.eval_interval = cfg.train.ckpt_interval = 2
    cfg.train.log_interval = 1
    cfg.work_dir = os.path.join(tree, f"work_{name}_{preset}")
    path = os.path.join(tree, f"{name}_{preset}.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


@pytest.mark.parametrize("name", ["ftvsr", "ttvsr"])
def test_train_cli_trains_evals_and_resumes(tree, name):
    args = ["--config", _config(tree, name), "--device", "cpu",
            "--lr-root", os.path.join(tree, "lr"),
            "--gt-root", os.path.join(tree, "gt"),
            "--val-lr-root", os.path.join(tree, "val_lr"),
            "--val-gt-root", os.path.join(tree, "val_gt")]
    first = train_cli.main(args + ["--total-iters", "2"])
    second = train_cli.main(args + ["--total-iters", "3"])
    assert (first["start"], first["step"]) == (0, 2)
    assert (second["start"], second["step"]) == (2, 3)
    assert all(np.isfinite(first["losses"] + second["losses"]))
    work = first["work_dir"]
    assert sorted(os.listdir(os.path.join(work, "ckpt"))) == \
        ["iter_2.pt", "iter_3.pt"]
    with open(os.path.join(work, "train_log.csv")) as f:
        rows = list(csv.reader(f))
    assert [r[:2] if r[1] == "eval_psnr" else r[:1] for r in rows] == \
        [["1"], ["2"], ["2", "eval_psnr"], ["3"]]
    psnr = float(rows[2][2])
    assert first["eval_psnr"] == [(2, psnr)] and 5 < psnr < 60

    model = train_cli.build_model(config.preset(PRESET), 0, "cpu")
    assert isinstance(model, FTVSRNet) and len(model.resblocks.main[2]) == 72
    if name == "ftvsr":
        return
    # the eval row: PSNR of the centre frame of each window's output
    cfg = config.ExperimentConfig.from_json(open(_config(tree, name)).read())
    model = train_cli.build_model(cfg, 1, "cpu").eval()
    assert not model.with_ftt and len(model.resblocks.main[2]) == 2
    load_weights(os.path.join(work, "ckpt", "iter_2.pt"), model)
    ds = ClipFolderDataset(os.path.join(tree, "val_lr"),
                           os.path.join(tree, "val_gt"), window=2)
    psnrs = []
    with torch.no_grad():
        for _, window, gt in ds.iter_test_windows("clip"):
            x = np.transpose(window.astype(np.float32) / 255, (0, 3, 1, 2))
            sr = model(torch.from_numpy(x[None]))[0, 1].numpy()
            psnrs.append(calculate_psnr(
                np.clip(sr.transpose(1, 2, 0) * 255, 0, 255),
                gt.astype(np.float32)))
    assert len(psnrs) == 2
    assert psnr == pytest.approx(float(np.mean(psnrs)), rel=1e-6)


def test_train_cli_refuses_vimeo_septuplets_for_ftvsr(tree):
    meta = os.path.join(tree, "meta.txt")
    with open(meta, "w") as f:
        f.write("clip (256,448,3)\n")
    with pytest.raises(ValueError, match="sample_train_sequence"):
        train_cli.main(["--config", _config(tree, "ftvsr", "ftvsr_vimeo90k"),
                        "--device", "cpu", "--meta-file", meta,
                        "--lr-root", os.path.join(tree, "lr"),
                        "--gt-root", os.path.join(tree, "gt"),
                        "--total-iters", "1"])
