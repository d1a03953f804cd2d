"""Training the GAN family through the port's ``train/cli.py``, as
``train.py`` trains it, on the CPU.

* The 5 GAN presets equal the JAX package's field by field, and
  ``ExperimentConfig.from_json`` keeps every field of each one's JAX
  ``config.json`` (``to_json`` gives it back unchanged).
* The degradation chain and ``degrade_sequence`` equal the JAX package's
  bit for bit: the port's ``np.random.RandomState(s)`` and
  ``random.Random(s)`` against the JAX package's global streams seeded
  with ``np.random.seed(s)`` and ``random.seed(s)`` (restored after);
  ``RandomVideoCompression`` refuses clearly without ``av``.
* ``gan_sampler``: the first batch the CLI trains on (its second draw, the
  first being dropped as the JAX CLI's initialisation batch) equals the
  second batch ``train.py``'s sampling calls (``train.py:172-208``) give
  with the JAX ``ClipFolderDataset`` for the same seed: GLEAN's centre
  LR frame and GT, and RealBasicVSR's degraded GT sequences (the JAX
  chain drawing from the global streams seeded by hand, as
  tests/test_integration_cli.py seeds them).
* ``train_cli.main`` on each of the 5 presets at tiny widths (from a JAX
  ``config.json``; GLEAN at 4 -> 8): a step, ``training complete``, a GAN
  checkpoint with the discriminator's entries only where there is one;
  then a run to step 2 that resumes from it (counter 2), the CSV rows.
* ``--device cuda`` refuses without CUDA; the GAN path refuses
  ``--load-from``.

Torch runs on one thread.
"""

import csv
import os
import random

import numpy as np
import pytest
import torch

from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu.data import degradations as jdeg
from fcvsr_tpu.utils.config import preset as j_preset
from fcvsr_tpu_torch.data import degradations as deg
from fcvsr_tpu_torch.train import cli as train_cli
from fcvsr_tpu_torch.utils import config

GAN_PRESETS = ["realbasicvsr_reds", "realbasicvsr_wogan_reds",
               "glean_cat_8x", "dic_celeba", "dic_gan_celeba"]


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
    """Smooth noisy clips: RealBasicVSR's GT (3 frames of 256 x 256),
    GLEAN's LR / GT pairs (16 -> 32, 4 frames) and DIC's (16 -> 128, 4
    frames), each LR the GT's block mean."""
    root = str(tmp_path_factory.mktemp("gan"))
    rng = np.random.default_rng(3)
    for name, lr, scale, n in (("rbv", 64, 4, 3), ("glean", 16, 2, 4),
                               ("dic", 16, 8, 4)):
        side = lr * scale
        for i in range(n):
            smooth = rng.uniform(0, 255, (4, 4, 3))
            gt = np.kron(smooth, np.ones((side // 4, side // 4, 1)))
            gt = np.clip(gt + rng.normal(0, 8, (side, side, 3)), 0, 255)
            low = gt.reshape(lr, scale, lr, scale, 3).mean((1, 3))
            _png(os.path.join(root, name, "gt", "clip", f"{i:08d}.png"), gt)
            _png(os.path.join(root, name, "lr", "clip", f"{i:08d}.png"), low)
    return root


def _section_fields(cfg):
    return {s: vars(getattr(cfg, s)) for s in
            ("model", "data", "train", "gan", "eval")}


@pytest.mark.parametrize("name", GAN_PRESETS)
def test_gan_presets_and_from_json_match_jax(name):
    assert name in config.PRESET_NAMES
    ref = j_preset(name)
    port = config.preset(name)
    assert _section_fields(port) == _section_fields(ref)
    got = config.ExperimentConfig.from_json(ref.to_json())
    assert got.to_json() == ref.to_json()


# ----------------------------- degradations ----------------------------------


def _jax_seeded(seed, fn):
    """``fn()`` with the global numpy and Python streams seeded, restored
    after."""
    np_state, py_state = np.random.get_state(), random.getstate()
    try:
        np.random.seed(seed)
        random.seed(seed)
        return fn()
    finally:
        np.random.set_state(np_state)
        random.setstate(py_state)


def _clip(seed, t=3, side=64):
    rng = np.random.default_rng(seed)
    smooth = rng.uniform(0, 1, (t, 4, 4, 3))
    base = np.kron(smooth, np.ones((1, side // 4, side // 4, 1)))
    return np.clip(base + rng.normal(0, 0.03, base.shape), 0, 1) \
        .astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_degradation_chain_is_jax_bit_for_bit(seed):
    """Two calls of one chain (the second starts from the first's
    streams), each over a 3-frame clip."""
    clips = [_clip(10 * seed + i) for i in range(2)]

    def run(chain, *gens):
        return [chain({"lq": [f for f in c]}, *gens)["lq"] for c in clips]

    want = _jax_seeded(seed, lambda: run(
        jdeg.realbasicvsr_degradation_chain()))
    got = run(deg.realbasicvsr_degradation_chain(
        rs=np.random.RandomState(seed), py_rng=random.Random(seed)))
    for w, g in zip(want, got):
        assert len(w) == len(g) == 3
        for a, b in zip(w, g):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_degrade_sequence_is_jax_bit_for_bit():
    gt = _clip(99, t=4, side=96)
    want = _jax_seeded(5, lambda: jdeg.degrade_sequence(
        jdeg.realbasicvsr_degradation_chain(), gt, 4))
    chain = deg.realbasicvsr_degradation_chain()
    got = deg.degrade_sequence(chain, gt, 4, np.random.RandomState(5),
                               random.Random(5))
    assert got.shape == (4, 24, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_video_compression_refuses_without_av():
    pytest.importorskip("scipy")
    try:
        import av  # noqa: F401
        pytest.skip("av is installed")
    except ImportError:
        pass
    chain = deg.realbasicvsr_degradation_chain(include_video_compression=True)
    with pytest.raises(RuntimeError, match="'av' library"):
        for seed in range(20):   # until its draw does not skip it
            chain({"lq": [f for f in _clip(seed, t=2, side=32)]},
                  np.random.RandomState(seed), random.Random(seed))


# ------------------------------- the stream ----------------------------------


def _cfg(name, tree, **over):
    cfg = j_preset(name)
    data = "rbv" if name.startswith("real") else name.split("_")[0]
    cfg.data.lr_root = os.path.join(tree, data, "lr")
    cfg.data.gt_root = os.path.join(tree, data, "gt")
    cfg.model.n_feats = 8
    cfg.data.batch_size = 1
    if data == "rbv":
        cfg.model.num_blocks, cfg.model.num_frames = 1, 2
    elif data == "glean":
        cfg.model.in_size, cfg.model.out_size = 4, 8
        cfg.model.num_blocks, cfg.model.num_frames = 1, 3
        cfg.data.lr_patch = 4
    else:
        cfg.model.num_blocks, cfg.model.num_steps = 2, 2
        cfg.model.num_frames = 3
    for k, v in over.items():
        setattr(cfg.data, k, v)
    return cfg


def test_glean_stream_is_train_py_second_batch(tree):
    cfg = _cfg("glean_cat_8x", tree, batch_size=2)
    port_cfg = config.ExperimentConfig.from_json(cfg.to_json())
    sample = train_cli.gan_sampler(port_cfg)
    rp = np.random.default_rng(cfg.train.seed)
    sample(rp)
    got = sample(rp)
    # train.py:195-208: the image families' centre LR frame and GT
    ds = JClipFolderDataset(lr_root=cfg.data.lr_root,
                            gt_root=cfg.data.gt_root,
                            window=cfg.model.num_frames, scale=2)
    rj = np.random.default_rng(cfg.train.seed)
    for batch in range(2):
        lqs, gts = [], []
        for _ in range(cfg.data.batch_size):
            lq, gt = ds.sample_train_window(rj, cfg.data.lr_patch)
            lqs.append(np.transpose(lq[lq.shape[0] // 2], (2, 0, 1)))
            gts.append(np.transpose(gt, (2, 0, 1)))
    assert got[0].shape == (2, 3, 4, 4) and got[1].shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(got[0], np.stack(lqs))
    np.testing.assert_array_equal(got[1], np.stack(gts))


def test_realbasicvsr_stream_is_train_py_second_batch(tree):
    cfg = _cfg("realbasicvsr_reds", tree, lr_patch=16)
    port_cfg = config.ExperimentConfig.from_json(cfg.to_json())
    sample = train_cli.gan_sampler(port_cfg)
    rp = np.random.default_rng(cfg.train.seed)
    sample(rp)
    got = sample(rp)
    assert sample.degrade_seconds > 0

    def jax_batches():
        # train.py:172-184, the chain on the global streams
        chain = jdeg.realbasicvsr_degradation_chain()
        ds = JClipFolderDataset(lr_root=cfg.data.gt_root,
                                gt_root=cfg.data.gt_root,
                                window=cfg.model.num_frames, scale=1)
        rj = np.random.default_rng(cfg.train.seed)
        out = []
        for _ in range(2):
            gt, _ = ds.sample_train_sequence(rj, 4 * cfg.data.lr_patch)
            lq = jdeg.degrade_sequence(chain, gt, 4)
            out.append((np.transpose(lq, (0, 3, 1, 2))[None],
                        np.transpose(gt, (0, 3, 1, 2))[None]))
        return out[1]

    want = _jax_seeded(cfg.train.seed, jax_batches)
    assert got[0].shape == (1, 2, 3, 16, 16)
    assert got[1].shape == (1, 2, 3, 64, 64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -------------------------------- the CLI ------------------------------------


def _run(tmp_path, cfg, iters, capsys):
    path = tmp_path / f"{cfg.name}.json"
    path.write_text(cfg.to_json())
    out = train_cli.main(["--config", str(path), "--work-dir",
                          str(tmp_path / "work"), "--total-iters",
                          str(iters), "--device", "cpu"])
    assert "training complete" in capsys.readouterr().out
    return out


@pytest.mark.parametrize("name", GAN_PRESETS)
def test_cli_trains_each_gan_preset_and_resumes(name, tree, tmp_path, capsys):
    cfg = _cfg(name, tree)
    cfg.train.log_interval = cfg.train.ckpt_interval = 1
    first = _run(tmp_path, cfg, 1, capsys)
    assert first["start"] == 0 and first["counter"] == 1
    disc = cfg.gan.disc != "none"
    logs = first["logs"][0]
    assert all(np.isfinite(v) for v in logs.values())
    assert ("loss_d" in logs) == disc and "loss_g" in logs
    if name.startswith("real"):
        assert "loss_clean" in logs
    if name.startswith("dic"):
        assert {"loss_pixel_v0", "loss_pixel_v1"} <= set(logs)
    run_dir = os.path.join(str(tmp_path / "work"), cfg.name)
    ckpt = torch.load(os.path.join(run_dir, "ckpt", "iter_1.pt"),
                      weights_only=True)
    keys = {"model", "optimizer", "counter", "step"} | (
        {"discriminator", "d_optimizer"} if disc else set())
    assert set(ckpt) == keys and ckpt["step"] == ckpt["counter"] == 1
    # the generator's Adam holds every generator tensor (the noise maps too)
    gen = train_cli.build_model(config.ExperimentConfig.from_json(
        cfg.to_json()), 0, torch.device("cpu"))
    assert len(ckpt["optimizer"]["param_groups"][0]["params"]) == \
        len(list(gen.parameters()))

    again = _run(tmp_path, cfg, 2, capsys)
    assert again["start"] == 1 and again["counter"] == 2
    assert len(again["logs"]) == 1
    ckpt2 = torch.load(os.path.join(run_dir, "ckpt", "iter_2.pt"),
                       weights_only=True)
    assert ckpt2["step"] == ckpt2["counter"] == 2
    with open(os.path.join(run_dir, "train_log.csv")) as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows] == ["1", "2"]
    assert len(rows[0]) == 1 + len(logs)


def test_cli_refuses_cuda_without_a_card_and_load_from(tree, tmp_path):
    cfg = _cfg("dic_celeba", tree)
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    args = ["--config", str(path), "--work-dir", str(tmp_path / "w"),
            "--total-iters", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cuda"):
            train_cli.main(args)
    with pytest.raises(ValueError, match="--load-from"):
        train_cli.main(args + ["--device", "cpu", "--load-from", "w.pt"])
