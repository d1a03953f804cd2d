"""Serving trained weights through the port, on the CPU: FCVSR-S at Y.

* ``utils.checkpoint.load_weights`` reads a ``tests/torch_mirror.py``
  state_dict saved as ``.pth`` in the reference's three layouts (raw,
  mmcv's ``state_dict`` wrapper with ``generator.`` keys beside ``meta`` and
  ``optimizer`` entries, DataParallel's ``module.`` keys): the port's
  output within 1e-4 of the mirror's (the bar of
  tests/test_parity_torch.py).  A file that needs more than
  ``torch.load(weights_only=True)`` is refused.
* ``export_npz`` writes what ``convert_torch_state_dict`` reads: the JAX
  model's output on it within 1e-4 of the port's.
* The slice as a whole: one ``.npz`` served by ``test.py`` and by the
  port's CLI (``--torch-checkpoint``, ``--device cpu``) on an 8-frame
  20x24 clip: PSNR, SSIM and tOF within 1e-3 of each other, over the same
  frames.
* The port's Farneback flows (two-tap resizes) against the JAX package's
  (dense resampling matrices) at odd sizes through the pyramid: 1e-9
  (float64 sums in another order), and tOF at Y and RGB.
* Train 2 steps with ``train/cli.py``, then serve the checkpoint directory
  with the run's ``config.json``: the SR is the trained model's own forward
  (its PSNRs equal, frame 0's PNG equal), not the seed's, and tOF is finite.

Torch runs on one thread (these tests train, and the suite's workers
share the cores).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.metrics import farneback as j_farneback
from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch import cli
from fcvsr_tpu_torch.data import ClipFolderDataset
from fcvsr_tpu_torch.metrics import farneback
from fcvsr_tpu_torch.models import FCVSRNet, init_weights
from fcvsr_tpu_torch.train import cli as train_cli
from fcvsr_tpu_torch.utils.checkpoint import (export_npz, latest_checkpoint,
                                              load_weights)
from tests.torch_mirror import FCVSRTorchMirror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "fcvsr_s_cvcpLD_QP37"
SMALL = dict(ac_num=3, freq_inv=4, sc_groups=4, up_ksize=1)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def x16():
    x = np.random.default_rng(21).uniform(0, 1, (1, 7, 1, 16, 16))
    return x.astype(np.float32)


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _layouts(sd):
    """The reference's checkpoint layouts of a state_dict."""
    return {
        "raw": sd,
        "mmcv": {"state_dict": {f"generator.{k}": v for k, v in sd.items()},
                 "meta": {"iter": 300000, "mmedit_version": "0.16.0",
                          "config": "exp_name = 'fcvsr'"},
                 "optimizer": {"generator": {
                     "state": {0: {"step": torch.tensor(3.0)}},
                     "param_groups": [{"lr": 1e-4, "params": [0]}]}}},
        "dataparallel": {f"module.{k}": v for k, v in sd.items()},
    }


@pytest.mark.parametrize("layout", ["raw", "mmcv", "dataparallel"])
def test_load_weights_reads_reference_pth(tmp_path, x16, layout):
    torch.manual_seed(22)
    mirror = FCVSRTorchMirror(in_channels=1, **SMALL).eval()
    path = str(tmp_path / "weights.pth")
    torch.save(_layouts(mirror.state_dict())[layout], path)
    port = FCVSRNet.small(in_channels=1).eval()
    load_weights(path, port)
    np.testing.assert_allclose(_forward(port, x16), _forward(mirror, x16),
                               rtol=0, atol=ATOL)


class _Pickled:
    pass


def test_load_weights_refuses_what_weights_only_refuses(tmp_path):
    path = str(tmp_path / "odd.pth")
    torch.save({"state_dict": {}, "meta": _Pickled()}, path)
    with pytest.raises(ValueError, match="weights_only"):
        load_weights(path, FCVSRNet.small(in_channels=1))


def test_export_npz_feeds_the_jax_converter(tmp_path, x16):
    port = init_weights(FCVSRNet.small(in_channels=1),
                        torch.Generator().manual_seed(23)).eval()
    path = export_npz(port, str(tmp_path / "w.npz"))
    jm = JFCVSRNet.small(in_channels=1)
    params = convert_torch_state_dict(
        dict(np.load(path)),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x16)))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x16)))
    np.testing.assert_allclose(_forward(port, x16), ref, rtol=0, atol=ATOL)


def test_farneback_matches_jax():
    rng = np.random.default_rng(26)
    base = rng.uniform(0, 255, (45, 61, 3))
    moved = np.roll(base, (1, 2), (0, 1)) + rng.normal(0, 2, base.shape)
    np.testing.assert_allclose(
        farneback.farneback_flow(base[..., 0], moved[..., 0]),
        j_farneback.farneback_flow(base[..., 0], moved[..., 0]),
        rtol=0, atol=1e-9)
    for conv in (None, "Y"):
        got = farneback.calculate_tof(moved, base, base, moved, conv, "rgb")
        ref = j_farneback.calculate_tof(moved, base, base, moved, conv, "rgb")
        assert abs(got - ref) < 1e-9, (conv, got, ref)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """8 frames of 20x24 (LR) and 80x96 (GT), smooth and drifting, as
    8-bit grey PNGs under lr/seq and gt/seq."""
    from PIL import Image

    root = tmp_path_factory.mktemp("serving_clip")
    rng = np.random.default_rng(24)
    base = rng.uniform(0, 255, (11, 7, 8))
    for i in range(8):
        coarse = base[i:i + 4].mean(0)
        gt = np.kron(coarse, np.ones((12, 12)))[:80, :96]
        gt = np.clip(gt + rng.normal(0, 4, gt.shape), 0, 255)
        lr = gt.reshape(20, 4, 24, 4).mean((1, 3))
        for sub, img in (("lr", lr), ("gt", gt)):
            d = root / sub / "seq"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(d / f"{i:08d}.png")
    return str(root / "lr"), str(root / "gt")


def test_port_cli_matches_test_py_on_one_npz(tmp_path, clip, monkeypatch):
    sys.path.insert(0, REPO)
    import test as test_py

    # test.py initialises its params op by op (45 s for FCVSR-S here) and
    # then replaces every one from the .npz: only their shapes are used,
    # so its init is given the abstract init's zeros
    init = JFCVSRNet.init
    monkeypatch.setattr(JFCVSRNet, "init", lambda self, *a: jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda *b: init(self, *b), *a)))

    lr, gt = clip
    port = init_weights(FCVSRNet.small(in_channels=1),
                        torch.Generator().manual_seed(25))
    npz = export_npz(port, str(tmp_path / "w.npz"))
    common = ["--preset", PRESET, "--lr-root", lr, "--gt-root", gt,
              "--torch-checkpoint", npz]
    ref = test_py.main(common)["per_sequence"]["seq"]
    got = cli.main(common + ["--device", "cpu"])
    assert got["weights"] == {"torch_checkpoint": os.path.abspath(npz)}
    r = got["per_sequence"]["seq"]
    assert r["frames"] == ref["frames"] == 8
    for key in ("psnr", "ssim", "tof"):
        assert abs(r[key] - ref[key]) < 1e-3, (key, r[key], ref[key])
    assert got["average"]["tof"] == r["tof"]


def test_serves_what_train_cli_trained(tmp_path, clip):
    from PIL import Image

    lr, gt = clip
    work = str(tmp_path / "work")
    trained = train_cli.main(["--preset", PRESET, "--device", "cpu",
                              "--lr-root", lr, "--gt-root", gt,
                              "--work-dir", work, "--total-iters", "2",
                              "--batch-size", "2", "--lr-patch", "16"])
    run = trained["work_dir"]
    ckpt_dir = os.path.join(run, "ckpt")
    out = str(tmp_path / "sr")
    got = cli.main(["--config", os.path.join(run, "config.json"),
                    "--checkpoint", ckpt_dir, "--device", "cpu",
                    "--save-dir", out])
    ckpt = latest_checkpoint(ckpt_dir)
    assert ckpt.endswith("iter_2.pt")
    assert got["weights"] == {"checkpoint": os.path.abspath(ckpt)}
    assert got["config"] == PRESET
    r = got["per_sequence"]["seq"]
    assert r["frames"] == 8 and np.isfinite(r["tof"])

    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["data"]["lr_root"] == lr
    model = cli.build_model(cli.preset(PRESET), 0, "cpu")
    seeded = cli.evaluate_sequence(model, ClipFolderDataset(
        lr, gt, grayscale=True), "seq", device="cpu")
    load_weights(ckpt, model)
    own = cli.evaluate_sequence(model, ClipFolderDataset(
        lr, gt, grayscale=True), "seq", device="cpu")
    assert r["psnr_frames"] == own["psnr_frames"]
    assert (r["psnr"], r["ssim"], r["tof"]) == (own["psnr"], own["ssim"],
                                                own["tof"])
    assert r["psnr_frames"] != seeded["psnr_frames"]

    ds = ClipFolderDataset(lr, gt, grayscale=True)
    _, window, _ = next(ds.iter_test_windows("seq"))
    x = np.transpose(window.astype(np.float32) / 255.0, (0, 3, 1, 2))[None]
    sr = np.clip(_forward(model, np.ascontiguousarray(x))[0, 0] * 255, 0, 255)
    png = np.asarray(Image.open(os.path.join(out, "seq", "00000000.png")))
    np.testing.assert_array_equal(png, sr.astype(np.uint8))
