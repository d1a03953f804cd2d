"""The port's training CLI trains on the JAX CLI's batches, bit for bit.

``train.py`` seeds its sampler on every run (resumed runs included), draws
one batch to initialise its state and then trains from the next one, with
no fast-forward on resume.  So its step i trains on the (i + 2)-th batch of
a fresh run, and a resumed run's first step on the 2nd.  The port's CLI
must draw the same batches in the same order.
"""

import types

import numpy as np
import pytest
import torch

import train as jax_train
from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu_torch.train import cli as train_cli

PRESET = "fcvsr_s_cvcpLD_QP37"
BATCH, PATCH = 2, 12


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_clip(root, n=8, h=20, w=24):
    from PIL import Image

    rng = np.random.default_rng(8)
    for seq in ("a", "b"):
        for sub, scale in (("lr", 1), ("gt", 4)):
            d = root / sub / seq
            d.mkdir(parents=True)
            for i in range(n):
                img = rng.integers(0, 256, (h * scale, w * scale), np.uint8)
                Image.fromarray(img).save(d / f"{i:08d}.png")


def _jax_batches(root, seed, n):
    """The first n batches ``train.sample_batch`` draws from the seed."""
    cfg = types.SimpleNamespace(
        model=types.SimpleNamespace(name="fcvsr_s"),
        data=types.SimpleNamespace(batch_size=BATCH, lr_patch=PATCH))
    data = JClipFolderDataset(lr_root=str(root / "lr"),
                              gt_root=str(root / "gt"), window=7,
                              grayscale=True)
    rng = np.random.default_rng(seed)
    return [jax_train.sample_batch(rng, data, cfg) for _ in range(n)]


def _port_batches(monkeypatch, root, total_iters):
    """The (lrs, gt) of every step one port CLI run takes."""
    seen = []
    make = train_cli.make_train_step

    def recording(state, loss, **kw):
        step = make(state, loss, **kw)

        def run(lrs, gt):
            seen.append((lrs.numpy().copy(), gt.numpy().copy()))
            return step(lrs, gt)
        return run

    monkeypatch.setattr(train_cli, "make_train_step", recording)
    out = train_cli.main([
        "--preset", PRESET, "--device", "cpu", "--seed", "3",
        "--lr-root", str(root / "lr"), "--gt-root", str(root / "gt"),
        "--work-dir", str(root / "work"), "--batch-size", str(BATCH),
        "--lr-patch", str(PATCH), "--total-iters", str(total_iters)])
    return out, seen


def _assert_same(port, ref):
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_fresh_run_trains_on_jax_batches_two_and_three(tmp_path, monkeypatch,
                                                       one_torch_thread):
    _write_clip(tmp_path)
    ref = _jax_batches(tmp_path, 3, 3)
    out, seen = _port_batches(monkeypatch, tmp_path, 2)
    assert out["start"] == 0 and len(seen) == 2
    _assert_same(seen[0], ref[1])
    _assert_same(seen[1], ref[2])
    # the dropped draw is a real batch, not the one trained on
    assert not np.array_equal(seen[0][0], ref[0][0])


def test_resumed_run_trains_on_jax_batch_two(tmp_path, monkeypatch,
                                             one_torch_thread):
    _write_clip(tmp_path)
    ref = _jax_batches(tmp_path, 3, 2)
    first, _ = _port_batches(monkeypatch, tmp_path, 1)
    resumed, seen = _port_batches(monkeypatch, tmp_path, 2)
    assert first["step"] == 1 and resumed["start"] == 1 and len(seen) == 1
    _assert_same(seen[0], ref[1])
