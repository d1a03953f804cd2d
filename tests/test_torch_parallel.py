"""The port's parallel helpers in one process, each rank's data stream, and
the rest of ``data/`` against the JAX package, on the CPU.

* Without a process group the helpers are what the JAX package's are for
  one process: ``initialize_multihost()`` forms nothing and returns 0,
  ``gather_results`` and ``psum_metrics`` return their input, the mesh is
  rank 0 of 1; a group asked for and not formed raises.
* Each rank's batches: ``train.cli.local_batch_size`` and ``sample_batch``
  on ``np.random.default_rng(seed + rank)`` draw ``train.py``'s per-host
  stream (``train.py:454-468``: the global batch rounded to a multiple of
  the devices, one a rank, then cut to the share; the first batch dropped),
  bit for bit, at 2 ranks.
* LMDB: a database written by either package reads the same in both
  readers (every key, every value, the key order, an overflow value), and
  both writers write the same bytes; ``SRLmdbDataset`` gives the same keys
  and images in both.
* ``AnnotationDataset``, ``CVCPClipCache``, ``SideInfoClipCache`` and
  ``MM522Dataset`` give the JAX package's clips, keys and samples under the
  same generator, bit for bit, on small trees under ``tmp_path``.
"""

import io
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import train as jax_train
from fcvsr_tpu.data import datasets as j_datasets
from fcvsr_tpu.data.lmdb_reader import LmdbReader as JLmdbReader
from fcvsr_tpu.data.lmdb_reader import SRLmdbDataset as JSRLmdbDataset
from fcvsr_tpu.data.lmdb_writer import write_lmdb as j_write_lmdb
from fcvsr_tpu_torch import data
from fcvsr_tpu_torch.parallel import (Mesh, gather_results,
                                      initialize_multihost, make_mesh,
                                      psum_metrics, rank_share, replicate,
                                      shard_batch)
from fcvsr_tpu_torch.train import cli as train_cli


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _write_frames(d, n, h, w, rng, channels=None):
    from PIL import Image

    d.mkdir(parents=True)
    for i in range(n):
        shape = (h, w) if channels is None else (h, w, channels)
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(
            d / f"{i:05d}.png")


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_helpers_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_multihost() == 0 and not dist.is_initialized()
    arr = np.arange(4.0)
    assert gather_results(arr) is arr
    got = psum_metrics({"psnr": 30.0, "loss": torch.tensor(2.5)})
    assert {k: float(v) for k, v in got.items()} == {"loss": 2.5,
                                                     "psnr": 30.0}
    assert all(v.dtype == torch.float32 for v in got.values())
    mesh = make_mesh("cpu")
    assert mesh == Mesh(torch.device("cpu"), 0, 1, None)
    with pytest.raises(RuntimeError, match="belongs to none"):
        make_mesh("cpu", group=object())
    batch = shard_batch({"x": np.ones((2, 3), np.float32)}, mesh)
    assert batch["x"].device.type == "cpu" and batch["x"].shape == (2, 3)
    x = np.arange(8)
    np.testing.assert_array_equal(rank_share(x, Mesh(mesh.device, 1, 2)),
                                  [4, 5, 6, 7])
    with pytest.raises(ValueError, match="does not split"):
        rank_share(np.arange(3), Mesh(mesh.device, 0, 2))
    module = torch.nn.Linear(2, 2)
    assert replicate(module, mesh) is module


def test_initialize_multihost_refuses_what_it_cannot_form(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="together"):
        initialize_multihost("127.0.0.1:1", 2)
    with pytest.raises(ValueError, match="not in"):
        initialize_multihost("127.0.0.1:1", 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            initialize_multihost("127.0.0.1:1", 1, 0, device="cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_rank_streams_are_train_py_per_host_streams(tmp_path, batch):
    rng = np.random.default_rng(8)
    for seq in ("a", "b"):
        _write_frames(tmp_path / "lr" / seq, 8, 20, 24, rng)
        _write_frames(tmp_path / "gt" / seq, 8, 80, 96, rng)
    world, seed, patch = 2, 3, 12
    ds = data.ClipFolderDataset(str(tmp_path / "lr"), str(tmp_path / "gt"),
                                grayscale=True)
    jds = j_datasets.ClipFolderDataset(str(tmp_path / "lr"),
                                       str(tmp_path / "gt"), grayscale=True)
    local = train_cli.local_batch_size(batch, world)
    # train.py:459-466 with one device a process
    glob = batch if batch % world == 0 else max(world,
                                                batch // world * world)
    assert local == glob // world
    cfg = types.SimpleNamespace(
        model=types.SimpleNamespace(name="fcvsr_s"),
        data=types.SimpleNamespace(batch_size=glob // world, lr_patch=patch))
    for rank in range(world):
        port = np.random.default_rng(seed + rank)
        ref = np.random.default_rng(seed + rank)
        for _ in range(3):  # the dropped batch, then two steps
            _same(train_cli.sample_batch(port, ds, local, patch),
                  jax_train.sample_batch(ref, jds, cfg))


def _items(n=300):
    rng = np.random.default_rng(0)
    items = {f"{i:05d}".encode(): rng.bytes(int(rng.integers(1, 200)))
             for i in range(n)}
    items[b"zz_big"] = rng.bytes(9000)  # an overflow chain of 3 pages
    return items


def test_lmdb_reads_the_same_both_ways(tmp_path):
    items = _items()
    data.write_lmdb(str(tmp_path / "port"), items)
    j_write_lmdb(str(tmp_path / "jax"), items)
    assert (tmp_path / "port" / "data.mdb").read_bytes() == \
        (tmp_path / "jax" / "data.mdb").read_bytes()
    for written in ("port", "jax"):
        for reader in (data.LmdbReader, JLmdbReader):
            r = reader(str(tmp_path / written))
            try:
                assert r.entries == len(items)
                assert list(r.keys()) == sorted(items)
                assert all(r.get(k) == v for k, v in items.items())
                assert r.get(b"absent") is None
            finally:
                r.close()


@pytest.mark.parametrize("meta", [True, False])
def test_sr_lmdb_dataset_matches_jax(tmp_path, meta):
    rng = np.random.default_rng(1)
    frames = {f"000_{i:08d}": rng.integers(0, 256, (6, 10, 3), np.uint8)
              for i in range(3)}
    writer = data.LmdbWriter(str(tmp_path / "db"))
    for k, v in frames.items():
        writer.put(k.encode(), _png(v))
    writer.close()
    if meta:
        (tmp_path / "db" / "meta_info.txt").write_text("".join(
            f"{k}.png (6,10,3) 1\n" for k in frames))
    port = data.SRLmdbDataset(str(tmp_path / "db"))
    ref = JSRLmdbDataset(str(tmp_path / "db"))
    assert port.keys() == ref.keys() == list(frames)
    assert port.meta == ref.meta
    for k, v in frames.items():
        _same(port.load(k), ref.load(k))
        np.testing.assert_array_equal(port.load(k), v)
    with pytest.raises(KeyError):
        port.load("absent")


def test_annotation_dataset_matches_jax(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text("calendar 41 (576,720,3)\nnot a clip line\n"
                   "city 34 (576,704,3)\n")
    args = (str(tmp_path / "lr"), str(tmp_path / "gt"), str(ann))
    port, ref = data.AnnotationDataset(*args), j_datasets.AnnotationDataset(
        *args)
    assert port.clips() == ref.clips() == [
        ("calendar", 41, (576, 720, 3)), ("city", 34, (576, 704, 3))]
    assert port.as_folder().sequences == ref.as_folder().sequences


def test_cvcp_clip_cache_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for seq in ("s0", "s1"):
        _write_frames(tmp_path / "lr" / seq, 9, 12, 14, rng)
        _write_frames(tmp_path / "hr" / seq, 9, 48, 56, rng)
    args = (str(tmp_path / "lr"), str(tmp_path / "hr"), ["s0", "s1"])
    port, ref = data.CVCPClipCache(*args), j_datasets.CVCPClipCache(*args)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(4):
        _same(port.sample(a, lr_patch=8), ref.sample(b, lr_patch=8))


def test_side_info_clip_cache_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    n, h, w = 8, 12, 14
    for seq in ("s0", "s1"):
        _write_frames(tmp_path / "lr" / seq, n, h, w, rng)
        _write_frames(tmp_path / "hr" / seq, n, 4 * h, 4 * w, rng)
        side = tmp_path / "side" / seq
        for sub in ("MV_l0", "Residue"):
            (side / sub).mkdir(parents=True)
        for i in range(n):  # beyond int8's range: clipped on load
            np.save(side / "MV_l0" / f"{i:05d}_mvl0.npy",
                    rng.integers(-300, 300, (h, w, 2)))
            np.save(side / "Residue" / f"{i:05d}_res.npy",
                    rng.integers(-300, 300, (h, w)))
        _write_frames(side / "Partition_Map", n, h, w, rng)
        _write_frames(side / "pred_unfiltered", n, h, w, rng)
        for sub, suffix in (("Partition_Map", "M_mask"),
                            ("pred_unfiltered", "unflt")):
            for p in sorted((side / sub).iterdir()):
                p.rename(p.with_name(f"{p.stem}_{suffix}.png"))
    args = (str(tmp_path / "lr"), str(tmp_path / "hr"),
            str(tmp_path / "side"), ["s0", "s1"])
    port, ref = data.SideInfoClipCache(*args), \
        j_datasets.SideInfoClipCache(*args)
    a, b = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(4):
        _same(port.sample(a, lr_patch=8), ref.sample(b, lr_patch=8))


def test_mm522_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    clips = ("000/c", "240/c", "eval_000/c")
    for clip in clips:
        _write_frames(tmp_path / "lq" / clip, 10, 10, 12, rng, channels=3)
        _write_frames(tmp_path / "gt" / clip, 10, 40, 48, rng, channels=3)
    meta = tmp_path / "meta.txt"
    meta.write_text("".join(f"root/x/{c}/{i:05d}\n" for c in clips
                            for i in range(3)) + "short/line\n")
    args = (str(tmp_path / "lq"), str(tmp_path / "gt"), str(meta))
    for part in ("official", "eval"):
        kw = dict(val_partition=part, interval_list=(1, 2),
                  random_reverse=True, num_input_frames=3)
        port, ref = data.MM522Dataset(*args, **kw), \
            j_datasets.MM522Dataset(*args, **kw)
        assert port.keys == ref.keys and len(port.keys) == 6
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(6):
            _same(port.sample_train_window(a, 6),
                  ref.sample_train_window(b, 6))
    for cls in (data.MM522Dataset, j_datasets.MM522Dataset):
        with pytest.raises(ValueError, match="Wrong validation partition"):
            cls(*args, val_partition="test")
