"""The port's tools (``fcvsr_tpu_torch/tools/``) on the CPU.

* Each pinned script of ``tools/`` has its counterpart, which pins the
  same preset (read from the JAX file as text, not imported), and every
  pinned preset resolves in the port's ``utils.config.preset``.
* An FCVSR-S train script runs 2 steps with ``--device cpu`` on a tiny
  synthetic RGB clip (one sequence of 8 frames of 24 x 32); ``publish``
  gives ``<out>-<sha256[:8]>.pth`` of its bytes, which loads with
  ``load_state_dict(strict=True)``; the matching test script serves it
  back at 4x; ``validate_released_ckpt`` exits 2 on a missing file, 0 at
  the served PSNR and 1 a dB off; the rehearsal passes at 3 steps.
* The export tool on the published ``.pth`` (``--device cpu``) holds the
  ``fcvsr::`` ops, saves, loads, and the loaded program matches the
  eager forward within 1e-6 of max |out| (the same plain versions, the
  same order).
* The three custom ops pass ``torch.library.opcheck`` on the CPU, and an
  eager call of their wrappers gives the op's result without calling the
  op.
* JAX FCVSR-S params (``model.init`` at a seed, jitted, with its forward's
  output: ``init_with_output``), carried across by
  ``utils.convert.state_dict_from_jax`` and published, serve one window
  through the port within 1e-4 max abs of the JAX forward, the bar of
  tests/test_torch_fcvsr.py (FFTs, the band split and the convs sum in
  other orders).
* The port's preprocessors write the JAX tools' ``data.mdb``,
  ``meta_info.txt`` and sub-images byte for byte.
* The FPS tool refuses to run without a card, by a named error.

Torch runs on one thread; JAX compiles FCVSR-S's init once, with XLA's
backend optimisation off, in a thread of its own from the first test
(the test that needs it comes last).
"""

import concurrent.futures
import hashlib
import importlib.util
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu_torch import cli
from fcvsr_tpu_torch.ops import fused_conv, fused_iac
from fcvsr_tpu_torch.tools import (export, publish_model, test_FCVSR_FPS,
                                   test_REDS_FCVSR_S, trained_proxy_rehearsal,
                                   train_FCVSR_S_REDS_LD37,
                                   validate_released_ckpt)
from fcvsr_tpu_torch.utils.config import preset
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
PINNED = sorted(f[:-3] for f in os.listdir(TOOLS)
                if re.match(r"(train|test)_.*\.py$", f))
S_RGB = "fcvsr_s_redsLD_QP37"
LR = (24, 32)
ATOL = 1e-4          # port against JAX (tests/test_torch_fcvsr.py)
EXPORT_RTOL = 1e-6   # loaded program against the eager forward, of max|out|
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def jax_reference():
    """(window, a future of (the JAX forward, the params)): FCVSR-S's
    ``model.init`` at a seed, jitted, with its forward's output
    (``init_with_output``), one compile.  XLA compiles without holding
    the GIL, so the compile runs in a thread of its own from the module's
    first test, beside the port's tests that come before its use."""
    jm = JFCVSRNet.small(in_channels=3)
    x = np.random.default_rng(7).uniform(0, 1, (1, 7, 3) + LR) \
        .astype(np.float32)
    key = jax.random.PRNGKey(3)

    def init():
        ref, params = jax.jit(jm.init_with_output).lower(
            key, jnp.asarray(x)).compile(FAST)(key, jnp.asarray(x))
        return np.asarray(ref), params

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield x, pool.submit(init)


def _jax_tool(name: str):
    """A JAX tool loaded by its path (only the preprocessors, whose output
    is compared)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", PINNED)
def test_pinned_scripts_pin_the_jax_presets(name):
    assert len(PINNED) == 29
    text = open(os.path.join(TOOLS, f"{name}.py")).read()
    pinned = re.findall(r'"--preset", "([^"]+)"', text)
    port = importlib.import_module(f"fcvsr_tpu_torch.tools.{name}")
    if name == "test_FCVSR_FPS":
        assert not pinned and not hasattr(port, "PRESET")
        jax_seqs = re.search(r"SEQS = (\[.*?\])\n", text, re.S).group(1)
        assert port.SEQS == eval(jax_seqs)
        return
    assert [port.PRESET] == pinned
    assert preset(port.PRESET).name


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """One RGB sequence of 8 frames, LR 24 x 32, GT 96 x 128."""
    root = str(tmp_path_factory.mktemp("clip"))
    trained_proxy_rehearsal.build_clips(root, np.random.default_rng(5), 1, 8,
                                        *LR)
    return os.path.join(root, "lr"), os.path.join(root, "gt")


@pytest.fixture(scope="module")
def trained(tmp_path_factory, clip):
    """(the train script's result, the published .pth) of a 2-step run."""
    work = str(tmp_path_factory.mktemp("work"))
    out = train_FCVSR_S_REDS_LD37.main(
        ["--device", "cpu", "--lr-root", clip[0], "--gt-root", clip[1],
         "--work-dir", work, "--total-iters", "2", "--batch-size", "1",
         "--lr-patch", "16"])
    pth = publish_model.main(["--ckpt", os.path.join(out["work_dir"], "ckpt"),
                              "--out", os.path.join(work, "fcvsr_s")])
    return out, pth


@pytest.fixture(scope="module")
def served(trained, clip, tmp_path_factory):
    """(the test script's summary of the published .pth, its SR folder)."""
    save = str(tmp_path_factory.mktemp("sr"))
    return test_REDS_FCVSR_S.main(
        ["--device", "cpu", "--torch-checkpoint", trained[1],
         "--lr-root", clip[0], "--gt-root", clip[1], "--save-dir", save,
         "--no-tof"]), save


def test_train_publish_and_serve_back(trained, served):
    out, pth = trained
    assert out["step"] == 2 and all(np.isfinite(out["losses"]))
    with open(pth, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    assert pth.endswith(f"fcvsr_s-{digest}.pth")
    model = cli.build_model(preset(S_RGB), 1, "cpu")
    model.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    summary, save = served
    assert summary["weights"] == {"torch_checkpoint": os.path.abspath(pth)}
    r = summary["per_sequence"]["seq_0"]
    assert r["frames"] == 8 and np.isfinite(r["psnr"])
    sr = np.asarray(Image.open(os.path.join(save, "seq_0", "00000000.png")))
    assert sr.shape == (4 * LR[0], 4 * LR[1], 3)


@pytest.mark.parametrize("ema", [False, True])
def test_publish_takes_the_ema_weights_when_asked(tmp_path, ema):
    """A port checkpoint's EMA replaces its parameters with ``--ema``; the
    buffers and the parameters without an EMA entry stay the model's."""
    model = {"w": torch.ones(2), "buf": torch.zeros(3)}
    ckpt = str(tmp_path / "iter_3.pt")
    torch.save({"model": model, "optimizer": {}, "ema": {"w": torch.full(
        (2,), 0.5)}, "step": 3}, ckpt)
    out = publish_model.main(["--ckpt", str(tmp_path), "--out",
                              str(tmp_path / "pub")] + (["--ema"] * ema))
    got = torch.load(out, weights_only=True)
    assert set(got) == {"w", "buf"} and torch.equal(got["buf"], model["buf"])
    assert torch.equal(got["w"], torch.full((2,), 0.5) if ema else model["w"])


@pytest.mark.parametrize("case,rc", [("missing", 2), ("served", 0),
                                     ("one_db_off", 1)])
def test_validate_released_ckpt_exit_codes(trained, clip, served, case, rc):
    pth = trained[1]
    args = ["--preset", S_RGB, "--lr-root", clip[0], "--gt-root", clip[1],
            "--device", "cpu", "--no-tof"]
    if case == "missing":
        assert validate_released_ckpt.main([pth + ".absent"] + args) == rc
        return
    expected = served[0]["average"]["psnr"] + \
        (1.0 if case == "one_db_off" else 0.0)
    assert validate_released_ckpt.main(
        [pth, "--expected-psnr", repr(expected)] + args) == rc


def test_rehearsal_passes_at_three_steps():
    assert trained_proxy_rehearsal.main(
        ["--steps", "3", "--seqs", "1", "--frames", "8", "--device",
         "cpu"]) == 0


def test_export_holds_the_ops_and_matches_eager(trained, tmp_path):
    pth = trained[1]
    x = np.random.default_rng(9).uniform(0, 1, (1, 7, 3) + LR) \
        .astype(np.float32)
    out = export.main(["--preset", S_RGB, "--height", str(LR[0]),
                       "--width", str(LR[1]), "--weights", pth,
                       "--out", str(tmp_path / "s.pt2"), "--device", "cpu"])
    # per window: 3 MGAA calls x 2 directions; 4 groups x 3 BlockRCBs x 3
    # levels x 2 pairs; 4 groups x 3 levels + conv_last0
    assert out["ops"] == {"iac_fused": 6, "conv3x3_pair": 72, "conv3x3": 13}
    program = torch.export.load(out["out"]).module()
    model = cli.build_model(preset(S_RGB), 0, "cpu")
    model.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    with torch.no_grad():
        ref = model(torch.from_numpy(x))
        got = program(torch.from_numpy(x))
    err = float((got - ref).abs().max())
    assert err <= EXPORT_RTOL * float(ref.abs().max()), err


def _op_cases():
    g = np.random.default_rng(11)

    def t(*shape, scale=1.0):
        return torch.from_numpy((g.standard_normal(shape) * scale)
                                .astype(np.float32))

    return {
        "conv3x3": (fused_conv.conv3x3_op,
                    (t(1, 5, 7, 8), t(3, 3, 8, 4, scale=0.2), t(4),
                     t(1, 5, 7, 4), True, 0.2)),
        "conv3x3_pair": (fused_conv.conv3x3_pair_op,
                         (t(2, 5, 6, 8), t(3, 3, 8, 16, scale=0.2), t(16),
                          t(3, 3, 16, 4, scale=0.2), None, 0.1)),
        "iac_fused": (fused_iac.iac_fused_op,
                      (t(1, 5, 7, 4), t(1, 5, 7, 24, scale=0.3),
                       t(2, 1, 5, 7, 2), 2, True)),
    }


@pytest.mark.parametrize("name", ["conv3x3", "conv3x3_pair", "iac_fused"])
def test_custom_ops_pass_opcheck(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


# each op's wrapper and the attribute of its module that holds the op
WRAPPERS = {"conv3x3": (fused_conv, "conv3x3", "conv3x3_op"),
            "conv3x3_pair": (fused_conv, "conv3x3_pair", "conv3x3_pair_op"),
            "iac_fused": (fused_iac, "iac_fused", "iac_fused_op")}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_eager_wrappers_do_not_dispatch_the_ops(name, monkeypatch):
    """An eager call that autograd does not record gives the op's result
    without calling the op (whose dispatch is host time a launch); the
    op is reached only while a trace runs."""
    mod, wrapper, attr = WRAPPERS[name]
    op, args = _op_cases()[name]
    ref = op(*args)

    def refuse(*a):
        raise AssertionError(f"eager {wrapper} called {attr}")

    monkeypatch.setattr(mod, attr, refuse)
    if name == "iac_fused":
        x, k, off, ac, act_last = args
        call = (x, k, off, ac, x.shape[-1], act_last)
    else:
        call = args
    with torch.no_grad():
        got = getattr(mod, wrapper)(*call)
    assert torch.equal(got, ref)


def _tree(root, files):
    """PNGs of random bytes: {relative path: (h, w)}."""
    g = np.random.default_rng(13)
    for rel, (h, w) in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        Image.fromarray(g.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, rel))


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, fs in os.walk(root) for f in fs}


# each dataset's toy tree and the tool's arguments (the data root passed
# as --data-root, or --data-path with --lmdb-path under it for REDS)
TREES = {
    "reds": ({**{f"train/{s:03d}/{i:08d}.png": (12, 16) for s in range(2)
                 for i in range(3)}, "val/001/00000000.png": (12, 16)},
             ["--compress-level", "1"]),
    "div2k": ({"DIV2K_train_HR/0001.png": (40, 52),
               "DIV2K_train_HR/0002.png": (36, 36),
               "DIV2K_train_LR_bicubic/X2/0001x2.png": (20, 26),
               "DIV2K_train_LR_bicubic/X2/0002x2.png": (18, 18)},
              ["--scales", "2", "--crop-size", "16", "--step", "8",
               "--thresh-size", "2", "--make-lmdb"]),
    "df2k_ost": ({"df2k_ost/GT/a.png": (30, 41),
                  "df2k_ost/GT/b.png": (20, 20)},
                 ["--crop-size", "12", "--step", "7", "--make-lmdb"]),
}


@pytest.mark.parametrize("name", list(TREES))
def test_preprocessors_write_the_jax_tools_bytes(name, tmp_path):
    files, extra = TREES[name]
    _tree(str(tmp_path / "src"), files)
    tool = f"preprocess_{name}_dataset"
    port = importlib.import_module(f"fcvsr_tpu_torch.tools.{tool}")
    outs = {}
    for side, mod in (("jax", _jax_tool(tool)), ("port", port)):
        root = str(tmp_path / side)
        shutil.copytree(str(tmp_path / "src"), root)
        if name == "reds":
            mod.main(["--data-path", os.path.join(root, "train"),
                      "--lmdb-path", os.path.join(root, "train.lmdb")]
                     + extra)
            mod.merge_train_val(os.path.join(root, "train"),
                                os.path.join(root, "val"))
        else:
            mod.main(["--data-root", root] + extra)
        outs[side] = _files(root)
    lmdbs = [k for k in outs["port"] if k.endswith("data.mdb")]
    assert lmdbs and any(k.endswith("meta_info.txt") for k in outs["port"])
    if name == "reds":
        assert "train/241/00000000.png" in outs["port"]
    assert outs["port"] == outs["jax"]


def test_fps_tool_refuses_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device"):
        test_FCVSR_FPS.main(["--model", "fcvsr_s", "--log", os.devnull])


@pytest.fixture(scope="module")
def jax_published(jax_reference, tmp_path_factory):
    """(window, the JAX forward, the published .pth of the JAX params)."""
    x, future = jax_reference
    ref, params = future.result()
    root = tmp_path_factory.mktemp("jax")
    raw = str(root / "jax_params.pth")
    torch.save(state_dict_from_jax(params), raw)
    return x, ref, publish_model.publish(raw, str(root / "fcvsr_s_jax"))


def test_published_jax_params_serve_as_jax(jax_published):
    x, ref, pth = jax_published
    model = cli.build_model(preset(S_RGB), 0, "cpu")
    model.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 3, 4 * LR[0], 4 * LR[1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
