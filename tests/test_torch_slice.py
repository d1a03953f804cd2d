"""The port's serving slice on the CPU: the full topology at reduced width
against JAX, fused against materialised kernel prediction, the CLI and the
video API, and the package's import hygiene."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch import cli
from fcvsr_tpu_torch.apis import pad_sequence, restoration_video_inference
from fcvsr_tpu_torch.models import FCVSRNet, init_weights
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = dict(n_feats=16, ac_num=2, freq_inv=2, sc_groups=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pool in each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_reduced_full_topology_matches_jax():
    """3x3 upsampling convs, 16 features, 2 IAC iterations, 2 bands, one
    SCNet group; bar 1e-4 as in tests/test_parity_torch.py.  The port's
    seeded weights go to the JAX model through ``convert_torch_state_dict``
    and come back through ``state_dict_from_jax``; the JAX model runs
    jitted with XLA's backend optimisation off (flax's ``init`` op by op
    took 20 s of this test)."""
    x = np.random.default_rng(0).uniform(0, 1, (1, 7, 1, 16, 24))
    x = x.astype(np.float32)
    jx = jnp.asarray(x)
    jm = JFCVSRNet(in_channels=1, **REDUCED)
    seeded = init_weights(FCVSRNet(in_channels=1, **REDUCED),
                          torch.Generator().manual_seed(0))
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in seeded.state_dict().items()},
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jx))
    ref = np.asarray(jax.jit(jm.apply).lower(params, jx).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(params, jx))
    model = FCVSRNet(in_channels=1, **REDUCED).eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_k_fused_matches_materialised():
    """Fused kernel prediction is the same function: 1e-5 (only the kernel
    matmul's summation order differs)."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, 7, 3, 16, 16)).astype(np.float32))
    outs = []
    for k_fused in (False, True):
        model = FCVSRNet(in_channels=3, k_fused=k_fused, **REDUCED)
        init_weights(model, torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            outs.append(model(x).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)


def test_init_weights_is_seeded():
    a, b = (init_weights(FCVSRNet.small(), torch.Generator().manual_seed(3))
            for _ in range(2))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def _write_clip(root, n, h, w, c):
    from PIL import Image

    rng = np.random.default_rng(4)
    for sub, scale in (("lr", 1), ("gt", 4)):
        d = os.path.join(root, sub, "seq")
        os.makedirs(d)
        for i in range(n):
            img = rng.integers(0, 256, (h * scale, w * scale, c), np.uint8)
            Image.fromarray(img[..., 0] if c == 1 else img).save(
                os.path.join(d, f"{i:08d}.png"))


def test_cli_pads_and_crops_odd_sizes(tmp_path):
    """30x46 LR frames pad to 32x48 and the SR output crops to 120x184;
    PSNR / SSIM are finite and no kernel launches on the CPU."""
    from PIL import Image

    _write_clip(str(tmp_path), 3, 30, 46, 1)
    before = launch_counts()
    summary = cli.main(["--preset", "fcvsr_s_cvcpLD_QP37", "--device", "cpu",
                        "--lr-root", str(tmp_path / "lr"),
                        "--gt-root", str(tmp_path / "gt"),
                        "--save-dir", str(tmp_path / "sr")])
    r = summary["per_sequence"]["seq"]
    assert r["frames"] == 3 and np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
    assert r["ms_per_frame"] is None  # no device time off CUDA
    sr = np.asarray(Image.open(tmp_path / "sr" / "seq" / "00000001.png"))
    assert sr.shape == (120, 184)
    assert launch_counts() == before


def test_pad_to_multiple():
    x = np.ones((2, 270, 479, 1), np.float32)
    y, hw = cli.pad_to_multiple(x)
    assert y.shape == (2, 272, 480, 1) and hw == (270, 479)
    assert y[:, 270:].sum() == 0 and y[:, :, 479:].sum() == 0


def test_fps_benchmark_refuses_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.fps_benchmark(None, device="cpu")


def test_pad_sequence_mirrors():
    frames = np.arange(5)[:, None].astype(np.float32)
    np.testing.assert_array_equal(pad_sequence(frames, 5)[:, 0],
                                  [4, 3, 0, 1, 2, 3, 4, 1, 0])


def test_video_inference_equals_per_window():
    model = init_weights(FCVSRNet.small(n_feats=16),
                         torch.Generator().manual_seed(5)).eval()
    frames = np.random.default_rng(6).uniform(0, 1, (4, 8, 8, 1))
    frames = frames.astype(np.float32)
    out = restoration_video_inference(model, frames, batch_windows=3)
    assert out.shape == (4, 32, 32, 1)
    from fcvsr_tpu.data.pipelines import padded_window_indices

    win = np.transpose(frames[padded_window_indices(2, 4, 7)], (0, 3, 1, 2))
    with torch.no_grad():
        single = model(torch.from_numpy(win[None].copy()))[0].numpy()
    np.testing.assert_allclose(out[2], np.transpose(single, (1, 2, 0)),
                               rtol=0, atol=1e-6)


def test_profiling_phases_on_cpu():
    """The profiling script's phases at a tiny size: every stage is timed,
    the stages and the rest add up to the forward, and the serving
    comparison leaves the model's k_fused as it was."""
    from fcvsr_tpu_torch import profiling

    model = init_weights(FCVSRNet.small(n_feats=16),
                         torch.Generator().manual_seed(7)).eval()
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (1, 7, 1, 8, 8)).astype(np.float32))
    st = profiling.stage_times(model, x, reps=2, warmup=1)
    assert set(st) == {"forward", "rest", "feat_extract", "MGAA.0", "MGAA.1",
                       "MGAA.2", "MFFR", "rconcat", "SCNet", "tail convs"}
    runs = profiling.serving_compare(model, x, reps=2, warmup=1)
    assert set(runs) == {"materialised", "k_fused"}
    assert model.MGAA.k_fused is False
    assert all(v > 0 for r in runs.values() for v in r.values())
    prof = profiling.device_profile(model, x, n=1)
    assert prof["wall_ms"] > 0 and prof["busy_ms"] is None


def test_import_leaves_jax_and_triton_out():
    code = ("import sys, fcvsr_tpu_torch, fcvsr_tpu_torch.ops, "
            "fcvsr_tpu_torch.models, fcvsr_tpu_torch.cli, "
            "fcvsr_tpu_torch.apis, fcvsr_tpu_torch.utils.convert, "
            "fcvsr_tpu_torch.profiling; "
            "bad = [m for m in ('jax', 'flax', 'triton') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No CUDA device here: chip_smoke.py exits non-zero with a clear error
    and prints no result line, in the repository and copied alone."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "FAIL" in proc.stderr
    assert '"ok"' not in proc.stdout
