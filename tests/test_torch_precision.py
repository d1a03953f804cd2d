"""The whole model in bf16 (``utils.precision``, ``sliding_window_sr(...,
bf16=True)``) against the JAX package's on the CPU: FCVSR-S at Y, seeded
port weights carried to JAX by ``export_npz`` and the JAX converter.

Bars: against the JAX package's bf16 output, the ``--fast`` bars (max
0.02, mean 2e-3; tests/test_inference_precision.py:74-75): both round the
same handoffs to bf16, but their bf16 sums run in other orders, so values
near a rounding boundary round apart (measured: max 5.2e-3, mean 7.4e-4);
against the port's own float32 output, the JAX package's bar for bf16
against float32 (mean 0.02; tests/test_inference_precision.py:37-44).
Torch runs on one thread; the JAX package's bf16 forward is jitted once,
in ``sliding_window_sr``, and serves both comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.models.inference import sliding_window_sr as j_sliding
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch.models import FCVSRNet, init_weights, sliding_window_sr
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.utils.checkpoint import export_npz
from fcvsr_tpu_torch.utils.precision import bf16_apply, cast_params

FAST_MAX, FAST_MEAN = 0.02, 2e-3
BF16_MEAN = 0.02


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    model = init_weights(FCVSRNet.small(in_channels=1),
                         torch.Generator().manual_seed(31)).eval()
    path = export_npz(model, str(tmp_path_factory.mktemp("w") / "w.npz"))
    jm = JFCVSRNet.small(in_channels=1)
    params = convert_torch_state_dict(
        dict(np.load(path)),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 7, 1, 16, 16), jnp.float32)))
    return model, jm, params


def _dev(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


def test_cast_params_casts_a_copy(small):
    model = small[0]
    m16 = cast_params(model)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.bfloat16 for t in m16.parameters())
    assert [t.dtype for t in m16.buffers()] == \
        [t.dtype for t in model.buffers()]      # MGAA's integer index
    assert m16.state_dict().keys() == model.state_dict().keys()


@pytest.fixture(scope="module")
def clip_case(small):
    """A 4-frame clip, its (4, 7, 1, 16, 16) windows, and the JAX package's
    ``sliding_window_sr(bf16=True)`` of it, 2 windows a call: its
    ``bf16_apply`` of each pair of windows (one jitted program)."""
    from fcvsr_tpu_torch.data.pipelines import padded_window_indices

    model, jm, params = small
    clip = np.random.default_rng(33).uniform(0, 1, (4, 16, 16, 1)) \
        .astype(np.float32)
    idx = np.stack([padded_window_indices(i, 4, 7) for i in range(4)])
    windows = np.ascontiguousarray(np.transpose(clip[idx], (0, 1, 4, 2, 3)))
    want = j_sliding(jm, params, clip, batch_windows=2, bf16=True)
    return clip, windows, want


def test_bf16_apply_matches_jax(small, clip_case):
    model = small[0]
    _, windows, want = clip_case
    x = torch.from_numpy(windows[:2])
    before = launch_counts()
    with torch.no_grad():
        got = bf16_apply(model, x)
        f32 = model(x)
    assert launch_counts() == before
    assert got.dtype == torch.float32 and got.shape == (2, 1, 64, 64)
    dmax, dmean = _dev(got.permute(0, 2, 3, 1), want[:2])
    assert dmax < FAST_MAX and dmean < FAST_MEAN, (dmax, dmean)
    dmax, dmean = _dev(got, f32)
    assert 0 < dmean < BF16_MEAN, (dmax, dmean)


def test_sliding_window_sr_bf16_matches_jax(small, clip_case):
    model = small[0]
    clip, _, want = clip_case
    got = sliding_window_sr(model, clip, batch_windows=2, device="cpu",
                            bf16=True)
    f32 = sliding_window_sr(model, clip, batch_windows=2, device="cpu")
    assert got.shape == want.shape == (4, 64, 64, 1)
    dmax, dmean = _dev(got, want)
    assert dmax < FAST_MAX and dmean < FAST_MEAN, (dmax, dmean)
    assert 0 < _dev(got, f32)[1] < BF16_MEAN
    # the caller's model stays float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_weights_reach_the_kernels_wrappers_cast_up():
    """A bf16 weight given to a kernel wrapper is cast up to float32 there:
    the same result as its float32 copy, bit for bit (the CPU runs the
    plain versions; tests/test_torch_kernels_gpu.py holds the kernels)."""
    from fcvsr_tpu_torch.ops import fused_conv, fused_iac

    rng = np.random.default_rng(34)

    def t(*shape, dt=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dt)

    x = t(1, 9, 11, 8, dt=torch.bfloat16)
    w1, w2 = (t(3, 3, 8, 8, dt=torch.bfloat16) for _ in range(2))
    b1 = t(8, dt=torch.bfloat16)
    assert torch.equal(fused_conv.conv3x3(x, w1, b1),
                       fused_conv.conv3x3(x, w1.float(), b1.float()))
    assert torch.equal(
        fused_conv.conv3x3_pair(x, w1, b1, w2, None),
        fused_conv.conv3x3_pair(x, w1.float(), b1.float(), w2.float(), None))
    feat, f0 = t(1, 9, 11, 8, dt=torch.bfloat16), t(1, 9, 11, 4,
                                                     dt=torch.bfloat16)
    flow = t(1, 9, 11, 2)
    wsel, bsel = t(4, 24, dt=torch.bfloat16), t(24, dt=torch.bfloat16)
    assert torch.equal(
        fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel, feat),
        fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel.float(),
                                    bsel.float(), feat))
