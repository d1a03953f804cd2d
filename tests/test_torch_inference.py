"""The port's ETC mode and batched serving against the JAX package, on the
CPU: ``models.fcvsr_etc_forward`` (13 frames in, 7 SR frames and their
bilinear bases out), ``models.inference.sliding_window_sr`` and
``tiled_sr``, FCVSR-S at Y with the port's seeded weights (the JAX params
from the converter on an abstract init; the JAX calls jitted).

Bars: 1e-4 against JAX, the bar of tests/test_parity_torch.py; batching is
exact in the port, so batched windows against single forwards at 1e-5
(only a conv's batch split may sum in another order); tiles against the
whole frame within the JAX test's bars (tests/test_tiled_sr.py: mean 5e-4,
max 5e-3), since the band split is a global FFT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.models import fcvsr_etc_forward as j_etc
from fcvsr_tpu.models.inference import sliding_window_sr as j_sliding
from fcvsr_tpu.models.inference import tiled_sr as j_tiled
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch.data.pipelines import padded_window_indices
from fcvsr_tpu_torch.models import (FCVSRNet, fcvsr_etc_forward,
                                    init_weights, sliding_window_sr,
                                    tiled_sr)

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: under the suite's workers its thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    port = init_weights(FCVSRNet.small(in_channels=1),
                        torch.Generator().manual_seed(11)).eval()
    jm = JFCVSRNet.small(in_channels=1)
    x0 = jnp.zeros((1, 7, 1, 16, 16), jnp.float32)
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()},
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0))
    return port, jm, params


def _smooth(seed, t, h, w):
    """Band-limited frames (t, h, w, 1) in [0, 1]: a quarter-size uniform
    grid, bilinearly upsampled."""
    small = np.random.default_rng(seed).uniform(0, 1, (t, 1, h // 4, w // 4))
    x = F.interpolate(torch.from_numpy(small.astype(np.float32)),
                      size=(h, w), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1).numpy()


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def test_etc_forward_matches_jax_and_single_windows(models):
    port, jm, params = models
    clip = np.random.default_rng(12).uniform(0, 1, (1, 13, 1, 16, 16))
    clip = clip.astype(np.float32)
    with torch.no_grad():
        out, base = fcvsr_etc_forward(port, torch.from_numpy(clip))
    assert out.shape == base.shape == (1, 7, 1, 64, 64)
    ref_out, ref_base = jax.jit(lambda p, c: j_etc(jm, p, c))(
        params, jnp.asarray(clip))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(base.numpy(), np.asarray(ref_base), rtol=0,
                               atol=1e-6)
    single = _forward(port, clip[:, 3:10])
    np.testing.assert_allclose(out[:, 3].numpy(), single, rtol=0, atol=1e-5)


def test_sliding_window_sr_matches_single_forwards_and_jax(models):
    port, jm, params = models
    clip = _smooth(13, 5, 16, 16)
    got = sliding_window_sr(port, clip, batch_windows=3, device="cpu")
    assert got.shape == (5, 64, 64, 1)
    for i in (0, 2, 4):
        win = np.transpose(clip[padded_window_indices(i, 5, 7)],
                           (0, 3, 1, 2))[None]
        np.testing.assert_allclose(
            got[i], np.transpose(_forward(port, win)[0], (1, 2, 0)), rtol=0,
            atol=1e-5)
    ref = j_sliding(jm, params, clip, batch_windows=3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_tiled_sr_matches_jax_and_bounds_the_seams(models):
    port, jm, params = models
    win = np.transpose(_smooth(14, 7, 48, 48), (0, 3, 1, 2))[None]
    got = tiled_sr(port, win, tile=32, overlap=8, device="cpu")
    assert got.shape == (1, 1, 192, 192)
    ref = j_tiled(jm, params, win, tile=32, overlap=8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    d = np.abs(got - _forward(port, win))
    assert d.mean() < 5e-4 and d.max() < 5e-3, (d.mean(), d.max())
    with pytest.raises(ValueError, match="overlap"):
        tiled_sr(port, win, tile=16, overlap=8, device="cpu")
