"""The port's FCVSRNet against the JAX FCVSRNet on the CPU, with the same
weights (converted by ``fcvsr_tpu_torch.utils.convert``).

Bar: 1e-4 max abs on the (B, C, 4H, 4W) output, the bar of
tests/test_parity_torch.py: the FFTs, the band split and a few hundred convs
sum in other orders in the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch.models import FCVSRNet
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax

ATOL = 1e-4


def _jax_reference(jm, x):
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return params, np.asarray(jm.apply(params, jnp.asarray(x)))


def _port(params, k_fused, **kw):
    model = FCVSRNet(k_fused=k_fused, **kw).eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("cin", [1, 3])
def test_small_matches_jax(cin):
    """FCVSR-S at Y and RGB widths, with materialised and fused kernel
    prediction."""
    x = np.random.default_rng(cin).uniform(0, 1, (1, 7, cin, 16, 16))
    x = x.astype(np.float32)
    params, ref = _jax_reference(JFCVSRNet.small(in_channels=cin), x)
    for k_fused in (False, True):
        model = _port(params, k_fused, in_channels=cin, ac_num=3, freq_inv=4,
                      sc_groups=4, up_ksize=1)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape == (1, cin, 64, 64)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_state_dict_round_trip_is_exact():
    """JAX params -> port state_dict -> JAX params returns them bit for bit;
    the dead DivEnh conv comes back as zeros."""
    jm = JFCVSRNet.small(in_channels=1)
    params0 = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 7, 1, 16, 16)))
    model = _port(params0, False, in_channels=1, ac_num=3, freq_inv=4,
                  sc_groups=4, up_ksize=1)
    sd = model.state_dict()
    assert not sd["MFFRblock.DivEnh_block.0.Conv.weight"].any()
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    params0)
    flat0 = jax.tree_util.tree_leaves_with_path(params0)
    flat1 = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat0) == len(flat1)
    for path, leaf in flat0:
        np.testing.assert_array_equal(np.asarray(flat1[path]),
                                      np.asarray(leaf))


def test_state_dict_from_jax_raises_on_unmapped_param():
    bogus = {"params": {"not_a_layer": {"Conv_0": {
        "kernel": np.zeros((1, 1, 1, 1), np.float32)}}}}
    with pytest.raises(KeyError, match="not_a_layer"):
        state_dict_from_jax(bogus)


def test_mgaa_sel_weights_follow_f1():
    """F.1's selected rows stay out of the state_dict; without autograd
    they are cached and made again when F.1's weights change, as a load
    does."""
    from fcvsr_tpu_torch.models.fcvsr import MGAA

    m = MGAA(4, ac_num=2)
    assert not any(k.startswith("sel") for k in m.state_dict())
    with torch.no_grad():  # under autograd they are made live on each call
        first = m.sel_weights()
        assert m.sel_weights()[0] is first[0]
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(0))
          for k, v in m.state_dict().items()}
    m.load_state_dict(sd)
    with torch.no_grad():
        wsel, wsel_t, bsel = m.sel_weights()
    assert wsel is not first[0]
    torch.testing.assert_close(wsel, sd["F.1.weight"][m.sel], rtol=0, atol=0)
    torch.testing.assert_close(wsel_t, wsel[:, :, 0, 0].t(), rtol=0, atol=0)
    torch.testing.assert_close(bsel, sd["F.1.bias"][m.sel], rtol=0, atol=0)
