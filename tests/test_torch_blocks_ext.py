"""The block library (``models/blocks_ext.py``) in the port against the JAX
package on the CPU: the gated and FFT-attention blocks, the shift encoders,
the U-Net parts and composites, ``FourierUnit`` / ``SpaFreqBlock`` with
``train=True`` (outputs and updated running statistics), the converter
(``utils.convert.block_state_dict_from_jax``) and ``init_weights``.

Weights are drawn with numpy for every variable JAX's ``init`` gives
(``test_torch_cvcp_zoo.draw_variables``: ``beta`` and PReLU slopes
non-zero, norm weights U(0.5, 1.5), running statistics not 0 / 1) and
loaded into the port with ``strict=True``.  Bars: a block within 1e-5 of
its max |out|, a composite (``Encoder2``, ``TFRUNet``, ``CABEncoder`` then
``CABDecoder``) within 1e-4, in float32; torch runs on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import blocks_ext as J
from fcvsr_tpu_torch.models import init_weights
from fcvsr_tpu_torch.models import blocks_ext as P
from fcvsr_tpu_torch.models.basicvsr import MMPixelShufflePack
from fcvsr_tpu_torch.utils.convert import block_state_dict_from_jax
from test_torch_cvcp_zoo import FAST, assert_close, draw_variables, uniform

BLOCK_RTOL = 1e-5
COMPOSITE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(fn, args):
    return [tree(fn, a) for a in args] if isinstance(args, list) else fn(args)


def jax_run(jmod, variables, args, **kw):
    """``jmod.apply`` jitted (compiled with FAST) on numpy ``args`` (lists
    of arrays allowed)."""
    jargs = tree(jnp.asarray, list(args))
    fn = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))
    return fn.lower(variables, *jargs).compile(FAST)(variables, *jargs)


def draw(jmod, args, seed):
    jargs = tree(jnp.asarray, list(args))
    return draw_variables(jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *jargs), seed)


def port(pmod, variables):
    pmod.load_state_dict(block_state_dict_from_jax(variables), strict=True)
    return pmod


def port_run(pmod, args):
    with torch.no_grad():
        return pmod(*tree(torch.from_numpy, list(args)))


def outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(jmod, pmod, args, seed, what, rtol=BLOCK_RTOL):
    variables = draw(jmod, args, seed)
    want = outputs(jax_run(jmod, variables, args))
    got = outputs(port_run(port(pmod, variables).eval(), args))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"{what}[{i}]", rtol)
    return variables


# ------------------------------- the blocks ----------------------------------

def feats(seed, k, shape):
    return [uniform(seed + i, shape) for i in range(k)]


BLOCKS = {
    # name: (JAX module, port module, inputs)
    "simple_gate": (J.SimpleGate(), P.SimpleGate(), [uniform(1, (2, 5, 7, 8))]),
    "simple_gate_sigmoid": (J.SimpleGate(sigmoid=True),
                            P.SimpleGate(sigmoid=True),
                            [uniform(2, (2, 5, 7, 8))]),
    "cab": (J.CAB(16), P.CAB(16), [uniform(3, (2, 9, 11, 16))]),
    "cab1": (J.CAB1(16), P.CAB1(16), [uniform(4, (1, 9, 11, 16))]),
    "with_bias_layernorm": (J.WithBiasLayerNorm(12), P.WithBiasLayerNorm(12),
                            [uniform(5, (2, 5, 7, 12), -3, 3)]),
    "fsas": (J.FSAS(8), P.FSAS(8), [uniform(6, (2, 16, 24, 8))]),
    "fsas_freq": (J.FSAS_freq(8, add_channel=8), P.FSAS_freq(8, 8),
                  [uniform(7, (2, 16, 24, 16))]),
    "fft_spatial_odd": (J.FFTSpatialModule(8), P.FFTSpatialModule(8),
                        [uniform(8, (2, 9, 13, 8))]),
    "multi_freq_agg": (J.MultiFreqAgg(16), P.MultiFreqAgg(16),
                       [feats(9, 3, (2, 6, 7, 16))]),
    "residual_block_nobn": (J.ResidualBlockNoBN(16, res_scale=0.5),
                            P.ResidualBlockNoBN(16, res_scale=0.5),
                            [uniform(10, (1, 9, 11, 16))]),
    "residual_blocks_input_conv": (
        J.ResidualBlocksWithInputConv(16, num_blocks=3),
        P.ResidualBlocksWithInputConv(3, 16, num_blocks=3),
        [uniform(11, (1, 9, 11, 3))]),
    "sam": (J.SAM(16), P.SAM(16), [uniform(12, (1, 9, 11, 16)),
                                   uniform(13, (1, 9, 11, 3))]),
    "downsample_odd": (J.DownSample(16, 8), P.DownSample(16, 8),
                       [uniform(14, (1, 9, 11, 16))]),
    "upsample": (J.UpSample(16, 8), P.UpSample(16, 8),
                 [uniform(15, (1, 5, 6, 24))]),
    "skip_upsample": (J.SkipUpSample(16, 8), P.SkipUpSample(16, 8),
                      [uniform(16, (1, 5, 6, 24)),
                       uniform(17, (1, 10, 12, 16))]),
    "shallow_cell": (J.ShallowCell(16), P.ShallowCell(3, 16),
                     [uniform(18, (1, 9, 11, 3))]),
    "pixel_shuffle_pack": (J.PixelShufflePack(8, 2), P.PixelShufflePack(
        16, 8, 2, 3), [uniform(19, (1, 5, 6, 16))]),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_jax(block):
    """Each block on drawn variables, within 1e-5 of max |out|; CAB1's
    ``beta`` is drawn non-zero (zero, the block would be the identity),
    FFTSpatialModule runs at an odd width (its inverse's ``s``), DownSample
    at odd sizes (symmetric padding, not XLA's SAME), SAM's two
    outputs."""
    jmod, pmod, args = BLOCKS[block]
    variables = compare(jmod, pmod, args, 30, block)
    if block == "cab1":
        assert np.abs(variables["params"]["beta"]).min() > 0


@pytest.mark.parametrize("reverse", [False, True])
def test_channel_shift_matches_jax(reverse):
    """The cross-frame roll at B 3 (the middle frame takes both
    neighbours' channels) and the 24-direction shift, both directions;
    exact, as it only moves values."""
    x = uniform(40, (3, 12, 14, 48))
    want = np.asarray(J.channel_shift(jnp.asarray(x), 3, reverse=reverse))
    got = P.channel_shift(torch.from_numpy(x), 3, reverse=reverse).numpy()
    assert got.shape == (3, 12, 14, 72)
    np.testing.assert_array_equal(got, want)
    hw = uniform(41, (2, 10, 12, 40))
    np.testing.assert_array_equal(
        P.spatial_shift24(torch.from_numpy(hw), 5).numpy(),
        np.asarray(J.spatial_shift24(jnp.asarray(hw), 5)))


def test_pixel_shuffle_pack_is_the_zoo_module():
    assert P.PixelShufflePack is MMPixelShufflePack


# ------------------------------ the composites -------------------------------

@pytest.mark.parametrize("name", ["tfrunet", "encoder2",
                                  "encoder_shift_cab2", "encoder_shift_fsas"])
def test_composite_matches_jax(name):
    """TFRUNet (n_feat 16, scale_unetfeats 12) and Encoder2 (the FSAS shift
    encoder over 3 frames) at 16 x 24, and EncoderShiftBlock over 3 frames
    at n_feat 48 (``number`` 3, so both direction tables take channels),
    with CAB2 and with FSAS_freq, within 1e-4 of max |out|.  The shift
    encoder is 16 blocks deep: with FSAS_freq's fourth-order spectral
    products, the port and JAX each lie about 3e-5 of max |out| from the
    port run in float64, so it is held to the composites' bar.  Encoder2
    lands near 8e-5 of max |out| from JAX, which is its float32 floor:
    JAX's output lies 9e-5 from the float64 port run, the port's 1.1e-4."""
    jmod, pmod, args = {
        "tfrunet": (J.TFRUNet(16), P.TFRUNet(16),
                    [uniform(50, (1, 16, 24, 16))]),
        "encoder2": (J.Encoder2(16), P.Encoder2(24, 16),
                     [uniform(51, (3, 16, 24, 24))]),
        "encoder_shift_cab2": (J.EncoderShiftBlock(48),
                               P.EncoderShiftBlock(48),
                               [uniform(20, (3, 16, 16, 48))]),
        "encoder_shift_fsas": (J.EncoderShiftBlock(48, use_fsas=True),
                               P.EncoderShiftBlock(48, use_fsas=True),
                               [uniform(21, (3, 16, 16, 48))]),
    }[name]
    compare(jmod, pmod, args, 52, name, COMPOSITE_RTOL)


def test_cab_encoder_decoder_matches_jax():
    """CABEncoder's 3 levels into CABDecoder at 16 x 24, each level's
    output within 1e-4 of its max |out|."""
    x = uniform(60, (1, 16, 24, 16))
    jenc, jdec = J.CABEncoder(16), J.CABDecoder(16)
    venc = draw(jenc, [x], 61)
    jouts = jax_run(jenc, venc, [x])
    vdec = draw(jdec, [[np.asarray(o) for o in jouts]], 62)
    want = jax_run(jdec, vdec, [[np.asarray(o) for o in jouts]])
    enc = port(P.CABEncoder(16), venc).eval()
    dec = port(P.CABDecoder(16), vdec).eval()
    with torch.no_grad():
        got = dec(enc(torch.from_numpy(x)))
    assert [tuple(g.shape) for g in got] == [(1, 16, 24, 16), (1, 8, 12, 24),
                                            (1, 4, 6, 32)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"cab_unet[{i}]", COMPOSITE_RTOL)


# ------------------------- FourierUnit in training ---------------------------

@pytest.mark.parametrize("block", ["fourier_unit", "spafreq"])
def test_train_mode_matches_jax_batch_stats(block):
    """``train=True``: two steps on new inputs; each output and the updated
    running mean and variance (flax's update, the biased batch variance)
    against JAX's ``mutable=["batch_stats"]``, each within 1e-5 of its
    max."""
    jmod, pmod = {
        "fourier_unit": (J.FourierUnit(8, train=True),
                         P.FourierUnit(8, train=True)),
        "spafreq": (J.SpaFreqBlock(8, train=True),
                    P.SpaFreqBlock(8, train=True)),
    }[block]
    x0 = uniform(70, (2, 6, 10, 8))
    variables = draw(jmod, [x0], 71)
    pmod = port(pmod, variables).train()
    for step in range(2):
        x = uniform(72 + step, (2, 6, 10, 8), -2, 2)
        want, upd = jax_run(jmod, variables, [x], mutable=["batch_stats"])
        variables = dict(variables, batch_stats=upd["batch_stats"])
        got = port_run(pmod, [x])
        assert_close(got, want, f"{block} step {step}")
        want_sd = block_state_dict_from_jax(variables)
        sd = pmod.state_dict()
        for key in want_sd:
            if key.endswith(("running_mean", "running_var")):
                assert_close(sd[key], want_sd[key], f"{key} step {step}")
        bn = pmod.bn if block == "fourier_unit" else pmod.fu0.bn
        assert int(bn.num_batches_tracked) == step + 1
    # eval mode normalises on the running statistics, as train=False does
    jeval = type(jmod)(8)
    want = jax_run(jeval, variables, [x0])
    assert_close(port_run(pmod.eval(), [x0]), want, f"{block} eval")


# ------------------------------ the converter --------------------------------

def test_converter_refuses_unknown_names():
    """An unknown param leaf, an unknown batch statistic and an unknown
    collection raise KeyError; TFRUNet's and SpaFreqBlock's variables
    load strictly (``CA``'s down / up as ``conv_du.0`` / ``.2``,
    ``FourierUnit``'s statistics)."""
    x = uniform(80, (1, 16, 24, 16))
    variables = draw(J.TFRUNet(16), [x], 81)
    sd = block_state_dict_from_jax(variables)
    assert "enc1_0.CA.conv_du.0.weight" in sd
    P.TFRUNet(16).load_state_dict(sd, strict=True)
    params = variables["params"]
    bad = dict(variables, params=dict(params, enc1_0=dict(
        params["enc1_0"], gamma=np.zeros(1, np.float32))))
    with pytest.raises(KeyError, match="gamma"):
        block_state_dict_from_jax(bad)
    spa = draw(J.SpaFreqBlock(8), [uniform(82, (1, 6, 10, 8))], 83)
    P.SpaFreqBlock(8).load_state_dict(block_state_dict_from_jax(spa),
                                      strict=True)
    bad = dict(spa, batch_stats=dict(spa["batch_stats"], fu0=dict(
        spa["batch_stats"]["fu0"], bn=dict(spa["batch_stats"]["fu0"]["bn"],
                                           scale=np.zeros(1)))))
    with pytest.raises(KeyError, match="batch_stats"):
        block_state_dict_from_jax(bad)
    with pytest.raises(KeyError, match="cache"):
        block_state_dict_from_jax(dict(spa, cache={}))


def test_init_weights_starts_gates_at_identity():
    """``init_weights``: CAB1's and CAB2's ``beta`` zero (each gated block
    the identity), WithBiasLayerNorm's weight ones and bias zeros."""
    enc = init_weights(P.Encoder2(24, 16), torch.Generator().manual_seed(0))
    for i in range(8):
        assert not getattr(enc.decoder_level1, f"cab1_{i}").beta.any()
        norm = getattr(enc.decoder_level1, f"fsas{i}").norm
        assert torch.equal(norm.weight, torch.ones(32))
        assert not norm.bias.any()
    block = init_weights(P.EncoderShiftBlock(16),
                         torch.Generator().manual_seed(0))
    assert not block.cab2_0.beta.any()
    assert torch.equal(block.cab2_0.norm.weight, torch.ones(24))
