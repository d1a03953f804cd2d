"""The port's zoo (EDVR, BasicVSR++, SPyNet) against the JAX models on the
CPU, with the same weights (``fcvsr_tpu_torch.utils.convert``).

Every offset conv (EDVR's ``conv_offset``, BasicVSR++'s ``conv_offset3``) is
zero-initialised, which would make each DCN a plain conv: the JAX param
trees get seeded values there, which put offsets several pixels long, some
out of the frame, through the deformable sampling.  Bar: 1e-4 max abs on the
output, the bar of tests/test_parity_torch.py.  Each JAX model is
initialised and applied once, under ``jax.jit``, in a module-scoped fixture
the tests share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.apis import restoration_video_inference as j_inference
from fcvsr_tpu.models.basicvsr_pp import BasicVSRPlusPlus as JBasicVSRPP
from fcvsr_tpu.models.basicvsr_pp import SecondOrderDeformableAlignment
from fcvsr_tpu.models.edvr import EDVRNet as JEDVRNet
from fcvsr_tpu.models.edvr import PCDAlignment
from fcvsr_tpu.models.spynet import SpyNet as JSpyNet
from fcvsr_tpu_torch.apis import restoration_video_inference
from fcvsr_tpu_torch.models import (BACKBONES, BasicVSRPlusPlus, EDVRNet,
                                    SpyNet, build, init_weights)
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax

ATOL = 1e-4


def _seed_offset_convs(params, name, seed, bias_scale):
    """A copy of ``params`` with every ``name`` conv (the last offset conv of
    a DCN) drawn from ``seed``: a small kernel and a bias of
    +-``bias_scale``."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if k == name:
                kern = np.asarray(v["Conv_0"]["kernel"])
                out[k] = {"Conv_0": {
                    "kernel": jnp.asarray(rng.standard_normal(kern.shape)
                                          * 0.3 / np.sqrt(kern[..., 0].size),
                                          jnp.float32),
                    "bias": jnp.asarray(rng.standard_normal(kern.shape[-1])
                                        * bias_scale, jnp.float32)}}
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return {"params": walk(params["params"])}


def _to_dict(tree):
    return {k: _to_dict(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def edvr_case():
    jm = JEDVRNet(mid_channels=16, deform_groups=8, num_blocks_extraction=1,
                  num_blocks_reconstruction=1)
    x = np.random.default_rng(0).uniform(0, 1, (1, 5, 3, 16, 16)) \
        .astype(np.float32)
    params = _to_dict(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    # offsets N(0, 3) px at the three levels of a 16x16 window: many of
    # them reach out of the 4x4, 8x8 and 16x16 frames
    params = _seed_offset_convs(params, "conv_offset", 1, 3.0)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    return params, x, ref


@pytest.fixture(scope="module")
def basicvsr_pp_case():
    jm = JBasicVSRPP(mid_channels=8, num_blocks=1)
    frames = np.random.default_rng(2).uniform(0, 1, (3, 64, 64, 3)) \
        .astype(np.float32)
    x = jnp.asarray(np.transpose(frames, (0, 3, 1, 2))[None])
    params = _to_dict(jax.jit(jm.init)(jax.random.PRNGKey(1), x))
    # residues 10 * tanh(N(0, 1.5)) around the random SPyNet's flows
    params = _seed_offset_convs(params, "conv_offset3", 3, 1.5)
    ref = j_inference(jm, params, frames, window_size=0)   # (T, 4H, 4W, 3)
    return params, frames, ref


def _port(cls, params, **kw):
    model = cls(**kw).eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def test_edvr_matches_jax(edvr_case):
    params, x, ref = edvr_case
    model = _port(EDVRNet, params, mid_channels=16, deform_groups=8,
                  num_blocks_extraction=1, num_blocks_reconstruction=1)
    offsets = []
    model.pcd_alignment.dcn_pack["l1"].conv_offset.register_forward_hook(
        lambda mod, inp, out: offsets.append(out[..., :8 * 18]))
    before = launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert launch_counts() == before
    assert got.shape == ref.shape == (1, 3, 64, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # the sampling was exercised: offsets of several pixels
    assert float(offsets[0].abs().max()) > 6.0


def _np_t(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a)


def test_pcd_alignment_matches_jax(edvr_case):
    """The alignment alone (its four DCNs one launch each on the card), on
    seeded pyramids of 5 neighbour frames against the repeated reference:
    the deformable sampling's share of the output is not damped by the
    model's tail."""
    params = edvr_case[0]
    model = _port(EDVRNet, params, mid_channels=16, deform_groups=8,
                  num_blocks_extraction=1, num_blocks_reconstruction=1)
    rng = np.random.default_rng(5)
    nbr = [_np_t(rng, 5, 16 // s, 16 // s, 16) for s in (1, 2, 4)]
    ref = [_np_t(rng, 1, 16 // s, 16 // s, 16) for s in (1, 2, 4)]
    ref = [(np.repeat(a, 5, 0), t.expand(5, -1, -1, -1)) for a, t in ref]
    want = jax.jit(PCDAlignment(16, 8).apply)(
        {"params": params["params"]["pcd_alignment"]},
        [jnp.asarray(a) for a, _ in nbr], [jnp.asarray(a) for a, _ in ref])
    with torch.no_grad():
        got = model.pcd_alignment([t for _, t in nbr], [t for _, t in ref])
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_second_order_alignment_matches_jax(basicvsr_pp_case):
    """BasicVSR++'s flow-guided DCN alone, with flows of several pixels:
    flow 1 steers the first 8 deform groups (feat_n1), flow 2 the last 8."""
    params = basicvsr_pp_case[0]
    model = _port(BasicVSRPlusPlus, params, mid_channels=8, num_blocks=1)
    rng = np.random.default_rng(6)
    ins = [_np_t(rng, 2, 13, 19, c, scale=s)
           for c, s in ((16, 1.0), (24, 1.0), (2, 4.0), (2, 4.0))]
    want = jax.jit(SecondOrderDeformableAlignment(8).apply)(
        {"params": params["params"]["forward_2"]["deform_align"]},
        *[jnp.asarray(a) for a, _ in ins])
    with torch.no_grad():
        got = model.deform_align["forward_2"](*[t for _, t in ins])
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_basicvsr_pp_matches_jax(basicvsr_pp_case):
    params, frames, ref = basicvsr_pp_case
    model = _port(BasicVSRPlusPlus, params, mid_channels=8, num_blocks=1)
    x = torch.from_numpy(np.ascontiguousarray(
        np.transpose(frames, (0, 3, 1, 2))[None]))
    with torch.no_grad():
        got = model(x)[0].permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (3, 256, 256, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_recurrent_inference_matches_jax(basicvsr_pp_case):
    """apis.restoration_video_inference(window_size=0): the whole clip in
    one forward, against the JAX API's recurrent path."""
    params, frames, ref = basicvsr_pp_case
    model = _port(BasicVSRPlusPlus, params, mid_channels=8, num_blocks=1)
    got = restoration_video_inference(model, frames, window_size=0)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_spynet_matches_jax(basicvsr_pp_case):
    """SPyNet alone at 1x64x64 (its coarsest level 2x2), with BasicVSR++'s
    random SPyNet weights."""
    params = basicvsr_pp_case[0]["params"]["spynet"]
    rng = np.random.default_rng(4)
    ref_img, supp = (rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
                     for _ in range(2))
    flow_ref = np.asarray(jax.jit(JSpyNet().apply)(
        {"params": params}, jnp.asarray(ref_img), jnp.asarray(supp)))
    model = _port(SpyNet, params)
    with torch.no_grad():
        flow = model(torch.from_numpy(ref_img), torch.from_numpy(supp))
    assert flow.shape == (1, 64, 64, 2)
    tol = ATOL * max(1.0, float(np.abs(flow_ref).max()))
    np.testing.assert_allclose(flow.numpy(), flow_ref, rtol=0, atol=tol)


def test_state_dict_from_jax_raises_on_unknown_param(edvr_case,
                                                     basicvsr_pp_case):
    for params in (edvr_case[0], basicvsr_pp_case[0]):
        tree = dict(params["params"])
        tree["conv_hr"] = dict(tree["conv_hr"], Conv_1={"kernel": np.zeros(1)})
        with pytest.raises(KeyError, match="conv_hr/Conv_1"):
            state_dict_from_jax({"params": tree})


def test_registry_builds_the_ports_models():
    assert BACKBONES.keys() == ["BasicVSRNet", "BasicVSRPlusPlus", "EDVRNet",
                                "FCVSRNet", "FCVSR_SNet", "IconVSR",
                                "SpyNet", "TDANNet"]
    model = build(BACKBONES, dict(type="EDVRNet", mid_channels=16,
                                  num_blocks_extraction=1,
                                  num_blocks_reconstruction=1))
    assert isinstance(model, EDVRNet)
    with pytest.raises(KeyError, match="FTVSRNet"):
        build(BACKBONES, dict(type="FTVSRNet"))


def test_init_weights_zeroes_the_offset_convs():
    """Seeded weights, as the reference initialises them: each DCN's last
    offset conv at zero, so it starts as a plain conv with mask 0.5."""
    model = init_weights(BasicVSRPlusPlus(mid_channels=8, num_blocks=1),
                         torch.Generator().manual_seed(0))
    for align in model.deform_align.values():
        assert not align.conv_offset[-1].weight.any()
        assert align.weight.abs().max() > 0
    again = init_weights(BasicVSRPlusPlus(mid_channels=8, num_blocks=1),
                         torch.Generator().manual_seed(0))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
