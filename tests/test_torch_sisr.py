"""The single-image backbones, TOFlow, SPyNet's /32 wrapper, the bicubic
resize and the pixel losses of the port against the JAX package on the CPU,
with the registries and the converter.

EDSR (x4 and x3), SRCNN, MSRResNet, RRDBNet and RDN run at 12 x 12 with
2 blocks (RDN 2 x 2 layers), as tests/test_sisr_zoo.py runs the JAX
models; TOFlow at 7 x 64 x 64 with its SPyNet's weights drawn non-zero,
so the neighbours warp by real flows.  Weights: the JAX models' variables
are drawn with numpy on the shapes ``jax.eval_shape`` gives (kernels
U(+-1/sqrt(fan_in)), biases U(+-0.1)) and carried by
``utils.convert.state_dict_from_jax``; each port model loads them with
``strict=True``.  The JAX side runs jitted with XLA's backend optimisation
off; torch runs on one thread.

Bars: outputs within 1e-4 abs and 1e-5 of max |out|; ``resize_bicubic``
1e-5; the losses 1e-6 relative; MSRResNet's gradient (Charbonnier-mean)
relative to the JAX gradient's norms: the whole gradient, the median
tensor and each tensor within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import registry as jax_registry
from fcvsr_tpu.models import sisr as J
from fcvsr_tpu.models.basicvsr_pp import BasicVSRPlusPlus as JBasicVSRPP
from fcvsr_tpu.models.edvr import EDVRNet as JEDVRNet
from fcvsr_tpu.models.fcvsr import FCVSRNet as JFCVSRNet
from fcvsr_tpu.models.glean import GLEANStyleGANv2 as JGLEAN
from fcvsr_tpu.models.spynet import SpyNet as JSpyNet
from fcvsr_tpu.models.spynet import convert_spynet_state_dict
from fcvsr_tpu.models.spynet import spynet_flow as j_spynet_flow
from fcvsr_tpu.ops import resize as jax_resize
from fcvsr_tpu.train import losses as JL
from fcvsr_tpu_torch.models import (BACKBONES, EDSR, LOSSES, RDN, SRCNN,
                                    BasicVSRPlusPlus, EDVRNet, FCVSRNet,
                                    GLEANStyleGANv2, MSRResNet, RRDBNet,
                                    SpyNet, TOFlow, build, init_weights,
                                    spynet_flow)
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.ops.resize import resize_bicubic
from fcvsr_tpu_torch.train import losses as PL
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_cvcp_zoo import (FAST, assert_close, jax_variables,
                                 jit_apply, jit_run, uniform)

GRAD_RTOL = 1e-3

SISR = {
    "EDSR_x4": (J.EDSR, EDSR, dict(num_blocks=2)),
    "EDSR_x3": (J.EDSR, EDSR, dict(num_blocks=2, upscale_factor=3)),
    "SRCNN": (J.SRCNN, SRCNN, {}),
    "MSRResNet": (J.MSRResNet, MSRResNet, dict(num_blocks=2)),
    "RRDBNet": (J.RRDBNet, RRDBNet, dict(num_blocks=2)),
    "RDN": (J.RDN, RDN, dict(num_blocks=2, num_layers=2)),
}
NEW = ("EDSR", "SRCNN", "MSRResNet", "RRDBNet", "RDN", "TOFlow", "LIIFEDSR",
       "LIIFRDN", "TTSR", "TTSRNet")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(cls, variables, **kw):
    model = cls(**kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


def check(got, want, what):
    rel = assert_close(got, want, what)
    err = rel * max(float(np.abs(np.asarray(want)).max()), 1e-6)
    assert err <= 1e-4, (what, err)


# --------------------------------- losses ------------------------------------

LOSS_CASES = {
    "charbonnier_mean": (JL.charbonnier, PL.charbonnier, {}),
    "charbonnier_sum_w": (JL.charbonnier, PL.charbonnier,
                          dict(reduction="sum", loss_weight=0.5)),
    "charbonnier_none": (JL.charbonnier, PL.charbonnier,
                         dict(reduction="none", eps=1e-6)),
    "charbonnier_sum_eps": (JL.charbonnier_sum, PL.charbonnier_sum, {}),
    "l1_mean": (JL.l1_loss, PL.l1_loss, {}),
    "l1_sum": (JL.l1_loss, PL.l1_loss, dict(reduction="sum")),
    "mse_mean": (JL.mse_loss, PL.mse_loss, {}),
    "mse_sum": (JL.mse_loss, PL.mse_loss, dict(reduction="sum")),
    "total_variation": (JL.total_variation, PL.total_variation, None),
    "sobel": (JL.sobel_loss, PL.sobel_loss, {}),
}


@pytest.mark.parametrize("name", LOSS_CASES)
def test_losses_match_jax(name):
    jfn, pfn, kw = LOSS_CASES[name]
    pred = uniform(1, (2, 3, 9, 11))
    target = uniform(2, (2, 3, 9, 11))
    if kw is None:        # total variation takes one image
        want = np.asarray(jfn(jnp.asarray(pred)))
        got = pfn(torch.from_numpy(pred)).numpy()
    else:
        want = np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target), **kw))
        got = pfn(torch.from_numpy(pred), torch.from_numpy(target),
                  **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_charbonnier_refuses_unknown_reduction():
    with pytest.raises(ValueError, match="reduction"):
        PL.charbonnier(torch.zeros(2), torch.zeros(2), reduction="max")


def test_losses_registry_matches_jax():
    assert LOSSES.keys() == jax_registry.LOSSES.keys()
    assert len(LOSSES.keys()) == 11
    assert LOSSES.get("CharbonnierLoss") is PL.charbonnier
    pred, target = uniform(3, (1, 3, 5, 6)), uniform(4, (1, 3, 5, 6))
    got = build(LOSSES, dict(type="L1Loss", pred=torch.from_numpy(pred),
                             target=torch.from_numpy(target),
                             reduction="sum"))
    want = jax_registry.build(jax_registry.LOSSES, dict(
        type="L1Loss", pred=jnp.asarray(pred), target=jnp.asarray(target),
        reduction="sum"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(KeyError, match="NoSuchLoss"):
        LOSSES.get("NoSuchLoss")


# ------------------------------ bicubic resize -------------------------------


@pytest.mark.parametrize("size", [((12, 13), (48, 52)), ((96, 128), (24, 32)),
                                  ((1, 7), (4, 28)), ((37, 41), (9, 10)),
                                  ((40, 40), (10, 10)), ((5, 9), (5, 9))],
                         ids=lambda s: f"{s[0]}->{s[1]}")
def test_resize_bicubic_matches_jax(size):
    (h, w), (oh, ow) = size
    x = uniform(5, (2, h, w, 3))
    want = np.asarray(jax_resize.resize_bicubic(jnp.asarray(x), oh, ow))
    got = resize_bicubic(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == want.shape == (2, oh, ow, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ----------------------------- the SISR models -------------------------------


@pytest.mark.parametrize("name", SISR)
def test_sisr_models_match_jax(name):
    jcls, pcls, kw = SISR[name]
    x = uniform(6, (1, 3, 12, 12), 0.0, 1.0)
    jm = jcls(**kw)
    variables = jax_variables(jm, [x], 7)
    want = np.asarray(jit_apply(jm, variables, x))
    model = port(pcls, variables, **kw)
    before = launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert launch_counts() == before
    up = kw.get("upscale_factor", 4)
    assert got.shape == (1, 3, 12 * up, 12 * up)
    check(got, want, name)


def test_msrresnet_grads_match_jax():
    kw = dict(num_blocks=2)
    x = uniform(8, (1, 3, 12, 12), 0.0, 1.0)
    gt = uniform(9, (1, 3, 48, 48), 0.0, 1.0)
    jm = J.MSRResNet(**kw)
    variables = jax_variables(jm, [x], 10)

    def loss_fn(v, x, gt):
        return JL.charbonnier(jm.apply(v, x), gt)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn)).lower(
        variables, jnp.asarray(x), jnp.asarray(gt)).compile(FAST)(
        variables, jnp.asarray(x), jnp.asarray(gt))
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = port(MSRResNet, variables, **kw)
    loss = PL.charbonnier(model(torch.from_numpy(x)), torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    compare_grads(dict(model.named_parameters()), ref, {})


def compare_grads(params, ref, bars, default=GRAD_RTOL):
    """Each tensor's gradient relative to its JAX norm within its bar
    (``bars``: a name prefix -> bar, else ``default``), the whole gradient
    and the median tensor within ``default``."""
    got = {k: p.grad.numpy() for k, p in params.items()}
    ref = {k: v.numpy() for k, v in ref.items()}
    assert got.keys() == ref.keys()
    rel = {}
    for k, r in ref.items():
        assert np.any(r) and np.any(got[k]), f"{k}: no gradient"
        rel[k] = float(np.linalg.norm(got[k] - r) / np.linalg.norm(r))
    for k, v in rel.items():
        bar = next((b for p, b in bars.items() if k.startswith(p)), default)
        assert v <= bar, (k, v, bar)
    norm = np.sqrt(sum(np.sum(r ** 2) for r in ref.values()))
    whole = np.sqrt(sum(np.sum((got[k] - r) ** 2)
                        for k, r in ref.items())) / norm
    median = float(np.median(list(rel.values())))
    print("worst", max((v, k) for k, v in rel.items()), "whole", whole,
          "median", median)
    assert whole <= default and median <= default
    return rel


# ------------------------------ TOFlow, SPyNet -------------------------------


def test_toflow_matches_jax():
    x = uniform(11, (1, 7, 3, 64, 64), 0.0, 1.0)
    jm = J.TOFlow()
    variables = jax_variables(jm, [x], 12)
    want = np.asarray(jit_apply(jm, variables, x))
    model = port(TOFlow, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        center = torch.from_numpy(x[:, 3]).permute(0, 2, 3, 1)
        flow = model.spynet(center, torch.from_numpy(x[:, 0]).permute(
            0, 2, 3, 1))
    # the drawn SPyNet moves the neighbours by pixels, not by nothing
    print("flow |max|", float(flow.abs().max()))
    assert float(flow.abs().mean()) > 0.5
    check(got, want, "TOFlow")


def reference_spynet_state(seed: int) -> dict:
    """A SPyNet state_dict under the reference names, drawn with numpy."""
    rng = np.random.default_rng(seed)
    state = {}
    for lvl in range(6):
        for i, (cin, cout) in enumerate(((8, 32), (32, 64), (64, 32),
                                         (32, 16), (16, 2))):
            base = f"basic_module.{lvl}.basic_module.{2 * i}"
            bound = 1 / np.sqrt(cin * 49)
            state[f"{base}.weight"] = rng.uniform(
                -bound, bound, (cout, cin, 7, 7)).astype(np.float32)
            state[f"{base}.bias"] = rng.uniform(
                -0.1, 0.1, cout).astype(np.float32)
    return state


def test_spynet_flow_matches_jax_from_a_reference_state_dict():
    """``spynet_flow`` at 40 x 72 (resized to 64 x 96 and back): the same
    reference-named weights, loaded strictly by the port and through
    ``convert_spynet_state_dict`` by the JAX package, give the same
    flow."""
    state = reference_spynet_state(13)
    ref, supp = uniform(14, (1, 40, 72, 3), 0, 1), uniform(15, (1, 40, 72, 3),
                                                           0, 1)
    jm = JSpyNet()
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 64, 96,
                                                                    3)))
    params = convert_spynet_state_dict(state, template)
    want = np.asarray(jit_run(lambda p, a, b: j_spynet_flow(jm, p, a, b),
                              params, ref, supp))
    model = SpyNet()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    with torch.no_grad():
        got = spynet_flow(model.eval(), torch.from_numpy(ref),
                          torch.from_numpy(supp))
    assert got.shape == (1, 40, 72, 2)
    print("flow |max|", float(np.abs(want).max()))
    check(got, want, "spynet_flow")


# ------------------------- the converter, the registry -----------------------

OLDER = {
    "EDVRNet": (JEDVRNet, EDVRNet, dict(mid_channels=16, deform_groups=8,
                                        num_blocks_extraction=1,
                                        num_blocks_reconstruction=1),
                (1, 5, 3, 16, 16)),
    "BasicVSRPlusPlus": (JBasicVSRPP, BasicVSRPlusPlus,
                         dict(mid_channels=8, num_blocks=1),
                         (1, 3, 3, 64, 64)),
    "GLEANStyleGANv2": (JGLEAN, GLEANStyleGANv2,
                        dict(in_size=8, out_size=32, rrdb_channels=8,
                             num_rrdbs=1, style_channels=8,
                             channel_multiplier=1), (1, 3, 8, 8)),
    "FCVSR_S": (JFCVSRNet.small, FCVSRNet.small, dict(in_channels=1),
                (1, 7, 1, 16, 16)),
}


@pytest.mark.parametrize("name", OLDER)
def test_older_trees_keep_their_mapping(name):
    """EDVR and BasicVSR++ share names with the new trees (conv_first,
    conv_hr, spynet), GLEAN its RRDBs, FCVSR the fallback: each still maps
    onto its own model."""
    jcls, pcls, kw, shape = OLDER[name]
    variables = jax_variables(jcls(**kw), [np.zeros(shape, np.float32)], 16)
    port(pcls, variables, **kw)


def test_state_dict_from_jax_raises_on_an_unknown_sisr_param():
    tree = {"conv_first": {"Conv_0": {"kernel": np.zeros((3, 3, 3, 4))}},
            "conv_after_body": {"Conv_0": {"kernel": np.zeros((3, 3, 4, 4)),
                                           "scale_x": np.zeros(4)}}}
    with pytest.raises(KeyError, match="conv_after_body/Conv_0/scale_x"):
        state_dict_from_jax({"params": tree})


def jax_defaults_tree(name: str):
    """The shapes of a JAX model's variables at its defaults."""
    small = {"TOFlow": [(1, 7, 3, 64, 64)],
             "LIIFEDSR": [(1, 3, 4, 4), (1, 8, 2), (1, 8, 2)],
             "TTSR": [(1, 3, 4, 4), (1, 3, 16, 16)],
             "TTSRNet": [(1, 4, 4, 3), (1, 4, 4, 1)]}
    small["LIIFRDN"] = small["LIIFEDSR"]
    args = [jnp.zeros(s) for s in small.get(name, [(1, 3, 4, 4)])]
    if name == "TTSRNet":   # the textures, a list
        args.append([jnp.zeros((1, 4 * s, 4 * s, 256 // s))
                     for s in (1, 2, 4)])
    jm = jax_registry.build(jax_registry.BACKBONES, dict(type=name))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)


@pytest.mark.parametrize("name", NEW)
def test_registry_builds_each_new_model_at_the_jax_defaults(name):
    """The port's model at its defaults holds the JAX model's parameters,
    one for one (the converter maps the JAX tree, shapes and all), and
    ``init_weights`` seeds it deterministically."""
    shapes = jax_defaults_tree(name)
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros)
    model = build(BACKBONES, dict(type=name))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True)
    a = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
    b = init_weights(build(BACKBONES, dict(type=name)),
                     torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.abs().sum() > 0 for k, v in a.items()
               if k.endswith("weight"))
