"""The rest of the DCN zoo in the port (BasicVSR, IconVSR, TDAN) against
the JAX models on the CPU, at the reduced sizes of tests/test_zoo_models.py,
with weights carried by ``utils.convert.state_dict_from_jax``.

Each JAX model is traced once, in a module-scoped fixture: one jitted
``value_and_grad`` of a Charbonnier-mean loss of its SR output, with the
output beside it, compiled with XLA's backend optimisation off.  Its parameters are drawn with numpy from the shapes
``jax.eval_shape`` gives (kernels U(+-1/sqrt(fan_in)), biases U(+-0.1)),
and every DCN's offset conv (zero-initialised, which would leave it a plain
conv) is seeded non-zero as tests/test_torch_zoo.py seeds it: offsets of
several pixels, some out of the frame.

Bars: the SR output within 1e-4 (TDAN's aligned frames too); gradients
relative to the JAX gradient's norm, the whole gradient and the median
tensor within 1e-3, each tensor within 1e-3 but for those upstream of a
sampling position, SPyNet's and the offset convs', which are rough at f32
noise as BasicVSR++'s are (a flow or offset within f32 noise of a pixel
boundary moves its sample's floor in one framework and not in the
other): those within 5e-2.  Measured: IconVSR's worst such tensor 2.1e-3
(PCD's offset_conv1 at level 1), its median 1.9e-4; BasicVSR's worst 9.9e-4
(SPyNet), TDAN's 1.7e-5 at most.  ``fix_iter`` freezes exactly the
``spynet`` and ``edvr`` tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.basicvsr import BasicVSRNet as JBasicVSRNet
from fcvsr_tpu.models.iconvsr import IconVSR as JIconVSR
from fcvsr_tpu.models.iconvsr import TDANNet as JTDANNet
from fcvsr_tpu_torch.models import (BACKBONES, BasicVSRNet, IconVSR, TDANNet,
                                    VideoRestorer, build, init_weights)
from fcvsr_tpu_torch.models.basicvsr import ModulatedDeformConv2d
from fcvsr_tpu_torch.models.iconvsr import (AugmentedDeformConvPack,
                                            DeformConvPack)
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.train.losses import LOSSES
from fcvsr_tpu_torch.train.trainer import TrainState
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_zoo import _seed_offset_convs, _to_dict

ATOL = 1e-4
GRAD_RTOL = 1e-3
FLIP_RTOL = 5e-2
# XLA's backend optimisation off: the one-off compiles of the JAX gradients
# take a third less time, their runs stay short at these sizes
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}

CASES = {
    "basicvsr": (JBasicVSRNet, BasicVSRNet,
                 dict(mid_channels=8, num_blocks=1), (1, 3, 3, 64, 64)),
    "iconvsr": (JIconVSR, IconVSR,
                dict(mid_channels=8, num_blocks=1, keyframe_stride=3),
                (1, 6, 3, 64, 64)),
    "tdan": (JTDANNet, TDANNet,
             dict(mid_channels=8, num_blocks_before_align=1,
                  num_blocks_after_align=1), (1, 5, 3, 16, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "bias":
            return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.uniform(-1, 1, s.shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    return _to_dict(jax.tree_util.tree_map_with_path(leaf, shapes))


def _jax_case(name):
    jcls, _, kw, shape = CASES[name]
    jm = jcls(**kw)
    rng = np.random.default_rng(len(name))
    x = rng.uniform(0, 1, shape).astype(np.float32)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  jnp.asarray(x)), 1)
    if name != "basicvsr":
        params = _seed_offset_convs(params, "conv_offset", 2, 3.0)
    outs = jax.eval_shape(jm.apply, params, jnp.asarray(x))
    sr_shape = (outs[0] if isinstance(outs, tuple) else outs).shape
    gt = rng.uniform(0, 1, sr_shape).astype(np.float32)

    def loss(p):
        y = jm.apply(p, jnp.asarray(x))
        sr = y[0] if isinstance(y, tuple) else y
        return jnp.mean(jnp.sqrt((sr - gt) ** 2 + 1e-12)), y

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (val, y), grads = fn.lower(params).compile(FAST)(params)
    y = tuple(np.asarray(v) for v in (y if isinstance(y, tuple) else (y,)))
    return dict(params=params, x=x, gt=gt, loss=float(val), outs=y,
                grads={k: v.numpy()
                       for k, v in state_dict_from_jax(grads).items()})


@pytest.fixture(scope="module")
def cases():
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _jax_case(name)
        return memo[name]
    return get


def _port(name, params):
    model = CASES[name][1](**CASES[name][2])
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _sr(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_and_grads_match_jax(name, cases):
    case = cases(name)
    model = _port(name, case["params"])
    before = launch_counts()
    out = model(torch.from_numpy(case["x"]))
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(case["outs"])
    for got, want in zip(outs, case["outs"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=ATOL)
    loss = LOSSES["charbonnier_mean"](_sr(out), torch.from_numpy(case["gt"]))
    loss.backward()
    assert launch_counts() == before
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    ref = case["grads"]
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == ref.keys()
    rel = {}
    for k, r in ref.items():
        assert np.any(r) and np.any(got[k]), f"{k}: no gradient"
        rel[k] = np.linalg.norm(got[k] - r) / np.linalg.norm(r)
        bar = FLIP_RTOL if k.startswith("spynet.") or "offset" in k \
            else GRAD_RTOL
        assert rel[k] <= bar, f"{k}: relative error {rel[k]}"
    whole = np.sqrt(sum(np.sum((got[k] - r) ** 2) for k, r in ref.items())
                    / sum(np.sum(r ** 2) for r in ref.values()))
    assert whole <= GRAD_RTOL and np.median(list(rel.values())) <= GRAD_RTOL


def test_tdan_runs_dcnv1(cases):
    """TDAN's four DCNs are DCNv1: no mask, no bias, 8 deform groups; its
    centre aligned frame is the input's own."""
    case = cases("tdan")
    model = _port("tdan", case["params"])
    packs = [m for m in model.modules() if isinstance(m, DeformConvPack)]
    assert len(packs) == 4 and isinstance(model.align_1,
                                          AugmentedDeformConvPack)
    assert all(p.bias is None and p.deform_groups == 8 for p in packs)
    with torch.no_grad():
        _, aligned = model(torch.from_numpy(case["x"]))
    np.testing.assert_array_equal(aligned[:, 2].numpy(), case["x"][:, 2])


@pytest.mark.parametrize("name", ["basicvsr", "iconvsr"])
def test_fix_iter_freezes_spynet_and_edvr(name):
    """Two restorer steps with fix_iter=1: the first moves every tensor but
    SPyNet's (and IconVSR's refill extractor's), the second all of them.
    The DCNs' last offset convs are drawn non-zero: at their zero init the
    convs before them would get no gradient."""
    model = init_weights(CASES[name][1](**CASES[name][2]),
                         torch.Generator().manual_seed(3))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv2d):
                mod.conv_offset.weight.normal_(0, 0.01)
    restorer = VideoRestorer(model, fix_iter=1)
    step = restorer.make_train_step(TrainState(model, lambda s: 1e-3,
                                               (0.9, 0.999)))
    rng = np.random.default_rng(4)
    b, t, c, h, w = CASES[name][3]
    lq = torch.from_numpy(rng.uniform(0, 1, (b, t, c, h, w))
                          .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (b, t, c, 4 * h, 4 * w))
                          .astype(np.float32))
    frozen = {k for k, _ in model.named_parameters()
              if "spynet" in k or "edvr" in k}
    assert frozen and any(k.startswith("spynet.") for k in frozen)
    assert (name == "iconvsr") == any(k.startswith("edvr.") for k in frozen)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    step(lq, gt)
    still = {k for k, p in model.named_parameters()
             if torch.equal(p, start[k])}
    assert still == frozen
    step(lq, gt)
    assert not any(torch.equal(p, start[k])
                   for k, p in model.named_parameters())


def test_registry_and_converter_take_the_new_models(cases):
    for name, (_, cls, kw, _) in CASES.items():
        assert type(build(BACKBONES, dict(type=cls.__name__, **kw))) is cls
    tree = dict(cases("tdan")["params"]["params"])
    tree["to_rgb"] = dict(tree["to_rgb"], Conv_1={"kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="to_rgb/Conv_1"):
        state_dict_from_jax({"params": tree})
