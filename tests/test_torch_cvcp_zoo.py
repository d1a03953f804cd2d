"""The CVCP compressed-VSR family in the port against the JAX package on
the CPU: ``LayerNorm2d``, ``CAB2`` (``beta`` non-zero), ``TFDC`` at an odd
width, ``SpaFreqBlock`` (non-trivial running statistics), FCVSR-TFDC whole
and through ``sliding_window_sr``, SIDECVSR whole (both outputs, once from
a ``SideInfoClipCache`` sample), RAFT and ``raft_flow``, the converter and
the registry.

Weights: the JAX models' variables are drawn with numpy from the shapes
``jax.eval_shape`` gives (kernels U(+-1/sqrt(fan_in)), biases U(+-0.1),
norm scales and weights U(0.5, 1.5), ``beta`` and PReLU slopes non-zero,
running means U(+-0.2) and variances U(0.5, 1.5)), so no weight the JAX
package starts at zero or one hides a mapping fault;
``utils.convert.state_dict_from_jax`` carries the whole variables dict and
each port module loads it with ``strict=True``.  The JAX side runs jitted
with XLA's backend optimisation off (compiles take less time); torch runs
on one thread.

Bars: every output within 1e-5 of its max |value| in float32 (RAFT's flow
and ``raft_flow`` too, over 3 updates).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.blocks import LayerNorm2d as JLayerNorm2d
from fcvsr_tpu.models.blocks_ext import CAB2 as JCAB2
from fcvsr_tpu.models.blocks_ext import TFDC as JTFDC
from fcvsr_tpu.models.blocks_ext import SpaFreqBlock as JSpaFreqBlock
from fcvsr_tpu.models.fcvsr_tfdc import FCVSRTFDCNet as JFCVSRTFDCNet
from fcvsr_tpu.models.inference import \
    sliding_window_sr as j_sliding_window_sr
from fcvsr_tpu.models.raft import RAFT as JRAFT
from fcvsr_tpu.models.raft import raft_flow as j_raft_flow
from fcvsr_tpu.models.sidecvsr import SIDECVSR as JSIDECVSR
from fcvsr_tpu_torch.models import (BACKBONES, RAFT, SIDECVSR, FCVSRNet,
                                    FCVSRTFDCNet, build, init_weights,
                                    raft_flow, sliding_window_sr)
from fcvsr_tpu_torch.models.blocks import LayerNorm2d
from fcvsr_tpu_torch.models.blocks_ext import CAB2, TFDC, SpaFreqBlock
from fcvsr_tpu_torch.utils.convert import (_cvcp_state_dict,
                                           state_dict_from_jax)

RTOL = 1e-5
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_dict(tree):
    return {k: to_dict(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


def draw_variables(shapes, seed: int) -> dict:
    """numpy draws for every leaf of a flax variables dict's shapes."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = str(getattr(path[-1], "key", path[-1])), s.shape
        if name in ("scale", "weight", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "alpha"):
            v = rng.uniform(-0.1, 0.1, shape) + (name == "alpha") * 0.2
        elif name == "mean":
            v = rng.uniform(-0.2, 0.2, shape)
        elif name == "beta":
            v = rng.uniform(-1, 1, shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return to_dict(jax.tree_util.tree_map_with_path(leaf, shapes))


def jax_variables(module, args, seed: int) -> dict:
    return draw_variables(jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a),
        *[jnp.asarray(a) for a in args]), seed)


def jit_run(fn, variables, *args):
    """``fn(variables, *args)`` jitted, compiled with FAST."""
    args = tuple(jnp.asarray(a) for a in args)
    return jax.jit(fn).lower(variables, *args).compile(FAST)(variables,
                                                             *args)


def jit_apply(module, variables, *args):
    return jit_run(module.apply, variables, *args)


def port(model, variables, block=False):
    """The port's model on the JAX variables; a block alone has no family
    name to be told by, so it maps by the family's rules directly."""
    sd = _cvcp_state_dict(variables, variables["params"], re.compile(".+")) \
        if block else state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def assert_close(got, want, what="", rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    print(f"{what}: max abs {err:.3e}, {err / scale:.3e} of max |out|")
    assert err <= rtol * scale, (what, err, scale)
    return err / scale


def uniform(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def run_both(jmod, pmod, args, seed):
    """A JAX block jitted and the port's on the same drawn variables."""
    variables = jax_variables(jmod, args, seed)
    want = jit_apply(jmod, variables, *args)
    pmod = port(pmod, variables, block=True)
    with torch.no_grad():
        got = pmod(*[torch.from_numpy(a) for a in args])
    return got, want, variables, pmod


# ------------------------------- the blocks ----------------------------------

@pytest.mark.parametrize("block", ["layernorm2d", "cab2", "tfdc_odd",
                                   "spafreq"])
def test_blocks_match_jax(block):
    """Each block on drawn variables; CAB2's ``beta`` is non-zero (zero, it
    would be the identity), TFDC runs at an odd width (its inverse
    transform's ``s``), SpaFreqBlock's running statistics are not 0 / 1."""
    jmod, pmod, shape = {
        "layernorm2d": (JLayerNorm2d(12), LayerNorm2d(12), (2, 5, 7, 12)),
        "cab2": (JCAB2(8, add_channel=8), CAB2(8, 8), (1, 9, 11, 16)),
        "tfdc_odd": (JTFDC(16), TFDC(16), (1, 8, 9, 48)),
        "spafreq": (JSpaFreqBlock(16), SpaFreqBlock(16), (1, 8, 10, 16)),
    }[block]
    x = uniform(1, shape)
    got, want, variables, _ = run_both(jmod, pmod, (x,), 2)
    if block == "cab2":
        assert np.abs(variables["params"]["beta"]).min() > 0
        assert np.abs(np.asarray(want) - x[..., :8]).max() > 1e-2
    if block == "spafreq":
        stats = variables["batch_stats"]["fu0"]["bn"]
        assert np.abs(stats["mean"]).max() > 0.1
    assert_close(got, want, block)


# ------------------------------- FCVSR-TFDC ----------------------------------

TFDC_KW = dict(n_feats=16, sc_groups=1)


@pytest.fixture(scope="module")
def tfdc_pair():
    jmod = JFCVSRTFDCNet(**TFDC_KW)
    x = uniform(3, (1, 7, 1, 16, 24), 0, 1)
    variables = jax_variables(jmod, (x,), 4)
    return jmod, variables, port(FCVSRTFDCNet(**TFDC_KW), variables), x


def test_fcvsr_tfdc_matches_jax(tfdc_pair):
    jmod, variables, model, x = tfdc_pair
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 1, 64, 96)
    assert_close(got, jit_apply(jmod, variables, x), "FCVSR-TFDC")


def test_fcvsr_tfdc_sliding_window_matches_jax(tfdc_pair):
    """9 frames, 4 windows a forward (the last batch filled)."""
    jmod, variables, model, _ = tfdc_pair
    clip = uniform(5, (9, 16, 24, 1), 0, 1)
    want = j_sliding_window_sr(jmod, variables, clip, batch_windows=4)
    got = sliding_window_sr(model, clip, batch_windows=4, device="cpu")
    assert got.shape == (9, 64, 96, 1)
    assert_close(got, want, "sliding_window_sr")


# -------------------------------- SIDECVSR -----------------------------------

SIDE_KW = dict(nf=16, sc_groups=1)


def side_inputs(seed, h=16, w=16):
    """x, mvs (a few pixels, which the STN's x32 takes to its clamp), and
    the partition map, residue and unfiltered prediction."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, 7, 1, h, w))
    mvs = rng.uniform(-3, 3, (1, 7, 2, h, w)) * rng.uniform(0, 1, (1, 7, 2,
                                                                   1, 1))
    pms, rms, ufs = (rng.uniform(0, 1, (1, 7, 1, h, w)) for _ in range(3))
    return tuple(np.asarray(a, np.float32) for a in (x, mvs, pms, rms, ufs))


@pytest.fixture(scope="module")
def side_pair():
    jmod = JSIDECVSR(**SIDE_KW)
    args = side_inputs(6)
    variables = jax_variables(jmod, args, 7)
    compiled = jax.jit(jmod.apply).lower(
        variables, *[jnp.asarray(a) for a in args]).compile(FAST)
    return compiled, variables, port(SIDECVSR(**SIDE_KW), variables), args


def _side_check(side_pair, args, what):
    compiled, variables, model, _ = side_pair
    want_sr, want_l1 = compiled(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        sr, l1 = model(*[torch.from_numpy(a) for a in args])
    assert sr.shape == (1, 1, 64, 64) and l1.shape == (7, 16, 16, 16)
    assert_close(sr, want_sr, f"{what} SR")
    assert_close(l1, want_l1, f"{what} L1")


def test_sidecvsr_matches_jax(side_pair):
    _side_check(side_pair, side_pair[3], "SIDECVSR")


def test_sidecvsr_on_a_side_info_sample_matches_jax(side_pair, tmp_path):
    """A ``SideInfoClipCache`` sample (written as tests/test_sidecvsr.py
    writes one, 16 x 24 frames): the port's dataset draws what the JAX
    package's draws, and both models restore it alike."""
    from PIL import Image

    from fcvsr_tpu.data.datasets import SideInfoClipCache as JSideInfo
    from fcvsr_tpu_torch.data import SideInfoClipCache

    rng = np.random.default_rng(0)
    for d in ["lr/seq0", "hr/seq0", "side/seq0/MV_l0", "side/seq0/Residue",
              "side/seq0/Partition_Map", "side/seq0/pred_unfiltered"]:
        (tmp_path / d).mkdir(parents=True)
    n, h, w = 9, 16, 24
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(
            tmp_path / "lr/seq0" / f"{i:05d}.png")
        Image.fromarray(rng.integers(0, 255, (h * 4, w * 4),
                                     dtype=np.uint8)).save(
            tmp_path / "hr/seq0" / f"{i:05d}.png")
        np.save(tmp_path / "side/seq0/MV_l0" / f"{i:05d}_mvl0.npy",
                rng.integers(-4, 4, (h, w, 2)).astype(np.int16))
        np.save(tmp_path / "side/seq0/Residue" / f"{i:05d}_res.npy",
                rng.integers(-30, 30, (h, w)).astype(np.int16))
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(
            tmp_path / "side/seq0/Partition_Map" / f"{i:05d}_M_mask.png")
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(
            tmp_path / "side/seq0/pred_unfiltered" / f"{i:05d}_unflt.png")
    roots = [str(tmp_path / d) for d in ("lr", "hr", "side")]
    got = SideInfoClipCache(*roots, ["seq0"]).sample(
        np.random.default_rng(1), lr_patch=16)
    want = JSideInfo(*roots, ["seq0"]).sample(np.random.default_rng(1),
                                              lr_patch=16)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)

    def nchw(a):   # (T, p, p, C) -> (1, T, C, p, p)
        return np.ascontiguousarray(
            np.transpose(a, (0, 3, 1, 2))[None], np.float32)

    args = (nchw(got["lrs"]), nchw(got["mvs"]), nchw(got["partition"]),
            nchw(got["residue"]), nchw(got["unfiltered"]))
    _side_check(side_pair, args, "SIDECVSR on a sample")


# ---------------------------------- RAFT -------------------------------------

@pytest.fixture(scope="module")
def raft_pair():
    jmod = JRAFT(iters=3)
    z = np.zeros((1, 64, 96, 3), np.float32)
    variables = jax_variables(jmod, (z, z), 8)
    return jmod, variables, port(RAFT(iters=3), variables)


def smooth_pair(seed, h, w, scale=255.0):
    """Two images, the second the first moved by about (2.0, 1.2) px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = [sum(np.sin(a * (xx - dx) + b * (yy - dy) + c)
               for a, b, c in rng.uniform(0.05, 0.4, (6, 3)))
           for dx, dy in ((0, 0), (2.0, 1.2))]
    out = [np.repeat((v - v.min()) / (v.max() - v.min()), 3).reshape(h, w, 3)
           [None] * scale for v in img]
    return tuple(np.asarray(v, np.float32) for v in out)


def test_raft_matches_jax(raft_pair):
    """3 updates at 1 x 64 x 96; the same parameter count as JAX's."""
    jmod, variables, model = raft_pair
    n_jax = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(
        variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    a, b = smooth_pair(9, 64, 96)
    want = jit_apply(jmod, variables, a, b)
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (1, 64, 96, 2)
    assert_close(got, want, "RAFT")


def test_raft_flow_matches_jax(raft_pair):
    """The /8 wrapper at 50 x 70: resized to 56 x 72 and back."""
    jmod, variables, model = raft_pair
    a, b = smooth_pair(10, 50, 70, 1.0)
    want = jit_run(lambda v, x, y: j_raft_flow(jmod, v, x, y), variables,
                   a, b)
    with torch.no_grad():
        got = raft_flow(model, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (1, 50, 70, 2)
    assert_close(got, want, "raft_flow")


# ------------------------------ the converter --------------------------------

def test_converter_loads_strictly_and_refuses_unknown_params(tfdc_pair,
                                                             raft_pair):
    """Each family's variables load with ``strict=True`` (the fixtures'
    models); a param or a batch-norm statistic the port has no key for
    raises KeyError."""
    for variables in (tfdc_pair[1], raft_pair[1]):
        bad = dict(variables, params=dict(variables["params"],
                                          bogus={"kernel": np.zeros(1)}))
        with pytest.raises(KeyError, match="bogus"):
            state_dict_from_jax(bad)
    bad = dict(raft_pair[1], batch_stats=dict(
        raft_pair[1]["batch_stats"], cnet={"norm1": {"scale": np.zeros(1)}}))
    with pytest.raises(KeyError, match="batch_stats"):
        state_dict_from_jax(bad)
    params = tfdc_pair[1]["params"]
    bad = dict(tfdc_pair[1], params=dict(params, TFDC=dict(
        params["TFDC"], CAB2=dict(params["TFDC"]["CAB2"], gamma=np.zeros(
            1)))))
    with pytest.raises(KeyError, match="gamma"):
        state_dict_from_jax(bad)


def test_registry_and_init_weights():
    """The five names build; ``init_weights`` starts the norms at ones and
    zeros, the running statistics at 0 and 1 and CAB2's ``beta`` at 0."""
    gen = torch.Generator().manual_seed(0)
    model = init_weights(build(BACKBONES, dict(type="FCVSRTFDCNet",
                                               **TFDC_KW)), gen)
    assert isinstance(model, FCVSRTFDCNet)
    tfdc = model.TFDC
    assert not tfdc.CAB2.beta.any()
    assert torch.equal(tfdc.CAB2.norm.weight, torch.ones(16))
    bn = model.Spa_freqblock0.fu0.bn
    assert not bn.running_mean.any() and torch.equal(
        bn.running_var, torch.ones(32))
    raft = init_weights(build(BACKBONES, dict(type="RAFT", iters=2)), gen)
    assert torch.equal(raft.fnet.norm1.weight, torch.ones(64))
    assert raft.fnet.conv1.weight.abs().max() > 0
    assert isinstance(build(BACKBONES, dict(type="SIDECVSR", **SIDE_KW)),
                      SIDECVSR)
    for name in ("GShiftNet", "GShiftNet_S"):   # FCVSR on Y, full and -S
        m = build(BACKBONES, dict(type=name))
        assert isinstance(m, FCVSRNet)
        assert m.conv_last0.weight.shape[0] == 1
    small = build(BACKBONES, dict(type="GShiftNet_S"))
    assert [p.shape for p in small.parameters()] == [
        p.shape for p in FCVSRNet.small(in_channels=1).parameters()]
