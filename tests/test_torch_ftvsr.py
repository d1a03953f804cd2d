"""FTVSR and TTVSR in the port against the JAX models on the CPU, with
weights carried by ``utils.convert.state_dict_from_jax``.

LTAM and the FTTA layer (both channel groupings, and the encoder that
stacks it) run alone; the whole models at the widths of
tests/test_ftvsr_e2e.py (mid 8, 2 blocks, d_model 16, 4 heads, keyframes
every 2 frames) over 5 frames of 64 x 64, so that 4 of each direction's
LTAM steps choose between 2 keyframes.  The JAX parameters are drawn with
numpy from the shapes ``jax.eval_shape`` gives (kernels U(+-1/sqrt(fan_in)),
biases U(+-0.1), LayerNorm scales U(0.5, 1.5)); FTVSR's output and its
Charbonnier-mean gradient come from one jitted ``value_and_grad``, compiled
once with XLA's backend optimisation off, in a module-scoped fixture (run
op by op instead, it took 116 s against 41 s jitted).

LTAM's discrete choices are held apart: each call's tracked locations
(nearest-pixel warps) and keyframe picks (an argmax), recorded on both
sides (JAX's by a method interceptor and a debug callback, the port's by a
forward hook), must be equal; the tests report the counts.

Bars: LTAM, the FTTA layers and both whole models within 1e-4 max abs;
gradients relative to the JAX gradient's norm, the whole gradient and the
median tensor within 1e-3, and each tensor within 1e-3 but SPyNet's,
which are rough at f32 noise as BasicVSR's are (its flows feed sampling
positions), within 5e-2.  Measured worst per tensor (this seed, printed
by the test): the FTT head 6.2e-4 (ftta.norm1.weight), SPyNet 4.0e-3,
every other tensor (the trunk, LTAM, the upsampler) 1.2e-5.  The key
embedding's bias, whose gradient is 0 in exact arithmetic, is held to
that: both packages' under 1e-9 of the whole gradient's norm.
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.ftvsr import FTTALayer as JFTTALayer
from fcvsr_tpu.models.ftvsr import FTTEncoder as JFTTEncoder
from fcvsr_tpu.models.ftvsr import FTVSRNet as JFTVSRNet
from fcvsr_tpu.models.ftvsr import LTAM as JLTAM
from fcvsr_tpu.models.ftvsr import _l2norm as j_l2norm
from fcvsr_tpu.ops.dct import space_to_depth as j_space_to_depth
from fcvsr_tpu.ops.warp import grid_sample_nearest as j_sample_nearest
from fcvsr_tpu_torch import apis
from fcvsr_tpu_torch.metrics import calculate_psnr
from fcvsr_tpu_torch.models import (BACKBONES, FTVSRNet, TTVSRNet,
                                    VideoRestorer, build, init_weights,
                                    tensor2img)
from fcvsr_tpu_torch.models.ftvsr import LTAM, FTTALayer, FTTEncoder
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.train.losses import LOSSES
from fcvsr_tpu_torch.train.trainer import TrainState
from fcvsr_tpu_torch.utils.convert import (_ftta_state_dict,
                                            state_dict_from_jax)
from test_torch_zoo import _to_dict

ATOL = 1e-4
GRAD_RTOL = 1e-3
SPYNET_RTOL = 5e-2
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
SMALL = dict(mid_channels=8, num_blocks=2, d_model=16, n_heads=4,
             keyframe_stride=2)
SHAPE = (1, 5, 3, 64, 64)
# the tensors after FTT's SPyNet: the FTT head's own
FTT_HEAD = ("conv_layer1.", "ftt_feat.", "ftt_res.", "ftta.", "ftt_fusion",
            "conv_layer2.")
# the attention's softmax does not see one vector added to every key: the
# key embedding's bias has a gradient of 0 but for rounding (1e-13 of the
# whole gradient's norm in both packages)
ZERO_GRAD = "ftta.layer_k.bias"


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
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.uniform(-1, 1, s.shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    return _to_dict(jax.tree_util.tree_map_with_path(leaf, shapes))


def _params(module, seed, *args):
    return _draw(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args),
                 seed)


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy()
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def _ltam_inputs(rng, b=2, h=16, w=20, c=8, t=3, s=4):
    hb, wb, d = h // s, w // s, c * s * s
    feats = [rng.standard_normal((b, h, w, c)).astype(np.float32)
             for _ in range(2)]
    bufs = [rng.standard_normal((b, t, hb, wb, d)).astype(np.float32)
            for _ in range(4)]
    # block coordinates: in the frame, out of it (zeros) and on .5
    loc = np.stack([rng.uniform(-1.5, wb + 0.5, (b, t, hb, wb)),
                    rng.uniform(-1.5, hb + 0.5, (b, t, hb, wb))], -1)
    half = rng.random(loc.shape) < 0.25
    loc[half] = np.floor(loc[half]) + 0.5
    return feats, bufs, loc.astype(np.float32)


def test_ltam_matches_jax():
    rng = np.random.default_rng(0)
    (cur, anchor), (s1, s2, s3, idx), loc = _ltam_inputs(rng)
    jm = JLTAM(stride=4)
    args = [jnp.asarray(a) for a in (cur, idx, anchor, s1, s2, s3, loc)]
    params = _params(jm, 1, *args)
    ref = jm.apply(params, *args)
    port = LTAM(4, 8)
    k = np.asarray(params["params"]["fusion"]["Conv_0"]["kernel"])
    port.load_state_dict({
        "fusion.weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        "fusion.bias": torch.from_numpy(np.asarray(
            params["params"]["fusion"]["Conv_0"]["bias"]))}, strict=True)
    t = [torch.from_numpy(a) for a in (cur, idx, anchor, loc)]
    s123 = torch.from_numpy(np.concatenate([s1, s2, s3], -1))
    _close(port(t[0], t[1], t[2], s123, t[3]), ref)


@pytest.mark.parametrize("channel,groups", [(144, None), (128, 64)])
def test_ftta_layer_matches_jax(channel, groups):
    """The gcd grouping (16 groups of 9 channels at 144) and the
    reference's 64 groups."""
    rng = np.random.default_rng(channel)
    q, k, v = (rng.standard_normal((2, 16, 24, channel)).astype(np.float32)
               for _ in range(3))
    jm = JFTTALayer(channel, 16, 4, freq_groups=groups)
    args = [jnp.asarray(a) for a in (q, k, v)]
    params = _params(jm, 2, *args)
    port = FTTALayer(channel, 16, 4, freq_groups=groups)
    port.load_state_dict(_ftta_state_dict(params["params"]), strict=True)
    assert port.groups == (16 if groups is None else 64)
    _close(port(*(torch.from_numpy(a) for a in (q, k, v))),
           jm.apply(params, *args))


def test_ftt_encoder_matches_jax_and_bad_groups_raise():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 16, 16, 64)).astype(np.float32)
               for _ in range(3))
    jm = JFTTEncoder(64, 16, 4, num_layer=2)
    args = [jnp.asarray(a) for a in (q, k, v)]
    params = _params(jm, 4, *args)
    port = FTTEncoder(64, 16, 4, num_layer=2)
    port.load_state_dict({k: v for i in range(2) for k, v in _ftta_state_dict(
        params["params"][f"layer{i}"], f"layers.{i}.").items()}, strict=True)
    _close(port(*(torch.from_numpy(a) for a in (q, k, v))),
           jm.apply(params, *args))
    with pytest.raises(ValueError, match="defect"):
        FTTALayer(144, 16, 4, freq_groups=64)


def _jax_pick(cur, idx, loc, s):
    """JAX LTAM's keyframe pick at each block, as its ``__call__`` takes
    it."""
    b, t, hb, wb, d = idx.shape
    k = j_sample_nearest(idx.reshape(b * t, hb, wb, d),
                         loc[..., 0].reshape(b * t, hb * wb),
                         loc[..., 1].reshape(b * t, hb * wb))
    q = j_l2norm(j_space_to_depth(cur, s), axis=-1)
    corr = jnp.einsum("bthwd,bhwd->bthw",
                      j_l2norm(k.reshape(b, t, hb, wb, d), axis=-1), q)
    return jnp.argmax(corr, axis=1)


@contextlib.contextmanager
def _jax_picks(record):
    """While tracing, every JAX LTAM call appends its (locations, picks),
    as numpy at run time, to ``record``."""

    def intercept(method, args, kwargs, ctx):
        if isinstance(ctx.module, JLTAM) and ctx.method_name == "__call__":
            cur, idx, *_, loc = args
            n = len(record)
            record.append(None)

            def store(loc, pick):
                record[n] = (np.asarray(loc), np.asarray(pick))

            jax.debug.callback(store, loc,
                               _jax_pick(cur, idx, loc, ctx.module.stride))
        return method(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        yield


def _port_picks(model, record):
    """A forward hook: every port LTAM call appends its (locations, picks)
    to ``record``."""

    def hook(mod, args, out):
        cur, idx, _, _, loc = args
        with torch.no_grad():
            pick = mod.scores(cur, idx, loc).argmax(1)
        record.append((loc.detach().numpy(), pick.numpy()))

    return model.LTAM.register_forward_hook(hook)


def _compare_picks(ref, got):
    """LTAM's discrete choices on two sides, call by call: the tracked
    locations that differ, and over the calls with 2 or more keyframes the
    picks, those that differ and the keyframes picked."""
    assert len(ref) == len(got) > 0
    n = flipped = moved = 0
    picked = set()
    for (rl, rp), (gl, gp) in zip(ref, got):
        assert rl.shape == gl.shape and rp.shape == gp.shape
        moved += int(np.any(rl != gl, -1).sum())
        if rl.shape[1] > 1:
            n += rp.size
            flipped += int((rp != gp).sum())
            picked |= set(np.unique(rp).tolist())
    stats = dict(calls=len(ref), picks_over_2_keyframes=n, flipped=flipped,
                 moved_locations=moved, keyframes_picked=sorted(picked))
    print("LTAM choices:", stats)
    assert n > 0 and len(picked) > 1, f"no choice between keyframes: {stats}"
    assert flipped == 0 and moved == 0, f"LTAM choices differ: {stats}"
    return stats


@pytest.fixture(scope="module")
def ftvsr_case():
    """FTVSR's JAX output, loss, gradient and LTAM choices on seeded inputs
    and weights."""
    jm = JFTVSRNet(**SMALL)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, SHAPE).astype(np.float32)
    gt = rng.uniform(0, 1, SHAPE[:3] + (256, 256)).astype(np.float32)
    params = _params(jm, 6, jnp.asarray(x))

    def loss(p, x, gt):
        y = jm.apply(p, x)
        return jnp.mean(jnp.sqrt((y - gt) ** 2 + 1e-12)), y

    # the frames are arguments, not constants XLA would fold
    picks = []
    with _jax_picks(picks):
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
            params, x, gt)
    (val, y), grads = fn.compile(FAST)(params, x, gt)
    return dict(params=params, x=x, gt=gt, loss=float(val),
                out=np.asarray(y), picks=picks,
                grads={k: v.numpy()
                       for k, v in state_dict_from_jax(grads).items()})


def _port(params, **kw):
    model = FTVSRNet(**SMALL, **kw)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def test_ftvsr_output_and_grads_match_jax(ftvsr_case):
    case = ftvsr_case
    model = _port(case["params"])
    before = launch_counts()
    picks = []
    hook = _port_picks(model, picks)
    out = model(torch.from_numpy(case["x"]))
    hook.remove()
    _compare_picks(case["picks"], picks)
    _close(out, case["out"])
    loss = LOSSES["charbonnier_mean"](out, torch.from_numpy(case["gt"]))
    loss.backward()
    assert launch_counts() == before
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    ref = case["grads"]
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == ref.keys()
    norm = np.sqrt(sum(np.sum(r ** 2) for r in ref.values()))
    rel = {}
    for k, r in ref.items():
        assert np.any(r) and np.any(got[k]), f"{k}: no gradient"
        if k == ZERO_GRAD:
            assert max(np.linalg.norm(got[k]), np.linalg.norm(r)) <= \
                1e-9 * norm
            continue
        rel[k] = np.linalg.norm(got[k] - r) / np.linalg.norm(r)
    bars = {"FTT head": GRAD_RTOL, "SPyNet": SPYNET_RTOL,
            "the rest": GRAD_RTOL}
    worst = {g: max((v, k) for k, v in rel.items() if _group(k) == g)
             for g in bars}
    print("worst relative gradient error by group:", worst)
    for g, (v, k) in worst.items():
        assert v <= bars[g], f"{g}: {k} relative error {v} > {bars[g]}"
    whole = np.sqrt(sum(np.sum((got[k] - r) ** 2)
                        for k, r in ref.items())) / norm
    median = np.median(list(rel.values()))
    print("whole", whole, "median", median)
    assert whole <= GRAD_RTOL and median <= GRAD_RTOL


def _group(key):
    if key.startswith(FTT_HEAD):
        return "FTT head"
    return "SPyNet" if key.startswith("spynet.") else "the rest"


def test_ttvsr_output_matches_jax():
    jm = JFTVSRNet(with_ftt=False, **SMALL)
    x = np.random.default_rng(7).uniform(0, 1, SHAPE).astype(np.float32)
    params = _params(jm, 8, jnp.asarray(x))
    ref_picks, picks = [], []
    with _jax_picks(ref_picks):
        fn = jax.jit(jm.apply).lower(params, x)
    ref = fn.compile(FAST)(params, x)
    model = build(BACKBONES, dict(type="TTVSRNet", **SMALL))
    assert isinstance(model, FTVSRNet) and not model.with_ftt
    assert not any(k.startswith(FTT_HEAD) for k in model.state_dict())
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    hook = _port_picks(model, picks)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), ref)
    hook.remove()
    _compare_picks(ref_picks, picks)


def test_registry_defaults_and_converter_routing(ftvsr_case):
    """The reference widths by default; an FTVSR tree (which holds a
    SpyNet) maps onto FTVSR's keys, not BasicVSR++'s; an unknown param
    raises."""
    ft = build(BACKBONES, dict(type="FTVSRNet"))
    tt = TTVSRNet()
    assert (len(ft.resblocks.main[2]), len(tt.resblocks.main[2])) == (72, 60)
    assert ft.ftta.mha.embed_dim == 144 and ft.ftta.mha.num_heads == 8
    assert ft.ftta.groups == 16 and ft.keyframe_stride == 3
    tree = dict(ftvsr_case["params"]["params"])
    keys = state_dict_from_jax({"params": tree})
    assert "LTAM.fusion.weight" in keys and "ftta.mha.in_proj_weight" in keys
    tree["ftta"] = dict(tree["ftta"], extra={"kernel": np.zeros((1, 1))})
    with pytest.raises(KeyError, match="ftta.extra"):
        state_dict_from_jax({"params": tree})


class _Replay(torch.nn.Module):
    """A model that returns a stored output."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def forward(self, lq):
        return self.out


def test_serving_and_restorer_take_ftvsr(ftvsr_case):
    """``restoration_video_inference(window_size=0)`` returns FTVSR's
    forward frame by frame; ``forward_test`` averages the sequence metrics
    over its (1, T, 3, 4H, 4W) output, or scores its centre frame against
    a centre GT (FTVSR's output replayed); ``fix_iter`` freezes SPyNet and
    nothing else."""
    case = ftvsr_case
    model = _port(case["params"]).eval()
    frames = np.transpose(case["x"][0], (0, 2, 3, 1))
    sr = apis.restoration_video_inference(model, frames, window_size=0)
    np.testing.assert_allclose(np.transpose(sr, (0, 3, 1, 2)),
                               case["out"][0], rtol=0, atol=ATOL)
    sr = np.transpose(sr, (0, 3, 1, 2))[None]
    res, state = VideoRestorer(model).forward_test(
        torch.from_numpy(case["x"]), case["gt"])
    want = [calculate_psnr(tensor2img(sr[:, i]), tensor2img(case["gt"][:, i]),
                           0, "Y", "rgb") for i in range(SHAPE[1])]
    assert res["eval_result"]["PSNR"] == pytest.approx(np.mean(want),
                                                       rel=1e-6)
    assert state is None and np.isfinite(res["eval_result"]["SSIM"])
    res, state = VideoRestorer(_Replay(torch.from_numpy(sr))).forward_test(
        torch.from_numpy(case["x"]), case["gt"][:, SHAPE[1] // 2])
    assert res["eval_result"]["PSNR"] == pytest.approx(want[SHAPE[1] // 2],
                                                       rel=1e-6)
    np.testing.assert_array_equal(state[0], tensor2img(sr[:, SHAPE[1] // 2]))


def test_fix_iter_freezes_ftvsrs_spynet():
    model = init_weights(TTVSRNet(mid_channels=8, num_blocks=1,
                                  keyframe_stride=2),
                         torch.Generator().manual_seed(9))
    restorer = VideoRestorer(model, fix_iter=1)
    step = restorer.make_train_step(TrainState(model, lambda s: 1e-3,
                                               (0.9, 0.999)))
    rng = np.random.default_rng(10)
    lq = torch.from_numpy(rng.uniform(0, 1, (1, 2, 3, 64, 64))
                          .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (1, 2, 3, 256, 256))
                          .astype(np.float32))
    frozen = {k for k, _ in model.named_parameters() if k.startswith(
        "spynet.")}
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    step(lq, gt)
    assert {k for k, p in model.named_parameters()
            if torch.equal(p, start[k])} == frozen
    step(lq, gt)
    assert not any(torch.equal(p, start[k])
                   for k, p in model.named_parameters())


def test_stage_times_split_ftvsrs_forward(ftvsr_case):
    """``profiling.stage_times`` with FTVSR's stages: SPyNet's LR and x4
    calls apart, the trunk, LTAM, the upsampler and the FTT head, and the
    rest, adding up to the forward."""
    from fcvsr_tpu_torch import profiling

    model = _port(ftvsr_case["params"]).eval()
    x = torch.from_numpy(ftvsr_case["x"][:, :2])
    st = profiling.stage_times(model, x, reps=1, warmup=0,
                               stages=profiling.FTVSR_STAGES)
    assert set(st) == {"forward", "rest", "SpyNet LR", "SpyNet HR",
                       "feat extract", "trunk", "LTAM", "upsampler",
                       "FTT head"}
    assert all(v > 0 for k, v in st.items() if k != "rest")
    assert st["forward"] == pytest.approx(
        sum(v for k, v in st.items() if k != "forward"))
