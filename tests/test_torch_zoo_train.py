"""Training the zoo through the port's restorer, against the JAX package on
the CPU.

* ``VideoRestorer.loss_fn`` gradients of EDVR (mid 16, 8 deform groups,
  1 / 1 blocks, centre-frame GT cut from a 5-D GT) and BasicVSR++ (mid 16,
  1 block, 3 frames of 64 x 64, per-frame GT) against ``jax.grad`` of the
  JAX ``VideoRestorer.loss_fn`` on the same weights, relative to the JAX
  gradient's norm: EDVR's each tensor within 1e-3 (f32 sums in other
  orders, and a relu input or sample point within f32 noise of its
  branch); BasicVSR++'s whole gradient and median tensor within 1e-3 and
  each tensor within 5e-2, the bars the card's gradients are held to
  (chip_smoke.py), since some of its tensors are rough at f32 noise (the
  test says more); its flow-guided DCN alone within 1e-4.  Every DCN's
  last offset conv is seeded non-zero, as ``tests/test_torch_zoo.py`` draws
  it, so the gradients run through the deformable sampling.
* Three restorer steps of BasicVSR++ with ``fix_iter=2`` against the JAX
  ``make_train_step`` with ``optax.adam``: SPyNet unchanged over the first
  two, every other tensor moving from the first, all of them after the
  third, and each tensor's update within 1e-2 of optax's in norm.  SPyNet's
  third update depends on Adam's step count: a count that skipped the
  frozen steps would make it 0.36 of the learning rate larger, about a
  third of its norm.  (Elementwise the updates agree to 1e-5 but for a few
  values whose gradient is within f32 noise of 0: Adam's first steps move
  by about the learning rate times the gradient's sign, so such a value
  moves by up to 2e-4 one way in one framework and the other way in the
  other.)
* ``forward_test``'s PSNR / SSIM / tOF against the JAX restorer's, centre
  frame with the tOF state threaded and per-frame sequences.
* ``ClipFolderDataset.sample_train_sequence`` bit for bit.
* On the CPU the DCN weights get their gradients (no detached cached
  weight), and an update reaches the next forward.

EDVR's JAX gradient is compiled with XLA's backend optimisation off, which
only speeds up that one-off compile; BasicVSR++'s runs 5x slower so, and
its gradient and train step are compiled with the defaults.  The JAX
restorer's forward runs jitted (``_Jitted``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fcvsr_tpu.data import ClipFolderDataset as JClipFolderDataset
from fcvsr_tpu.models.basicvsr_pp import BasicVSRPlusPlus as JBasicVSRPP
from fcvsr_tpu.models.edvr import EDVRNet as JEDVRNet
from fcvsr_tpu.models.restorers import VideoRestorer as JVideoRestorer
from fcvsr_tpu.models.restorers import tensor2img as j_tensor2img
from fcvsr_tpu_torch.data import ClipFolderDataset
from fcvsr_tpu_torch.models import (BasicVSRPlusPlus, EDVRNet, VideoRestorer,
                                    init_weights, tensor2img)
from fcvsr_tpu_torch.models.basicvsr import ModulatedDeformConv2d
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.train.trainer import TrainState
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_zoo import _seed_offset_convs, _to_dict

GRAD_RTOL = 1e-3
FLIP_RTOL = 5e-2
UPDATE_RTOL = 1e-2
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
EDVR_KW = dict(mid_channels=16, deform_groups=8, num_blocks_extraction=1,
               num_blocks_reconstruction=1)
PP_KW = dict(mid_channels=16, num_blocks=1)


def _case(jm, seed, lq_shape, gt_shape, offset_conv, bias_scale):
    rng = np.random.default_rng(seed)
    lq = rng.uniform(0, 1, lq_shape).astype(np.float32)
    gt = rng.uniform(0, 1, gt_shape).astype(np.float32)
    params = _to_dict(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                       jnp.asarray(lq)))
    return _seed_offset_convs(params, offset_conv, seed + 1, bias_scale), \
        lq, gt


@pytest.fixture(scope="module")
def edvr_case():
    jm = JEDVRNet(**EDVR_KW)
    params, lq, gt = _case(jm, 20, (2, 5, 3, 16, 16), (2, 5, 3, 64, 64),
                           "conv_offset", 3.0)
    return jm, params, lq, gt


@pytest.fixture(scope="module")
def pp_case():
    jm = JBasicVSRPP(**PP_KW)
    params, lq, gt = _case(jm, 30, (1, 3, 3, 64, 64), (1, 3, 3, 256, 256),
                           "conv_offset3", 1.5)
    return jm, params, lq, gt


class _Jitted:
    """A flax module whose ``apply`` runs jitted, for the JAX restorer's
    ``forward_test`` (which calls ``model.apply``)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply)


def _port(cls, params, **kw):
    model = cls(**kw)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _jax_grads(restorer, params, lq, gt, opts=FAST):
    fn = jax.jit(jax.value_and_grad(
        lambda p: restorer.loss_fn(p, jnp.asarray(lq), jnp.asarray(gt))[0]))
    loss, grads = fn.lower(params).compile(opts)(params)
    return float(loss), {k: v.numpy() for k, v in
                         state_dict_from_jax(grads).items()}


def _check_grads(model, ref, per_tensor):
    """Every tensor within ``per_tensor`` of its JAX gradient's norm, and
    the whole gradient and the median tensor within GRAD_RTOL."""
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == ref.keys()
    rel = {}
    for k, r in ref.items():
        assert np.any(r) and np.any(got[k]), f"{k}: no gradient"
        rel[k] = np.linalg.norm(got[k] - r) / np.linalg.norm(r)
        assert rel[k] <= per_tensor, f"{k}: relative error {rel[k]}"
    whole = np.sqrt(sum(np.sum((got[k] - r) ** 2) for k, r in ref.items())
                    / sum(np.sum(r ** 2) for r in ref.values()))
    assert whole <= GRAD_RTOL and np.median(list(rel.values())) <= GRAD_RTOL


@pytest.mark.parametrize("which", ["edvr", "basicvsr_pp"])
def test_restorer_grads_match_jax(which, edvr_case, pp_case):
    """EDVR: each tensor within GRAD_RTOL.  BasicVSR++: the whole gradient
    and the median tensor within GRAD_RTOL, each tensor within FLIP_RTOL.
    Its offset convs' and SPyNet's gradients are rough at this point: they
    sum millions of bilinear samples' derivatives, and f32 noise in either
    framework moves some samples across a pixel boundary, which moves some
    of those tensors by more than 1e-3 of their norm, while the alignment
    alone agrees within 1e-4 (below)."""
    if which == "edvr":
        jm, params, lq, gt = edvr_case
        model, kw = _port(EDVRNet, params, **EDVR_KW), dict(
            center_frame_only=True)
    else:
        jm, params, lq, gt = pp_case
        model, kw = _port(BasicVSRPlusPlus, params, **PP_KW), {}
    ref_loss, ref = _jax_grads(JVideoRestorer(jm, **kw), params, lq, gt,
                               FAST if which == "edvr" else None)
    before = launch_counts()
    loss, sr = VideoRestorer(model, **kw).loss_fn(torch.from_numpy(lq),
                                                  torch.from_numpy(gt))
    loss.backward()
    assert launch_counts() == before
    assert sr.shape == ((2, 3, 64, 64) if which == "edvr"
                        else (1, 3, 3, 256, 256))
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    _check_grads(model, ref, GRAD_RTOL if which == "edvr" else FLIP_RTOL)


def test_second_order_alignment_grads_match_jax(pp_case):
    """BasicVSR++'s flow-guided DCN alone (its offset convs, the DCN's
    weights and all four inputs), offsets of several pixels: each gradient
    within 1e-4 of its max."""
    from fcvsr_tpu.models.basicvsr_pp import SecondOrderDeformableAlignment

    params = pp_case[1]["params"]["backward_1"]["deform_align"]
    model = _port(BasicVSRPlusPlus, pp_case[1], **PP_KW)
    align = model.deform_align["backward_1"]
    rng = np.random.default_rng(6)
    ins = [(rng.standard_normal((2, 13, 19, c)) * s).astype(np.float32)
           for c, s in ((32, 1.0), (48, 1.0), (2, 4.0), (2, 4.0))]
    g = rng.standard_normal((2, 13, 19, 16)).astype(np.float32)
    jg = jax.grad(lambda p, *a: jnp.vdot(
        SecondOrderDeformableAlignment(16).apply({"params": p}, *a), g),
        argnums=(0, 1, 2, 3, 4))(params, *[jnp.asarray(a) for a in ins])
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    align(*leaves).backward(torch.from_numpy(g))
    ref = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": {"backward_1": {"deform_align": jg[0]}, "spynet": {}}}
    ).items()}
    pairs = [(t.grad.numpy(), np.asarray(r)) for t, r in zip(leaves, jg[1:])]
    pairs += [(p.grad.numpy(), ref[f"deform_align.backward_1.{k}"])
              for k, p in align.named_parameters()]
    for a, r in pairs:
        assert float(np.abs(a - r).max()) <= 1e-4 * float(np.abs(r).max())


def test_fix_iter_steps_match_optax(pp_case):
    jm, params, lq, gt = pp_case
    lr, fix_iter = 1e-4, 2
    tx = optax.adam(lr, b1=0.9, b2=0.999)
    jstep_fn = JVideoRestorer(jm, fix_iter=fix_iter).make_train_step(tx)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    jopt = tx.init(jparams)
    jlq, jgt = jnp.asarray(lq), jnp.asarray(gt)
    step = jnp.zeros((), jnp.int32)
    jstep = jstep_fn.lower(jparams, jopt, step, jlq, jgt).compile()

    model = _port(BasicVSRPlusPlus, params, **PP_KW)
    restorer = VideoRestorer(model, fix_iter=fix_iter)
    state = TrainState(model, lambda s: lr, betas=(0.9, 0.999))
    tstep = restorer.make_train_step(state)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    spynet = [k for k in start if restorer.is_frozen(k)]
    assert spynet and all(k.startswith("spynet.") for k in spynet)
    for i in range(3):
        jparams, jopt, step, jout = jstep(jparams, jopt, step, jlq, jgt)
        out = tstep(torch.from_numpy(lq), torch.from_numpy(gt))
        np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]),
                                   rtol=1e-5)
        now = dict(model.named_parameters())
        moved = {k for k in start if not torch.equal(now[k], start[k])}
        if i < fix_iter:
            assert moved == set(start) - set(spynet), f"step {i}"
        else:
            assert moved == set(start), set(start) - moved
    assert state.step == int(step) == 3
    ref = state_dict_from_jax(jparams)
    for k, p in model.named_parameters():
        want = ref[k] - start[k]
        dev = float((p.detach() - ref[k]).norm() / want.norm())
        assert dev <= UPDATE_RTOL, f"{k}: update off by {dev} of its norm"


def test_forward_test_metrics_match_jax(edvr_case, pp_case):
    metrics = ("PSNR", "SSIM", "tOF")
    # the centre frame, the tOF state threaded over two windows
    jm, params, lq, gt = edvr_case
    port = VideoRestorer(_port(EDVRNet, params, **EDVR_KW), metrics=metrics)
    ref = JVideoRestorer(_Jitted(jm), metrics=metrics)
    got_state = ref_state = None
    for i in range(2):
        got, got_state = port.forward_test(torch.from_numpy(lq[i:i + 1]),
                                           gt[i:i + 1, 2], got_state)
        want, ref_state = ref.forward_test(params, jnp.asarray(lq[i:i + 1]),
                                           jnp.asarray(gt[i:i + 1, 2]),
                                           ref_state)
        for m in metrics:
            np.testing.assert_allclose(got["eval_result"][m],
                                       want["eval_result"][m], rtol=1e-3,
                                       atol=1e-3, err_msg=m)
    assert want["eval_result"]["tOF"] > 0
    # a sequence of per-frame GT, metrics averaged over the frames
    jm, params, lq, gt = pp_case
    port = VideoRestorer(_port(BasicVSRPlusPlus, params, **PP_KW))
    got, _ = port.forward_test(torch.from_numpy(lq), torch.from_numpy(gt))
    want, _ = JVideoRestorer(_Jitted(jm)).forward_test(
        params, jnp.asarray(lq), jnp.asarray(gt))
    for m in ("PSNR", "SSIM"):
        np.testing.assert_allclose(got["eval_result"][m],
                                   want["eval_result"][m], rtol=1e-4)
    out, _ = port.forward_test(torch.from_numpy(lq))
    assert out["output"].shape == (1, 3, 3, 256, 256)
    img = np.random.default_rng(3).uniform(-0.2, 1.2, (1, 3, 8, 6))
    np.testing.assert_array_equal(tensor2img(torch.from_numpy(img)),
                                  j_tensor2img(img))


def _write_clip(root, n=9, h=20, w=24, seqs=("a", "b")):
    from PIL import Image

    rng = np.random.default_rng(8)
    for seq in seqs:
        for sub, scale in (("lr", 1), ("gt", 4)):
            d = os.path.join(root, sub, seq)
            os.makedirs(d)
            for i in range(n):
                img = rng.integers(0, 256, (h * scale, w * scale, 3), np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{i:08d}.png"))


def test_sample_train_sequence_matches_jax_bit_for_bit(tmp_path):
    _write_clip(str(tmp_path))
    kw = dict(lr_root=str(tmp_path / "lr"), gt_root=str(tmp_path / "gt"),
              window=5)
    port, ref = ClipFolderDataset(**kw), JClipFolderDataset(**kw)
    rp, rr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        got, want = port.sample_train_sequence(rp, 12), \
            ref.sample_train_sequence(rr, 12)
        assert got[0].shape == (5, 12, 12, 3) and got[1].shape == (5, 48, 48,
                                                                     3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_dcn_weights_get_gradients_on_cpu():
    """After a forward without autograd (which caches the HWIO weights), a
    training forward still reaches every DCN's live weight and bias, and an
    update of the weights reaches the next cached forward."""
    model = init_weights(EDVRNet(**EDVR_KW), torch.Generator().manual_seed(0))
    dcns = [m for m in model.modules() if isinstance(m, ModulatedDeformConv2d)]
    assert len(dcns) == 4
    x = torch.rand(1, 5, 3, 16, 16)
    with torch.no_grad():
        before = model(x)
    model(x).square().mean().backward()
    for m in dcns:
        assert m.weight.grad is not None and m.weight.grad.abs().max() > 0
        assert m.bias.grad is not None and m.bias.grad.abs().max() > 0
    with torch.no_grad():
        for m in dcns:
            m.weight.sub_(0.1 * m.weight.grad)
        after = model(x)
    assert float((after - before).abs().max()) > 0
