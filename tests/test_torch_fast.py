"""The port's --fast serving configuration against the JAX package, on the
CPU (the kernels themselves run only on a GPU:
tests/test_torch_kernels_gpu.py).

* ``ops.psfold``: the folds against the JAX ones, 1x1 and 3x3, bit for bit
  (they only move values) and at 1e-6; the phase-split convs, the block
  permutation and the tap-major conv against the JAX ones at 1e-5 (convs
  that sum in other orders), and ``tail_impl='folded_pb'`` on the full
  topology (3x3 upsampling convs) against the JAX model's unfolded tail at
  1e-4.
* The resident IAC chain's plain version against the JAX resident chain in
  interpret mode, with |flow| <= 1 px where its radius-2 window is exact:
  1e-4 in float32, as tests/test_torch_kernels.py holds the per-iteration
  chain (the stencils sum in another order); in bf16 storage two bf16
  steps (1.6e-2) of the output's magnitude, since both round every
  iteration's output and a value within reassociation noise of a rounding
  boundary rounds either way.  And against the exact gather path with
  large flows at 1e-5.
* The quad's plain version against ``conv3x3_quad_rows`` in interpret mode
  within the bar of tests/test_scnet_rows.py (5e-2 of the output's scale:
  the TPU kernel runs single-pass bf16 matmuls).
* FCVSR-S, Y and RGB, under each exact flag against the JAX model with
  ``batch_mgaa`` and the folded tail (exact paths) at 1e-4, the bar of
  tests/test_parity_torch.py; the bf16 flags within the JAX package's
  --fast bars (max 0.02, mean 2e-3; tests/test_inference_precision.py) of
  the port's float32 path and of the JAX model: each bf16 type alone
  (``head_dtype``, ``mffr_dtype``, ``tail_dtype``) and the whole
  ``cli.FAST``, the JAX ``--fast`` set.
* Every flag leaves the state_dict as it is; the serving flags raise under
  autograd, and the resident chain with k_fused raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import FCVSRNet as JFCVSRNet
from fcvsr_tpu.ops.pallas_conv import (conv3x3_quad_rows, pad_to_rows,
                                       prep_weight, rows_to_nhwc)
from fcvsr_tpu.ops.pallas_iac import iac_fused_resident as j_resident
from fcvsr_tpu.ops import psfold as j_psfold
from fcvsr_tpu.ops.psfold import fold_ps_bias as j_fold_bias
from fcvsr_tpu.ops.psfold import fold_ps_conv as j_fold_conv
from fcvsr_tpu.ops.sac import iac as j_iac
from fcvsr_tpu.utils.torch_import import convert_torch_state_dict
from fcvsr_tpu_torch import cli
from fcvsr_tpu_torch.models import FCVSRNet, init_weights
from fcvsr_tpu_torch.ops import fused_conv, fused_iac, launch_counts
from fcvsr_tpu_torch.ops import psfold
from fcvsr_tpu_torch.ops.psfold import fold_ps_bias, fold_ps_conv
from fcvsr_tpu_torch.ops.sac import iac

ATOL = 1e-4
BF16_RTOL = 1.6e-2
# FCVSR-S
SMALL = dict(ac_num=3, freq_inv=4, sc_groups=4, up_ksize=1)
EXACT_FLAGS = {
    "batch_mgaa": dict(batch_mgaa=True),
    "folded": dict(tail_impl="folded"),
    "resident": dict(iac_chain="resident"),
    "quad": dict(scnet_fuse="quad"),
    "all": dict(batch_mgaa=True, tail_impl="folded", iac_chain="resident",
                scnet_fuse="quad"),
}
BF16_FLAGS = {
    "head_dtype": dict(head_dtype="bf16"),
    "mffr_dtype": dict(mffr_dtype="bf16"),
    "tail_dtype": dict(tail_dtype="bf16"),
    "fast": cli.FAST,
    "fast resident quad": cli.serving_flags(True, "resident", "quad"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: under the suite's workers its thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("k,cin,cout", [(1, 8, 4), (3, 6, 2), (3, 16, 1)])
def test_fold_ps_matches_jax(k, cin, cout):
    rng = np.random.default_rng(k + cin)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    once, twice = fold_ps_conv(_t(w), 2), fold_ps_conv(fold_ps_conv(_t(w), 2), 2)
    np.testing.assert_allclose(once.numpy(), np.asarray(j_fold_conv(w, 2)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(twice.numpy(),
                               np.asarray(j_fold_conv(j_fold_conv(w, 2), 2)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(fold_ps_bias(_t(b), 2).numpy(),
                               np.asarray(j_fold_bias(b, 2)), rtol=0, atol=1e-6)


def test_fast_is_the_jax_fast_set():
    """test.py:183-187's flags, under the port's names (its scnet_dtype
    stands for scnet_impl='rows_bf16'; warp_impl='pallas' is the port's
    kernels, always on)."""
    assert cli.FAST == dict(batch_mgaa=True, k_fused=True, tail_impl="folded",
                            iac_dtype="bf16", scnet_dtype="bf16",
                            head_dtype="bf16", mffr_dtype="bf16")


@pytest.mark.parametrize("cin,cout", [(8, 12), (5, 4)])
def test_phase_split_convs_match_jax(cin, cout):
    rng = np.random.default_rng(cin)
    # a fold reads the pre-shuffle map: 4 Cin channels
    x = rng.standard_normal((2, 7, 9, 4 * cin)).astype(np.float32)
    w3 = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.2
    b3 = rng.standard_normal(cout).astype(np.float32)
    fk, fb = j_fold_conv(w3, 2), j_fold_bias(b3, 2)
    fk_t, fb_t = _t(fk), _t(fb)
    for name in ("conv_folded_phase2", "conv_folded_phase2_blocked"):
        ref = np.asarray(getattr(j_psfold, name)(jnp.asarray(x), fk, fb))
        got = getattr(psfold, name)(_t(x), fk_t, fb_t).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=name)
    perm = psfold.block_to_interleaved_perm(4 * cout)
    np.testing.assert_array_equal(perm, j_psfold.block_to_interleaved_perm(
        4 * cout))
    # the blocked layout read through the permutation is the interleaved
    inter = psfold.conv_folded_phase2(_t(x), fk_t, fb_t)
    blocked = psfold.conv_folded_phase2_blocked(_t(x), fk_t, fb_t)
    np.testing.assert_array_equal(blocked.numpy(), inter[..., perm].numpy())
    # tap-major: the doubly folded last conv (S 3) and a 1x1 fold (S 1)
    for k in (3, 1):
        wl = rng.standard_normal((k, k, 4 * cin, 3)).astype(np.float32) * 0.2
        bl = rng.standard_normal(3).astype(np.float32)
        ref = np.asarray(j_psfold.conv_folded_tapmajor(
            jnp.asarray(x), jnp.asarray(wl), jnp.asarray(bl)))
        got = psfold.conv_folded_tapmajor(_t(x), _t(wl), _t(bl)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_phase_blocked_tail_matches_jax_unfolded():
    """The full topology at a reduced width (3x3 upsampling convs, so
    folded_pb takes the phase split) against the JAX model's xla tail, and
    the port's own three tails against each other."""
    reduced = dict(n_feats=16, ac_num=2, freq_inv=2, sc_groups=1)
    x = np.random.default_rng(15).uniform(0, 1, (1, 7, 1, 12, 16))
    x = x.astype(np.float32)
    model = init_weights(FCVSRNet(in_channels=1, **reduced),
                         torch.Generator().manual_seed(15)).eval()
    jm = JFCVSRNet(in_channels=1, **reduced)
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    outs = {}
    with torch.no_grad():
        for impl in ("folded_pb", "folded", "xla"):
            model.set_serving_flags(tail_impl=impl)
            outs[impl] = model(torch.from_numpy(x)).numpy()
    assert model.folded_tail()[0].shape[0] == 3
    np.testing.assert_allclose(outs["folded_pb"], ref, rtol=0, atol=ATOL)
    for impl in ("folded", "xla"):
        np.testing.assert_allclose(outs["folded_pb"], outs[impl], rtol=0,
                                   atol=1e-5, err_msg=impl)


def _chain_inputs(seed, b, h, w, c, ac, flow):
    rng = np.random.default_rng(seed)
    fin = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((b, h, w, ac * 3 * c)) * 0.3).astype(np.float32)
    if flow > 1:
        off = (rng.standard_normal((ac, b, h, w, 2)) * flow).astype(np.float32)
    else:
        off = rng.uniform(-flow, flow, (ac, b, h, w, 2)).astype(np.float32)
    return fin, k, off


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resident_chain_plain_matches_jax_interpret(dtype):
    b, h, w, c, ac = 2, 16, 24, 16, 3
    fin, k, off = _chain_inputs(0, b, h, w, c, ac, 1.0)
    jt, tt = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(j_resident(jnp.asarray(fin).astype(jt),
                                jnp.asarray(k).astype(jt), jnp.asarray(off),
                                ac, c, tile_rows=8, interpret=True), np.float32)
    got = fused_iac.iac_chain_plain(_t(fin).to(tt), _t(k).to(tt), _t(off), ac)
    assert got.dtype == tt
    tol = ATOL if dtype == "f32" else BF16_RTOL * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("act_last", [True, False])
def test_resident_chain_matches_jax_gather(act_last):
    """Large and out-of-frame flows, through ``ops.sac.iac``'s resident
    routing (the plain version on the CPU) and its wrapper, no launch."""
    b, h, w, c, ac = 2, 11, 13, 8, 3
    fin, k, off = _chain_inputs(1, b, h, w, c, ac, 12.0)
    ref = np.asarray(j_iac(jnp.asarray(fin), jnp.asarray(k), jnp.asarray(off),
                           ac, c, 3, act_last=act_last, kernel1_both=True,
                           k1_only=True, warp_impl="gather", k_tap_major=True))
    before = launch_counts()
    got = iac(_t(fin), _t(k), _t(off), ac, c, act_last=act_last,
              chain="resident")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        fused_iac.iac_fused_resident(_t(fin), _t(k), _t(off), ac,
                                     act_last).numpy(), ref, rtol=0, atol=1e-5)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="materialised"):
        iac(_t(fin), None, _t(off), ac, c, k_parts=(1, 2, 3), chain="resident")


def test_quad_plain_matches_pallas_interpret():
    h, w = 16, 24
    rng = np.random.default_rng(2)
    chans = (16, 32, 16, 16, 16)
    x = rng.standard_normal((1, h, w, chans[0])).astype(np.float32)
    ws = [(rng.standard_normal((3, 3, a, b)) * 0.1).astype(np.float32)
          for a, b in zip(chans, chans[1:])]
    bs = [(rng.standard_normal(chans[1]) * 0.1).astype(np.float32),
          (rng.standard_normal(chans[2]) * 0.1).astype(np.float32), None, None]
    jargs = [a for wt, bias in zip(ws, bs) for a in
             (prep_weight(jnp.asarray(wt)),
              None if bias is None else jnp.asarray(bias))]
    y_ref, out_ref = (np.asarray(rows_to_nhwc(r, h, w)) for r in
                      conv3x3_quad_rows(pad_to_rows(jnp.asarray(x), 8), *jargs,
                                        h=h, w=w, tile_rows=8, interpret=True))
    targs = [a for wt, bias in zip(ws, bs) for a in
             (_t(wt), None if bias is None else _t(bias))]
    y, out = fused_conv.conv3x3_quad(_t(x), *targs)
    for got, ref in ((y, y_ref), (out, out_ref)):
        assert np.abs(got.numpy() - ref).max() < 5e-2 * np.abs(ref).max()


@pytest.fixture(scope="module", params=[1, 3], ids=["Y", "RGB"])
def jax_small(request):
    """FCVSR-S with the port's seeded weights, and the JAX model's output on
    them with batch_mgaa and the folded tail (exact gather / xla paths).
    The JAX param tree comes from the converter on an abstract init, and
    the apply is jitted: op by op, the init and the apply would cost half
    a minute of compiles each."""
    cin = request.param
    x = np.random.default_rng(cin).uniform(0, 1, (1, 7, cin, 16, 16))
    x = x.astype(np.float32)
    sd = init_weights(FCVSRNet(in_channels=cin, **SMALL),
                      torch.Generator().manual_seed(cin)).state_dict()
    jm = JFCVSRNet.small(in_channels=cin, batch_mgaa=True, tail_impl="folded")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                      shapes)
    return cin, x, sd, np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))


def _port(sd, cin, **flags):
    model = FCVSRNet(in_channels=cin, **SMALL, **flags).eval()
    model.load_state_dict(sd, strict=True)
    return model


def test_exact_flags_match_jax(jax_small):
    cin, x, sd, ref = jax_small
    for name, flags in EXACT_FLAGS.items():
        with torch.no_grad():
            got = _port(sd, cin, **flags)(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape == (1, cin, 64, 64)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=name)


def test_bf16_flags_within_fast_bars(jax_small):
    cin, x, sd, ref = jax_small
    with torch.no_grad():
        f32 = _port(sd, cin)(torch.from_numpy(x)).numpy()
        for name, flags in BF16_FLAGS.items():
            got = _port(sd, cin, **flags)(torch.from_numpy(x)).numpy()
            for other in (f32, ref):
                d = np.abs(got - other)
                assert d.max() < 0.02 and d.mean() < 2e-3, (name, d.max(),
                                                             d.mean())


def test_flags_leave_state_dict_unchanged():
    """The same keys, shapes and seeded values under every flag."""
    def seeded(**flags):
        return init_weights(FCVSRNet.small(in_channels=1, **flags),
                            torch.Generator().manual_seed(4)).state_dict()

    base = seeded()
    for flags in (*EXACT_FLAGS.values(), *BF16_FLAGS.values()):
        sd = seeded(**flags)
        assert list(sd) == list(base)
        assert all(torch.equal(sd[k], v) for k, v in base.items())


def test_serving_flags_raise_under_autograd_and_resident_kf_raises():
    with pytest.raises(ValueError, match="k_fused"):
        FCVSRNet.small(k_fused=True, iac_chain="resident")
    with pytest.raises(ValueError, match="k_fused"):
        FCVSRNet.small().set_serving_flags(k_fused=True, iac_chain="resident")
    assert cli.serving_flags(True, "resident")["k_fused"] is False
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (1, 7, 1, 8, 8)).astype(np.float32))
    for flags, what in ((dict(iac_chain="resident"), "MGAA"),
                        (dict(iac_dtype="bf16"), "MGAA"),
                        (dict(head_dtype="bf16"), "MGAA"),
                        (dict(mffr_dtype="bf16"), "MFFR"),
                        (dict(tail_dtype="bf16"), "FCVSRNet"),
                        (dict(scnet_fuse="quad"), "SCNet"),
                        (dict(scnet_dtype="bf16"), "SCNet")):
        model = FCVSRNet.small(n_feats=16, **flags)
        with pytest.raises(RuntimeError, match=f"{what}.*inference only"):
            model(x)
