"""The GAN losses and the GAN restorer's step in the port against the JAX
package's on the CPU.

* ``gan_loss`` for its 4 types, real and fake targets, generator and
  discriminator; ``disc_shift_loss``; ``gradient_penalty_loss`` at JAX's
  interpolation weights (its ``alpha``, drawn from its key, handed to the
  port); ``gradient_loss`` with and without a weight map;
  ``perceptual_loss`` (and the style loss) at seeded VGG19 weights at
  32 x 32, through ``load_vgg_npz``; ``transferal_perceptual_loss``.
* Two ``GANRestorer`` steps of a small GLEAN with the U-Net discriminator
  against two of JAX's ``make_train_step`` on the same variables (JAX's
  initial values: the noise weights at zero): the logs, every generator
  and discriminator tensor after each step, the noise maps unmoved by step
  1 and moved by step 2 (JAX trains them), and the spectral-norm ``u``
  unchanged in both.  Then the gated step (``disc_steps=2``,
  ``disc_init_steps=1``): three steps of which the first two leave the
  generator and its Adam untouched, against JAX's.
* The generator loss of RealBasicVSR (with its cleaning loss, the U-Net's
  GAN term) and of DIC (every step's L1 and LightCNN's GAN term, as
  ``train.py``'s DIC loss) against JAX's; ``dic_losses`` (with landmark
  heatmaps) and ``area_downsample``.

The restorer's steps run in float64 on both sides (JAX under
``jax.enable_x64``): in float32 one activation within rounding of zero (a
GLEAN leaky relu's input of 4e-8) takes the other slope in one package,
and Adam's first step, about lr times each gradient's sign, turns that
into visible differences in the small gradients upstream; in float64 the
comparison is of the algorithm alone.  The card's float32 step is held
to the CPU's in chip_smoke.py.

Bars: losses within 1e-5 (relative; the float64 steps' logs within
1e-9); after each float64 step every tensor, rounded to float32, within
1e-6 of JAX's (times its max |value| when above 1), and each step moves
some tensor by at least half the lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fcvsr_tpu.models.dic import DICNet as JDICNet
from fcvsr_tpu.models.discriminators import LightCNN as JLightCNN
from fcvsr_tpu.models.discriminators import \
    UNetDiscriminatorWithSpectralNorm as JUNet
from fcvsr_tpu.models.gan_restorer import GANRestorer as JGANRestorer
from fcvsr_tpu.models.gan_restorer import dic_losses as j_dic_losses
from fcvsr_tpu.models.glean import GLEANStyleGANv2 as JGLEAN
from fcvsr_tpu.models.real_basicvsr import RealBasicVSRNet as JRealBasicVSR
from fcvsr_tpu.train import gan_losses as JL
from fcvsr_tpu_torch.models import (DICNet, GANRestorer, GLEANStyleGANv2,
                                    LightCNN, RealBasicVSRNet,
                                    UNetDiscriminatorWithSpectralNorm)
from fcvsr_tpu_torch.models.gan_restorer import area_downsample, dic_losses
from fcvsr_tpu_torch.train import gan_losses as L
from fcvsr_tpu_torch.train.cli import _dic_generator_loss
from fcvsr_tpu_torch.utils.config import GANConfig
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_gan_models import (FAST, draw_variables, jax_variables,
                                   port_model)

LOSS_RTOL = 1e-5
LOG_RTOL = 1e-9
STATE_ATOL = 1e-6
LR, BETAS = 1e-3, (0.9, 0.99)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def close(got, want, rtol=LOSS_RTOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-6), (got, want)


# ------------------------------- the losses ----------------------------------


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "hinge"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("is_disc", [True, False])
def test_gan_loss_matches_jax(gan_type, real, is_disc):
    pred = np.random.default_rng(1).normal(0, 2, (3, 5, 4, 1)) \
        .astype(np.float32)
    want = JL.gan_loss(jnp.asarray(pred), real, gan_type, loss_weight=0.3,
                       is_disc=is_disc)
    close(L.gan_loss(t(pred), real, gan_type, loss_weight=0.3,
                     is_disc=is_disc), want)


def test_disc_shift_and_gradient_losses_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
            for _ in range(2))
    w = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    close(L.disc_shift_loss(t(a)), JL.disc_shift_loss(jnp.asarray(a)))
    for kw in ({}, {"reduction": "sum"}):
        close(L.gradient_loss(t(a), t(b), t(w), 0.5, **kw),
              JL.gradient_loss(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(w), 0.5, **kw))
    close(L.gradient_loss(t(a), t(b)),
          JL.gradient_loss(jnp.asarray(a), jnp.asarray(b)))


def test_gradient_penalty_matches_jax_at_its_alpha():
    rng = np.random.default_rng(3)
    real, fake = (rng.uniform(0, 1, (3, 8, 8, 2)).astype(np.float32)
                  for _ in range(2))
    wk = rng.normal(0, 0.5, (3, 3, 2, 4)).astype(np.float32)

    def j_disc(x):
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(wk), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.tanh(y) ** 2

    def p_disc(x):
        y = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), t(wk).permute(3, 2, 0, 1), padding=1)
        return torch.tanh(y) ** 2

    key = jax.random.PRNGKey(7)
    want = JL.gradient_penalty_loss(j_disc, key, jnp.asarray(real),
                                    jnp.asarray(fake), loss_weight=10.0)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))
    got = L.gradient_penalty_loss(p_disc, t(real), t(fake), loss_weight=10.0,
                                  alpha=t(alpha))
    close(got, want)
    # drawn from a generator, the weights are U(0, 1), one a sample
    g = L.gradient_penalty_loss(p_disc, t(real), t(fake),
                                generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(g)


def test_perceptual_and_style_losses_match_jax_at_seeded_vgg19(tmp_path):
    rng = np.random.default_rng(4)
    x, gt = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
             for _ in range(2))
    layers = {"2": 0.1, "7": 0.5, "34": 1.0}
    jvgg = JL.VGGFeatureExtractor(layer_name_list=tuple(layers))
    variables = jax_variables(jvgg, x, 5)
    fn = jax.jit(lambda v, a, b: JL.perceptual_loss(
        jvgg, v, a, b, layers, perceptual_weight=0.7, style_weight=0.2))
    want_p, want_s = fn(variables, jnp.asarray(x), jnp.asarray(gt))
    # the port's VGG from a torchvision-keyed .npz
    sd = state_dict_from_jax(variables)
    assert sorted(sd)[:2] == ["features.0.bias", "features.0.weight"]
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{k: v.numpy() for k, v in sd.items()},
             **{"classifier.0.weight": np.zeros((2, 2), np.float32)})
    vgg = L.load_vgg_npz(str(path), L.VGGFeatureExtractor(tuple(layers)))
    with torch.no_grad():
        got_p, got_s = L.perceptual_loss(vgg, t(x), t(gt), layers,
                                         perceptual_weight=0.7,
                                         style_weight=0.2)
        close(got_p, want_p)
        close(got_s, want_s)
        none_p, _ = L.perceptual_loss(vgg, t(x), t(gt), layers,
                                      perceptual_weight=0.0)
    assert none_p is None


@pytest.mark.parametrize("use_attention", [True, False])
def test_transferal_perceptual_loss_matches_jax(use_attention):
    rng = np.random.default_rng(6)
    maps = [rng.normal(0, 1, (2, 4 * 2 ** i, 5 * 2 ** i, 3))
            .astype(np.float32) for i in range(3)]
    tex = [rng.normal(0, 1, m.shape).astype(np.float32) for m in maps]
    attn = rng.uniform(0, 1, (2, 4, 5, 1)).astype(np.float32)
    for crit in ("mse", "l1"):
        want = JL.transferal_perceptual_loss(
            [jnp.asarray(m) for m in maps], jnp.asarray(attn),
            [jnp.asarray(x) for x in tex], use_attention, crit, 0.5)
        close(L.transferal_perceptual_loss(
            [t(m) for m in maps], t(attn), [t(x) for x in tex],
            use_attention, crit, 0.5), want)


# -------------------------- the GAN restorer's step --------------------------

# GLEAN at 4 -> 8: XLA's float64 convs on the CPU are slow, and its
# StyleGAN2 layers are 512 channels wide whatever the multiplier
GLEAN_KW = dict(in_size=4, out_size=8, rrdb_channels=8, num_rrdbs=1,
                style_channels=8, channel_multiplier=1)


def _jax_initial(variables):
    """The noise weights at zero, as the JAX package initialises them."""
    def zero(tree):
        return {k: zero(v) if isinstance(v, dict) else
                np.zeros_like(v) if k == "noise_weight" else v
                for k, v in tree.items()}
    return dict(variables, params=zero(variables["params"]))


@pytest.fixture(scope="module")
def glean_pair():
    rng = np.random.default_rng(7)
    lq = rng.uniform(0, 1, (3, 1, 3, 4, 4)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 1, 3, 8, 8)).astype(np.float32)
    gen, disc = JGLEAN(**GLEAN_KW), JUNet(mid_channels=8)
    g_vars = _jax_initial(jax_variables(gen, lq[0], 8))
    d_vars = draw_variables(jax.eval_shape(
        lambda v: disc.init(jax.random.PRNGKey(1), v),
        jnp.zeros((1, 8, 8, 3))), 9)
    return dict(gen=gen, disc=disc, g_vars=g_vars, d_vars=d_vars, lq=lq,
                gt=gt)


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else np.asarray(v, np.float64)
            for k, v in tree.items()}


def _jax_steps(pair, n, **kw):
    """n steps of JAX's make_train_step in float64: each step's generator
    and discriminator variables (as the port's state_dicts, float32) and
    logs."""
    gen, disc = pair["gen"], pair["disc"]
    rest = JGANRestorer(
        generator_apply=lambda p, x: gen.apply(p, x),
        disc_apply=lambda p, x: disc.apply(p, x), gan_type="vanilla",
        gan_loss_weight=1e-2, pixel_loss_weight=1.0, **kw)
    out = []
    with jax.enable_x64(True):
        g_tx = optax.adam(LR, b1=BETAS[0], b2=BETAS[1])
        d_tx = optax.adam(LR, b1=BETAS[0], b2=BETAS[1])
        g_vars, d_vars = _f64(pair["g_vars"]), _f64(pair["d_vars"])
        state = (g_vars, d_vars, g_tx.init(g_vars), d_tx.init(d_vars),
                 jnp.int32(0))
        data = [(np.float64(pair["lq"][i]), np.float64(pair["gt"][i]))
                for i in range(n)]
        step = rest.make_train_step(g_tx, d_tx)
        for lq, gt in data:
            state, logs = step(state, lq, gt)
            out.append((state_dict_from_jax(jax.device_get(state[0])),
                        state_dict_from_jax(jax.device_get(state[1])),
                        {k: float(v) for k, v in logs.items()}))
    return out


def _port_steps(pair, n, **kw):
    """The same n steps of the port's GANRestorer in float64."""
    gen = port_model(GLEANStyleGANv2, pair["g_vars"], **GLEAN_KW).double()
    disc = port_model(UNetDiscriminatorWithSpectralNorm, pair["d_vars"],
                      mid_channels=8).double()
    rest = GANRestorer(gen, disc, gan_type="vanilla", gan_loss_weight=1e-2,
                       pixel_loss_weight=1.0, **kw)
    g_opt = torch.optim.Adam(gen.parameters(), lr=LR, betas=BETAS, eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), lr=LR, betas=BETAS,
                             eps=1e-8)
    step = rest.make_train_step(g_opt, d_opt)
    out = []
    for i in range(n):
        logs = step(t(pair["lq"][i]).double(), t(pair["gt"][i]).double())
        out.append(({k: v.float() for k, v in gen.state_dict().items()},
                    {k: v.float() for k, v in disc.state_dict().items()},
                    {k: float(v) for k, v in logs.items()}))
    return out, g_opt


def _check_update(before, got, want, what):
    """The port's tensors after a step equal JAX's, both rounded to
    float32, within STATE_ATOL; and the step moved them."""
    moved = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= STATE_ATOL * max(1.0, float(w.abs().max())), \
            (what, k, err)
        moved = max(moved, float((w - before[k]).abs().max()))
    assert moved > 0.5 * LR, (what, moved)


def test_glean_unet_two_steps_match_jax(glean_pair):
    want = _jax_steps(glean_pair, 2)
    got, _ = _port_steps(glean_pair, 2)
    g0 = state_dict_from_jax(glean_pair["g_vars"])
    d0 = state_dict_from_jax(glean_pair["d_vars"])
    prev = (g0, d0)
    for i, ((wg, wd, wl), (gg, gd, gl)) in enumerate(zip(want, got)):
        assert set(wl) == set(gl) == {"loss_pix", "loss_gan", "loss_d_real",
                                      "loss_d_fake", "loss_d", "loss_g"}
        for k in wl:
            close(gl[k], wl[k], LOG_RTOL)
        _check_update(prev[0], gg, wg, f"G step {i + 1}")
        _check_update(prev[1], gd, wd, f"D step {i + 1}")
        prev = (wg, wd)
    noise = [k for k in g0 if k.endswith(".noise")]
    assert len(noise) == 3
    for k in noise:
        # zero gradient while noise_weight is 0; moving from step 2
        assert torch.equal(want[0][0][k], g0[k]) and \
            torch.equal(got[0][0][k], g0[k]), k
        assert not torch.equal(want[1][0][k], g0[k]), k
        assert not torch.equal(got[1][0][k], g0[k]), k
    for k in d0:
        if k.endswith((".u", ".sigma")):
            for step in range(2):
                assert torch.equal(want[step][1][k], d0[k]), k
                assert torch.equal(got[step][1][k], d0[k]), k


def test_gated_generator_steps_match_jax(glean_pair):
    """disc_steps 2, disc_init_steps 1: steps 1 and 2 leave the generator
    (and its Adam) as it was, step 3 updates it, at Adam's step 1; the
    discriminator steps every time."""
    kw = dict(disc_steps=2, disc_init_steps=1)
    want = _jax_steps(glean_pair, 3, **kw)
    got, g_opt = _port_steps(glean_pair, 3, **kw)
    g0 = state_dict_from_jax(glean_pair["g_vars"])
    d0 = state_dict_from_jax(glean_pair["d_vars"])
    for i in range(2):
        for k in g0:
            assert torch.equal(got[i][0][k], g0[k]), (i, k)
            assert torch.equal(want[i][0][k], g0[k]), (i, k)
    steps = {int(s["step"]) for s in g_opt.state_dict()["state"].values()}
    assert steps == {1}
    prev_d = d0
    for i in range(3):
        for k in want[i][2]:
            close(got[i][2][k], want[i][2][k], LOG_RTOL)
        _check_update(prev_d, got[i][1], want[i][1], f"D step {i + 1}")
        prev_d = want[i][1]
    _check_update(g0, got[2][0], want[2][0], "G step 3")


# -------------------------- the generator losses -----------------------------


def test_real_basicvsr_generator_loss_matches_jax():
    rng = np.random.default_rng(10)
    lq = rng.uniform(0, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    gt = rng.uniform(0, 1, (1, 2, 3, 256, 256)).astype(np.float32)
    kw = dict(mid_channels=8, num_propagation_blocks=1,
              num_cleaning_blocks=1)
    gen, disc = JRealBasicVSR(**kw), JUNet(mid_channels=8)
    g_vars = jax_variables(gen, lq, 11, return_lqs=True)
    d_vars = draw_variables(jax.eval_shape(
        lambda v: disc.init(jax.random.PRNGKey(1), v),
        jnp.zeros((1, 256, 256, 3))), 12)
    rest = JGANRestorer(
        generator_apply=lambda p, x: gen.apply(p, x, return_lqs=True),
        disc_apply=lambda p, x: disc.apply(p, x), gan_loss_weight=5e-2,
        pixel_loss_weight=1.0, cleaning_loss_weight=1.0)
    fn = jax.jit(rest.generator_loss)
    want, (wlogs, _) = fn.lower(g_vars, d_vars, lq, gt).compile(FAST)(
        g_vars, d_vars, lq, gt)
    port = GANRestorer(
        port_model(RealBasicVSRNet, g_vars, **kw),
        port_model(UNetDiscriminatorWithSpectralNorm, d_vars,
                   mid_channels=8),
        gan_loss_weight=5e-2, pixel_loss_weight=1.0,
        cleaning_loss_weight=1.0)
    with torch.no_grad():
        got, logs, _ = port.generator_loss(t(lq), t(gt))
    close(got, want)
    assert set(logs) == set(wlogs) == {"loss_pix", "loss_clean", "loss_gan"}
    for k in logs:
        close(logs[k], wlogs[k])


def test_dic_generator_loss_matches_jax():
    """train.py's DIC loss (run_gan_training, :225-254): each step's L1
    times pixel_loss_weight, plus LightCNN's GAN term on the last SR."""
    rng = np.random.default_rng(13)
    lq = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 3, 128, 128)).astype(np.float32)
    kw = dict(mid_channels=8, num_blocks=2, hg_mid_channels=16, num_steps=2)
    gen, disc = JDICNet(**kw), JLightCNN()
    g_vars = jax_variables(gen, lq, 14)
    d_vars = draw_variables(jax.eval_shape(
        lambda v: disc.init(jax.random.PRNGKey(1), v),
        jnp.zeros((1, 128, 128, 3))), 15)
    gan = GANConfig(disc="lightcnn", gan_loss_weight=5e-3,
                    pixel_loss_weight=1.0)

    def j_loss(gp, dp, lq, gt):
        sr_list, _ = gen.apply(gp, lq)
        logs, total = {}, 0.0
        for k, sr in enumerate(sr_list):
            lp = jnp.abs(sr - gt).mean() * gan.pixel_loss_weight
            logs[f"loss_pixel_v{k}"] = lp
            total += lp
        fake = disc.apply(dp, jnp.transpose(sr_list[-1], (0, 2, 3, 1)))
        lg = JL.gan_loss(fake, True, gan.gan_type,
                         loss_weight=gan.gan_loss_weight)
        logs["loss_gan"] = lg
        return total + lg, logs

    want, wlogs = jax.jit(j_loss).lower(g_vars, d_vars, lq, gt).compile(
        FAST)(g_vars, d_vars, lq, gt)
    pg = port_model(DICNet, g_vars, **kw)
    pd = port_model(LightCNN, d_vars)
    with torch.no_grad():
        got, logs, sr = _dic_generator_loss(pg, pd, gan)(t(lq), t(gt))
    assert sr.shape == (2, 128, 128, 3)
    # DIC's JAX float32 evaluation is 3e-4 off its float64 value
    # (test_torch_gan_models.py): the loss within 1e-4
    close(got, want, 1e-4)
    assert set(logs) == set(wlogs)
    for k in logs:
        close(logs[k], wlogs[k], 1e-4)


def test_dic_losses_and_area_downsample_match_jax():
    from fcvsr_tpu.models.gan_restorer import \
        area_downsample as j_area_downsample

    rng = np.random.default_rng(16)
    srs = [rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
           for _ in range(3)]
    hms = [rng.uniform(0, 1, (2, 5, 4, 4)).astype(np.float32)
           for _ in range(3)]
    gt = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    gt_hm = rng.uniform(0, 1, (2, 5, 4, 4)).astype(np.float32)
    want, wlogs = j_dic_losses([jnp.asarray(a) for a in srs],
                               [jnp.asarray(a) for a in hms],
                               jnp.asarray(gt), jnp.asarray(gt_hm))
    got, logs = dic_losses([t(a) for a in srs], [t(a) for a in hms], t(gt),
                           t(gt_hm))
    close(got, want)
    assert set(logs) == set(wlogs) and len(logs) == 6
    for k in logs:
        close(logs[k], wlogs[k])
    x = rng.uniform(0, 1, (2, 3, 12, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(area_downsample(t(x), 4).numpy(),
                               np.asarray(j_area_downsample(jnp.asarray(x),
                                                            4)),
                               rtol=1e-6, atol=1e-7)
