"""The GAN family's models in the port against the JAX package's on the CPU:
RealBasicVSR on both sides of its cleaning threshold (outputs, cleaned
frames and gradients), GLEAN, DIC over 2 feedback steps, DIC's transposed
conv alone at an odd size (the kernel flip), the StyleGAN2 generator and
discriminator, the U-Net discriminator with its spectral-norm ``u``
carried, LightCNN (and its feature loss) and ModifiedVGG.

Weights: the JAX models' variables are drawn with numpy from the shapes
``jax.eval_shape`` gives (kernels U(+-1/sqrt(fan_in)), biases U(+-0.1),
StyleGAN2's unit-scale weights, ``constant_input`` and noise maps N(0, 1),
noise weights and PReLU slopes U(0.1, 0.3), spectral-norm ``u`` N(0, 1),
batch-norm statistics non-trivial), so no weight the JAX package starts at
zero hides a mapping fault; ``utils.convert.state_dict_from_jax`` carries
the whole variables dict (``params``, ``noises``, ``batch_stats``) and
each port model loads it with ``strict=True``.  Each JAX model runs
jitted, built once in a module-scoped fixture.  Torch runs on one thread.

Bars: each output within 1e-4 of its max |value| (RealBasicVSR's cleaned
frames too), DIC's within 1e-3: XLA's CPU float32 evaluation of the JAX
DIC is itself 3.3e-4 of max |SR| from the same model in float64 (the
port's 1.2e-7, held here to 1e-5 against the port in float64; measured
against JAX 3.1e-4).  RealBasicVSR's gradients, the whole gradient within 1e-4 of
its norm and each tensor within 1e-3 of its own norm (SPyNet's tensors,
upstream of its sampling positions, within 5e-2 as the zoo tests hold
them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.dic import ConvTranspose2d as JConvTranspose2d
from fcvsr_tpu.models.dic import DICNet as JDICNet
from fcvsr_tpu.models.discriminators import LightCNN as JLightCNN
from fcvsr_tpu.models.discriminators import ModifiedVGG as JModifiedVGG
from fcvsr_tpu.models.discriminators import \
    UNetDiscriminatorWithSpectralNorm as JUNet
from fcvsr_tpu.models.discriminators import \
    light_cnn_feature_loss as j_light_cnn_feature_loss
from fcvsr_tpu.models.glean import GLEANStyleGANv2 as JGLEAN
from fcvsr_tpu.models.real_basicvsr import RealBasicVSRNet as JRealBasicVSR
from fcvsr_tpu.models.stylegan2 import StyleGAN2Discriminator as JSG2D
from fcvsr_tpu.models.stylegan2 import StyleGAN2Generator as JSG2G
from fcvsr_tpu_torch.models import (BACKBONES, DICNet, GLEANStyleGANv2,
                                    LightCNN, ModifiedVGG, RealBasicVSRNet,
                                    StyleGAN2Discriminator,
                                    StyleGAN2Generator,
                                    UNetDiscriminatorWithSpectralNorm, build)
from fcvsr_tpu_torch.models.dic import ConvTranspose2d
from fcvsr_tpu_torch.models.discriminators import light_cnn_feature_loss
from fcvsr_tpu_torch.utils.convert import (conv_transpose_weight,
                                           state_dict_from_jax)

OUT_RTOL = 1e-4
GRAD_RTOL = 1e-4
TENSOR_RTOL = 1e-3
FLIP_RTOL = 5e-2
# XLA's backend optimisation off: the one-off compiles take less time, the
# runs stay short at these sizes
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
        names = [str(getattr(p, "key", p)) for p in path]
        col, name, shape = names[0], names[-1], s.shape
        if col == "noises" or name in ("u", "weight", "constant_input") \
                or name.endswith("_w"):
            v = rng.standard_normal(shape)
        elif name == "sigma":
            v = np.ones(shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("noise_weight", "alpha"):
            v = rng.uniform(0.1, 0.3, shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name in ("bias", "mean") or name.endswith("_b"):
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return to_dict(jax.tree_util.tree_map_with_path(leaf, shapes))


def jax_variables(module, x, seed: int, **kw) -> dict:
    return draw_variables(jax.eval_shape(
        lambda v: module.init(jax.random.PRNGKey(0), v, **kw),
        jnp.asarray(x)), seed)


def jit_apply(module, variables, *args, **kw):
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kw))
    args = tuple(jnp.asarray(a) for a in args)
    return fn.lower(variables, *args).compile(FAST)(variables, *args)


def port_model(cls, variables, **kw):
    model = cls(**kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def assert_close(got, want, rtol=OUT_RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)
    return err / scale


# ------------------------------ RealBasicVSR ---------------------------------

RBV_KW = dict(mid_channels=8, num_propagation_blocks=1, num_cleaning_blocks=1)
RBV_SHAPE = (1, 2, 3, 64, 64)


@pytest.fixture(scope="module")
def rbv():
    """JAX RealBasicVSR's outputs, cleaned frames and gradients at the
    default threshold (255: one cleaning pass) and at 0 (three)."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, RBV_SHAPE).astype(np.float32)
    variables = jax_variables(JRealBasicVSR(**RBV_KW), x, 1, return_lqs=True)
    gt = rng.uniform(0, 1, (1, 2, 3, 256, 256)).astype(np.float32)
    out = {}
    for thres in (255.0, 0.0):
        jm = JRealBasicVSR(dynamic_refine_thres=thres, **RBV_KW)

        def loss(v):
            sr, cleaned = jm.apply(v, jnp.asarray(x), return_lqs=True)
            return (jnp.abs(sr - gt).mean() + jnp.abs(cleaned).mean(),
                    (sr, cleaned))

        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        (val, (sr, cleaned)), grads = \
            fn.lower(variables).compile(FAST)(variables)
        out[thres] = dict(loss=float(val), sr=np.asarray(sr),
                          cleaned=np.asarray(cleaned),
                          grads=state_dict_from_jax(grads))
    return dict(variables=variables, x=x, gt=gt, out=out)


@pytest.mark.parametrize("thres,passes", [(255.0, 1), (0.0, 3)])
def test_real_basicvsr_matches_jax_on_both_sides_of_the_threshold(
        rbv, thres, passes):
    model = port_model(RealBasicVSRNet, rbv["variables"],
                       dynamic_refine_thres=thres, **RBV_KW)
    want = rbv["out"][thres]
    sr, cleaned = model(torch.from_numpy(rbv["x"]), return_lqs=True)
    assert model.cleaning_passes == passes
    assert_close(sr, want["sr"], what="sr")
    assert_close(cleaned, want["cleaned"], what="cleaned")
    loss = (sr - torch.from_numpy(rbv["gt"])).abs().mean() + \
        cleaned.abs().mean()
    assert abs(loss.item() - want["loss"]) <= 1e-5 * abs(want["loss"])
    loss.backward()
    grads = dict(model.named_parameters())
    ref = want["grads"]
    assert set(ref) == set(grads)
    diff = np.sqrt(sum(float(((grads[k].grad - ref[k]) ** 2).sum())
                       for k in ref))
    norm = np.sqrt(sum(float((ref[k] ** 2).sum()) for k in ref))
    assert diff <= GRAD_RTOL * norm, (diff, norm)
    for k, g in ref.items():
        bar = FLIP_RTOL if "spynet" in k else TENSOR_RTOL
        err = float((grads[k].grad - g).norm())
        assert err <= bar * max(float(g.norm()), 1e-8 * norm), (k, err)
    # the cleaning module gets gradient from every pass taken
    assert float(grads["image_cleaning.1.weight"].grad.norm()) > 0


# ------------------------------ GLEAN / StyleGAN2 ----------------------------

GLEAN_KW = dict(in_size=8, out_size=32, rrdb_channels=8, num_rrdbs=1,
                style_channels=8, channel_multiplier=1)


@pytest.fixture(scope="module")
def glean():
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    jm = JGLEAN(**GLEAN_KW)
    variables = jax_variables(jm, x, 2)
    return dict(variables=variables, x=x,
                out=np.asarray(jit_apply(jm, variables, x)))


def test_glean_matches_jax(glean):
    model = port_model(GLEANStyleGANv2, glean["variables"], **GLEAN_KW)
    with torch.no_grad():
        out = model(torch.from_numpy(glean["x"]))
    assert out.shape == (2, 3, 32, 32)
    assert_close(out, glean["out"], what="glean")
    # the noise maps are parameters (the generator's Adam trains them)
    names = {n for n, _ in model.named_parameters()}
    assert {"g_conv1.noise", "g_conv_up5.noise", "g_conv5.noise"} <= names
    with pytest.raises(ValueError, match="8px"):
        model(torch.zeros(1, 3, 16, 16))


def test_stylegan2_generator_matches_jax():
    kw = dict(out_size=16, style_channels=8, num_mlps=2,
              channel_multiplier=1)
    z = np.random.default_rng(13).standard_normal((2, 8)).astype(np.float32)
    jm = JSG2G(**kw)
    variables = jax_variables(jm, z, 3)
    want = jit_apply(jm, variables, z)
    model = port_model(StyleGAN2Generator, variables, **kw)
    with torch.no_grad():
        assert_close(model(torch.from_numpy(z)), want, what="sg2 generator")


@pytest.mark.parametrize("batch", [2, 3])
def test_stylegan2_discriminator_matches_jax(batch):
    kw = dict(in_size=32, channel_multiplier=1)
    x = np.random.default_rng(14 + batch).uniform(
        -1, 1, (batch, 32, 32, 3)).astype(np.float32)
    jm = JSG2D(**kw)
    variables = jax_variables(jm, x, 4)
    want = jit_apply(jm, variables, x)
    model = port_model(StyleGAN2Discriminator, variables, **kw)
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x)), want, what="sg2 disc")


# ---------------------------------- DIC --------------------------------------

DIC_KW = dict(mid_channels=8, num_blocks=2, hg_mid_channels=16, num_steps=2)


DIC_RTOL = 1e-3
F64_RTOL = 1e-5


def test_dic_matches_jax_over_two_steps():
    x = np.random.default_rng(15).uniform(0, 1, (1, 3, 16, 16)) \
        .astype(np.float32)
    jm = JDICNet(**DIC_KW)
    variables = jax_variables(jm, x, 5)
    srs, hms = jit_apply(jm, variables, x)
    model = port_model(DICNet, variables, **DIC_KW)
    m64 = port_model(DICNet, variables, **DIC_KW).double()
    with torch.no_grad():
        got_srs, got_hms = model(torch.from_numpy(x))
        srs64, hms64 = m64(torch.from_numpy(x).double())
    assert len(got_srs) == len(got_hms) == 2
    for k in range(2):
        assert got_srs[k].shape == (1, 3, 128, 128)
        assert got_hms[k].shape == (1, 68, 32, 32)
        assert_close(got_srs[k], srs[k], DIC_RTOL, f"sr {k}")
        assert_close(got_hms[k], hms[k], DIC_RTOL, f"heatmap {k}")
        assert_close(got_srs[k].double(), srs64[k], F64_RTOL, f"sr64 {k}")
        assert_close(got_hms[k].double(), hms64[k], F64_RTOL, f"hm64 {k}")


def test_dic_transposed_conv_flip_at_an_odd_size():
    """k 6, stride 3, padding 2, 4 -> 5 channels on a 7 x 9 map; the
    unflipped kernel would be off by the kernel's asymmetry."""
    x = np.random.default_rng(16).standard_normal((2, 7, 9, 4)) \
        .astype(np.float32)
    jm = JConvTranspose2d(features=5, kernel_size=6, stride=3, padding=2)
    variables = jax_variables(jm, x, 6)
    want = np.asarray(jit_apply(jm, variables, x))
    conv = ConvTranspose2d(4, 5, 6, 3, 2)
    with torch.no_grad():
        conv.weight.copy_(conv_transpose_weight(
            variables["params"]["kernel"]))
        conv.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        got = conv(torch.from_numpy(x))
        assert got.shape == (2, 20, 26, 5) == want.shape
        assert_close(got, want, what="conv transpose")
        kernel = np.asarray(variables["params"]["kernel"])
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            kernel.transpose(2, 3, 0, 1))))
        assert np.abs(conv(torch.from_numpy(x)).numpy() - want).max() > \
            1e-2 * np.abs(want).max()


# ----------------------------- discriminators --------------------------------


def test_unet_discriminator_carries_u_and_never_writes_it():
    x = np.random.default_rng(17).uniform(0, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    jm = JUNet(mid_channels=8)
    variables = jax_variables(jm, x, 7)
    want = jit_apply(jm, variables, x)
    model = port_model(UNetDiscriminatorWithSpectralNorm, variables,
                       mid_channels=8)
    u0 = {n: b.clone() for n, b in model.named_buffers()}
    assert set(u0) == {f"conv_{i}.{b}" for i in range(1, 9)
                       for b in ("u", "sigma")}
    np.testing.assert_array_equal(
        u0["conv_3.u"].numpy(),
        variables["batch_stats"]["SpectralNorm_2"]["conv_3/kernel/u"])
    model.train()
    out = model(torch.from_numpy(x))
    assert_close(out, want, what="unet")
    out.mean().backward()
    for n, b in model.named_buffers():
        assert torch.equal(b, u0[n]), n


def test_lightcnn_and_its_feature_loss_match_jax():
    rng = np.random.default_rng(18)
    x, y = (rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
            for _ in range(2))
    jm = JLightCNN()
    variables = jax_variables(jm, x, 8)
    fn = jax.jit(lambda v, a, b: (
        jm.apply(v, a), jm.apply(v, a, features_only=True),
        j_light_cnn_feature_loss(jm, v, a, b)))
    logits, feats, floss = fn(variables, jnp.asarray(x), jnp.asarray(y))
    model = port_model(LightCNN, variables)
    with torch.no_grad():
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        assert_close(model(xt), logits, what="logits")
        assert_close(model(xt, features_only=True), feats, what="features")
        got = float(light_cnn_feature_loss(model, xt, yt))
    assert abs(got - float(floss)) <= OUT_RTOL * abs(float(floss))


def test_modified_vgg_matches_jax_in_eval():
    x = np.random.default_rng(19).uniform(0, 1, (2, 128, 128, 3)) \
        .astype(np.float32)
    jm = JModifiedVGG(mid_channels=8)
    variables = jax_variables(jm, x, 9)
    want = jit_apply(jm, variables, x)
    model = port_model(ModifiedVGG, variables, mid_channels=8).eval()
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x)), want, what="modified vgg")


def test_registry_builds_the_gan_family():
    names = ("RealBasicVSRNet", "GLEANStyleGANv2", "DICNet",
             "FeedbackHourglass", "StyleGAN2Generator",
             "StyleGAN2Discriminator", "ModifiedVGG", "LightCNN",
             "UNetDiscriminatorWithSpectralNorm")
    assert set(names) <= set(BACKBONES.keys())
    model = build(BACKBONES, dict(type="UNetDiscriminatorWithSpectralNorm",
                                  mid_channels=8))
    assert isinstance(model, UNetDiscriminatorWithSpectralNorm)
