"""The GAN family on a GPU against the same models on the CPU.

Skips without a CUDA device.  The machine with the card has no JAX, so run
these without the repository's conftest (which configures JAX):

    python -m pytest tests/test_torch_gan_gpu.py -q --noconftest

At small widths and odd shapes (frames of 40 x 56 for the U-Net, whose
three halvings need multiples of 8; RealBasicVSR's LR 64 x 96, SPyNet's
least; GLEAN 4 -> 8 with StyleGAN2's discriminator at 8; DIC 16 -> 128
over 2 steps with LightCNN), TF32 off: each model's output within 1e-4 of
its max |value| (DIC's within 1e-3: its float32 evaluation is 3e-4 from
float64 on the CPU, tests/test_torch_gan_models.py), and one
``GANRestorer`` step's generator and discriminator gradients per family,
each tensor within 5e-2 and each network's whole gradient and median
tensor within 1e-3 of their norm, or within 4 times the CPU's own floor
where that is larger: a leaky relu, or a LightCNN max-feature-map or max
pool, whose inputs lie within float32 noise of a tie takes the other
branch on one device, and the floor measures that on the CPU (the same
step with its inputs moved by 1e-6 of themselves; LightCNN's
discriminator gradient at these shapes: 1.6e-3 of its norm on the card).
chip_smoke.py holds the full widths to 1e-3.  No kernel of ``ops.launch_counts()`` lies on
these paths.  Then ``train/cli.py --device cuda`` trains the tiny GLEAN a
step.
"""

import numpy as np
import pytest
import torch

from fcvsr_tpu_torch.models import (DICNet, GLEANStyleGANv2, LightCNN,
                                    RealBasicVSRNet, StyleGAN2Discriminator,
                                    UNetDiscriminatorWithSpectralNorm,
                                    init_weights)
from fcvsr_tpu_torch.models.gan_restorer import GANRestorer
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.train.cli import _dic_generator_loss
from fcvsr_tpu_torch.utils.config import GANConfig

pytestmark = pytest.mark.gpu

OUT_RTOL = 1e-4
DIC_RTOL = 1e-3
GRAD_RTOL = 1e-3
FLIP_RTOL = 5e-2
# the bars' floor: this many times the CPU's own deviation when the step's
# inputs move by 1e-6 of themselves
FLOOR_TIMES = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _seeded(model, seed):
    return init_weights(model, torch.Generator().manual_seed(seed))


def _rand(seed, *shape):
    a = np.random.default_rng(seed).uniform(0, 1, shape)
    return torch.from_numpy(a.astype(np.float32))


def _close(got, ref, rtol, what):
    got = got.float().cpu()
    err = float((got - ref).abs().max())
    assert err <= rtol * float(ref.abs().max()), (what, err)


FAMILIES = {
    # (generator, discriminator, lq shape, gt shape, restorer kwargs)
    "realbasicvsr": (
        lambda: RealBasicVSRNet(mid_channels=8, num_propagation_blocks=1,
                                num_cleaning_blocks=1),
        lambda: UNetDiscriminatorWithSpectralNorm(mid_channels=8),
        (1, 2, 3, 64, 96), (1, 2, 3, 256, 384),
        dict(gan_loss_weight=5e-2, pixel_loss_weight=1.0,
             cleaning_loss_weight=1.0)),
    "glean": (
        lambda: GLEANStyleGANv2(in_size=4, out_size=8, rrdb_channels=8,
                                num_rrdbs=1, style_channels=8,
                                channel_multiplier=1),
        lambda: StyleGAN2Discriminator(in_size=8, channel_multiplier=1),
        (3, 3, 4, 4), (3, 3, 8, 8),
        dict(gan_loss_weight=1e-2, pixel_loss_weight=1.0)),
    "dic": (
        lambda: DICNet(mid_channels=8, num_blocks=2, hg_mid_channels=16,
                       num_steps=2),
        LightCNN, (2, 3, 16, 16), (2, 3, 128, 128), None),
}


def _grads(restorer, lq, gt):
    """The generator's and the discriminator's gradients of one step's
    losses (the generator's first, with D's weights frozen)."""
    gen, disc = restorer.generator, restorer.discriminator
    for m in (gen, disc):
        m.zero_grad(set_to_none=True)
    disc.requires_grad_(False)
    loss, _, sr = restorer.generator_loss(lq, gt)
    loss.backward()
    disc.requires_grad_(True)
    restorer.disc_loss(sr, gt)[0].backward()
    return {f"{tag}.{k}": None if p.grad is None else p.grad.cpu()
            for tag, m in (("G", gen), ("D", disc))
            for k, p in m.named_parameters()}


def _restorer(name, dev):
    make_g, make_d, _, _, kw = FAMILIES[name]
    gen = _seeded(make_g(), 0).to(dev)
    disc = _seeded(make_d(), 1).to(dev)
    if kw is None:
        rest = GANRestorer(gen, disc)
        rest.generator_loss = _dic_generator_loss(
            gen, disc, GANConfig(disc="lightcnn", gan_loss_weight=5e-3))
        return rest
    return GANRestorer(gen, disc, **kw)


def _deviation(got, ref, tag):
    """(whole, median, worst tensors) relative deviation of one network's
    gradients from another's."""
    diff2 = norm2 = 0.0
    rel = {}
    for k, r in ref.items():
        if not k.startswith(tag + "."):
            continue
        assert (r is None) == (got[k] is None), k
        if r is None:
            continue
        d = float((got[k] - r).norm())
        diff2, norm2 = diff2 + d * d, norm2 + float(r.norm()) ** 2
        rel[k] = d / float(r.norm()) if r.any() else d
    return (diff2 ** 0.5 / norm2 ** 0.5, float(np.median(list(rel.values()))),
            sorted(rel.items(), key=lambda kv: -kv[1])[:4])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_gan_step_gradients_on_the_card_match_the_cpu(cuda, name):
    _, _, lq_shape, gt_shape, _ = FAMILIES[name]
    lq, gt = _rand(2, *lq_shape), _rand(3, *gt_shape)
    ref = _grads(_restorer(name, "cpu"), lq, gt)
    moved = [a * (1 + 1e-6 * torch.from_numpy(np.random.default_rng(4 + i)
             .standard_normal(a.shape).astype(np.float32)))
             for i, a in enumerate((lq, gt))]
    floor_grads = _grads(_restorer(name, "cpu"), *moved)
    before = launch_counts()
    got = _grads(_restorer(name, cuda), lq.to(cuda), gt.to(cuda))
    assert launch_counts() == before
    for tag in ("G", "D"):
        whole, median, worst = _deviation(got, ref, tag)
        floor = _deviation(floor_grads, ref, tag)
        bar = max(GRAD_RTOL, FLOOR_TIMES * floor[0])
        what = (tag, whole, median, worst, "floor", floor)
        assert worst[0][1] <= FLIP_RTOL, what
        assert whole <= bar and median <= bar, what


def test_gan_models_on_the_card_match_the_cpu(cuda):
    cases = [
        (FAMILIES["realbasicvsr"][0], (1, 2, 3, 64, 96), OUT_RTOL),
        (FAMILIES["glean"][0], (3, 3, 4, 4), OUT_RTOL),
        (FAMILIES["dic"][0], (1, 3, 16, 16), DIC_RTOL),
        (FAMILIES["realbasicvsr"][1], (2, 40, 56, 3), OUT_RTOL),
        (FAMILIES["glean"][1], (3, 8, 8, 3), OUT_RTOL),
        (LightCNN, (2, 128, 128, 3), OUT_RTOL),
    ]
    for i, (make, shape, rtol) in enumerate(cases):
        model = _seeded(make(), i).eval()
        x = _rand(i, *shape)
        with torch.no_grad():
            ref = model(x)
            got = model.to(cuda)(x.to(cuda))
        refs = ref[0] + ref[1] if isinstance(ref, tuple) else [ref]
        gots = got[0] + got[1] if isinstance(got, tuple) else [got]
        for r, g in zip(refs, gots):
            _close(g, r, rtol, type(model).__name__)


def test_train_cli_trains_a_tiny_glean_on_the_card(cuda, tmp_path):
    from PIL import Image

    from fcvsr_tpu_torch.train import cli as train_cli
    from fcvsr_tpu_torch.utils.config import preset

    rng = np.random.default_rng(0)
    for i in range(4):
        gt = rng.uniform(0, 255, (32, 32, 3))
        for sub, img in (("gt", gt),
                         ("lr", gt.reshape(16, 2, 16, 2, 3).mean((1, 3)))):
            d = tmp_path / sub / "clip"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(d / f"{i:08d}.png")
    cfg = preset("glean_cat_8x")
    cfg.model.in_size, cfg.model.out_size = 4, 8
    cfg.model.n_feats, cfg.model.num_blocks, cfg.model.num_frames = 8, 1, 3
    cfg.data.lr_patch, cfg.data.batch_size = 4, 2
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    out = train_cli.main(["--config", str(path), "--lr-root",
                          str(tmp_path / "lr"), "--gt-root",
                          str(tmp_path / "gt"), "--work-dir",
                          str(tmp_path / "work"), "--total-iters", "1"])
    assert out["device"] != "cpu" and len(out["ms_per_step"]) == 1
    assert all(np.isfinite(v) for v in out["logs"][0].values())
