"""The GAN restorers' training step (counterpart of
``fcvsr_tpu.models.gan_restorer``; mmedit restorers/srgan.py,
real_basicvsr.py, esrgan.py, glean.py, dic.py).

One :meth:`GANRestorer.make_train_step` step, in the JAX package's order:

1. the generator's loss (pixel L1, RealBasicVSR's cleaning loss on the
   area-downsampled GT, an optional perceptual / style loss, and the GAN
   loss through the discriminator's current weights) and its gradient;
2. the generator's update, unless the step is gated (``counter %
   disc_steps != 0`` or ``counter < disc_init_steps``): a gated step
   leaves the generator and its Adam (moments and step count) untouched;
3. the discriminator's update, on the generator's output from *before*
   its update (detached) and the GT.

The discriminator's parameters take no gradient from the generator's loss
(``requires_grad`` is off while it runs).  ``relativistic`` is ESRGAN's
relativistic discriminator.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..train.gan_losses import VGGFeatureExtractor, gan_loss, perceptual_loss

__all__ = ["GANRestorer", "area_downsample", "dic_losses"]


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch's ``F.interpolate(mode='area')`` at an integer factor: the mean
    of each factor x factor block, (..., H, W, C)."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, h // factor, factor, w // factor, factor, c)
    return y.mean((-4, -2))


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) or (B, C, H, W) -> (N, H, W, C) frames."""
    if x.dim() == 5:
        b, t, c, h, w = x.shape
        x = x.reshape(b * t, c, h, w)
    return x.permute(0, 2, 3, 1)


class GANRestorer:
    """A generator (``forward(lq)`` -> SR, or (SR, cleaned LQ) with
    ``return_lqs`` when ``cleaning_loss_weight > 0``), a discriminator over
    NHWC frames (None: generator-only training, the ``wogan`` stage) and
    the recipe.  ``counter`` counts the steps taken.

    ``generator_loss`` may be replaced by a function ``(lq, gt) -> (loss,
    logs, sr frames)`` (the training CLI does so for DIC, as the JAX CLI
    does)."""

    def __init__(self, generator: nn.Module,
                 discriminator: Optional[nn.Module] = None,
                 gan_type: str = "vanilla", gan_loss_weight: float = 5e-3,
                 pixel_loss_weight: float = 1e-2,
                 cleaning_loss_weight: float = 0.0,
                 perceptual: Optional[VGGFeatureExtractor] = None,
                 perceptual_layer_weights: Optional[Dict[str, float]] = None,
                 perceptual_weight: float = 1.0, style_weight: float = 0.0,
                 disc_steps: int = 1, disc_init_steps: int = 0,
                 relativistic: bool = False):
        self.generator, self.discriminator = generator, discriminator
        self.gan_type = gan_type
        self.gan_loss_weight = gan_loss_weight
        self.pixel_loss_weight = pixel_loss_weight
        self.cleaning_loss_weight = cleaning_loss_weight
        self.perceptual = perceptual
        self.perceptual_layer_weights = perceptual_layer_weights or {"34": 1.0}
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.disc_steps, self.disc_init_steps = disc_steps, disc_init_steps
        self.relativistic = relativistic
        self.counter = 0

    def generator_loss(self, lq, gt):
        """(loss, logs, the SR frames (N, H, W, C) detached)."""
        if self.cleaning_loss_weight > 0:
            out, cleaned = self.generator(lq, return_lqs=True)
        else:
            out, cleaned = self.generator(lq), None
        sr, gt_f = _frames(out), _frames(gt)
        logs, loss = {}, 0.0
        if self.pixel_loss_weight > 0:
            lp = (sr - gt_f).abs().mean() * self.pixel_loss_weight
            loss, logs["loss_pix"] = loss + lp, lp
        if cleaned is not None:
            lc = (_frames(cleaned) - area_downsample(gt_f, 4)).abs().mean() \
                * self.cleaning_loss_weight
            loss, logs["loss_clean"] = loss + lc, lc
        if self.perceptual is not None:
            lp, ls = perceptual_loss(
                self.perceptual, sr, gt_f, self.perceptual_layer_weights,
                perceptual_weight=self.perceptual_weight,
                style_weight=self.style_weight)
            if lp is not None:
                loss, logs["loss_perceptual"] = loss + lp, lp
            if ls is not None:
                loss, logs["loss_style"] = loss + ls, ls
        if self.discriminator is not None:
            fake_pred = self.discriminator(sr)
            if self.relativistic:
                real_pred = self.discriminator(gt_f).detach()
                lg = (gan_loss(real_pred - fake_pred.mean(), False,
                               self.gan_type,
                               loss_weight=self.gan_loss_weight)
                      + gan_loss(fake_pred - real_pred.mean(), True,
                                 self.gan_type,
                                 loss_weight=self.gan_loss_weight)) / 2
            else:
                lg = gan_loss(fake_pred, True, self.gan_type,
                              loss_weight=self.gan_loss_weight)
            loss, logs["loss_gan"] = loss + lg, lg
        return loss, logs, sr.detach()

    def disc_loss(self, sr_detached, gt):
        """(loss, logs) of the discriminator on the GT and the SR frames."""
        gt_f = _frames(gt)
        real_pred = self.discriminator(gt_f)
        fake_pred = self.discriminator(sr_detached)
        if self.relativistic:
            # each term detaches the other prediction's mean, as esrgan.py
            ld_real = gan_loss(real_pred - fake_pred.detach().mean(), True,
                               self.gan_type, is_disc=True) * 0.5
            ld_fake = gan_loss(fake_pred - real_pred.detach().mean(), False,
                               self.gan_type, is_disc=True) * 0.5
        else:
            ld_real = gan_loss(real_pred, True, self.gan_type, is_disc=True)
            ld_fake = gan_loss(fake_pred, False, self.gan_type, is_disc=True)
        return ld_real + ld_fake, {"loss_d_real": ld_real,
                                   "loss_d_fake": ld_fake}

    def make_train_step(self, g_opt: torch.optim.Optimizer,
                        d_opt: Optional[torch.optim.Optimizer] = None
                        ) -> Callable:
        """``step(lq, gt) -> logs`` (detached scalars): one generator and one
        discriminator update of the optimisers' parameters, as above."""
        disc = self.discriminator

        def step(lq, gt) -> Dict[str, torch.Tensor]:
            run_g = self.counter % self.disc_steps == 0 and \
                self.counter >= self.disc_init_steps
            if disc is not None:
                disc.requires_grad_(False)
            g_opt.zero_grad(set_to_none=True)
            with torch.set_grad_enabled(run_g):
                g_loss, logs, sr = self.generator_loss(lq, gt)
            if run_g:
                g_loss.backward()
                g_opt.step()
            if disc is not None:
                disc.requires_grad_(True)
                d_opt.zero_grad(set_to_none=True)
                d_loss, d_logs = self.disc_loss(sr, gt)
                d_loss.backward()
                d_opt.step()
                logs = dict(logs, **d_logs, loss_d=d_loss)
            self.counter += 1
            logs = dict(logs, loss_g=g_loss)
            return {k: torch.as_tensor(v).detach() for k, v in logs.items()}

        return step


def dic_losses(sr_list, heatmap_list, gt, gt_heatmap, pixel_loss=None):
    """DIC's multi-step supervision: every step's SR against the GT and its
    landmark heatmaps against the GT heatmaps (L1 unless ``pixel_loss``).
    Returns (total, logs)."""
    crit = pixel_loss or (lambda a, b: (a - b).abs().mean())
    logs, loss_pix, loss_align = {}, 0.0, 0.0
    for step, (sr, hm) in enumerate(zip(sr_list, heatmap_list)):
        lp, la = crit(sr, gt), crit(hm, gt_heatmap)
        logs[f"loss_pixel_v{step}"] = lp
        logs[f"loss_align_v{step}"] = la
        loss_pix, loss_align = loss_pix + lp, loss_align + la
    return loss_pix + loss_align, logs
