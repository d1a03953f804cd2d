"""Backbone and loss registries (counterpart of
``fcvsr_tpu.models.registry``): ``build(BACKBONES, dict(type='EDVRNet',
mid_channels=64))`` builds a model from an mmedit-style config;
``LOSSES.get('L1Loss')`` is a loss function, and ``build(LOSSES, cfg)``
calls it with the config's other keys, as the JAX package's ``build``
does.  Both hold the JAX package's names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from .basicvsr import BasicVSRNet
from .basicvsr_pp import BasicVSRPlusPlus
from .dic import DICNet, FeedbackHourglass
from .discriminators import (LightCNN, ModifiedVGG,
                             UNetDiscriminatorWithSpectralNorm,
                             light_cnn_feature_loss)
from .edvr import EDVRNet
from .fcvsr import FCVSRNet
from .fcvsr_tfdc import FCVSRTFDCNet
from .ftvsr import FTVSRNet, TTVSRNet
from .glean import GLEANStyleGANv2
from .iconvsr import IconVSR, TDANNet
from .liif import LIIFEDSR, LIIFRDN
from .raft import RAFT
from .real_basicvsr import RealBasicVSRNet
from .sidecvsr import SIDECVSR
from .sisr import EDSR, RDN, SRCNN, MSRResNet, RRDBNet, TOFlow
from .spynet import SpyNet
from .stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
from .ttsr import TTSR, TTSRNet
from ..train import gan_losses as GL
from ..train import losses as L

__all__ = ["Registry", "BACKBONES", "LOSSES", "build"]


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register_obj(self, name: str, obj):
        self._entries[name] = obj
        return obj

    def get(self, name: str):
        if name not in self._entries:
            raise KeyError(f"{self.name} registry has no '{name}'; "
                           f"known: {sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name):
        return name in self._entries

    def keys(self):
        return sorted(self._entries)


def build(registry: Registry, cfg: dict) -> Any:
    """``cfg['type']`` names the entry; the other keys are its arguments."""
    cfg = dict(cfg)
    return registry.get(cfg.pop("type"))(**cfg)


BACKBONES = Registry("backbones")
for _cls in (FCVSRNet, EDVRNet, BasicVSRNet, BasicVSRPlusPlus, IconVSR,
             TDANNet, SpyNet, FTVSRNet):
    BACKBONES.register_obj(_cls.__name__, _cls)
BACKBONES.register_obj("TTVSRNet", TTVSRNet)
for _cls in (EDSR, MSRResNet, RDN, RRDBNet, SRCNN, TOFlow,
             FCVSRTFDCNet, RAFT, SIDECVSR, DICNet, FeedbackHourglass,
             LIIFEDSR, LIIFRDN, TTSR, TTSRNet, GLEANStyleGANv2,
             RealBasicVSRNet, StyleGAN2Generator,
             StyleGAN2Discriminator, ModifiedVGG, LightCNN,
             UNetDiscriminatorWithSpectralNorm):
    BACKBONES.register_obj(_cls.__name__, _cls)
BACKBONES.register_obj("FCVSR_SNet", FCVSRNet.small)
# the CVCP names of FCVSR on Y
BACKBONES.register_obj("GShiftNet",
                       lambda **kw: FCVSRNet(in_channels=1, **kw))
BACKBONES.register_obj("GShiftNet_S",
                       lambda **kw: FCVSRNet.small(in_channels=1, **kw))

LOSSES = Registry("losses")
for _name, _fn in (("CharbonnierLoss", L.charbonnier),
                   ("CharbonnierLossSum", L.charbonnier_sum),
                   ("L1Loss", L.l1_loss), ("MSELoss", L.mse_loss),
                   ("GANLoss", GL.gan_loss),
                   ("GradientLoss", GL.gradient_loss),
                   ("DiscShiftLoss", GL.disc_shift_loss),
                   ("GradientPenaltyLoss", GL.gradient_penalty_loss),
                   ("PerceptualLoss", GL.perceptual_loss),
                   ("TransferalPerceptualLoss", GL.transferal_perceptual_loss),
                   ("LightCNNFeatureLoss", light_cnn_feature_loss)):
    LOSSES.register_obj(_name, _fn)
