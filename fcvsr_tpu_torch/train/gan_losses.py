"""GAN, perceptual and gradient losses (counterpart of
``fcvsr_tpu.train.gan_losses``; mmedit models/losses/{gan_loss.py,
perceptual_loss.py, gradient_loss.py}), NHWC images.

The VGG feature extractor keeps torchvision's ``vgg19.features`` indices
(``features.N``), so mmedit's ``layer_weights={'34': 1.0}`` configs keep
their meaning.  No VGG weights ship with the repository: it starts from
seeded random weights unless an ``.npz`` of ``features.N.weight`` /
``.bias`` (torch layout) is loaded with :func:`load_vgg_npz`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.blocks import Conv2d

__all__ = [
    "gan_loss", "disc_shift_loss", "gradient_penalty_loss", "gradient_loss",
    "VGGFeatureExtractor", "perceptual_loss", "transferal_perceptual_loss",
    "load_vgg_npz",
]


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_type: str,
             real_label_val: float = 1.0, fake_label_val: float = 0.0,
             loss_weight: float = 1.0, is_disc: bool = False) -> torch.Tensor:
    """mmedit's GANLoss: vanilla (BCE with logits), lsgan, wgan or hinge.
    ``loss_weight`` applies to the generator's loss only, as in the
    reference."""
    if gan_type == "wgan":
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == "hinge":
        if is_disc:
            pred = -pred if target_is_real else pred
            loss = F.relu(1 + pred).mean()
        else:
            loss = -pred.mean()
    else:
        target = torch.full_like(
            pred, real_label_val if target_is_real else fake_label_val)
        if gan_type == "vanilla":
            loss = (torch.clamp(pred, min=0) - pred * target
                    + torch.log1p(torch.exp(-pred.abs()))).mean()
        elif gan_type == "lsgan":
            loss = ((pred - target) ** 2).mean()
        else:
            raise NotImplementedError(f"GAN type {gan_type}")
    return loss if is_disc else loss * loss_weight


def disc_shift_loss(pred: torch.Tensor, loss_weight: float = 0.1):
    """mean(pred^2) times the weight."""
    return (pred ** 2).mean() * loss_weight


def gradient_penalty_loss(disc_fn, real_data: torch.Tensor,
                          fake_data: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          loss_weight: float = 1.0,
                          generator: Optional[torch.Generator] = None,
                          alpha: Optional[torch.Tensor] = None):
    """WGAN-GP: the gradient norm of ``disc_fn`` at random interpolates of
    the real and fake data, driven to 1.  The interpolation weights
    (one a sample) are ``alpha`` when given, else drawn uniform from
    ``generator`` (on the CPU)."""
    if alpha is None:
        shape = (real_data.shape[0],) + (1,) * (real_data.dim() - 1)
        alpha = torch.rand(shape, generator=generator)
    alpha = alpha.to(real_data)
    interp = (alpha * real_data + (1 - alpha) * fake_data).detach()
    interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(interp).sum(), interp,
                                   create_graph=True)
    if mask is not None:
        grads = grads * mask
    norm = torch.sqrt((grads ** 2).sum(tuple(range(1, grads.dim()))) + 1e-12)
    return ((norm - 1.0) ** 2).mean() * loss_weight


_SOBEL_X = ((1, 0, -1), (2, 0, -2), (1, 0, -1))
_SOBEL_Y = ((1, 2, 1), (0, 0, 0), (-1, -2, -1))


def gradient_loss(pred: torch.Tensor, target: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  loss_weight: float = 1.0, reduction: str = "mean"):
    """L1 between the Sobel gradients (x and y, per channel, zero padded)
    of ``pred`` and ``target``, NHWC."""
    c = pred.shape[-1]

    def grad2d(x, k):
        kern = torch.tensor(k, dtype=x.dtype, device=x.device)
        kern = kern.expand(c, 1, 3, 3)
        return F.conv2d(x.permute(0, 3, 1, 2), kern, padding=1,
                        groups=c).permute(0, 2, 3, 1)

    def l1(a, b):
        d = (a - b).abs()
        if weight is not None:
            d = d * weight
        if reduction == "mean":
            return d.mean()
        return d.sum() if reduction == "sum" else d

    loss = l1(grad2d(pred, _SOBEL_X), grad2d(target, _SOBEL_X)) + \
        l1(grad2d(pred, _SOBEL_Y), grad2d(target, _SOBEL_Y))
    return loss * loss_weight


# torchvision's vgg19.features: 3x3 conv widths, "M" a 2x2 max pool
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _vgg19_layers():
    """[(torchvision index, kind, channels)] of vgg19.features."""
    layers, idx = [], 0
    for v in _VGG19_CFG:
        if v == "M":
            layers.append((idx, "pool", None))
            idx += 1
        else:
            layers += [(idx, "conv", v), (idx + 1, "relu", None)]
            idx += 2
    return layers


class VGGFeatureExtractor(nn.Module):
    """The VGG19 prefix up to the deepest layer named in
    ``layer_name_list`` (torchvision indices as strings), returning those
    activations by name.  Input (B, H, W, 3) in [0, 1], ImageNet-normalised
    inside with ``use_input_norm``.  Convs are ``features.N``."""

    def __init__(self, layer_name_list: Sequence[str] = ("34",),
                 use_input_norm: bool = True):
        super().__init__()
        self.wanted = set(layer_name_list)
        self.use_input_norm = use_input_norm
        self.max_idx = max(int(k) for k in self.wanted)
        self.features = nn.ModuleDict()
        cin = 3
        for idx, kind, ch in _vgg19_layers():
            if idx > self.max_idx:
                break
            if kind == "conv":
                self.features[str(idx)] = Conv2d(cin, ch, 3)
                cin = ch
        self.register_buffer("mean", torch.tensor((0.485, 0.456, 0.406)),
                             persistent=False)
        self.register_buffer("std", torch.tensor((0.229, 0.224, 0.225)),
                             persistent=False)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        out = {}
        for idx, kind, _ in _vgg19_layers():
            if idx > self.max_idx:
                break
            if kind == "conv":
                x = self.features[str(idx)](x)
            elif kind == "relu":
                x = F.relu(x)
            else:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            if str(idx) in self.wanted:
                out[str(idx)] = x
        return out


def load_vgg_npz(path: str, vgg: VGGFeatureExtractor) -> VGGFeatureExtractor:
    """Load torchvision-keyed ``features.N.weight`` / ``.bias`` arrays
    (OIHW, the port's own layout) from an ``.npz`` into ``vgg``; entries
    deeper than its last layer are skipped, a missing one raises."""
    with np.load(path) as data:
        sd = {k: torch.from_numpy(np.asarray(data[k], np.float32))
              for k in data.files if k.startswith("features.")
              and k.split(".")[1] in vgg.features}
    vgg.load_state_dict(sd, strict=True)
    return vgg


def _gram(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    f = x.reshape(b, h * w, c)
    return torch.einsum("bpc,bpd->bcd", f, f) / (c * h * w)


def perceptual_loss(vgg: VGGFeatureExtractor, x: torch.Tensor,
                    gt: torch.Tensor, layer_weights: Dict[str, float],
                    perceptual_weight: float = 1.0,
                    style_weight: float = 0.0, norm_img: bool = False,
                    criterion: str = "l1"):
    """mmedit's PerceptualLoss: (perceptual loss or None, style loss or
    None) over VGG features of ``x`` and of ``gt`` (detached), NHWC."""
    if norm_img:
        x, gt = (x + 1) * 0.5, (gt + 1) * 0.5
    xf, gf = vgg(x), vgg(gt.detach())

    def crit(a, b):
        d = a - b
        return d.abs().mean() if criterion == "l1" else (d * d).mean()

    percep = style = None
    if perceptual_weight > 0:
        percep = sum(crit(xf[k], gf[k]) * w
                     for k, w in layer_weights.items()) * perceptual_weight
    if style_weight > 0:
        style = sum(crit(_gram(xf[k]), _gram(gf[k])) * w
                    for k, w in layer_weights.items()) * style_weight
    return percep, style


def transferal_perceptual_loss(maps: Sequence[torch.Tensor],
                               soft_attention: torch.Tensor,
                               textures: Sequence[torch.Tensor],
                               use_attention: bool = True,
                               criterion: str = "mse",
                               loss_weight: float = 1.0) -> torch.Tensor:
    """TTSR's transferal perceptual loss, NHWC: each scale's features
    against the transferred textures (detached), weighted by the soft
    attention (B, H, W, 1) upsampled (nearest) to the scale."""
    loss = 0.0
    for i, (m, t) in enumerate(zip(maps, textures)):
        d = m - t.detach()
        if use_attention:
            a = soft_attention
            if i:
                a = a.repeat_interleave(2 ** i, 1).repeat_interleave(2 ** i, 2)
            d = d * a
        loss = loss + ((d * d).mean() if criterion == "mse"
                       else d.abs().mean())
    return loss * loss_weight
