"""LPIPS v0.1 with the AlexNet backbone (counterpart of
``fcvsr_tpu.metrics.lpips``): the ImageNet-shifted input through AlexNet's
five conv stages (a 3 x 3 stride-2 max-pool after the first two), each
stage's relu features unit-normalised per position over the channels, the
two images' squared differences through a 1 x 1 ``lin{i}`` head without
bias, averaged over space and summed over the stages.

The released weights (torchvision's ``alexnet.features`` and the lpips
package's v0.1 linear heads) are not bundled: :func:`load_torch_lpips_weights`
loads them from their state dicts, checking every shape.  Without them the
module runs on its random init.  It is built on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["LPIPSAlex", "lpips_distance", "load_torch_lpips_weights"]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# AlexNet's conv stages: (out channels, kernel, stride, padding)
_ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
         (256, 3, 1, 1))
# torchvision's alexnet.features index of each conv stage
_TORCHVISION = ("0", "3", "6", "8", "10")


class _AlexFeatures(nn.Module):
    """AlexNet's conv trunk (``conv0`` .. ``conv4``); returns the five relu
    feature maps that LPIPS taps."""

    def __init__(self, device=None):
        super().__init__()
        cin = 3
        for i, (cout, k, s, p) in enumerate(_ALEX):
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, k, s, p,
                                                  device=device))
            cin = cout

    def forward(self, x):
        feats = []
        for i in range(len(_ALEX)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPSAlex(nn.Module):
    """LPIPS v0.1, AlexNet backbone: ``forward(x, y)`` on (B, 3, H, W)
    images in [-1, 1] gives the (B,) distances."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.net = _AlexFeatures(device)
        for i, (c, *_) in enumerate(_ALEX):
            self.add_module(f"lin{i}", nn.Conv2d(c, 1, 1, bias=False,
                                                 device=device))
        self.register_buffer("shift", torch.tensor(
            _SHIFT, device=device).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(
            _SCALE, device=device).view(1, 3, 1, 1), persistent=False)

    def forward(self, x, y):
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            an = a / a.norm(dim=1, keepdim=True).clamp_min(1e-10)
            bn = b / b.norm(dim=1, keepdim=True).clamp_min(1e-10)
            lin = getattr(self, f"lin{i}")((an - bn).square())
            total = total + lin.mean((1, 2, 3))
        return total


def lpips_distance(model: LPIPSAlex, img1_01, img2_01) -> torch.Tensor:
    """The LPIPS distances of (B, 3, H, W) images in [0, 1] (tensors or
    arrays), computed on the model's device."""
    dev = next(model.parameters()).device
    a = torch.as_tensor(img1_01, dtype=torch.float32, device=dev)
    b = torch.as_tensor(img2_01, dtype=torch.float32, device=dev)
    return model(a * 2 - 1, b * 2 - 1)


def load_torch_lpips_weights(backbone_state, lin_state,
                             model: LPIPSAlex) -> LPIPSAlex:
    """Load the official lpips package's weights into ``model``:
    ``backbone_state`` is torchvision's ``alexnet.features`` state dict
    (``0.weight`` .. ``10.bias``), ``lin_state`` the linear heads
    (``lin{i}.model.1.weight``).  Every shape is checked (``ValueError``)
    and the load is strict."""
    sd = {}
    for i, tk in enumerate(_TORCHVISION):
        for leaf in ("weight", "bias"):
            sd[f"net.conv{i}.{leaf}"] = backbone_state[f"{tk}.{leaf}"]
        sd[f"lin{i}.weight"] = lin_state[f"lin{i}.model.1.weight"]
    own = model.state_dict()
    for key, value in sd.items():
        value = torch.as_tensor(value, dtype=torch.float32)
        if value.shape != own[key].shape:
            raise ValueError(f"{key}: {tuple(value.shape)} vs "
                             f"{tuple(own[key].shape)}")
        sd[key] = value
    model.load_state_dict(sd, strict=True)
    return model
