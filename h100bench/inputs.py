"""What the benchmark makes from ``--seed``: the weights and the frames.

Both are made on the card by a ``torch.Generator`` seeded from the run's
seed, in a few large calls, so that the same seed gives the same inputs.

* :func:`make_weights`: a state dict with the model's keys, drawn as the
  port's ``init_weights`` draws them (U(+-1/sqrt(fan_in)) for convs and
  their biases, kaiming-normal x 0.1 with zero biases for the convs inside
  SCNet's residual blocks, PReLU slopes 0.25, DivEnh's a = 0 and b = 1),
  from one uniform and one normal draw over all parameters.
* :func:`video`: synthetic 8-bit video, a smooth seeded texture (a sum of
  sinusoids at random frequencies, orientations and phases) under a slow
  global motion, with noise, quantised to 1/255.  ``hr_scale`` renders
  the same scene at 4x, and its LR is the HR's 4x4 box average.
"""

from __future__ import annotations

import math
import re

import torch

__all__ = ["generator", "make_weights", "video", "SUBSEED"]

# one stream per use of the seed, so that adding a use moves no other
SUBSEED = {"weights": 1, "video": 2, "train": 3, "sample": 4}

_SCALED = re.compile(r"^recorb1\.body\.\d+\.body\.\d+\.")


def generator(seed, use, device):
    """A generator on ``device`` seeded from the run's seed and a use."""
    mixed = (int(seed) * 1_000_003 + SUBSEED[use]) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


def make_weights(shapes, seed, device):
    """name -> float32 tensor on ``device`` for every entry of ``shapes``
    (name -> shape, a model's state dict keys)."""
    g = generator(seed, "weights", device)
    names = list(shapes)
    numel = {n: math.prod(shapes[n]) for n in names}
    total = sum(numel.values())
    uni = torch.rand(total, generator=g, device=device) * 2 - 1
    nrm = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for n in names:
        shape, k = tuple(shapes[n]), numel[n]
        u, z = uni[at:at + k].view(shape), nrm[at:at + k].view(shape)
        at += k
        base = n.rsplit(".", 1)[0]
        scaled = bool(_SCALED.match(n))
        if n.endswith(".relu.weight") or n == "lrelu.weight":
            t = torch.full(shape, 0.25, device=device)
        elif n.endswith(".a"):
            t = torch.zeros(shape, device=device)
        elif n.endswith(".b"):
            t = torch.ones(shape, device=device)
        elif n.endswith(".bias"):
            w = shapes[base + ".weight"]
            t = torch.zeros(shape, device=device) if scaled else \
                u * math.prod(w[1:]) ** -0.5
        elif n.endswith(".weight"):
            fan_in = math.prod(shape[1:])
            t = z * ((2.0 / fan_in) ** 0.5 * 0.1) if scaled else \
                u * fan_in ** -0.5
        else:
            raise KeyError(f"no rule draws {n}")
        out[n] = t.contiguous()
    return out


def video(g, clips, frames, h, w, channels=1, hr_scale=1, n_waves=24):
    """(clips, frames, channels, h * hr_scale, w * hr_scale) uint8 frames of
    ``clips`` independent scenes, on ``g``'s device; with ``hr_scale`` > 1
    also their LR, the HR's box average (clips, frames, channels, h, w).
    The scene moves by 0.2 to 1.5 LR pixels a frame."""
    dev = g.device
    s = hr_scale
    shape = (clips, 1, channels, n_waves)
    freq = torch.exp(torch.empty(shape, device=dev).uniform_(
        math.log(1 / 160), math.log(1 / 6), generator=g))
    ang = torch.rand(shape, generator=g, device=dev) * (2 * math.pi)
    phase = torch.rand(shape, generator=g, device=dev) * (2 * math.pi)
    amp = (freq * 6) ** -0.5
    amp = amp / amp.square().sum(-1, keepdim=True).sqrt()
    speed = torch.empty((clips, 1, 1, 1), device=dev).uniform_(
        0.2, 1.5, generator=g)
    heading = torch.rand((clips, 1, 1, 1), generator=g, device=dev) * (
        2 * math.pi)
    t = torch.arange(frames, device=dev, dtype=torch.float32)[None, :, None,
                                                              None]
    ox, oy = speed * torch.cos(heading) * t, speed * torch.sin(heading) * t
    # LR pixel coordinates of the HR pixel centres
    ys = (torch.arange(h * s, device=dev, dtype=torch.float32) + 0.5) / s
    xs = (torch.arange(w * s, device=dev, dtype=torch.float32) + 0.5) / s
    fx, fy = freq * torch.cos(ang), freq * torch.sin(ang)
    img = torch.zeros((clips, frames, channels, h * s, w * s), device=dev)
    for k in range(n_waves):
        # phase of wave k at frame t: 2 pi (fx (x - ox) + fy (y - oy)) + p
        p0 = (2 * math.pi) * (-(fx[..., k, None, None] * ox[..., None])
                              - fy[..., k, None, None] * oy[..., None]) \
            + phase[..., k, None, None]
        px = (2 * math.pi) * fx[..., k, None, None] * xs
        py = (2 * math.pi) * fy[..., k, None, None] * ys[:, None]
        img += amp[..., k, None, None] * torch.sin(px + py + p0)
    img = 0.5 + 0.3 * img
    noise = torch.randn(img.shape, generator=g, device=dev) * (2 / 255)
    hr = _quantise(img + noise)
    if s == 1:
        return hr
    lr = torch.nn.functional.avg_pool2d(
        img.reshape(-1, 1, h * s, w * s), s).reshape(clips, frames, channels,
                                                     h, w)
    lr_noise = torch.randn(lr.shape, generator=g, device=dev) * (2 / 255)
    return hr, _quantise(lr + lr_noise)


def _quantise(x):
    return torch.round(x.clamp(0, 1) * 255).to(torch.uint8)
