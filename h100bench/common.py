"""Pieces the traffic kinds share: the model built from a configuration and
the benchmark's weights, the seeded sample of served frames, and the
comparison of served frames with the reference."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs
from .reference import fcvsr as ref

__all__ = ["TOPOLOGY", "topology", "build_model", "Reservoir",
           "frame_errors", "reference_frames", "window_indices",
           "precision"]

# the configuration keys FCVSRNet takes (corr_radius is MGAA's own 4)
TOPOLOGY = ("n_feats", "in_channels", "num_frames", "ac_num", "freq_inv",
            "sc_groups", "up_ksize")


def topology(cfg):
    """The reference forward's keywords."""
    return {k: cfg[k] for k in ("ac_num", "freq_inv", "sc_groups",
                                "up_ksize")}


def build_model(cfg, weights, device):
    """FCVSRNet with the configuration's widths and serving flags, the
    benchmark's weights copied in, on ``device``."""
    from fcvsr_tpu_torch.models.fcvsr import FCVSRNet

    model = FCVSRNet(**{k: cfg[k] for k in TOPOLOGY},
                     **cfg["serving_flags"]).to(device)
    model.load_state_dict(weights)
    return model


def weight_shapes(cfg):
    """The state dict's shapes, from a model built on the meta device."""
    from fcvsr_tpu_torch.models.fcvsr import FCVSRNet

    with torch.device("meta"):
        model = FCVSRNet(**{k: cfg[k] for k in TOPOLOGY})
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def make_weights(cfg, seed, device):
    return inputs.make_weights(weight_shapes(cfg), seed, device)


class precision:
    """Context: TF32 on or off for cuDNN's convolutions and cuBLAS's
    products, restored on exit."""

    def __init__(self, tf32):
        self.tf32 = tf32

    def __enter__(self):
        self._old = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self._old


class Reservoir:
    """A uniform sample of ``k`` of the frames served, drawn from the seed
    (reservoir sampling): ``offer`` each frame's key in serving order, and
    keep its output when ``offer`` says so."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng([int(seed) % 2 ** 63,
                                          inputs.SUBSEED["sample"]])
        self.seen = 0
        self.kept = {}   # slot -> (key, output)

    def offer(self, key):
        """The slot the frame takes, or None."""
        n = self.seen
        self.seen += 1
        if n < self.k:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None

    def keep(self, slot, key, out):
        self.kept[slot] = (key, out)

    def items(self):
        return [self.kept[s] for s in sorted(self.kept)]


def window_indices(center, frames, window=7):
    """The frames of ``center``'s window in a clip of ``frames``, its edges
    replicated."""
    half = window // 2
    return [min(max(i, 0), frames - 1)
            for i in range(center - half, center + half + 1)]


@torch.no_grad()
def reference_frames(weights, cfg, windows, device, tf32=False):
    """The reference's restored frames, (H, W) windows of uint8 frames in:
    each (7, H, W, C) window is scaled to [0, 1], zero-padded bottom and
    right to a multiple of 4, restored, cropped to (4H, 4W); returns
    (4H, 4W, C) float32 numpy frames.  One window at a time, in the
    configuration's precision (``tf32`` for the control)."""
    outs = []
    with precision(tf32):
        for win in windows:
            t, h, w, c = win.shape
            x = torch.from_numpy(np.ascontiguousarray(win)).to(device)
            x = x.permute(0, 3, 1, 2).float().div(255.0)[None]
            x = torch.nn.functional.pad(x, (0, -w % 4, 0, -h % 4))
            y = ref.forward(weights, x, **topology(cfg))[0]
            outs.append(y[:, :4 * h, :4 * w].permute(1, 2, 0).cpu().numpy())
    return outs


def frame_errors(served, reference):
    """max_err: the largest |served - reference| over the frames; rms_err:
    the root mean square of the difference, in [0, 1] units."""
    mx, sq, n = 0.0, 0.0, 0
    for a, b in zip(served, reference):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        if not np.all(np.isfinite(d)):
            return {"max_err": math.inf, "rms_err": math.inf}
        mx = max(mx, float(np.abs(d).max()))
        sq += float(np.square(d).sum())
        n += d.size
    return {"max_err": mx, "rms_err": math.sqrt(sq / max(n, 1))}
