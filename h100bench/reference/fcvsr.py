"""FCVSR and FCVSR-S in plain PyTorch: the benchmark's frozen reference.

A functional forward over a state dict with the reference checkpoint keys
(``feat_extract.0.weight``, ``MGAA.F.1.weight``, ``recorb1.body.0...``),
NCHW throughout, every operation a plain ``torch`` call in the caller's
precision.  It follows the released model (QZ1-boy/FCVSR,
``mmedit/models/backbones/sr_backbones/fcvsr_net.py``) with the behaviours
its checkpoints were trained with:

* SAC applies the first kernel half in both passes (the second half of
  ``F.1``'s output is never read);
* the forward correlation feature conditions both offset directions, with
  CorrBlock's raw reinterpretation of the (C, H*W) product as
  (H, W, C/2, 2) and zero flow features;
* ``DivEnh.Conv`` is defined and never called;
* SCNet's cross-scale exchange adds the top level's own body output twice
  and the bottom level's twice (its down/up lists are padded with them).

Nothing here imports the measured program: the benchmark hands the same
weights and frames to both.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["forward", "band_masks", "SMALL", "FULL"]

# the two configurations' topology (the FCVSRNet keywords that differ)
FULL = dict(ac_num=6, freq_inv=8, sc_groups=10, up_ksize=3)
SMALL = dict(ac_num=3, freq_inv=4, sc_groups=4, up_ksize=1)


def _conv(x, sd, name, stride=1):
    w = sd[name + ".weight"]
    return F.conv2d(x, w, sd.get(name + ".bias"), stride, w.shape[-1] // 2)


def _prelu(x, sd, name):
    return F.prelu(x, sd[name + ".weight"])


def _ca(x, sd, name):
    """Squeeze-and-excite: x * sigmoid(W2 relu(W1 mean_hw(x)))."""
    y = x.mean((2, 3), keepdim=True)
    y = torch.sigmoid(_conv(F.relu(_conv(y, sd, name + ".conv_du.0")), sd,
                            name + ".conv_du.2"))
    return x * y


def _conv_blk(x, sd, name):
    out = _conv(_prelu(_conv(x, sd, name + ".conv1"), sd, name + ".relu"),
                sd, name + ".conv2")
    return _ca(out, sd, name + ".CA") + out


def _seq(x, sd, name, idx, act=F.relu):
    """Convs ``name.<i>`` for i in ``idx``, ``act`` between them."""
    for n, i in enumerate(idx):
        x = _conv(x, sd, f"{name}.{i}")
        if n + 1 < len(idx):
            x = act(x)
    return x


def _spectrum(x):
    """rfft2 (norm 'backward') packed as [imag, real] on channels."""
    f = torch.fft.rfft2(x, norm="backward")
    return torch.cat([f.imag, f.real], 1)


def _corr(f1, f2, radius=4):
    """CorrBlock of the released model: the product's contiguous (C, H*W)
    buffer read as (H, W, C/2, 2); pixel (h, w) samples its own (C/2, 2)
    map at (h + q % n - r, w + q // n - r), zeros outside."""
    b, c, h, w = f1.shape
    prod = (f1 * f2 / math.sqrt(c)).contiguous().reshape(b, h, w, c // 2, 2)
    n = 2 * radius + 1
    hh = torch.arange(h, device=f1.device)[:, None]
    ww = torch.arange(w, device=f1.device)[None, :]
    out = []
    for q in range(n * n):
        ii = hh + (q % n - radius)
        jj = ww + (q // n - radius)
        valid = (ii >= 0) & (ii < c // 2) & (jj >= 0) & (jj < 2)
        v = prod[:, hh, ww, ii.clamp(0, c // 2 - 1), jj.clamp(0, 1)]
        out.append(v * valid.to(v.dtype))
    return torch.stack(out, 1)


def _warp(x, flow):
    """Bilinear sampling of x at (x + dx, y + dy), zeros outside (the
    released ``flow_warp``: grid_sample, align_corners=True)."""
    b, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype),
                            torch.arange(w, device=x.device, dtype=x.dtype),
                            indexing="ij")
    px = gx + flow[:, 0]
    py = gy + flow[:, 1]
    grid = torch.stack([2.0 * px / max(w - 1, 1) - 1.0,
                        2.0 * py / max(h - 1, 1) - 1.0], -1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def _sac(x, taps):
    """Separable adaptive 3-tap filter, vertical then horizontal, the same
    per-pixel taps in both passes, replicate borders."""
    h, w = x.shape[2:]
    p = F.pad(x, (0, 0, 1, 1), mode="replicate")
    x = sum(p[:, :, t:t + h] * taps[t] for t in range(3))
    p = F.pad(x, (1, 1, 0, 0), mode="replicate")
    return sum(p[:, :, :, t:t + w] * taps[t] for t in range(3))


def _iac(feat_in, k, flows, ac_num, d):
    """ac_num iterations of lrelu_0.1(SAC(warp(cur, flow_i)) + feat_in)."""
    cur = feat_in
    for i in range(ac_num):
        ki = k[:, i * 3 * d:(i + 1) * 3 * d]
        taps = [ki[:, t * d:(t + 1) * d] for t in range(3)]
        cur = F.leaky_relu(_sac(_warp(cur, flows[i]), taps) + feat_in, 0.1)
    return cur


def _mgaa(x, sd, ac_num, name="MGAA"):
    d = x.shape[1] // 3
    h, w = x.shape[2:]
    x1, x2, x3 = x[:, :d], x[:, d:2 * d], x[:, 2 * d:]
    x1f, x2f, x3f = _spectrum(x1), _spectrum(x2), _spectrum(x3)
    fuse = [0, 2, 4]
    off_f = (x1f - x2f) + _seq(torch.cat([x1f, x2f], 1), sd,
                               name + ".convfuse", fuse)
    off_b = (x3f - x2f) + _seq(torch.cat([x3f, x2f], 1), sd,
                               name + ".convfuse", fuse)
    sim = _seq(x2f, sd, name + ".convcrt", [0, 2])
    corr = _corr(x1f, x2f)
    zero = off_f.new_zeros((off_f.shape[0], 2) + off_f.shape[2:])
    off_f = _seq(torch.cat([off_f, corr, zero], 1), sd, name + ".convcorr",
                 fuse)
    off_b = _seq(torch.cat([off_b, corr, zero], 1), sd, name + ".convcorr",
                 fuse)
    flows_f, flows_b = [], []
    for i in range(ac_num):
        for off, flows in ((off_f, flows_f), (off_b, flows_b)):
            g = _conv_blk(off, sd, f"{name}.MConvB.{i}") * sim
            spec = torch.complex(g[:, :2], g[:, 2:])
            flows.append(torch.fft.irfft2(spec, s=(h, w), norm="backward"))
    f0 = _conv(_conv(x2, sd, name + ".conv_KP"), sd, name + ".F.0")
    # F.1's first kernel half of each iteration, tap-major: column
    # i*3d + t*d + c is F.1's output i*6d + c*3 + t
    sel = torch.tensor([i * 6 * d + c * 3 + t for i in range(ac_num)
                        for t in range(3) for c in range(d)],
                       device=x.device)
    k = F.conv2d(f0, sd[name + ".F.1.weight"][sel],
                 sd[name + ".F.1.bias"][sel])
    a1 = _iac(x1, k, flows_f, ac_num, d)
    a3 = _iac(x3, k, flows_b, ac_num, d)
    return _conv(torch.cat([a1, a3], 1), sd, name + ".conv3") + x2


@lru_cache(maxsize=None)
def _bands_1024(num_bands):
    size = 1024
    interval = math.sqrt((size / 2) ** 2 + (size / 2) ** 2) / num_bands
    d2 = (np.arange(size) - size // 2).astype(np.float64) ** 2
    dist2 = d2[:, None] + d2[None, :]
    bands = []
    for n in range(num_bands):
        pf = torch.from_numpy(np.exp(
            -dist2 / (2.0 * (interval * (n + 1)) ** 2)).astype(np.float32))
        for prev in bands:
            pf = pf - prev
        bands.append(pf)
    return torch.stack(bands)


def band_masks(num_bands, h, w, device):
    """(K, h, w) Gaussian ring masks of the released MFFR: built on a
    1024 x 1024 centred grid, bicubic-resized to (h, w), ifftshifted."""
    m = F.interpolate(_bands_1024(num_bands)[None], size=(h, w),
                      mode="bicubic", align_corners=False)[0]
    return torch.fft.ifftshift(m, dim=(1, 2)).to(device)


def _div_enh(x, sd, name, xb=None, eb=None):
    c = x.shape[1]
    a = sd[name + ".a"].reshape(1, c, 1, 1)
    b = sd[name + ".b"].reshape(1, c, 1, 1)
    if xb is None:
        out = x - x.mean((2, 3), keepdim=True)
        return _ca(0.2 * a * out * x + b * x, sd, name + ".ca")
    out = x - xb + 0.2 * eb
    return (_ca(0.2 * a * out * x + b * x, sd, name + ".ca")
            + _ca(0.2 * a * eb * x + b * x, sd, name + ".ca"))


def _mffr(x, sd, freq_inv, name="MFFRblock"):
    h, w = x.shape[2:]
    m = band_masks(freq_inv, h, w, x.device)
    xf = torch.fft.fft2(x)
    bands = [torch.fft.ifft2(xf * m[k]).real for k in range(freq_inv)][::-1]
    raw = enh = None
    for i, band in enumerate(bands):
        fo = _div_enh(band, sd, f"{name}.DivEnh_block.{i}", raw, enh)
        raw = band if raw is None else raw + band
        enh = fo if enh is None else enh + fo
    return _ca(enh, sd, name + ".ca") + x


def _context(r, sd, name):
    b, c, h, w = r.shape
    mask = torch.softmax(_conv(r, sd, name + ".conv_mask").reshape(b, h * w),
                         1)
    ctx = torch.bmm(r.reshape(b, c, h * w), mask[:, :, None])[..., None]
    add = _conv(F.leaky_relu(_conv(ctx, sd, name + ".channel_add_conv.0"),
                             0.2), sd, name + ".channel_add_conv.2")
    return r + add


def _level(x, sd, name):
    y = _conv(F.leaky_relu(_conv(x, sd, name + ".body.0"), 0.1), sd,
              name + ".body.2")
    r = _conv(F.leaky_relu(_conv(y, sd, name + ".body.3.body.0"), 0.2), sd,
              name + ".body.3.body.2")
    return y + F.leaky_relu(_context(r, sd, name + ".body.3.gcnet"), 0.2)


def _down(x):
    return F.interpolate(x, scale_factor=0.5, mode="bilinear",
                         align_corners=False)


def _up(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=False)


def _block_rcb(xs, sd, name):
    res = [_level(x, sd, name) for x in xs]
    dn = [res[0]] + [_down(_conv(r, sd, name + ".down.0")) for r in res[:-1]]
    up = [_up(_conv(r, sd, name + ".up.0")) for r in res[1:]] + [res[-1]]
    return [x + r + a + b for x, r, a, b in zip(xs, res, dn, up)]


def _scnet(xs, sd, groups, name="recorb1"):
    res = list(xs)
    for g in range(groups):
        gin = res
        for j in range(3):
            res = _block_rcb(res, sd, f"{name}.body.{g}.body.{j}")
        res = [_conv(r, sd, f"{name}.body.{g}.conv") + x
               for x, r in zip(gin, res)]
    return [x + r for x, r in zip(xs, res)]


def forward(sd, x, ac_num=6, freq_inv=8, sc_groups=10, up_ksize=3,
            stages=None):
    """(B, 7, C, H, W) frames in [0, 1] -> (B, C, 4H, 4W), H and W
    multiples of 4.  ``sd``: the state dict (name -> tensor); the topology
    keywords as in :data:`FULL` and :data:`SMALL` (``up_ksize`` is read from
    the weights).  ``stages``: a dict that receives MGAA's, MFFR's and
    SCNet's outputs, for tests."""
    del up_ksize  # the tail convs' own kernel sizes say it
    b, t, c, h, w = x.shape
    nf = sd["recorb0.weight"].shape[0]
    feat = _conv(x.reshape(b, t * c, h, w), sd, "feat_extract.0")
    f1, f2, f3 = feat[:, :3 * nf], feat[:, 3 * nf:4 * nf], feat[:, 4 * nf:]
    g1 = _mgaa(f1, sd, ac_num)
    g3 = _mgaa(f3, sd, ac_num)
    g2 = _mgaa(torch.cat([g1, f2, g3], 1), sd, ac_num)
    dec = _mffr(g2, sd, freq_inv)
    dec1 = _conv(dec, sd, "rconcat1", stride=2)
    dec2 = _conv(dec1, sd, "rconcat2", stride=2)
    l1, l2, l3 = _scnet([dec, dec1, dec2], sd, sc_groups)
    if stages is not None:
        stages.update(mgaa=g2, mffr=dec, scnet=l1)

    def lrelu(v):
        return _prelu(v, sd, "lrelu")

    o3 = lrelu(_conv(l3, sd, "upconv1_L3"))
    o3_1 = F.pixel_shuffle(o3, 2)
    o3_2 = F.pixel_shuffle(o3_1, 2)
    o2 = lrelu(_conv(l2, sd, "upconv1_L2"))
    o2 = F.pixel_shuffle(o2 + _conv(torch.cat([o2, o3_1], 1), sd,
                                    "upconv1_L2_2"), 2)
    fuse = _conv(_conv(torch.cat([l1, o2, o3_2], 1), sd, "upconv_fuse"), sd,
                 "recorb0")
    up = lrelu(F.pixel_shuffle(_conv(fuse, sd, "upconv1"), 2))
    up = lrelu(F.pixel_shuffle(_conv(up, sd, "upconv2"), 2))
    out = _conv(up, sd, "conv_last0")
    base = F.interpolate(x[:, t // 2], size=(4 * h, 4 * w), mode="bilinear",
                         align_corners=False)
    return out + base
