"""Operations and bytes of FCVSR's stages, from the configuration's widths
and the input's shape alone, so they read the same whatever implements a
stage.

* A convolution is 2 * k^2 * Cin * Cout / groups operations per output
  pixel (a multiply and an add per weight), at its output's size.
* An IAC iteration does, per pixel and channel, 4 bilinear taps of the warp
  and 3 + 3 taps of the separable filter (10 multiply-adds, 20
  operations), the residual add and the activation: 22 operations.
* A complex FFT of N points is 5 * N * log2(N) operations; a real one
  (rfft2, irfft2) half that.
* The context blocks' weighted sums are 2 * C operations per pixel.
* Elementwise work (the spectral gates, the band masks, the residual sums,
  resizes, shuffles) is not counted.

The peak table and the least-time arithmetic sit here too.
"""

from __future__ import annotations

import math

__all__ = ["conv_flops", "fft_flops", "iac_flops", "forward_work",
           "forward_flops", "PEAK_FLOP_S", "HBM_BYTES_S", "least_time_s",
           "IAC_FLOPS_PER_ELEMENT"]

# NVIDIA's H100 SXM data sheet (dense, at 700 W): the bf16 tensor-core
# rate, against which every share is taken (the exact path already runs
# its float32 products on the tensor cores), and the HBM3 bandwidth
PEAK_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12

IAC_FLOPS_PER_ELEMENT = 2 * (4 + 3 + 3) + 2
F32 = 4


def conv_flops(k, cin, cout, h, w, groups=1):
    return 2 * k * k * cin * cout // groups * h * w


def fft_flops(h, w, channels, real=False):
    n = h * w
    full = 5 * n * math.log2(n) * channels
    return full / 2 if real else full


def iac_flops(h, w, channels, iterations):
    return IAC_FLOPS_PER_ELEMENT * h * w * channels * iterations


def _half(n):
    return -(-n // 2)


def _mgaa(nf, h, w, ac_num, corr_radius):
    d, wf = nf, w // 2 + 1
    n_corr = (2 * corr_radius + 1) ** 2
    fuse = (conv_flops(1, 4 * d, 2 * d, h, wf)
            + 2 * conv_flops(1, 2 * d, 2 * d, h, wf))
    corr = (conv_flops(1, 2 * d + n_corr + 2, d, h, wf)
            + conv_flops(1, d, d, h, wf) + conv_flops(1, d, 4, h, wf))
    crt = conv_flops(1, 2 * d, d, h, wf) + conv_flops(1, d, 4, h, wf)
    blks = sum(2 * conv_flops(2 * i + 1, 4, 4, h, wf)
               + 2 * conv_flops(1, 4, 4, 1, 1) for i in range(ac_num))
    convs = (2 * fuse + crt + 2 * corr + 2 * blks
             + 2 * conv_flops(3, d, d, h, w)              # conv_KP, F.0
             + conv_flops(1, d, ac_num * 3 * d, h, w)     # F.1's used half
             + conv_flops(3, 2 * d, d, h, w))             # conv3
    ffts = (fft_flops(h, w, 3 * d, real=True)
            + fft_flops(h, w, 2 * 2 * ac_num, real=True))
    iac = 2 * iac_flops(h, w, d, ac_num)
    maps = (3 * d + d) * h * w * F32
    return convs, ffts + iac, maps


def _mffr(nf, h, w, freq_inv):
    ca = 2 * conv_flops(1, nf, nf // 16, 1, 1)
    convs = 2 * freq_inv * ca  # 2K - 1 DivEnh attentions and MFFR's own
    ffts = fft_flops(h, w, nf) * (1 + freq_inv)
    return convs, ffts, 2 * nf * h * w * F32


def _scnet(nf, levels, groups):
    convs = other = 0
    for _ in range(groups):
        for _ in range(3):
            for i, (h, w) in enumerate(levels):
                convs += (conv_flops(3, nf, 2 * nf, h, w)
                          + conv_flops(3, 2 * nf, nf, h, w)
                          + 2 * conv_flops(3, nf, nf, h, w)
                          + conv_flops(1, nf, 1, h, w)
                          + 2 * conv_flops(1, nf, nf, 1, 1))
                other += 2 * nf * h * w
                if i + 1 < len(levels):
                    convs += conv_flops(1, nf, nf, h, w)     # down
                if i > 0:
                    convs += conv_flops(1, nf, nf, h, w)     # up
        convs += sum(conv_flops(3, nf, nf, h, w) for h, w in levels)
    maps = 2 * sum(nf * h * w * F32 for h, w in levels)
    return convs, other, maps


def _tail(nf, c, h, w, k, levels):
    (h2, w2), (h3, w3) = levels[1], levels[2]
    return (conv_flops(k, nf, nf, h3, w3)                      # upconv1_L3
            + conv_flops(k, nf, nf, h2, w2)                    # upconv1_L2
            + conv_flops(k, nf + nf // 4, nf, h2, w2)          # upconv1_L2_2
            + conv_flops(3, nf + nf // 4 + nf // 16, nf, h, w)  # upconv_fuse
            + conv_flops(3, nf, nf, h, w)                      # recorb0
            + conv_flops(k, nf, 4 * nf, h, w)                  # upconv1
            + conv_flops(k, nf, 4 * nf, 2 * h, 2 * w)          # upconv2
            + conv_flops(3, nf, c, 4 * h, 4 * w))              # conv_last0


def forward_work(cfg, h, w):
    """Stage -> {'conv_flops', 'flops', 'bytes'} of one window's forward
    at LR size (h, w) (multiples of 4), and 'total'.  ``cfg``: the
    configuration (n_feats, in_channels, num_frames, ac_num, freq_inv,
    sc_groups, up_ksize, corr_radius).  Bytes count the stage's input and
    output maps once each, float32; SCNet's also its weights once."""
    nf, c, t = cfg["n_feats"], cfg["in_channels"], cfg["num_frames"]
    levels = [(h, w), (_half(h), _half(w)), (_half(_half(h)), _half(_half(w)))]
    out = {}

    def put(name, convs, other=0.0, nbytes=0.0):
        out[name] = {"conv_flops": convs, "flops": convs + other,
                     "bytes": nbytes}

    put("feat_extract", conv_flops(3, t * c, t * nf, h, w), 0,
        (t * c + t * nf) * h * w * F32)
    m = [_mgaa(nf, h, w, cfg["ac_num"], cfg["corr_radius"])
         for _ in range(3)]
    put("MGAA", sum(x[0] for x in m), sum(x[1] for x in m),
        sum(x[2] for x in m))
    put("MFFR", *_mffr(nf, h, w, cfg["freq_inv"]))
    put("rconcat", conv_flops(3, nf, nf, *levels[1])
        + conv_flops(3, nf, nf, *levels[2]))
    convs, other, maps = _scnet(nf, levels, cfg["sc_groups"])
    # a BlockRCB: its body pair, the RCB pair, the context block and the
    # down / up projections; a group: three of them and its conv
    block = 36 * nf * nf + 18 * nf * nf + 4 * nf * nf + 6 * nf
    weights = cfg["sc_groups"] * (3 * block + 9 * nf * nf + nf) * F32
    put("SCNet", convs, other, maps + weights)
    put("tail", _tail(nf, c, h, w, cfg["up_ksize"], levels), 0,
        (nf * h * w + c * 16 * h * w) * F32)
    out["total"] = {k: sum(v[k] for v in out.values())
                    for k in ("conv_flops", "flops", "bytes")}
    return out


def forward_flops(cfg, h, w):
    """Operations of one window's forward: :func:`forward_work`'s total."""
    return forward_work(cfg, h, w)["total"]["flops"]


def least_time_s(flops, nbytes):
    """The least time the card could take: the larger of the operations at
    :data:`PEAK_FLOP_S` and the bytes at :data:`HBM_BYTES_S`."""
    return max(flops / PEAK_FLOP_S, nbytes / HBM_BYTES_S)
