"""FCVSR (counterpart of ``fcvsr_tpu.models.fcvsr``).

* ``MGAA``     - motion-guided adaptive alignment in the frequency domain.
* ``MFFR``     - multi-frequency feature refinement.
* ``FCVSRNet`` - 7 LR frames -> the x4 centre frame.

Reference behaviours kept (shipped checkpoints depend on them): SAC applies
kernel1 in both passes; the forward correlation feature conditions both
offset directions; the CorrBlock memory-reinterpret reshape; identity flow
features are zero; DivEnh's conv is dead weight.  Parameter names are the
reference checkpoint keys.  Features are channels-last inside the model.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import _native
from ..ops.corr import corr_lookup
from ..ops.freq import irfft_features, rfft_features, split_freq
from ..ops.fused_conv import conv3x3
from ..ops.psfold import (block_to_interleaved_perm,
                          conv_folded_phase2_blocked, conv_folded_tapmajor,
                          fold_ps_bias, fold_ps_conv)
from ..ops.resize import resize_bilinear
from ..ops.sac import iac
from .basicvsr import MMResidualBlock, ModulatedDeformConv2d
from .blocks import (BlockRCB, CALayer, Conv2d, ConvBlk, DivEnh, LayerNorm2d,
                     PReLU, RCB, SCNet, pixel_shuffle, set_compute_dtype)
from .blocks_ext import CAB1, CAB2
from .raft import InstanceNorm
from .scnet_rows import STORAGE, conv_bias, hwio
from .sidecvsr import _WideBlock

__all__ = ["MGAA", "MFFR", "FCVSRNet", "init_weights", "fcvsr_etc_forward"]


def _check_dtype(name, value):
    if value not in STORAGE:
        raise ValueError(f"{name} is 'f32' or 'bf16', not {value!r}")


def _compute_dtype(value):
    """A dtype flag's compute dtype for ``blocks``: None for 'f32' (the
    input's, float32), torch.bfloat16 for 'bf16'."""
    return None if value == "f32" else STORAGE[value]


def _inference_only(what, flags, *tensors):
    """Raise when autograd records a forward with a serving flag set;
    ``flags``: (name, value, plain value) triples."""
    serving = [f"{k}={v!r}" for k, v, plain in flags if v != plain]
    if serving and _native.records(*tensors):
        raise RuntimeError(
            f"{what}({', '.join(serving)}) is inference only: it has no "
            "backward.  Train without it, or run the forward under "
            "torch.no_grad()")


def _check_iac(k_fused, iac_chain, iac_dtype):
    if iac_chain not in ("periter", "resident"):
        raise ValueError(f"iac_chain is 'periter' or 'resident', not "
                         f"{iac_chain!r}")
    if iac_chain == "resident" and k_fused:
        raise ValueError("iac_chain='resident' takes materialised kernels: "
                         "it does not combine with k_fused")
    _check_dtype("iac_dtype", iac_dtype)


class MGAA(nn.Module):
    """Motion-guided adaptive alignment: (B, H, W, 3*dim) -> (B, H, W, dim),
    the centre group aligned with its two neighbours.

    Options, none of which changes the parameters:

    * ``k_fused``: the IAC kernel computes the per-pixel kernels from F.0's
      output and F.1's selected weights, so F.1's output is never made.
    * ``batch_fb``: the forward and backward ConvBlk calls run as one batch
      (exact).
    * ``iac_chain``: 'periter' (one IAC launch an iteration) or 'resident'
      (the whole chain in one launch, materialised kernels only: with
      ``k_fused`` it raises, as the JAX package has no resident kf chain).
      A constructor argument, where the JAX package has the global
      ``set_iac_chain``.
    * ``iac_dtype``: 'f32' or 'bf16', the storage of the IAC chain's maps
      (its inputs, kernels or F.0's output, and every iteration's output);
      the aligned maps return to float32 for conv3 (or go to a bf16 conv3
      under ``head_dtype``).
    * ``head_dtype``: 'f32' or 'bf16', the spectral head's storage and
      compute type: the rfft's packed spectra (a float32 transform, bf16
      storage), ``convfuse``, ``convcrt``, ``convcorr``, the ``MConvB``
      ConvBlks and ``conv3``.  The gated spectra go back to float32 for the
      irfft, so the warp offsets stay float32, as in the JAX package.

    ``k_fused``, ``iac_chain='resident'`` and the bf16 types are inference
    only: a forward that autograd records raises."""

    def __init__(self, dim: int, ac_ks: int = 3, ac_num: int = 6,
                 corr_radius: int = 4, k_fused: bool = False,
                 batch_fb: bool = False, iac_chain: str = "periter",
                 iac_dtype: str = "f32", head_dtype: str = "f32"):
        super().__init__()
        if ac_ks != 3:
            raise ValueError(f"the IAC kernel has 3 taps, not ac_ks={ac_ks}")
        _check_iac(k_fused, iac_chain, iac_dtype)
        _check_dtype("head_dtype", head_dtype)
        d = dim
        self.dim, self.ac_ks, self.ac_num = d, ac_ks, ac_num
        self.corr_radius, self.k_fused = corr_radius, k_fused
        self.batch_fb, self.iac_chain = batch_fb, iac_chain
        self.iac_dtype = iac_dtype
        self.convfuse = nn.Sequential(
            Conv2d(4 * d, 2 * d, 1, bias=False), nn.ReLU(),
            Conv2d(2 * d, 2 * d, 1, bias=False), nn.ReLU(),
            Conv2d(2 * d, 2 * d, 1, bias=False))
        n_corr = (2 * corr_radius + 1) ** 2
        self.convcorr = nn.Sequential(
            Conv2d(2 * d + n_corr + 2, d, 1, bias=False), nn.ReLU(),
            Conv2d(d, d, 1, bias=False), nn.ReLU(),
            Conv2d(d, 4, 1, bias=False))
        self.MConvB = nn.ModuleList([ConvBlk(4, i) for i in range(ac_num)])
        self.convcrt = nn.Sequential(
            Conv2d(2 * d, d, 1, bias=False), nn.ReLU(),
            Conv2d(d, 4, 1, bias=False))
        self.conv_KP = Conv2d(d, d, 3)
        self.F = nn.Sequential(Conv2d(d, d, 3),
                               Conv2d(d, ac_num * d * ac_ks * 2, 1))
        self.conv3 = Conv2d(2 * d, d, 3, bias=False)
        self.head_dtype = head_dtype
        # F.1 output channels of the kernel1 halves, tap-major per iteration:
        # the kernel2 halves are dead under the kernel1-both reference bug
        half = d * ac_ks
        self.register_buffer("sel", torch.tensor(
            [i * 2 * half + c * ac_ks + t for i in range(ac_num)
             for t in range(ac_ks) for c in range(d)]), persistent=False)

    @property
    def head_dtype(self) -> str:
        return self._head_dtype

    @head_dtype.setter
    def head_dtype(self, value: str) -> None:
        _check_dtype("head_dtype", value)
        self._head_dtype = value
        for m in (self.convfuse, self.convcorr, self.MConvB, self.convcrt,
                  self.conv3):
            set_compute_dtype(m, _compute_dtype(value))

    def sel_weights(self):
        """F.1's weight, its (C0, n*3C) transpose for ``k_fused``, and its
        bias at the ``sel`` rows.  Under autograd they are selected from the
        live parameters on every call, so F.1 gets its gradient, and while
        ``torch.export`` traces, so that the graph selects them from F.1;
        otherwise they are made once, detached, and again only when F.1
        changes."""
        w, b = self.F[1].weight, self.F[1].bias
        if _native.records(w, b) or _native.traced(w):
            wsel = w.index_select(0, self.sel)
            return wsel, wsel[:, :, 0, 0].t().contiguous(), \
                b.index_select(0, self.sel)
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version, w.device)
        cached = self.__dict__.get("_sel_weights")
        if cached is None or cached[0] != key:
            wsel = w.detach().index_select(0, self.sel)
            cached = (key, wsel, wsel[:, :, 0, 0].t().contiguous(),
                      b.detach().index_select(0, self.sel))
            self.__dict__["_sel_weights"] = cached
        return cached[1:]

    def forward(self, x):
        d = self.dim
        b, h, w, _ = x.shape
        x1, x2, x3 = x[..., :d], x[..., d:2 * d], x[..., 2 * d:]

        hd = _compute_dtype(self.head_dtype)
        xf = rfft_features(x, 3, hd)  # [imag_g, real_g] per group
        x1f, x2f, x3f = xf[..., :2 * d], xf[..., 2 * d:4 * d], xf[..., 4 * d:]
        off_f = (x1f - x2f) + self.convfuse(torch.cat([x1f, x2f], -1))
        off_b = (x3f - x2f) + self.convfuse(torch.cat([x3f, x2f], -1))
        sim = self.convcrt(x2f)

        corrf = corr_lookup(x1f, x2f, self.corr_radius)
        zero_flow = off_f.new_zeros(off_f.shape[:3] + (2,))
        off_f = self.convcorr(torch.cat([off_f, corrf, zero_flow], -1))
        off_b = self.convcorr(torch.cat([off_b, corrf, zero_flow], -1))

        # per-iteration offset fields: ConvBlk -> gate -> one batched irfft
        # over all 2*ac_num gated spectra, each [re(2), im(2)]
        gated = []
        if self.batch_fb:
            off_fb = torch.cat([off_f, off_b], 0)
            sim_fb = torch.cat([sim, sim], 0)
            for blk in self.MConvB:
                g = blk(off_fb) * sim_fb
                gated += [g[:b], g[b:]]
        else:
            for blk in self.MConvB:
                gated += [blk(off_f) * sim, blk(off_b) * sim]
        packed = torch.cat([g[..., :2] for g in gated]
                           + [g[..., 2:] for g in gated], -1).float()
        fields = irfft_features(packed, h, w)      # (B, H, W, 4 * ac_num)
        offsets_f = torch.stack([fields[..., 4 * i:4 * i + 2]
                                 for i in range(self.ac_num)])
        offsets_b = torch.stack([fields[..., 4 * i + 2:4 * i + 4]
                                 for i in range(self.ac_num)])

        f0 = self.F[0](self.conv_KP(x2))
        wsel, wsel_t, bsel = self.sel_weights()
        _inference_only("MGAA", (("k_fused", self.k_fused, False),
                                 ("iac_chain", self.iac_chain, "periter"),
                                 ("iac_dtype", self.iac_dtype, "f32"),
                                 ("head_dtype", self.head_dtype, "f32")),
                        f0, wsel)
        # the chain's storage: iac_dtype's, or bf16 where the whole model
        # runs in bf16 (utils.precision)
        st = torch.bfloat16 if x.dtype == torch.bfloat16 \
            else STORAGE[self.iac_dtype]
        if self.k_fused:
            k_parts = (f0.to(st).contiguous(), wsel_t, bsel)
            pred_k = None
        else:
            k_parts = None
            pred_k = F.conv2d(f0.permute(0, 3, 1, 2), wsel, bsel) \
                .permute(0, 2, 3, 1).to(st)
        aligned = [iac(feat.to(st), pred_k, offs, self.ac_num, d,
                       k_parts=k_parts, chain=self.iac_chain)
                   for feat, offs in ((x1, offsets_f), (x3, offsets_b))]
        return self.conv3(torch.cat(aligned, -1).to(hd or x2.dtype)) \
            .to(x2.dtype) + x2


class MFFR(nn.Module):
    """Multi-frequency feature refinement.  ``dtype``: 'f32' or 'bf16', the
    storage and compute type of the band split (a float32 transform, bf16
    bands) and of the DivEnh chain and its channel attention; the residual
    add is float32.  bf16 is inference only."""

    def __init__(self, dim: int, freq_inv: int = 8, dtype: str = "f32"):
        super().__init__()
        self.freq_inv = freq_inv
        self.DivEnh_block = nn.ModuleList([DivEnh(dim) for _ in range(freq_inv)])
        self.ca = CALayer(dim)
        self.dtype = dtype

    @property
    def dtype(self) -> str:
        return self._dtype

    @dtype.setter
    def dtype(self, value: str) -> None:
        _check_dtype("mffr_dtype", value)
        self._dtype = value
        set_compute_dtype(self, _compute_dtype(value))

    def forward(self, x):
        _inference_only("MFFR", (("dtype", self.dtype, "f32"),), x,
                        self.ca.conv_du[0].weight)
        freq = split_freq(x, self.freq_inv, _compute_dtype(self.dtype)) \
            .flip(0)  # low-to-high band order
        enhanced_sum = raw_sum = out_sum = None
        for i, de in enumerate(self.DivEnh_block):
            fo = de(freq[i]) if i == 0 else de(freq[i], raw_sum, enhanced_sum)
            raw_sum = freq[i] if raw_sum is None else raw_sum + freq[i]
            enhanced_sum = fo if enhanced_sum is None else enhanced_sum + fo
            out_sum = fo if out_sum is None else out_sum + fo
        return self.ca(out_sum).to(x.dtype) + x


class FCVSRNet(nn.Module):
    """FCVSR: (B, 7, C, H, W) in [0, 1] -> (B, C, 4H, 4W).

    ``in_channels`` is 1 (Y) or 3 (RGB).  FCVSR-S is the same topology with
    ac_num=3, freq_inv=4, sc_groups=4 and 1x1 upsampling convs
    (:meth:`small`).

    The flags of the JAX package's ``--fast`` serving configuration, under
    its names; none changes the ``state_dict``:

    * ``batch_mgaa``: MGAA(f1) and MGAA(f3) run as one call at batch 2B,
      with MGAA's ``batch_fb`` (exact);
    * ``tail_impl``: 'xla', 'folded' (the upsampling tail with upconv2
      and conv_last0 folded over the pixel shuffles, ``ops.psfold``, all
      at (H, W)) or 'folded_pb' (the fold with upconv2 as four per-phase
      2x2 convs in phase-blocked channels and conv_last0 tap-major, where
      the folded upconv2 kernel is 3x3, the full topology; elsewhere the
      dense fold); all exact up to summation order;
    * ``k_fused``, ``iac_chain`` ('periter' or 'resident'), ``iac_dtype``
      and ``head_dtype`` ('f32' or 'bf16'): MGAA's;
    * ``mffr_dtype`` ('f32' or 'bf16'): MFFR's ``dtype``;
    * ``tail_dtype`` ('f32' or 'bf16'): SCNet's outputs and every map of
      the upsampling tail through ``conv_last0`` stored and computed in
      bf16 (weights float32, cast where used); ``conv_last0`` then runs
      K3 on bf16 maps, the folded convs in bf16;
    * ``scnet_dtype`` ('f32' or 'bf16', the storage of SCNet's maps; it
      stands for the JAX package's ``scnet_impl='rows_bf16'``, since the
      port has no rows layout) and ``scnet_fuse`` ('pair' or 'quad'):
      SCNet's ``dtype`` and ``fuse`` (``models.scnet_rows``).

    ``k_fused``, ``iac_chain='resident'``, ``scnet_fuse='quad'`` and the
    bf16 types are serving flags: they raise under autograd."""

    def __init__(self, n_feats: int = 64, in_channels: int = 1, ac_ks: int = 3,
                 ac_num: int = 6, freq_inv: int = 8, sc_groups: int = 10,
                 up_ksize: int = 3, num_frames: int = 7, k_fused: bool = False,
                 batch_mgaa: bool = False, tail_impl: str = "xla",
                 iac_chain: str = "periter", iac_dtype: str = "f32",
                 scnet_dtype: str = "f32", scnet_fuse: str = "pair",
                 head_dtype: str = "f32", mffr_dtype: str = "f32",
                 tail_dtype: str = "f32", device=None):
        super().__init__()
        _check_tail_scnet(tail_impl, scnet_dtype, scnet_fuse)
        nf = n_feats
        self.nf, self.num_frames = nf, num_frames
        self.batch_mgaa, self.tail_impl = batch_mgaa, tail_impl
        self.feat_extract = nn.Sequential(
            Conv2d(num_frames * in_channels, num_frames * nf, 3))
        self.lrelu = PReLU()
        self.MGAA = MGAA(nf, ac_ks, ac_num, k_fused=k_fused,
                         batch_fb=batch_mgaa, iac_chain=iac_chain,
                         iac_dtype=iac_dtype, head_dtype=head_dtype)
        self.rconcat1 = Conv2d(nf, nf, 3, stride=2)
        self.rconcat2 = Conv2d(nf, nf, 3, stride=2)
        self.recorb1 = SCNet(nf, sc_groups, fuse=scnet_fuse,
                             dtype=scnet_dtype)
        self.recorb0 = Conv2d(nf, nf, 3)
        ks = up_ksize
        self.upconv1_L2 = Conv2d(nf, nf, ks)
        self.upconv1_L2_2 = Conv2d(nf + nf // 4, nf, ks)
        self.upconv1_L3 = Conv2d(nf, nf, ks)
        self.upconv1 = Conv2d(nf, nf * 4, ks)
        self.upconv2 = Conv2d(nf, nf * 4, ks)
        self.conv_last0 = Conv2d(nf, in_channels, 3)
        self.MFFRblock = MFFR(nf, freq_inv, mffr_dtype)
        self.upconv_fuse = Conv2d(nf + nf // 4 + nf // 16, nf, 3)
        self.tail_dtype = tail_dtype
        if device is not None:
            self.to(device)

    # the tail's convs, which ``tail_dtype`` sets (conv_last0 runs K3 on
    # its input's storage, or is folded)
    _TAIL = ("upconv1_L3", "upconv1_L2", "upconv1_L2_2", "upconv_fuse",
             "recorb0", "upconv1", "upconv2")

    @property
    def tail_dtype(self) -> str:
        return self._tail_dtype

    @tail_dtype.setter
    def tail_dtype(self, value: str) -> None:
        _check_dtype("tail_dtype", value)
        self._tail_dtype = value
        for name in self._TAIL:
            set_compute_dtype(getattr(self, name), _compute_dtype(value))

    @classmethod
    def small(cls, in_channels: int = 1, **kw):
        return cls(in_channels=in_channels, ac_num=3, freq_inv=4, sc_groups=4,
                   up_ksize=1, **kw)

    def forward(self, x):
        b, t, c, h, w = x.shape
        nf = self.nf
        center = x[:, t // 2].permute(0, 2, 3, 1)            # (B, H, W, C)
        feats = x.permute(0, 3, 4, 1, 2).reshape(b, h, w, t * c)

        feat = self.feat_extract(feats)
        f1, f2, f3 = feat[..., :3 * nf], feat[..., 3 * nf:4 * nf], \
            feat[..., 4 * nf:]
        if self.batch_mgaa:
            g13 = self.MGAA(torch.cat([f1, f3], 0))
            g1, g3 = g13[:b], g13[b:]
        else:
            g1 = self.MGAA(f1)
            g3 = self.MGAA(f3)
        g2 = self.MGAA(torch.cat([g1, f2, g3], -1))

        dec = self.MFFRblock(g2)
        dec1 = self.rconcat1(dec)
        dec2 = self.rconcat2(dec1)
        l1, l2, l3 = self.recorb1([dec, dec1, dec2])
        _inference_only("FCVSRNet", (("tail_dtype", self.tail_dtype, "f32"),),
                        l1, self.upconv1.weight)
        td = _compute_dtype(self.tail_dtype)
        if td is not None:
            l1, l2, l3 = l1.to(td), l2.to(td), l3.to(td)

        lrelu = self.lrelu
        out_l3 = lrelu(self.upconv1_L3(l3))
        out_l3_1 = pixel_shuffle(out_l3)
        out_l3_2 = pixel_shuffle(out_l3_1)
        out_l2 = lrelu(self.upconv1_L2(l2))
        out_l2 = pixel_shuffle(
            out_l2 + self.upconv1_L2_2(torch.cat([out_l2, out_l3_1], -1)))
        fuse = torch.cat([l1, out_l2, out_l3_2], -1)
        fuse = self.recorb0(self.upconv_fuse(fuse))
        if self.tail_impl in ("folded", "folded_pb"):
            # upconv1 -> lrelu -> folded upconv2 -> lrelu -> doubly folded
            # conv_last0, all at (H, W), then both shuffles (the PReLU has
            # one slope, so it commutes with a shuffle)
            w2, b2, wl, bl = self.folded_tail()
            a = lrelu(self.upconv1(fuse))
            if self.tail_impl == "folded_pb" and w2.shape[0] == 3:
                # phase-blocked: four 2x2 convs, their block layout taken
                # by conv_last0's weight, which runs tap-major
                up = lrelu(conv_folded_phase2_blocked(a, w2, b2))
                perm = torch.from_numpy(block_to_interleaved_perm(
                    w2.shape[3])).to(wl.device)
                y16 = conv_folded_tapmajor(up, wl[:, :, perm], bl)
            else:
                y16 = _conv_nhwc(lrelu(_conv_nhwc(a, w2, b2)), wl, bl)
            out = pixel_shuffle(pixel_shuffle(y16))
        else:
            up = lrelu(pixel_shuffle(self.upconv1(fuse)))
            up = lrelu(pixel_shuffle(self.upconv2(up)))
            last = self.conv_last0
            out = conv3x3(up.contiguous(), hwio(last), conv_bias(last))
        out = out.float() + resize_bilinear(center, 4 * h, 4 * w)
        return out.permute(0, 3, 1, 2)

    def serving_flags(self) -> dict:
        """The serving flags, under the constructor's names."""
        m, sc = self.MGAA, self.recorb1
        return dict(batch_mgaa=self.batch_mgaa, k_fused=m.k_fused,
                    tail_impl=self.tail_impl, iac_chain=m.iac_chain,
                    iac_dtype=m.iac_dtype, scnet_dtype=sc.dtype,
                    scnet_fuse=sc.fuse, head_dtype=m.head_dtype,
                    mffr_dtype=self.MFFRblock.dtype,
                    tail_dtype=self.tail_dtype)

    def set_serving_flags(self, **flags) -> dict:
        """Set serving flags in place, checked as the constructor checks
        them; returns the previous ones (the weights stay)."""
        old = self.serving_flags()
        unknown = set(flags) - set(old)
        if unknown:
            raise TypeError(f"not serving flags: {sorted(unknown)}")
        new = {**old, **flags}
        _check_tail_scnet(new["tail_impl"], new["scnet_dtype"],
                          new["scnet_fuse"])
        _check_iac(new["k_fused"], new["iac_chain"], new["iac_dtype"])
        for name in ("head_dtype", "mffr_dtype", "tail_dtype"):
            _check_dtype(name, new[name])
        m, sc = self.MGAA, self.recorb1
        self.batch_mgaa, self.tail_impl = new["batch_mgaa"], new["tail_impl"]
        m.batch_fb, m.k_fused = new["batch_mgaa"], new["k_fused"]
        m.iac_chain, m.iac_dtype = new["iac_chain"], new["iac_dtype"]
        sc.dtype, sc.fuse = new["scnet_dtype"], new["scnet_fuse"]
        m.head_dtype, self.MFFRblock.dtype = new["head_dtype"], \
            new["mffr_dtype"]
        self.tail_dtype = new["tail_dtype"]
        return old

    def folded_tail(self):
        """upconv2 folded over one shuffle and conv_last0 over two (HWIO),
        with their biases.  Under autograd, and while ``torch.export``
        traces, they are folded from the live parameters on every call;
        otherwise once, and again only when a weight changes."""
        convs = (self.upconv2, self.conv_last0)
        params = [t for c in convs for t in (c.weight, c.bias)]
        if _native.records(*params) or _native.traced(params[0]):
            return _fold_tail(*params)
        key = tuple((t.data_ptr(), t._version, t.device) for t in params)
        cached = self.__dict__.get("_folded_tail")
        if cached is None or cached[0] != key:
            cached = (key, _fold_tail(*(t.detach() for t in params)))
            self.__dict__["_folded_tail"] = cached
        return cached[1]


def _check_tail_scnet(tail_impl, scnet_dtype, scnet_fuse):
    if tail_impl not in ("xla", "folded", "folded_pb"):
        raise ValueError(f"tail_impl is 'xla', 'folded' or 'folded_pb', not "
                         f"{tail_impl!r}")
    if scnet_dtype not in STORAGE or scnet_fuse not in ("pair", "quad"):
        raise ValueError(f"scnet_dtype is 'f32' or 'bf16' and scnet_fuse "
                         f"'pair' or 'quad', not {scnet_dtype!r} and "
                         f"{scnet_fuse!r}")


def _fold_tail(w2, b2, wl, bl):
    def to_hwio(w):
        return w.permute(2, 3, 1, 0)

    return (fold_ps_conv(to_hwio(w2), 2), fold_ps_bias(b2, 2),
            fold_ps_conv(fold_ps_conv(to_hwio(wl), 2), 2),
            fold_ps_bias(fold_ps_bias(bl, 2), 2))


def _conv_nhwc(x, w_hwio, bias):
    """SAME, stride-1 conv of an NHWC map with an HWIO weight, in x's
    type."""
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w_hwio.permute(3, 2, 0, 1).to(x.dtype), bias.to(x.dtype),
                 padding=w_hwio.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def fcvsr_etc_forward(model: FCVSRNet, clip: torch.Tensor):
    """Temporal-consistency mode (the JAX package's ``fcvsr_etc_forward``,
    reference ``GShiftNet_ETC``): a (B, 13, C, H, W) clip -> (out, base),
    each (B, 7, C, 4H, 4W).  The 7 overlapping windows of the model's 7
    frames go through the model as one batch (window-major on the batch
    axis, where the JAX package vmaps them); ``base`` is the bilinear x4
    resize of each window's centre frame."""
    b, frames, c, h, w = clip.shape
    t = model.num_frames
    n = frames - t + 1
    if n < 1:
        raise ValueError(f"a clip of {frames} frames holds no window of {t}")
    windows = torch.cat([clip[:, i:i + t] for i in range(n)])
    out = model(windows).reshape(n, b, c, 4 * h, 4 * w).transpose(0, 1)
    centre = clip[:, t // 2:t // 2 + n].reshape(b * n, c, h, w)
    base = resize_bilinear(centre.permute(0, 2, 3, 1), 4 * h, 4 * w)
    return out, base.permute(0, 3, 1, 2).reshape(b, n, c, 4 * h, 4 * w)


def _uniform(t: torch.Tensor, fan_in: int, generator) -> None:
    t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1)
            * fan_in ** -0.5)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded re-initialisation of every parameter.

    Convs get torch's default U(+-1/sqrt(fan_in)) for weight and bias; the
    residual blocks the reference re-initialises (SCNet's BlockRCB and its
    RCB, mmedit's ResidualBlockNoBN, the width-4 cross-scale block of
    SIDECVSR and FCVSR-TFDC) get kaiming-normal x 0.1 with zero bias, which
    keeps deep stacks stable; a deformable conv gets
    U(+-1/sqrt(fan_in)), a zero bias (if it has one) and a zero last offset
    conv (zero offsets, mask 0.5); PReLU slopes are 0.25 and DivEnh keeps a = 0,
    b = 1.  Linear layers and an attention's packed input projection get
    U(+-1/sqrt(fan_in)) for weight and bias; the norms (LayerNorm,
    ``LayerNorm2d``, RAFT's instance norm, batch norms) get ones and zeros,
    batch norms' running statistics 0 and 1, and CAB1's and CAB2's ``beta``
    zeros (the block starts as the identity), as the JAX package initialises them.
    Last, a module with an ``init_seeded(generator)`` method (the
    GAN family's equalised-lr and spectral-norm layers, RRDB's dense
    blocks, DIC) sets its own parameters and buffers with it."""
    scaled, zeroed = set(), set()
    for mod in model.modules():
        if isinstance(mod, (BlockRCB, RCB, MMResidualBlock, _WideBlock)):
            scaled.update(id(m) for m in mod.modules()
                          if isinstance(m, nn.Conv2d))
        elif isinstance(mod, ModulatedDeformConv2d):
            zeroed.add(id([m for m in mod.conv_offset.modules()
                           if isinstance(m, nn.Conv2d)][-1]))
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, ModulatedDeformConv2d)):
            wt = mod.weight
            fan_in = wt.shape[1] * wt.shape[2] * wt.shape[3]
            if id(mod) in zeroed:
                wt.zero_()
                mod.bias.zero_()
            elif isinstance(mod, ModulatedDeformConv2d):
                _uniform(wt, fan_in, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif id(mod) in scaled:
                std = (2.0 / fan_in) ** 0.5 * 0.1
                wt.copy_(torch.randn(wt.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            else:
                _uniform(wt, fan_in, generator)
                if mod.bias is not None:
                    _uniform(mod.bias, fan_in, generator)
        elif isinstance(mod, nn.Linear):
            _uniform(mod.weight, mod.weight.shape[1], generator)
            _uniform(mod.bias, mod.weight.shape[1], generator)
        elif isinstance(mod, nn.MultiheadAttention):
            fan_in = mod.in_proj_weight.shape[1]
            _uniform(mod.in_proj_weight, fan_in, generator)
            _uniform(mod.in_proj_bias, fan_in, generator)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        elif isinstance(mod, DivEnh):
            mod.a.zero_()
            mod.b.fill_(1.0)
        elif isinstance(mod, (nn.LayerNorm, LayerNorm2d, InstanceNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
        elif isinstance(mod, (CAB1, CAB2)):
            mod.beta.zero_()
    for mod in model.modules():
        if hasattr(mod, "init_seeded"):
            mod.init_seeded(generator)
    return model
