"""Weights from the JAX package: flax params -> the port's ``state_dict``
(counterpart of ``fcvsr_tpu.utils.torch_import``, in the other direction).
SIDECVSR, FCVSR-TFDC and RAFT keep the JAX package's module names.

FCVSR's names map through :func:`flax_to_torch_key`, the port's own copy of
the JAX package's key map; the zoo's (EDVR, BasicVSR, BasicVSR++, IconVSR,
TDAN, FTVSR, TTVSR, SPyNet) through patterns onto mmedit's names; the
single-image models (EDSR, SRCNN, MSRResNet, RRDBNet, RDN), TOFlow, LIIF
and TTSR keep the JAX package's module names, TOFlow's SPyNet mmedit's.
Kernels and DCN weights go from HWIO to OIHW, PReLU's ``alpha`` becomes
``weight`` (1,) and DivEnh's ``a``/``b`` become (C, 1, 1).  FTVSR's attention
(``FTTALayer``) keeps torch's layout: a dense kernel (in, out) becomes a
``Linear`` weight (out, in), the three input projections pack into
``mha.in_proj_weight`` / ``in_proj_bias`` in q, k, v order, ``attn_out``
becomes ``mha.out_proj`` and a LayerNorm's ``scale`` its ``weight``.

:func:`block_rcb_args_from_jax` and :func:`block_rcb_args` give the
arguments of the BlockRCB level kernel (``ops.fused_blockrcb.block_rcb``)
from the JAX benchmark's ``block_rcb_rows`` arguments and from a port
``BlockRCB``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "block_state_dict_from_jax",
           "flax_to_torch_key",
           "conv_transpose_weight", "block_rcb_args_from_jax",
           "block_rcb_args"]

_TOP_CONVS = {
    "feat_extract": "feat_extract.0", "rconcat1": "rconcat1",
    "rconcat2": "rconcat2", "recorb0": "recorb0", "upconv1_L2": "upconv1_L2",
    "upconv1_L2_2": "upconv1_L2_2", "upconv1_L3": "upconv1_L3",
    "upconv1": "upconv1", "upconv2": "upconv2", "conv_last0": "conv_last0",
    "upconv_fuse": "upconv_fuse",
}
_MGAA = {
    "convfuse0": "MGAA.convfuse.0", "convfuse1": "MGAA.convfuse.2",
    "convfuse2": "MGAA.convfuse.4",
    "convcorr0": "MGAA.convcorr.0", "convcorr1": "MGAA.convcorr.2",
    "convcorr2": "MGAA.convcorr.4",
    "convcrt0": "MGAA.convcrt.0", "convcrt1": "MGAA.convcrt.2",
    "conv_KP": "MGAA.conv_KP", "F0": "MGAA.F.0", "F1": "MGAA.F.1",
    "conv3": "MGAA.conv3",
}
_GCNET = {"conv_mask": "conv_mask", "add0": "channel_add_conv.0",
          "add1": "channel_add_conv.2"}


def _ca(base: str, part: str) -> str:
    return f"{base}.conv_du.{0 if part == 'down' else 2}"


def flax_to_torch_key(path: str) -> str | None:
    """Map a '/'-joined flax param path (without the trailing kernel/bias
    leaf) to the reference torch module name, or None if it has none."""
    p = path.split("/")
    if p[0] in _TOP_CONVS and p[1:2] == ["Conv_0"]:
        return _TOP_CONVS[p[0]]
    if p[0] == "lrelu":
        return "lrelu"
    if p[0] == "MGAA":
        if p[1] in _MGAA:
            return _MGAA[p[1]]
        if p[1].startswith("mconv"):
            base = f"MGAA.MConvB.{int(p[1][len('mconv'):])}"
            if p[2] in ("conv1", "conv2", "relu"):
                return f"{base}.{p[2]}"
            if p[2] == "CA":
                return _ca(f"{base}.CA", p[3])
        return None
    if p[0] == "MFFRblock":
        if p[1] == "ca":
            return _ca("MFFRblock.ca", p[2])
        if p[1].startswith("divenh"):
            base = f"MFFRblock.DivEnh_block.{int(p[1][len('divenh'):])}"
            if len(p) == 2:  # leaf params a/b live directly on the module
                return base
            if p[2] == "ca":
                return _ca(f"{base}.ca", p[3])
        return None
    if p[0] == "recorb1":  # SCNet
        base = f"recorb1.body.{int(p[1][len('group'):])}"
        if p[2] == "conv":
            return f"{base}.conv"
        base = f"{base}.body.{int(p[2][len('block'):])}"
        sub = {"body0": "body.0", "body1": "body.2", "down": "down.0",
               "up": "up.0"}
        if p[3] in sub:
            return f"{base}.{sub[p[3]]}"
        if p[3] == "rcb":
            r = f"{base}.body.3"
            if p[4] in ("body0", "body1"):
                return f"{r}.{sub[p[4]]}"
            if p[4] == "gcnet":
                return f"{r}.gcnet.{_GCNET[p[5]]}"
    return None


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# The zoo: (flax module path without its Conv_0, port module name) patterns
# of mmedit's names, matched whole.
_SPYNET = [(rf"level(\d)/conv{i}", rf"basic_module.\1.basic_module.{2 * i}")
           for i in range(5)]
_TAIL = [(r"(upsample[12])/upsample_conv", r"\1.upsample_conv"),
         (r"(conv_hr|conv_last)", r"\1")]
_EDVR = _TAIL + [
    (r"conv_first", "conv_first"),
    (r"extract(\d+)/(conv[12])", r"feature_extraction.\1.\2"),
    (r"recon(\d+)/(conv[12])", r"reconstruction.\1.\2"),
    (r"(feat_l[23]_conv[12])", r"\1.conv"),
    (r"pcd_alignment/(offset_conv[123]|feat_conv)_(l[123])",
     r"pcd_alignment.\1.\2.conv"),
    (r"pcd_alignment/dcn_pack_(l[123])", r"pcd_alignment.dcn_pack.\1"),
    (r"pcd_alignment/dcn_pack_(l[123])/conv_offset",
     r"pcd_alignment.dcn_pack.\1.conv_offset"),
    (r"pcd_alignment/(cas_offset_conv[12])", r"pcd_alignment.\1.conv"),
    (r"pcd_alignment/cas_dcnpack", "pcd_alignment.cas_dcnpack"),
    (r"pcd_alignment/cas_dcnpack/conv_offset",
     "pcd_alignment.cas_dcnpack.conv_offset"),
    (r"fusion/(temporal_attn[12]|spatial_attn5|spatial_attn_add2)",
     r"fusion.\1"),
    (r"fusion/(feat_fusion|spatial_attn[1-4]|spatial_attn_l[1-3]"
     r"|spatial_attn_add1)", r"fusion.\1.conv"),
]
_BRANCH = r"(backward_[12]|forward_[12])"
_BASICVSR_PP = _TAIL + [
    (rf"spynet/{p}", rf"spynet.{t}") for p, t in _SPYNET] + [
    (r"(feat_extract|reconstruction)/input_conv", r"\1.main.0"),
    (r"(feat_extract|reconstruction)/block(\d+)/(conv[12])",
     r"\1.main.2.\2.\3"),
    (rf"{_BRANCH}/backbone/input_conv", r"backbone.\1.main.0"),
    (rf"{_BRANCH}/backbone/block(\d+)/(conv[12])",
     r"backbone.\1.main.2.\2.\3"),
    (rf"{_BRANCH}/deform_align", r"deform_align.\1")] + [
    (rf"{_BRANCH}/deform_align/conv_offset{i}",
     rf"deform_align.\1.conv_offset.{2 * i}") for i in range(4)]


_SPYNET_IN = [(rf"spynet/{p}", rf"spynet.{t}") for p, t in _SPYNET]
# BasicVSR's scans name the trunks backward/resblocks, forward/resblocks
_BASICVSR = _TAIL + _SPYNET_IN + [
    (r"(backward|forward)/resblocks/input_conv", r"\1_resblocks.main.0"),
    (r"(backward|forward)/resblocks/block(\d+)/(conv[12])",
     r"\1_resblocks.main.2.\2.\3"),
    (r"fusion", "fusion")]
_ICONVSR = _TAIL + _SPYNET_IN + [
    (rf"edvr/{p}", rf"edvr.{t}") for p, t in _EDVR[len(_TAIL):]
    if not p.startswith("recon")] + [
    (r"(backward|forward)_fusion", r"\1_fusion"),
    (r"(backward|forward)_resblocks/input_conv", r"\1_resblocks.main.0"),
    (r"(backward|forward)_resblocks/block(\d+)/(conv[12])",
     r"\1_resblocks.main.2.\2.\3")]
_TDAN = [
    (r"feat_conv", "feat_extract.0.conv"),
    (r"pre(\d+)/(conv[12])", r"feat_extract.1.\1.\2"),
    (r"agg_conv", "feat_aggregate.0"),
    (r"agg_dcn([12])", r"feat_aggregate.\1"),
    (r"agg_dcn([12])/conv_offset", r"feat_aggregate.\1.conv_offset"),
    (r"(align_[12])", r"\1"), (r"(align_[12])/conv_offset", r"\1.conv_offset"),
    (r"to_rgb", "to_rgb"),
    (r"rec_conv", "reconstruct.0.conv"),
    (r"post(\d+)/(conv[12])", r"reconstruct.1.\1.\2"),
    (r"up1/upsample_conv", "reconstruct.2.upsample_conv"),
    (r"up2/upsample_conv", "reconstruct.3.upsample_conv"),
    (r"final", "reconstruct.4")]


_TRUNK = r"(feat_extractor|resblocks|ftt_feat|ftt_res)"
_FTVSR = _TAIL + _SPYNET_IN + [
    (rf"{_TRUNK}/input_conv", r"\1.main.0"),
    (rf"{_TRUNK}/block(\d+)/(conv[12])", r"\1.main.2.\2.\3"),
    (r"LTAM/fusion", "LTAM.fusion"),
    (r"(fusion|conv_layer[12]|ftt_fusion[01])", r"\1")]
_FTTA_LINEAR = ("layer_q", "layer_k", "layer_v", "linear1", "linear2")


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _ftta_state_dict(tree: Mapping,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax ``FTTALayer``'s params as the port's, under ``prefix``."""
    known = set(_FTTA_LINEAR) | {"in_proj_q", "in_proj_k", "in_proj_v",
                                 "attn_out", "norm1", "norm2"}
    for name, sub in tree.items():
        leaves = {"scale", "bias"} if name.startswith("norm") \
            else {"kernel", "bias"}
        if name not in known or set(sub) != leaves:
            raise KeyError(f"no port key for JAX param {prefix}{name}/"
                           f"{sorted(sub)}")
    out = {}
    for name, torch_name in [(n, n) for n in _FTTA_LINEAR] + [
            ("attn_out", "mha.out_proj")]:
        out[f"{prefix}{torch_name}.weight"] = _tensor(tree[name]["kernel"]).t()
        out[f"{prefix}{torch_name}.bias"] = _tensor(tree[name]["bias"])
    out[f"{prefix}mha.in_proj_weight"] = torch.cat(
        [_tensor(tree[f"in_proj_{n}"]["kernel"]).t() for n in "qkv"])
    out[f"{prefix}mha.in_proj_bias"] = torch.cat(
        [_tensor(tree[f"in_proj_{n}"]["bias"]) for n in "qkv"])
    for name in ("norm1", "norm2"):
        out[f"{prefix}{name}.weight"] = _tensor(tree[name]["scale"])
        out[f"{prefix}{name}.bias"] = _tensor(tree[name]["bias"])
    return {k: v.contiguous() for k, v in out.items()}


def _ftvsr_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """FTVSRNet / TTVSRNet: the convs by pattern, the attention by
    :func:`_ftta_state_dict`."""
    out = _zoo_state_dict({k: v for k, v in tree.items() if k != "ftta"},
                          _FTVSR)
    if "ftta" in tree:
        out.update(_ftta_state_dict(tree["ftta"], "ftta."))
    return out


def _zoo_key(patterns, path: str) -> str | None:
    """The port module name of a flax module path, or None."""
    for pat, template in patterns:
        m = re.fullmatch(pat, path)
        if m is not None:
            return m.expand(template)
    return None


def _zoo_state_dict(tree: Mapping, patterns) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        v = np.asarray(value, dtype=np.float32)
        mod = path[:-1][:-1] if path[-2:-1] == ("Conv_0",) else path[:-1]
        base = _zoo_key(patterns, "/".join(mod))
        if base is None or path[-1] not in ("kernel", "weight", "bias"):
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        # conv kernels and DCN weights are HWIO; the port keeps OIHW
        out[f"{base}.{'bias' if path[-1] == 'bias' else 'weight'}"] = \
            torch.tensor(v if path[-1] == "bias" else v.transpose(3, 2, 0, 1))
    return out


# RealBasicVSR under mmedit's names: the cleaning module is
# Sequential(ResidualBlocksWithInputConv, conv), BasicVSR is ``basicvsr``
_REAL_BASICVSR = [
    (r"image_cleaning/blocks/input_conv", "image_cleaning.0.main.0"),
    (r"image_cleaning/blocks/block(\d+)/(conv[12])",
     r"image_cleaning.0.main.2.\1.\2"),
    (r"image_cleaning/conv", "image_cleaning.1")] + [
    (rf"basicvsr/{p}", rf"basicvsr.{t}") for p, t in _BASICVSR]
# the top-level names that tell the other GAN-family models apart: GLEAN,
# DIC, the StyleGAN2 generator and discriminator, the U-Net, LightCNN,
# ModifiedVGG and the VGG feature extractor
_GAN_MARKERS = ("rrdb_extractor", "hour_glass", "mlp0", "from_rgb_w",
                "conv_9", "mf0", "conv0_0", "features_0")
# DIC's transposed convs
_TRANSPOSED = re.compile(r"(.*/)?(up_block\d+|conv_up)")
_EQUAL_CONV = re.compile(r"(.+)_([wb])")


def conv_transpose_weight(kernel) -> torch.Tensor:
    """The JAX package's ``ConvTranspose2d`` kernel (k, k, Cin, Cout), an
    lhs-dilated correlation's, as ``F.conv_transpose2d``'s weight (Cin,
    Cout, k, k): flipped in both spatial axes."""
    k = np.asarray(kernel, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))


def _gan_param(module: str, leaf: str, v: np.ndarray):
    """(port key, tensor) of one GAN-family param under the JAX package's
    module names ('/' -> '.', flax's ``Conv_0`` dropped), or None."""
    def at(name):
        return f"{module}.{name}" if module else name

    if leaf == "kernel" and v.ndim == 4:
        if _TRANSPOSED.fullmatch(module):
            return at("weight"), conv_transpose_weight(v)
        return at("weight"), torch.tensor(v.transpose(3, 2, 0, 1))
    if leaf in ("kernel", "weight") and v.ndim == 2:   # dense (in, out)
        return at("weight"), torch.tensor(v.T)
    if leaf == "weight" and v.ndim == 4:               # modulated conv
        return at("weight"), torch.tensor(v.transpose(3, 2, 0, 1))
    if leaf in ("bias", "noise_weight", "constant_input"):
        return at(leaf), torch.tensor(v)
    if leaf == "alpha":
        return at("weight"), torch.tensor(v.reshape(1))
    if leaf == "scale":                                # batch norm
        return at("weight"), torch.tensor(v)
    m = _EQUAL_CONV.fullmatch(leaf)
    if m and not module:           # StyleGAN2 discriminator's econv params
        w = v.transpose(3, 2, 0, 1) if m.group(2) == "w" else v
        return f"{m.group(1)}.{'weight' if m.group(2) == 'w' else 'bias'}", \
            torch.tensor(w)
    return None


def _gan_state_dict(variables: Mapping, tree: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """The GAN family's variables: ``params``, the ``noises`` collection
    (StyleGAN2's and GLEAN's noise maps, the port's ``noise`` parameters,
    NHWC) and ``batch_stats`` (the U-Net's spectral-norm ``u`` and
    ``sigma``, the port's buffers; ModifiedVGG's running statistics)."""
    if "image_cleaning" in tree:
        return _zoo_state_dict(tree, _REAL_BASICVSR)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        v = np.asarray(value, dtype=np.float32)
        mod = [p for p in path[:-1] if p != "Conv_0"]
        mod = [f"features.{p[len('features_'):]}" if p.startswith("features_")
               else p for p in mod]
        got = _gan_param(".".join(mod), path[-1], v)
        if got is None:
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        out[got[0]] = got[1]
    for path, value in _flatten(variables.get("noises", {})):
        out[".".join(path)] = torch.tensor(np.asarray(value, np.float32))
    for path, value in _flatten(variables.get("batch_stats", {})):
        # flax names a spectral norm's variables 'conv_1/kernel/u', one key
        path = tuple(q for p in path for q in p.split("/"))
        v = torch.tensor(np.asarray(value, np.float32))
        if path[0].startswith("SpectralNorm_") and path[-1] in ("u", "sigma"):
            # SpectralNorm_i/<conv>/kernel/u -> <conv>.u
            out[f"{path[1]}.{path[-1]}"] = v
        elif path[-1] in ("mean", "var"):
            base = ".".join(path[:-1])
            out[f"{base}.running_{path[-1]}"] = v
            out[f"{base}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"no port key for JAX batch_stats "
                           f"{'/'.join(path)}")
    unknown = set(variables) - {"params", "noises", "batch_stats"}
    if unknown and "params" in variables:
        raise KeyError(f"no port keys for JAX collections {sorted(unknown)}")
    return out


# The CVCP family's top-level module names (JAX's, which are the port's),
# each family told apart by its first names
_CVCP = {
    "SIDECVSR": (("mv_patch_attn",), re.compile(
        r"conv_first|side[0-3]|sft_rb[0-6]|mv_patch_attn|attn_[qp]"
        r"|tsa_fusion|recon_trunk|upconv1_L[23]|upconv[12]|conv_last")),
    "FCVSRTFDCNet": (("TFDC", "Spa_freqblock0"), re.compile(
        r"lrelu|TFDC|feat_extract|Spa_freqblock0|rconcat[12]|recorb[01]"
        r"|upconv1_L[23]|upconv1_L2_2|upconv_fuse|upconv[12]|conv_last0")),
    "RAFT": (("fnet", "update_block"), re.compile(r"[fc]net|update_block")),
}


def _cvcp_param(path, v: np.ndarray):
    """(port key, tensor) of one param of SIDECVSR, FCVSR-TFDC, RAFT or the
    single-image family, or None: the module path without flax's
    ``Conv_0``, a ``CALayer``'s (``CA2``'s, or ``CA``'s in ``CAB`` and the
    U-Net blocks) ``down`` / ``up`` as ``conv_du.0`` / ``.2``;
    conv kernels OIHW, dense kernels (in, out) ``Linear`` weights (out,
    in), a norm's ``scale`` its ``weight``, PReLU's ``alpha`` its (1,)
    weight."""
    mod = []
    for p in path[:-1]:
        if p == "Conv_0":
            continue
        if mod and mod[-1] in ("CA", "CA2") and p in ("down", "up"):
            p = "conv_du.0" if p == "down" else "conv_du.2"
        mod.append(p)
    leaf = path[-1]

    def at(name):
        return ".".join(mod + [name])

    if leaf == "kernel" and v.ndim == 4:
        return at("weight"), torch.tensor(v.transpose(3, 2, 0, 1))
    if leaf == "kernel" and v.ndim == 2:
        return at("weight"), torch.tensor(v.T)
    if leaf in ("bias", "beta") or (leaf == "weight" and v.ndim == 1):
        return at(leaf), torch.tensor(v)
    if leaf == "scale":
        return at("weight"), torch.tensor(v)
    if leaf == "alpha":
        return at("weight"), torch.tensor(v.reshape(1))
    return None


def _cvcp_state_dict(variables: Mapping, tree: Mapping,
                     names) -> Dict[str, torch.Tensor]:
    """SIDECVSR, FCVSR-TFDC or RAFT: ``params`` by :func:`_cvcp_param`,
    ``batch_stats`` (RAFT's context encoder, ``FourierUnit.bn``) as the
    batch norms' running statistics."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        got = None
        if names.fullmatch(path[0]):
            got = _cvcp_param(path, np.asarray(value, np.float32))
        if got is None:
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        out[got[0]] = got[1]
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[-1] not in ("mean", "var") or not names.fullmatch(path[0]):
            raise KeyError(f"no port key for JAX batch_stats "
                           f"{'/'.join(path)}")
        base = ".".join(path[:-1])
        out[f"{base}.running_{path[-1]}"] = torch.tensor(
            np.asarray(value, np.float32))
        out[f"{base}.num_batches_tracked"] = torch.tensor(0)
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown and "params" in variables:
        raise KeyError(f"no port keys for JAX collections {sorted(unknown)}")
    return out


def block_state_dict_from_jax(variables: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """The variables (``params``, and ``batch_stats`` for ``FourierUnit``'s
    batch norms in either mode) of one JAX ``blocks_ext`` block or
    composite (``CAB``, ``FSAS``, ``EncoderShiftBlock``, ``TFRUNet``,
    ...), which no family name tells apart, onto the port module's
    ``state_dict`` under the JAX package's module names
    (:func:`_cvcp_param`; a ``WithBiasLayerNorm``'s ``weight`` / ``bias``
    keep theirs).  Raises ``KeyError`` on a param or a statistic it cannot
    map."""
    return _cvcp_state_dict(variables, variables.get("params", {}),
                            re.compile(".+"))


# The single-image family's names that no older tree has, each tuple all
# present: LIIF's imnet, EDSR's trunk (also LIIF-EDSR's), RDN's (also
# LIIF-RDN's), RRDBNet's, TTSR's and TTSRNet's, TOFlow's fusion beside its
# spynet (BasicVSR++'s marker), SRCNN's convs.  MSRResNet has conv_first
# and conv_hr, which EDVR has too, with its pcd_alignment.
_SISR_MARKERS = (("imnet",), ("conv_after_body",), ("sfe1",),
                 ("conv_body",), ("extractor", "generator"), ("sfe_first",),
                 ("spynet", "conv_4"), ("conv1", "conv3"),
                 ("conv_first", "conv_hr"))


def _is_sisr(tree: Mapping) -> bool:
    return "pcd_alignment" not in tree and any(
        all(n in tree for n in names) for names in _SISR_MARKERS)


def _sisr_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """EDSR, SRCNN, MSRResNet, RRDBNet, RDN, TOFlow, LIIF-EDSR, LIIF-RDN,
    TTSR and TTSRNet under the JAX package's names
    (:func:`_cvcp_param`); TOFlow's SPyNet under mmedit's."""
    out: Dict[str, torch.Tensor] = {}
    if "spynet" in tree:
        out.update({f"spynet.{k}": v for k, v in _zoo_state_dict(
            tree["spynet"], _SPYNET).items()})
    for path, value in _flatten(tree):
        if path[0] == "spynet":
            continue
        got = _cvcp_param(path, np.asarray(value, np.float32))
        if got is None:
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        out[got[0]] = got[1]
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax FCVSRNet, EDVRNet, BasicVSRNet, BasicVSRPlusPlus, IconVSR,
    TDANNet, FTVSRNet (TTVSRNet) or SpyNet param
    tree (``{'params': ...}`` or its inside, numpy-convertible leaves; the
    model is told by its top-level names) onto the port's ``state_dict``
    keys.  Raises ``KeyError`` on a param it cannot map.

    The GAN family (RealBasicVSR, GLEAN, DIC, the StyleGAN2 generator and
    discriminator, the U-Net, LightCNN, ModifiedVGG, the VGG feature
    extractor) takes the whole variables dict: ``params`` with ``noises``
    and ``batch_stats`` beside it.  RealBasicVSR maps onto mmedit's names;
    the others keep the JAX package's module names, '/' turned to '.'
    (``Conv_0`` dropped), dense kernels (in, out) become (out, in)
    weights, conv and modulated-conv kernels OIHW, DIC's transposed-conv
    kernels are flipped (:func:`conv_transpose_weight`) and StyleGAN2's
    ``constant_input`` and noise maps stay NHWC.

    SIDECVSR, FCVSR-TFDC and RAFT take the whole variables dict too
    (``params`` and ``batch_stats``: RAFT's context encoder and
    FCVSR-TFDC's ``FourierUnit`` batch norms) and keep the JAX package's
    module names (:func:`_cvcp_param`); the JAX package's key map has no
    reference names for them.  So do EDSR, SRCNN, MSRResNet, RRDBNet, RDN,
    TOFlow (its SPyNet under mmedit's names), LIIF-EDSR, LIIF-RDN, TTSR and
    TTSRNet (:func:`_sisr_state_dict`), each told by names that no older
    tree has (``_SISR_MARKERS``), checked before the older markers they
    share."""
    tree = params.get("params", params)
    if any(m in tree for m in ("image_cleaning",) + _GAN_MARKERS):
        return _gan_state_dict(params, tree)
    for markers, names in _CVCP.values():
        if any(m in tree for m in markers):
            return _cvcp_state_dict(params, tree, names)
    if _is_sisr(tree):
        return _sisr_state_dict(tree)
    # FTVSR has a SpyNet too: its marker goes first
    if "LTAM" in tree:
        return _ftvsr_state_dict(tree)
    for marker, patterns in (("pcd_alignment", _EDVR), ("edvr", _ICONVSR),
                             ("align_1", _TDAN), ("backward", _BASICVSR),
                             ("spynet", _BASICVSR_PP), ("level0", _SPYNET)):
        if marker in tree:
            return _zoo_state_dict(tree, patterns)
    out: Dict[str, torch.Tensor] = {}
    divenh = {}
    for path, value in _flatten(tree):
        v = np.asarray(value, dtype=np.float32)
        base = flax_to_torch_key("/".join(path[:-1]))
        leaf = path[-1]
        if base is None:
            raise KeyError(f"no port key for JAX param {'/'.join(path)}")
        if leaf == "kernel":
            out[f"{base}.weight"] = torch.tensor(v.transpose(3, 2, 0, 1))
        elif leaf == "bias":
            out[f"{base}.bias"] = torch.tensor(v)
        elif leaf == "alpha":
            out[f"{base}.weight"] = torch.tensor(v.reshape(1))
        elif leaf in ("a", "b"):
            out[f"{base}.{leaf}"] = torch.tensor(v.reshape(-1, 1, 1))
            divenh[base] = v.size
        else:
            raise KeyError(f"unknown JAX param leaf {'/'.join(path)}")
    # DivEnh.Conv is never called by the forward and the JAX tree has no
    # param for it; zeros fill it so that load_state_dict(strict=True) holds.
    for base, c in divenh.items():
        out[f"{base}.Conv.weight"] = torch.zeros(c, c, 3, 3)
        out[f"{base}.Conv.bias"] = torch.zeros(c)
    return out


def _from_cat3(w3) -> torch.Tensor:
    """The JAX conv kernels' cat3 layout (3, Cout, 3 Cin), ``w3[dy, co,
    dx Cin + ci] = W[dy, dx, ci, co]`` (``pallas_conv.prep_weight``), back
    to HWIO (3, 3, Cin, Cout)."""
    w3 = np.asarray(w3, np.float32)
    kh, cout, k = w3.shape
    if kh != 3 or k % 3:
        raise ValueError(f"not a cat3 weight: {w3.shape}")
    return torch.from_numpy(np.ascontiguousarray(
        w3.reshape(3, cout, 3, k // 3).transpose(0, 2, 3, 1)))


def _vec(v):
    return None if v is None else torch.from_numpy(
        np.ascontiguousarray(np.asarray(v, np.float32).reshape(-1)))


def block_rcb_args_from_jax(wb0, bb0, wb1, bb1, wr0, wr1, w_mask, w_add0,
                            w_add1) -> dict:
    """``block_rcb_rows``'s weights (cat3 convs, (C,) biases or None, the
    (C,) mask and the (C, C) MLP matrices) as ``block_rcb``'s keyword
    arguments: HWIO float32 CPU tensors."""
    return dict(wb0=_from_cat3(wb0), bb0=_vec(bb0), wb1=_from_cat3(wb1),
                bb1=_vec(bb1), wr0=_from_cat3(wr0), wr1=_from_cat3(wr1),
                w_mask=_vec(w_mask),
                w_add0=torch.from_numpy(np.array(w_add0, np.float32)),
                w_add1=torch.from_numpy(np.array(w_add1, np.float32)))


def block_rcb_args(blk) -> dict:
    """A port ``BlockRCB``'s weights as ``block_rcb``'s keyword arguments,
    on the module's device: HWIO convs, the ContextBlock's 1x1 mask (C,)
    and MLP matrices (C, C) laid out (in, out)."""
    from ..models.scnet_rows import conv_bias, hwio

    body0, body1, rcb = blk.body[0], blk.body[2], blk.body[3]
    gc = rcb.gcnet
    return dict(wb0=hwio(body0), bb0=conv_bias(body0), wb1=hwio(body1),
                bb1=conv_bias(body1), wr0=hwio(rcb.body[0]),
                wr1=hwio(rcb.body[2]),
                w_mask=gc.conv_mask.weight.detach()[0, :, 0, 0].contiguous(),
                w_add0=gc.channel_add_conv[0].weight.detach()[:, :, 0, 0]
                .t().contiguous(),
                w_add1=gc.channel_add_conv[2].weight.detach()[:, :, 0, 0]
                .t().contiguous())
