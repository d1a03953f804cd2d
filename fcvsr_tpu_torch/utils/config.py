"""Experiment configuration and the FCVSR, FTVSR and GAN presets (the
port's own copy of ``fcvsr_tpu.utils.config``, for the models the port
trains).

One dataclass covers the reference's config axes {model} x {dataset} x
{QP}.  The presets reproduce the shipped FCVSR configs
(configs/restorers/fcvsr/fcvsr[_s]_{cvcp,reds,vimeo}LD_QP{22,27,32,37}.py):
the CVCP ones follow the CVSR_train recipe (Y, Adam 0.5e-5 / 1e-4,
MultiStepLR, Charbonnier-sum), the REDS / Vimeo ones the mmedit recipe
(RGB, Adam 2e-4, CosineRestart, Charbonnier-mean); and the 7 FTVSR
configs (configs/restorers/ftvsr/: RGB, 7-frame segments, Adam 2e-4,
CosineRestart, Charbonnier-mean, batch 1, LR patches of 64); and the 5
GAN recipes (``realbasicvsr_reds``, ``realbasicvsr_wogan_reds``,
``glean_cat_8x``, ``dic_celeba``, ``dic_gan_celeba``: two Adam optimisers,
a generator and one of three discriminators, ``GANConfig``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

__all__ = ["ExperimentConfig", "preset", "PRESET_NAMES"]


@dataclass
class ModelConfig:
    name: str = "fcvsr"  # fcvsr | fcvsr_s | ftvsr | ttvsr | realbasicvsr
    #                      | glean | dic
    n_feats: int = 64
    in_channels: int = 3          # 1 = Y (CVCP), 3 = RGB (REDS/Vimeo)
    num_frames: int = 7
    num_blocks: int = 0           # recurrent trunk depth (0 = model default)
    in_size: int = 0              # GLEAN fixed LR size (0 = model default)
    out_size: int = 0             # GLEAN StyleGAN2 output size
    num_steps: int = 0            # DIC feedback steps (0 = model default)
    hg_num_keypoints: int = 68    # DIC landmark heatmap count


@dataclass
class DataConfig:
    dataset: str = "reds"         # cvcp | reds | vimeo
    qp: int = 37
    lr_root: str = ""
    gt_root: str = ""
    ann_file: str = ""            # kept for the JAX config's sake
    meta_file: str = ""           # Vimeo-90K septuplet list (vimeo only)
    lr_patch: int = 128           # LR crop (mmedit: gt_patch 512 -> lq 128)
    batch_size: int = 2
    window_padding: str = "replicate"
    # RealBasicVSR: synthesize the LQ from the GT with the second-order
    # degradation chain (``data.degradations``; lr_root then unused)
    degradations: bool = False


@dataclass
class TrainConfig:
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.99)
    schedule: str = "cosine_restart"   # cosine_restart | multistep | linear
    total_iters: int = 600000
    milestones: Sequence[int] = field(
        default_factory=lambda: [2000, 6000, 10000, 120000])
    gamma: float = 0.25
    min_lr: float = 1e-7
    loss: str = "charbonnier_mean"     # charbonnier_mean | charbonnier_sum
    ckpt_interval: int = 5000
    eval_interval: int = 5000
    log_interval: int = 100
    seed: int = 0
    use_ema: bool = False
    resume_from: str = ""
    load_from: str = ""


@dataclass
class GANConfig:
    """The two-optimiser adversarial recipe (mmedit restorers/srgan.py,
    real_basicvsr.py, glean.py, dic.py): the discriminator, the GAN loss's
    type and weight, the pixel and cleaning weights, D's lr, the gating of
    the generator's update and the relativistic variant."""

    enabled: bool = False
    disc: str = "unet_sn"         # unet_sn | stylegan2 | lightcnn | none
    gan_type: str = "vanilla"
    gan_loss_weight: float = 5e-2
    pixel_loss_weight: float = 1.0
    cleaning_loss_weight: float = 0.0   # RealBasicVSR cleaning branch
    disc_lr: float = 1e-4
    disc_steps: int = 1
    disc_init_steps: int = 0
    relativistic: bool = False


@dataclass
class EvalConfig:
    crop_border: int = 0
    convert_to: Optional[str] = "Y"
    metrics: Sequence[str] = field(default_factory=lambda: ["PSNR", "SSIM"])
    save_images: bool = False


_SECTIONS = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig,
             "gan": GANConfig, "eval": EvalConfig}


@dataclass
class ExperimentConfig:
    name: str = "fcvsr_redsLD_QP37"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    gan: GANConfig = field(default_factory=GANConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    work_dir: str = "./work_dirs"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        """Read a config written by :meth:`to_json`, or by the JAX package
        (whose extra fields and sections, for models the port does not run,
        are ignored)."""
        raw = json.loads(text)
        parts = {}
        for key, kind in _SECTIONS.items():
            names = {f.name for f in dataclasses.fields(kind)}
            vals = {k: v for k, v in raw.get(key, {}).items() if k in names}
            if "betas" in vals:
                vals["betas"] = tuple(vals["betas"])
            parts[key] = kind(**vals)
        return cls(name=raw.get("name", "custom"),
                   work_dir=raw.get("work_dir", "./work_dirs"), **parts)


_QPS = (22, 27, 32, 37)
_MODELS = ("fcvsr", "fcvsr_s")
_DATASETS = ("cvcp", "reds", "vimeo")
# the 7 reference FTVSR configs (configs/restorers/ftvsr/)
_FTVSR_PRESETS = (
    "ftvsr_cvcp", "ftvsr_cvcpLD_QP22", "ftvsr_cvcpLD_QP27",
    "ftvsr_cvcpLD_QP32", "ftvsr_cvcpLD_QP37", "ftvsr_reds4",
    "ftvsr_vimeo90k",
)

# the GAN and feedback recipes (the JAX package's ``_gan_preset``)
_GAN_PRESETS = (
    "realbasicvsr_reds", "realbasicvsr_wogan_reds",
    "glean_cat_8x", "dic_celeba", "dic_gan_celeba",
)

PRESET_NAMES = [f"{m}_{d}LD_QP{q}" for m in _MODELS for d in _DATASETS
                for q in _QPS] + list(_FTVSR_PRESETS) + list(_GAN_PRESETS)


def _ftvsr_preset(name: str) -> ExperimentConfig:
    """An FTVSR recipe: RGB, 7-frame training segments (the reference
    trains longer REDS segments), Adam 2e-4, CosineRestart,
    Charbonnier-mean, batch 1, LR patches of 64 (GT 256); the dataset (and
    a CVCP config's QP) from the name."""
    cfg = ExperimentConfig(name=name)
    cfg.model.name = "ftvsr"
    cfg.model.in_channels = 3
    cfg.model.num_frames = 7
    if "cvcp" in name:
        cfg.data.dataset = "cvcp"
        if "QP" in name:
            cfg.data.qp = int(name.rsplit("QP", 1)[1])
    elif "reds" in name:
        cfg.data.dataset = "reds"
    else:
        cfg.data.dataset = "vimeo"
    cfg.train.lr = 2e-4
    cfg.train.schedule = "cosine_restart"
    cfg.train.loss = "charbonnier_mean"
    cfg.data.batch_size = 1
    cfg.data.lr_patch = 64
    return cfg


def _gan_preset(name: str) -> ExperimentConfig:
    """A GAN or feedback recipe.  RealBasicVSR: 7-frame clips, batch 2, LR
    patches of 64 made from the GT by the degradation chain, Adam 5e-5, the
    cleaning loss at weight 1, the U-Net discriminator at GAN weight 5e-2
    (``wogan``: no discriminator, Adam 1e-4).  GLEAN: 32 -> 256, batch 2,
    Adam 1e-4, StyleGAN2's discriminator at GAN weight 1e-2.  DIC: 4
    feedback steps, 16 -> 128, batch 2, Adam 1e-4, pixel weight 1
    (``gan``: LightCNN at GAN weight 5e-3).  Every recipe names the
    CosineRestart schedule, which the GAN trainer does not apply (its
    Adams run at constant lr, as the JAX package's do)."""
    cfg = ExperimentConfig(name=name)
    cfg.train.schedule = "cosine_restart"
    cfg.train.loss = "charbonnier_mean"
    cfg.gan.enabled = True
    cfg.data.batch_size = 2
    if name.startswith("realbasicvsr"):
        cfg.model.name = "realbasicvsr"
        cfg.model.num_frames = 7
        cfg.data.lr_patch = 64
        cfg.data.degradations = True
        cfg.train.lr = 5e-5
        cfg.gan.cleaning_loss_weight = 1.0
        if "wogan" in name:
            cfg.gan.disc = "none"
            cfg.train.lr = 1e-4
        else:
            cfg.gan.disc = "unet_sn"
            cfg.gan.gan_loss_weight = 5e-2
    elif name.startswith("glean"):
        cfg.model.name = "glean"
        cfg.model.in_size, cfg.model.out_size = 32, 256
        cfg.data.lr_patch = 32
        cfg.train.lr = 1e-4
        cfg.gan.disc = "stylegan2"
        cfg.gan.gan_loss_weight = 1e-2
        cfg.gan.disc_lr = 1e-4
    else:
        cfg.model.name = "dic"
        cfg.model.num_steps = 4
        cfg.data.lr_patch = 16
        cfg.train.lr = 1e-4
        cfg.gan.pixel_loss_weight = 1.0
        if "gan" in name:
            cfg.gan.disc = "lightcnn"
            cfg.gan.gan_loss_weight = 5e-3
        else:
            cfg.gan.disc = "none"
    return cfg


def preset(name: str) -> ExperimentConfig:
    """The preset ``fcvsr[_s]_{cvcp,reds,vimeo}LD_QP{22,27,32,37}``, one of
    the 7 FTVSR configs (``ftvsr_cvcp[LD_QP*]``, ``ftvsr_reds4``,
    ``ftvsr_vimeo90k``) or one of the 5 GAN recipes."""
    if name not in PRESET_NAMES:
        raise KeyError(f"unknown preset {name}; options: {PRESET_NAMES[:4]}...")
    if name in _FTVSR_PRESETS:
        return _ftvsr_preset(name)
    if name in _GAN_PRESETS:
        return _gan_preset(name)
    head, qp = name.rsplit("_QP", 1)
    model, ds = head.rsplit("_", 1)
    cfg = ExperimentConfig(name=name)
    cfg.model.name = model
    cfg.data.dataset = ds[:-len("LD")]
    cfg.data.qp = int(qp)
    if cfg.data.dataset == "cvcp":
        # CVSR_train recipe (train_LD_freqCVSR_22.py:33-45)
        cfg.model.in_channels = 1
        cfg.train.lr = 0.5e-5 if model == "fcvsr" else 1e-4
        cfg.train.schedule = "multistep"
        cfg.train.loss = "charbonnier_sum"
        cfg.data.batch_size = 6 if model == "fcvsr" else 4
        cfg.data.lr_patch = 128
    else:
        # mmedit recipe (fcvsr_redsLD_QP37.py:92-105)
        cfg.model.in_channels = 3
        cfg.train.lr = 2e-4
        cfg.train.schedule = "cosine_restart"
        cfg.train.loss = "charbonnier_mean"
        cfg.data.batch_size = 2
        cfg.data.lr_patch = 128 if model == "fcvsr" else 64
    return cfg
