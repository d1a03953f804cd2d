"""Experiment configuration and the FCVSR presets (the port's own copy of
``fcvsr_tpu.utils.config``, for the two models the port runs).

One dataclass covers the reference's config axes {model} x {dataset} x
{QP}.  The presets reproduce the shipped FCVSR configs
(configs/restorers/fcvsr/fcvsr[_s]_{cvcp,reds,vimeo}LD_QP{22,27,32,37}.py):
the CVCP ones follow the CVSR_train recipe (Y, Adam 0.5e-5 / 1e-4,
MultiStepLR, Charbonnier-sum), the REDS / Vimeo ones the mmedit recipe
(RGB, Adam 2e-4, CosineRestart, Charbonnier-mean).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

__all__ = ["ExperimentConfig", "preset", "PRESET_NAMES"]


@dataclass
class ModelConfig:
    name: str = "fcvsr"           # fcvsr | fcvsr_s
    n_feats: int = 64
    in_channels: int = 3          # 1 = Y (CVCP), 3 = RGB (REDS/Vimeo)
    num_frames: int = 7


@dataclass
class DataConfig:
    dataset: str = "reds"         # cvcp | reds | vimeo
    qp: int = 37
    lr_root: str = ""
    gt_root: str = ""
    meta_file: str = ""           # Vimeo-90K septuplet list (vimeo only)
    lr_patch: int = 128           # LR crop (mmedit: gt_patch 512 -> lq 128)
    batch_size: int = 2
    window_padding: str = "replicate"


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
class EvalConfig:
    crop_border: int = 0
    convert_to: Optional[str] = "Y"


_SECTIONS = {"model": ModelConfig, "data": DataConfig, "train": TrainConfig,
             "eval": EvalConfig}


@dataclass
class ExperimentConfig:
    name: str = "fcvsr_redsLD_QP37"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
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

PRESET_NAMES = [f"{m}_{d}LD_QP{q}" for m in _MODELS for d in _DATASETS
                for q in _QPS]


def preset(name: str) -> ExperimentConfig:
    """The preset ``fcvsr[_s]_{cvcp,reds,vimeo}LD_QP{22,27,32,37}``."""
    if name not in PRESET_NAMES:
        raise KeyError(f"unknown preset {name}; options: {PRESET_NAMES[:4]}...")
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
