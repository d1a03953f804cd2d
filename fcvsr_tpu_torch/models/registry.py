"""Backbone registry (counterpart of ``fcvsr_tpu.models.registry``):
``build(BACKBONES, dict(type='EDVRNet', mid_channels=64))`` builds a model
from an mmedit-style config.  Only the models the port has are registered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from .basicvsr import BasicVSRNet
from .basicvsr_pp import BasicVSRPlusPlus
from .edvr import EDVRNet
from .fcvsr import FCVSRNet
from .iconvsr import IconVSR, TDANNet
from .spynet import SpyNet

__all__ = ["Registry", "BACKBONES", "build"]


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register_obj(self, name: str, obj):
        self._entries[name] = obj
        return obj

    def get(self, name: str):
        if name not in self._entries:
            raise KeyError(f"{self.name} registry has no '{name}'; "
                           f"known: {sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name):
        return name in self._entries

    def keys(self):
        return sorted(self._entries)


def build(registry: Registry, cfg: dict) -> Any:
    """``cfg['type']`` names the entry; the other keys are its arguments."""
    cfg = dict(cfg)
    return registry.get(cfg.pop("type"))(**cfg)


BACKBONES = Registry("backbones")
for _cls in (FCVSRNet, EDVRNet, BasicVSRNet, BasicVSRPlusPlus, IconVSR,
             TDANNet, SpyNet):
    BACKBONES.register_obj(_cls.__name__, _cls)
BACKBONES.register_obj("FCVSR_SNet", FCVSRNet.small)
