"""Models of the port (channels-last inside, reference key names): FCVSR,
and the zoo's EDVR, BasicVSR++ and SPyNet."""

from .basicvsr_pp import BasicVSRPlusPlus
from .edvr import EDVRNet
from .fcvsr import MFFR, MGAA, FCVSRNet, init_weights
from .registry import BACKBONES, build
from .spynet import SpyNet

__all__ = ["BACKBONES", "BasicVSRPlusPlus", "EDVRNet", "FCVSRNet", "MGAA",
           "MFFR", "SpyNet", "build", "init_weights"]
