"""Models of the port (channels-last inside, reference key names): FCVSR,
and the zoo's EDVR, BasicVSR++ and SPyNet; and the restorer that trains
and evaluates them."""

from .basicvsr_pp import BasicVSRPlusPlus
from .edvr import EDVRNet
from .fcvsr import MFFR, MGAA, FCVSRNet, init_weights
from .registry import BACKBONES, build
from .restorers import VideoRestorer, tensor2img
from .spynet import SpyNet

__all__ = ["BACKBONES", "BasicVSRPlusPlus", "EDVRNet", "FCVSRNet", "MGAA",
           "MFFR", "SpyNet", "VideoRestorer", "build", "init_weights",
           "tensor2img"]
