"""Models of the port (channels-last inside, reference key names): FCVSR
(with its ETC mode), and the zoo's EDVR, BasicVSR, BasicVSR++, IconVSR,
TDAN, FTVSR, TTVSR and SPyNet; the restorer that trains and evaluates
them; and batched sliding-window and tiled serving
(``models.inference``)."""

from .basicvsr import BasicVSRNet
from .basicvsr_pp import BasicVSRPlusPlus
from .edvr import EDVRNet
from .fcvsr import MFFR, MGAA, FCVSRNet, fcvsr_etc_forward, init_weights
from .ftvsr import FTVSRNet, TTVSRNet
from .iconvsr import IconVSR, TDANNet
from .inference import sliding_window_sr, tiled_sr
from .registry import BACKBONES, build
from .restorers import VideoRestorer, tensor2img
from .spynet import SpyNet

__all__ = ["BACKBONES", "BasicVSRNet", "BasicVSRPlusPlus", "EDVRNet",
           "FCVSRNet", "FTVSRNet", "IconVSR", "MGAA", "MFFR", "SpyNet",
           "TDANNet", "TTVSRNet", "VideoRestorer", "build",
           "fcvsr_etc_forward", "init_weights", "sliding_window_sr",
           "tensor2img", "tiled_sr"]
