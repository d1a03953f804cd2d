"""Models of the port (channels-last inside, reference key names): FCVSR
(with its ETC mode), and the zoo's EDVR, BasicVSR, BasicVSR++, IconVSR,
TDAN, FTVSR, TTVSR and SPyNet; the single-image models EDSR, SRCNN,
MSRResNet, RRDBNet and RDN, TOFlow, LIIF (on EDSR's and RDN's trunks) and
the reference-based TTSR; the CVCP compressed-VSR family (SIDECVSR
on HEVC side information, FCVSR-TFDC) and RAFT; the restorer that trains
and evaluates them; batched sliding-window and tiled serving (``models.inference``);
and the GAN family: RealBasicVSR, GLEAN (on StyleGAN2), DIC, the three
discriminators and the GAN restorer that trains them."""

from .basicvsr import BasicVSRNet
from .basicvsr_pp import BasicVSRPlusPlus
from .dic import DICNet, FeedbackHourglass
from .discriminators import (LightCNN, ModifiedVGG,
                             UNetDiscriminatorWithSpectralNorm)
from .edvr import EDVRNet
from .fcvsr import MFFR, MGAA, FCVSRNet, fcvsr_etc_forward, init_weights
from .fcvsr_tfdc import FCVSRTFDCNet
from .ftvsr import FTVSRNet, TTVSRNet
from .gan_restorer import GANRestorer
from .glean import GLEANStyleGANv2
from .iconvsr import IconVSR, TDANNet
from .inference import sliding_window_sr, tiled_sr
from .liif import LIIFEDSR, LIIFRDN
from .raft import RAFT, raft_flow
from .real_basicvsr import RealBasicVSRNet
from .registry import BACKBONES, LOSSES, build
from .restorers import VideoRestorer, tensor2img
from .sidecvsr import SIDECVSR
from .sisr import EDSR, RDN, SRCNN, MSRResNet, RRDBNet, TOFlow
from .spynet import SpyNet, spynet_flow
from .stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
from .ttsr import TTSR, TTSRNet

__all__ = ["BACKBONES", "BasicVSRNet", "BasicVSRPlusPlus", "DICNet", "EDSR",
           "EDVRNet", "FCVSRNet", "FCVSRTFDCNet", "FTVSRNet", "FeedbackHourglass",
           "GANRestorer", "GLEANStyleGANv2", "IconVSR", "LIIFEDSR", "LIIFRDN",
           "LOSSES", "LightCNN", "MGAA", "MFFR", "MSRResNet", "ModifiedVGG",
           "RAFT", "RDN", "RRDBNet", "RealBasicVSRNet", "SIDECVSR", "SRCNN",
           "SpyNet", "StyleGAN2Discriminator", "StyleGAN2Generator",
           "TDANNet", "TOFlow", "TTSR", "TTSRNet", "TTVSRNet",
           "UNetDiscriminatorWithSpectralNorm", "VideoRestorer", "build",
           "fcvsr_etc_forward", "init_weights", "raft_flow",
           "sliding_window_sr", "spynet_flow", "tensor2img", "tiled_sr"]
