"""FCVSR models of the port (channels-last inside, reference key names)."""

from .fcvsr import MFFR, MGAA, FCVSRNet, init_weights

__all__ = ["FCVSRNet", "MGAA", "MFFR", "init_weights"]
