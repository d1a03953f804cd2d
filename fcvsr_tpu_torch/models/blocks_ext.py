"""Library blocks of ``fcvsr_tpu.models.blocks_ext`` that the port's models
use; the rest stay to be ported.

``PixelShufflePack`` (a conv to ``out_channels * r * r`` channels, then
depth-to-space in torch's channel order) is the zoo's
``MMPixelShufflePack``, under the JAX package's name: its parameters are
``upsample_conv.weight`` / ``.bias`` in both."""

from __future__ import annotations

from .basicvsr import MMPixelShufflePack as PixelShufflePack

__all__ = ["PixelShufflePack"]
