"""The whole training step's share of the chip's peak: 3 x the forward's
operations (``work.py``) for every clip a completed step consumed, over the
window's wall time, over the bf16 tensor-core peak."""

from h100bench.work import PEAK_FLOP_S


def read(t):
    if t.kind != "train" or not t.clips:
        return None
    flops = 3 * t.train_flops_per_clip * t.clips
    return 100.0 * flops / t.window_s / PEAK_FLOP_S
