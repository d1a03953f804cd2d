"""The whole forward's share of the chip's peak: ``work.py``'s operations
of one window's forward for every frame delivered, over the window's wall
time, over the bf16 tensor-core peak.  Padded windows count for nothing."""

from h100bench.work import PEAK_FLOP_S


def read(t):
    if t.kind != "serve" or not t.frames:
        return None
    flops = t.work["total"]["flops"] * t.frames
    return 100.0 * flops / t.window_s / PEAK_FLOP_S
