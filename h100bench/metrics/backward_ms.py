"""The backward's CUDA-event time a step, the median over the window's
steps: from the model output's gradient (the loss's own backward is
before it) to the update's start, so it holds the accumulation of the
gradients."""

import statistics


def read(t):
    v = [s["backward_ms"] for s in t.steps]
    return statistics.median(v) if t.kind == "train" and v else None
