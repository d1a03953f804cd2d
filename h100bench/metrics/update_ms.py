"""The update's CUDA-event time a step (``TrainState.apply_gradients``:
the schedule and Adam), the median over the window's steps."""

import statistics


def read(t):
    v = [s["update_ms"] for s in t.steps]
    return statistics.median(v) if t.kind == "train" and v else None
