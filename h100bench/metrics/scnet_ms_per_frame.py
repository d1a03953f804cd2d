"""SCNet's CUDA-event time a frame: the median over the window's forwards
of the stage's time over the forward's batch."""

import statistics


def read(t):
    v = [f["stages"]["SCNet"] / f["batch"] for f in t.forwards
         if "SCNet" in f["stages"]]
    return statistics.median(v) if t.kind == "serve" and v else None
