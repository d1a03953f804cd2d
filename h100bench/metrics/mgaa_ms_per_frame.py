"""MGAA's CUDA-event time a frame, its three calls summed: the median over
the window's forwards of the stage's time over the forward's batch."""

import statistics


def read(t):
    v = [f["stages"]["MGAA"] / f["batch"] for f in t.forwards
         if "MGAA" in f["stages"]]
    return statistics.median(v) if t.kind == "serve" and v else None
