"""SCNet's share of its roofline: its least time (the larger of its
operations at the bf16 tensor-core peak and its bytes at HBM's rate, from
``work.py``) over its measured time, the median over the window's
forwards."""

import statistics

from h100bench.work import least_time_s


def read(t):
    if t.kind != "serve":
        return None
    s = t.work["SCNet"]
    v = [least_time_s(s["flops"] * f["batch"], s["bytes"] * f["batch"])
         * 1e3 / f["stages"]["SCNet"]
         for f in t.forwards if f["stages"].get("SCNet")]
    return 100.0 * statistics.median(v) if v else None
