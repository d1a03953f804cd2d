"""The per-layer readers on a made-up window: each returns its number
where its cells' kind has something to read, and None elsewhere (never 0
for a share of a roofline or a peak)."""

from types import SimpleNamespace

import pytest

from h100bench import harness, work

BENCH = harness.load_benchmark()
CFG = harness.load_config(BENCH, "fcvsr_cvcp_y")
W = work.forward_work(CFG, 272, 480)


def serve(**kw):
    fw = [{"batch": 8, "ms": 800.0, "stages": {"SCNet": 400.0,
                                                "MGAA": 160.0}},
          {"batch": 8, "ms": 820.0, "stages": {"SCNet": 440.0,
                                                "MGAA": 200.0}}]
    return SimpleNamespace(**{"kind": "serve", "forwards": fw, "steps": [],
                              "window_s": 2.0, "busy_s": 1.8, "frames": 16,
                              "work": W, **kw})


def train(**kw):
    steps = [{"forward_ms": 150.0, "backward_ms": 250.0, "update_ms": 2.0},
             {"forward_ms": 160.0, "backward_ms": 270.0, "update_ms": 4.0}]
    return SimpleNamespace(**{"kind": "train", "forwards": [], "steps": steps,
                              "window_s": 1.0, "busy_s": 0.6, "clips": 12,
                              "train_flops_per_clip": 1e12, **kw})


def test_serve_readers():
    t = serve()
    read = harness.reader
    assert read("outside_forward_share.serve")(t) == pytest.approx(19.0)
    assert read("scnet_ms_per_frame")(t) == pytest.approx(52.5)
    assert read("mgaa_ms_per_frame")(t) == pytest.approx(22.5)
    assert read("idle_share.serve")(t) == pytest.approx(10.0)
    mfu = 100 * W["total"]["flops"] * 16 / 2.0 / work.PEAK_FLOP_S
    assert read("mfu.serve")(t) == pytest.approx(mfu)
    s = W["SCNet"]
    least = [work.least_time_s(s["flops"] * 8, s["bytes"] * 8) * 1e3 / ms
             for ms in (400.0, 440.0)]
    assert read("scnet_roofline")(t) == pytest.approx(50 * sum(least))
    for m in ("backward_ms", "update_ms", "idle_share.train", "mfu.train"):
        assert read(m)(t) is None


def test_train_readers():
    t = train()
    read = harness.reader
    assert read("backward_ms")(t) == pytest.approx(260.0)
    assert read("update_ms")(t) == pytest.approx(3.0)
    assert read("idle_share.train")(t) == pytest.approx(40.0)
    assert read("mfu.train")(t) == pytest.approx(
        100 * 3 * 1e12 * 12 / work.PEAK_FLOP_S)
    for m in ("outside_forward_share.serve", "scnet_ms_per_frame",
              "scnet_roofline", "idle_share.serve", "mfu.serve"):
        assert read(m)(t) is None


def test_nothing_to_read_is_none():
    assert harness.reader("idle_share.serve")(serve(busy_s=None)) is None
    assert harness.reader("scnet_roofline")(serve(forwards=[])) is None
    assert harness.reader("mfu.train")(train(clips=0)) is None
