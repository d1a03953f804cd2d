"""work.py's counts: against hand counts, against the figures PERF.md's
kernel table uses, and against ``torch.utils.flop_counter`` on the port's
forward."""

import math

import pytest
import torch

from h100bench import common, work
from h100bench.tests.test_h100bench_reference import CFGS, EXACT

FULL = {**CFGS["fcvsr"], "corr_radius": 4}
SMALL = {**CFGS["fcvsr_s"], "corr_radius": 4}


def test_conv_hand_counts():
    # a 3x3 conv, 2 * 9 * Cin * Cout a pixel
    assert work.conv_flops(3, 2, 5, 4, 6) == 2 * 9 * 2 * 5 * 24
    assert work.conv_flops(1, 8, 4, 3, 3, groups=2) == 2 * 8 * 4 // 2 * 9
    # K2's pair at 272 x 480: 64 -> 128 -> 64, 38.5 GFLOP (PERF.md's table)
    pair = work.conv_flops(3, 64, 128, 272, 480) \
        + work.conv_flops(3, 128, 64, 272, 480)
    assert pair == 38_503_710_720
    # K3 64 -> 1 at 1088 x 1920, conv_last0
    assert work.conv_flops(3, 64, 1, 1088, 1920) == 2 * 9 * 64 * 1088 * 1920


def test_fft_and_iac_hand_counts():
    assert work.fft_flops(4, 8, 1) == 5 * 32 * 5
    assert work.fft_flops(4, 8, 3, real=True) == 5 * 32 * 5 * 3 / 2
    # 4 bilinear taps and 3 + 3 filter taps (multiply-adds), add, act
    assert work.IAC_FLOPS_PER_ELEMENT == 22
    assert work.iac_flops(2, 3, 4, 6) == 22 * 2 * 3 * 4 * 6


@pytest.mark.parametrize("cfg,tflop", [(FULL, 2.94), (SMALL, 1.25)])
def test_conv_totals_at_the_fps_shape(cfg, tflop):
    w = work.forward_work(cfg, 272, 480)
    assert w["total"]["conv_flops"] / 1e12 == pytest.approx(tflop, rel=4e-3)
    # SCNet's share: 83% of FCVSR's convs, 78% of FCVSR-S's
    share = w["SCNet"]["conv_flops"] / w["total"]["conv_flops"]
    assert share == pytest.approx(0.835 if cfg is FULL else 0.783, abs=0.01)
    assert w["total"]["flops"] >= w["total"]["conv_flops"]


@pytest.mark.parametrize("name", ["fcvsr", "fcvsr_s"])
def test_convs_match_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = {**CFGS[name], "corr_radius": 4, "serving_flags": EXACT}
    model = common.build_model(
        cfg, common.make_weights(cfg, 0, torch.device("cpu")),
        torch.device("cpu")).eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.rand(1, 7, 1, 32, 48))
    counts = counter.get_flop_counts()["Global"]
    convs = sum(v for k, v in counts.items() if "convolution" in str(k))
    assert convs == work.forward_work(cfg, 32, 48)["total"]["conv_flops"]


def test_scnet_bytes_hold_its_weights():
    from fcvsr_tpu_torch.models.fcvsr import FCVSRNet

    with torch.device("meta"):
        model = FCVSRNet(in_channels=1)
    weights = sum(p.numel() for n, p in model.state_dict().items()
                  if n.startswith("recorb1.")) * 4
    w = work.forward_work(FULL, 272, 480)["SCNet"]
    maps = 2 * 4 * 64 * (272 * 480 + 136 * 240 + 68 * 120)
    assert w["bytes"] == maps + weights


def test_least_time():
    assert work.least_time_s(989e12, 0) == pytest.approx(1.0)
    assert work.least_time_s(0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(work.least_time_s(1e9, 3.35e12), 1.0)
