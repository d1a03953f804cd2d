"""The check catches a broken program: each cell's run, on the CPU at a
small size (the look for a card skipped; the port's CPU path is its plain
versions), with the timed path broken underneath, reads ``correct`` false;
unbroken, true.  The faults a cell can have: an answer altered where it is
produced (serving); half of the batch left out (the clip cell's batches of
windows; training's loss over the rest); a step that leaves the state
unchanged (training).  One card, so no exchange between chips to leave
out.  The training kind has no cell in ``BENCHMARK.json`` (the port's
training gradients on the card are at fault, PERF.md): its cell is made
here, with limits of its own, so that its check stays tested."""

import time

import pytest
import torch

from h100bench import harness

TRAIN = {"name": "fcvsr.train_cvcp", "config": "fcvsr_cvcp_y",
         "traffic": "train_cvcp", "chips": 1}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
BENCH = harness.load_benchmark()
BENCH = {**BENCH, "workloads": BENCH["workloads"] + [TRAIN]}
CPU = torch.device("cpu")
SMALL = {
    "fcvsr.clip1080": dict(height=9, width=14, clip_frames=6, clips=1,
                           batch_windows=4, compared_frames=6),
    "fcvsr_s.stream1080": dict(height=9, width=14, clip_frames=8,
                               compared_frames=3),
    "fcvsr.stream1080": dict(height=9, width=14, clip_frames=8,
                             compared_frames=3),
    "fcvsr.train_cvcp": dict(clips=2, patch=8, batches=3),
}


@pytest.fixture(autouse=True)
def _train_limits(monkeypatch):
    load = harness.load_limits
    monkeypatch.setattr(harness, "load_limits", lambda cell: TRAIN_LIMITS
                        if cell == TRAIN["name"] else load(cell))


def _run(cell):
    torch.manual_seed(0)
    return harness.run_cell(BENCH, cell, 2 ** 31 + 99, 0.0, False, CPU,
                            time.perf_counter(), mix_overrides=SMALL[cell])


def _altered(monkeypatch):
    from fcvsr_tpu_torch.models.fcvsr import FCVSRNet

    forward = FCVSRNet.forward

    def altered(self, x):
        out = forward(self, x).clone()
        out[:, :, 5, 7] += 1 / 255   # one 8-bit step at one pixel
        return out

    monkeypatch.setattr(FCVSRNet, "forward", altered)


def _half_batch(monkeypatch):
    from fcvsr_tpu_torch.models.fcvsr import FCVSRNet

    forward = FCVSRNet.forward

    def half(self, x):
        n = max(1, x.shape[0] // 2)
        out = forward(self, x[:n])
        return torch.cat([out, out[-1:].expand(x.shape[0] - n, -1, -1, -1)])

    monkeypatch.setattr(FCVSRNet, "forward", half)


def _loss_on_half(monkeypatch):
    from fcvsr_tpu_torch.train import losses

    full = losses.LOSSES["charbonnier_sum"]

    def half(pred, target, eps=1e-4):
        n = pred.shape[0] // 2
        return full(pred[:n], target[:n], eps)

    monkeypatch.setitem(losses.LOSSES, "charbonnier_sum", half)


def _state_unchanged(monkeypatch):
    from fcvsr_tpu_torch.train.trainer import TrainState

    def skip(self):
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", skip)


FAULTS = [
    ("fcvsr.clip1080", _altered), ("fcvsr.clip1080", _half_batch),
    ("fcvsr_s.stream1080", _altered), ("fcvsr.stream1080", _altered),
    ("fcvsr.train_cvcp", _loss_on_half),
    ("fcvsr.train_cvcp", _state_unchanged),
]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
