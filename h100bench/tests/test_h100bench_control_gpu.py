"""On the card, at each cell's own size with a short window: the
program's run reads correct, and the control (the reference in TF32, the
precision below the configurations' float32 with TF32 off, in the
program's place) fails at least one of the cell's limits.  Run on the chip:
``python3 -m pytest h100bench/tests/test_h100bench_control_gpu.py -q``."""

import time

import pytest

from h100bench import harness

pytestmark = pytest.mark.gpu

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(cell, cuda):
    r = harness.run_cell(BENCH, cell, 2 ** 31 + 2024, 1.0, False, cuda,
                         time.perf_counter(), control=True)
    assert r["correct"], r["checks"]
    limits = harness.load_limits(cell)
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
