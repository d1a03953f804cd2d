"""One run of one cell, found by name.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric sits in files of its own, which this module finds by the names in
``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration (widths, precision, serving
  flags, training recipe), the file its ``configs`` entry names;
* ``traffic/<traffic>.json``: the mix's parameters, whose ``kind`` names
  the general driver ``traffic/<kind>.py`` that reads them;
* ``metrics/<metric>.py``: the reader of one per-layer metric, whose
  ``read(t)`` returns a number or None;
* ``limits/<cell>.json``: the limit of each number the cell's check
  compares.

A run: set-up (import, weights and inputs from the seed, warm-up), the
measured window (whole requests until the first that completes after
``seconds``), the device's peak memory, the program's state freed, then the
check against the plain reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from .trace import NullTracer, Tracer

__all__ = ["ROOT", "HERE", "load_benchmark", "find", "load_config",
           "load_mix", "load_limits", "driver_class", "reader", "run_cell"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_config(bench, name, root=ROOT):
    with open(Path(root) / find(bench["configs"], name)["file"]) as f:
        return json.load(f)


def load_mix(name):
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_limits(cell):
    with open(HERE / "limits" / f"{cell}.json") as f:
        return json.load(f)


def driver_class(kind):
    return importlib.import_module(f"h100bench.traffic.{kind}").Driver


def reader(metric):
    """``metrics/<metric>.py``'s ``read``: loaded by path, since a metric's
    name may hold dots."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _listed(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def _device_info(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(bench, cell_name, seed, seconds, trace, device, t_start,
             mix_overrides=None, control=False):
    """One run; returns the result (the line's keys, ``checks`` last).
    ``t_start``: the process's start on ``time.perf_counter``'s clock.
    ``mix_overrides`` change the mix's parameters (the tests' small
    sizes); ``control`` also reads the control (the reference in TF32 in
    the program's place) into ``result['control']``."""
    cell = find(bench["workloads"], cell_name)
    cfg = load_config(bench, cell["config"])
    mix = {**load_mix(cell["traffic"]), **(mix_overrides or {})}
    tracer = Tracer(device) if trace else NullTracer()
    # the configuration's precision: float32, TF32 off
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    driver = driver_class(mix["kind"])(cfg, mix, seed, device, tracer)
    driver.setup()
    if trace:
        driver.attach(tracer)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    tracer.start()
    latencies, i = [], 0
    t0 = time.perf_counter()
    while True:
        # a serving request ends with its frames on the host; training
        # steps queue on, as a training loop runs them
        a = time.perf_counter()
        driver.request(i)
        b = time.perf_counter()
        latencies.append(b - a)
        i += 1
        if b - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    tracer.stop()

    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    layer = driver.layer_inputs()
    readout = tracer.readout() if trace else None
    driver.release()
    readings = driver.readings(control)
    limits = load_limits(cell_name)
    checks = {k: {"value": readings["program"][k], "limit": limits[k]}
              for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    result = {"correct": correct, "attempted": i, "failed": 0}
    if trace:
        t = SimpleNamespace(**vars(readout), **layer)
        metrics = {}
        for m in bench["per_layer"]:
            if _listed(m, cell_name):
                v = reader(m["name"])(t)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = {**_device_info(device, peak),
                            "busy_s": readout.busy_s,
                            "window_s": readout.window_s}
        result["breakdown"] = readout.breakdown
    else:
        e2e = driver.end_to_end(elapsed, latencies)
        e2e["setup_s"] = setup_s
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"] if _listed(m, cell_name)}
        result["device"] = _device_info(device, peak)
    if control:
        result["control"] = readings.get("control")
    result["checks"] = checks
    return result


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
