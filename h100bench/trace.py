"""What a traced run records, from the benchmark's own files: host spans
around the calls into the program's layers, CUDA-event marks from forward
hooks the benchmark registers on ``FCVSRNet`` and its children, and the
device's kernels from ``torch.profiler`` (CUDA activity only).

An untraced run gets a :class:`Tracer` that records nothing.

The reading of the profiler's events is a copy of the port's
``fcvsr_tpu_torch.profiling._profile`` (device events as the profiler
collected them, busy time as the union of their intervals); its wall time
includes the profiler's own host cost, so the idle share is an upper bound.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import torch

__all__ = ["Tracer", "NullTracer"]

# FCVSRNet children timed as stages: child name -> stage
STAGES = {"MGAA": "MGAA", "recorb1": "SCNet", "MFFRblock": "MFFR"}


class NullTracer:
    """Records nothing: the untraced run's tracer."""

    active = False

    def span(self, name):
        return contextlib.nullcontext()

    def start(self):
        pass

    def stop(self):
        pass


class Tracer(NullTracer):
    """Spans, CUDA-event marks and the profiler over one measured window."""

    active = True

    def __init__(self, device):
        self.device = device
        self.spans = []        # (name, host ns start, host ns end)
        self.forwards = []     # {"batch", "events": [(stage, start, end)]}
        self.steps = []        # [forward start, backward start, update
        #                         start, update end] events
        self._open = None
        self._step = None
        self._handles = []
        self._prof = None
        self.window_s = None

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def attach_model(self, model):
        """Hooks on the model (each forward, its batch, host span) and on
        the children named in :data:`STAGES`."""
        def pre(mod, args):
            self._open = {"batch": args[0].shape[0], "events": [],
                          "host": time.perf_counter_ns(),
                          "start": self._event()}

        def post(mod, args, out):
            fw = self._open
            fw["end"] = self._event()
            self.spans.append(("forward", fw.pop("host"),
                               time.perf_counter_ns()))
            self.forwards.append(fw)
            if self._step is not None and out.requires_grad:
                self._step.append(fw["start"])
                out.register_hook(self._backward_start)

        self._handles += [model.register_forward_pre_hook(pre),
                          model.register_forward_hook(post)]
        for name, child in model.named_children():
            if name not in STAGES:
                continue
            self._handles += [
                child.register_forward_pre_hook(
                    lambda m, a, name=name: self._stage_mark(name, "start")),
                child.register_forward_hook(
                    lambda m, a, o, name=name: self._stage_mark(name, "end"))]

    def _stage_mark(self, name, kind):
        if self._open is None:
            return
        ev = self._event()
        if kind == "start":
            self._open["events"].append([STAGES[name], ev, None])
        else:
            self._open["events"][-1][2] = ev

    def _backward_start(self, grad):
        self._step.append(self._event())
        self._host_bwd = time.perf_counter_ns()
        return grad

    def attach_train_state(self, state):
        """Marks at the update's start and end: ``state.apply_gradients``
        is wrapped on the instance, which the train step calls."""
        inner = state.apply_gradients

        def apply_gradients():
            if self._step is not None:
                t0 = time.perf_counter_ns()
                self.spans.append(("backward", self._host_bwd, t0))
                self._step.append(self._event())
            inner()
            if self._step is not None:
                self._step.append(self._event())
                self.spans.append(("update", t0, time.perf_counter_ns()))
                self.steps.append(self._step)
                self._step = []

        state.apply_gradients = apply_gradients
        self._step = []

    def start(self):
        """Begin the traced window: the profiler, then a clock anchor (the
        first device event after a synchronised host mark)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._anchor_host = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        self.forwards.clear()
        self.spans.clear()
        self.steps.clear()
        self._t0 = time.perf_counter_ns()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self._t1 = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        self.window_s = (self._t1 - self._t0) / 1e9
        for h in self._handles:
            h.remove()
        self._handles = []

    def readout(self):
        """The window as the per-layer readers take it (see
        ``metrics/``): forwards with their stage times, steps with their
        phase times, the device's busy time and the breakdown."""
        forwards = []
        for fw in self.forwards:
            stages = {}
            for stage, a, b in fw["events"]:
                if b is not None:
                    stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b)
            forwards.append({"batch": fw["batch"],
                             "ms": fw["start"].elapsed_time(fw["end"]),
                             "stages": stages})
        steps = [{"forward_ms": s[0].elapsed_time(s[1]),
                  "backward_ms": s[1].elapsed_time(s[2]),
                  "update_ms": s[2].elapsed_time(s[3])}
                 for s in self.steps if len(s) == 4]
        busy_s, device_ops, gaps = self._device()
        return SimpleNamespace(window_s=self.window_s, busy_s=busy_s,
                               forwards=forwards, steps=steps,
                               breakdown={"device_ops": device_ops,
                                          "idle_gaps": gaps})

    def _device(self):
        from torch.autograd import DeviceType

        events = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                s = ev.start_ns()
                events.append((s, s + ev.duration_ns(), ev.name()))
        if len(events) < 2:
            return None, [], []
        events.sort()
        # the anchor: the sleep kernel (else the first device event),
        # launched just after the host mark; host ns + offset = device ns
        anchor = next((ev for ev in events if "spin_kernel" in ev[2]),
                      events[0])
        offset = anchor[0] - self._anchor_host
        lo, hi = self._t0 + offset, self._t1 + offset
        merged, by_name = [], {}
        for s, e, name in events:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            by_name[name] = by_name.get(name, 0) + (e - s)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        if not merged:
            return None, [], []
        busy = sum(e - s for s, e in merged) / 1e9
        gaps = [(lo, merged[0][0])] + \
            [(a[1], b[0]) for a, b in zip(merged, merged[1:])] + \
            [(merged[-1][1], hi)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        spans = sorted(self.spans, key=lambda sp: sp[1])
        labelled = [[self._label(spans, s - offset), (e - s) / 1e9]
                    for s, e in gaps if e > s]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return busy, [[name[:160], ns / 1e9] for name, ns in ops], labelled

    @staticmethod
    def _label(spans, host_ns):
        """The innermost span open on the host at ``host_ns``."""
        best = None
        for name, s, e in spans:
            if s > host_ns:
                break
            if e >= host_ns and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "between spans"
