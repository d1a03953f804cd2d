"""Kind ``train``: the CVCP training recipe, one optimizer step a request.

Set-up builds one training step, ``train.trainer.TrainState`` (Adam, the
MultiStepLR schedule) under ``make_train_step`` with the recipe's loss, from
the benchmark's weights, and drives it through its first
``checked_steps`` steps, which warm it up; the window then runs the same
object on.  Every step takes the next of ``batches`` distinct batches made
on the card from the seed: ``clips`` clips of 7 LR frames of ``patch`` x
``patch`` and their 4x GT centre frames, each clip its own scene (the LR
the GT's box average, both quantised to 8 bits).

The check: the reference (plain PyTorch, the same weights and batches) runs
the first steps again.  Compared are each step's loss, each leaf's first
gradient as Adam got it (its first moment after one step, over 1 - beta1)
and each leaf's change after the checked steps, by norms (see
:func:`leaf_gap`).
"""

from __future__ import annotations

import gc
import math
import statistics

import torch

from .. import common, inputs, work
from ..reference import train as ref_train

__all__ = ["Driver", "leaf_gap"]

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone: it is left out
DEAD_LEAF = 1e-3


def leaf_gap(program, reference, leaves):
    """The worst leaf's |‖program‖ - ‖reference‖|, over the larger of its
    reference norm and the median leaf's."""
    norms = {n: float(reference[n].norm()) for n in leaves}
    floor = statistics.median(norms.values())
    worst = 0.0
    for n in leaves:
        p = program.get(n)
        pn = 0.0 if p is None else float(p.norm())
        if not math.isfinite(pn):
            return math.inf
        worst = max(worst, abs(pn - norms[n]) / max(norms[n], floor))
    return worst


class Driver:
    kind = "train"

    def __init__(self, cfg, mix, seed, device, tracer):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.tracer = device, tracer
        self.recipe = cfg["train"]
        self.clips = 0

    def _batches(self):
        g = inputs.generator(self.seed, "train", self.device)
        m, c = self.mix, self.cfg["in_channels"]
        out = []
        for _ in range(m["batches"]):
            hr, lr = inputs.video(g, m["clips"], self.cfg["num_frames"],
                                  m["patch"], m["patch"], c, hr_scale=4)
            out.append((lr.float().div_(255.0),
                        hr[:, self.cfg["num_frames"] // 2].float().div_(
                            255.0)))
        return out

    def setup(self):
        from fcvsr_tpu_torch.train.lr_schedule import multistep
        from fcvsr_tpu_torch.train.trainer import TrainState, make_train_step

        r = self.recipe
        self.weights = common.make_weights(self.cfg, self.seed, self.device)
        self.model = common.build_model(self.cfg, self.weights,
                                        self.device).train()
        self.state = TrainState(self.model, multistep(
            r["lr"], r["milestones"], r["gamma"]), betas=tuple(r["betas"]))
        self.step = make_train_step(self.state, r["loss"])
        self.pool = self._batches()
        losses = []
        for i in range(self.mix["checked_steps"]):
            losses.append(self.step(*self.pool[i])["loss"])
            if i == 0:
                opt = self.state.optimizer
                self.first_grads = {
                    n: opt.state[p]["exp_avg"] / (1 - r["betas"][0])
                    for n, p in self.model.named_parameters()
                    if p in opt.state}
        self.losses = [float(x) for x in losses]
        self.changed = {n: p.detach().clone()
                        for n, p in self.model.named_parameters()}
        self.done = self.mix["checked_steps"]

    def attach(self, tracer):
        tracer.attach_model(self.model)
        tracer.attach_train_state(self.state)

    def request(self, i):
        with self.tracer.span("step"):
            lrs, gt = self.pool[(self.done + i) % len(self.pool)]
            self.step(lrs, gt)
        self.clips += self.mix["clips"]
        return self.mix["clips"]

    def end_to_end(self, elapsed, latencies):
        return {"train_clips_per_s": self.clips / elapsed}

    def release(self):
        del self.step, self.state, self.model
        gc.collect()  # the traced run's wrappers hold cycles
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, tf32):
        batches = self.pool[:self.mix["checked_steps"]]
        with common.precision(tf32):
            return ref_train.train_steps(self.weights, batches,
                                         common.topology(self.cfg),
                                         self.recipe)

    def _numbers(self, run, ref):
        losses, grads, params = run
        r_losses, r_grads, r_params = ref
        live = {n: g for n, g in r_grads.items() if g is not None}
        floor = statistics.median(float(g.norm()) for g in live.values())
        leaves = [n for n, g in live.items()
                  if float(g.norm()) >= DEAD_LEAF * floor]
        w = self.weights
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, r_losses)),
            "grad_gap": leaf_gap(grads, r_grads, leaves),
            "change_gap": leaf_gap({n: params[n] - w[n] for n in leaves},
                                   {n: r_params[n] - w[n] for n in leaves},
                                   leaves)}

    def readings(self, control=False):
        self.pool = self.pool[:self.mix["checked_steps"]]
        ref = self._reference(False)
        out = {"program": self._numbers(
            (self.losses, self.first_grads, self.changed), ref)}
        if control:
            out["control"] = self._numbers(self._reference(True), ref)
        return out

    def layer_inputs(self):
        p = self.mix["patch"]
        return {"kind": self.kind, "clips": self.clips,
                "train_flops_per_clip":
                    work.forward_flops(self.cfg, p, p)}
