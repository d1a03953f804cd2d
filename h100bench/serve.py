"""The base of the serving kinds (``traffic/clip.py``, ``traffic/stream.py``):
set-up from the seed, the seeded sample of served frames, the end-to-end
metrics and the comparison with the reference."""

from __future__ import annotations

import gc

import numpy as np
import torch

from . import common, inputs, work

__all__ = ["ServeDriver"]


class ServeDriver:
    """A closed loop of one client; a request delivers ``frames`` restored
    frames.  Subclasses make ``self.pool`` (uint8 (N, T, H, W, C) host
    frames), warm up and serve: :meth:`request` returns the frames it
    delivered."""

    kind = "serve"

    def __init__(self, cfg, mix, seed, device, tracer):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.tracer = device, tracer
        self.sample = common.Reservoir(mix["compared_frames"], seed)
        self.frames = 0

    def setup(self):
        self.weights = common.make_weights(self.cfg, self.seed, self.device)
        self.model = common.build_model(self.cfg, self.weights,
                                        self.device).eval()
        g = inputs.generator(self.seed, "video", self.device)
        m = self.mix
        clips = inputs.video(g, m["clips"], m["clip_frames"], m["height"],
                             m["width"], self.cfg["in_channels"])
        # (N, T, C, H, W) -> host (N, T, H, W, C), as a decoder hands it
        self.pool = np.ascontiguousarray(
            clips.permute(0, 1, 3, 4, 2).cpu().numpy())
        del clips
        self.warm_up()

    def keep(self, key, frame, copy=False):
        """Offer one served frame to the sample; ``key`` names its window.
        ``copy`` keeps a copy, where the frame is a view of a larger
        output."""
        slot = self.sample.offer(key)
        if slot is not None:
            self.sample.keep(slot, key, np.array(frame) if copy else frame)

    def attach(self, tracer):
        tracer.attach_model(self.model)

    def end_to_end(self, elapsed, latencies):
        return {"frames_per_s": self.frames / elapsed,
                "frame_p95_ms": float(np.percentile(latencies, 95)) * 1e3}

    def release(self):
        """Free the program's state: the model and its caches."""
        del self.model
        gc.collect()  # the traced run's wrappers hold cycles
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, control=False):
        """The numbers compared: the sampled served frames against the
        reference; with ``control`` also the reference in TF32 in the
        program's place."""
        keys = [k for k, _ in self.sample.items()]
        served = [f for _, f in self.sample.items()]
        windows = [self.window(k) for k in keys]
        ref = common.reference_frames(self.weights, self.cfg, windows,
                                      self.device)
        out = {"program": common.frame_errors(served, ref)}
        if control:
            low = common.reference_frames(self.weights, self.cfg, windows,
                                          self.device, tf32=True)
            out["control"] = common.frame_errors(low, ref)
        return out

    def layer_inputs(self):
        """What the per-layer readers need besides the trace."""
        h = -(-self.mix["height"] // 4) * 4
        w = -(-self.mix["width"] // 4) * 4
        return {"kind": self.kind, "frames": self.frames,
                "work": work.forward_work(self.cfg, h, w)}
