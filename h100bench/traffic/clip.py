"""Kind ``clip``: offline restoration of whole segments.

One client, closed loop.  A request is a segment of ``clip_frames`` LR
frames (uint8, as decoded), scaled to [0, 1], zero-padded to a multiple of
4 by ``cli.pad_to_multiple``, restored by
``models.inference.sliding_window_sr`` (every frame's window of 7, edges
replicated, ``batch_windows`` windows a forward) and cropped to 4x the
segment's size.  The segments are ``clips`` distinct scenes from the seed,
served in turn.
"""

from __future__ import annotations

import numpy as np

from ..common import window_indices
from ..serve import ServeDriver

__all__ = ["Driver"]


class Driver(ServeDriver):

    def _serve(self, segment):
        from fcvsr_tpu_torch.cli import pad_to_multiple
        from fcvsr_tpu_torch.models.inference import sliding_window_sr

        clip = segment.astype(np.float32) / 255.0
        padded, (h, w) = pad_to_multiple(clip)
        out = sliding_window_sr(self.model, padded, window=7,
                                batch_windows=self.mix["batch_windows"],
                                padding="replicate", device=self.device)
        return out[:, :4 * h, :4 * w]

    def warm_up(self):
        # the one shape the window runs: a forward of batch_windows windows
        self._serve(self.pool[0][:self.mix["batch_windows"]])

    def request(self, i):
        n = len(self.pool)
        with self.tracer.span("request"):
            out = self._serve(self.pool[i % n])
        for j in range(len(out)):
            self.keep((i % n, j), out[j], copy=True)
        self.frames += len(out)
        return len(out)

    def window(self, key):
        clip, j = key
        seg = self.pool[clip]
        return seg[window_indices(j, len(seg))]
