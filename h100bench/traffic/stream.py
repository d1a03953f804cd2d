"""Kind ``stream``: a live stream restored frame by frame.

One client, closed loop, batch 1.  The client holds the last 7 LR frames
of the stream (uint8, as decoded); a request is the arrival of the next
frame: the window is stacked and scaled to [0, 1], zero-padded to a
multiple of 4 by ``cli.pad_to_multiple``, moved to the card, restored by
one ``FCVSRNet`` forward without autograd, and its centre frame comes back
to the host, cropped to 4x the frame, as ``cli.evaluate_sequence`` serves a
window.  The stream is one seeded scene of ``clip_frames`` frames, played
in a loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..serve import ServeDriver

__all__ = ["Driver"]


class Driver(ServeDriver):

    def _serve(self, win):
        from fcvsr_tpu_torch.cli import pad_to_multiple

        with self.tracer.span("prepare"):
            padded, (h, w) = pad_to_multiple(win.astype(np.float32) / 255.0)
            x = torch.from_numpy(np.ascontiguousarray(
                np.transpose(padded, (0, 3, 1, 2))[None])).to(self.device)
        with torch.no_grad():
            y = self.model(x)
        with self.tracer.span("collect"):
            sr = y[0].cpu().numpy()
        return np.transpose(sr, (1, 2, 0))[:4 * h, :4 * w]

    def _frames(self, i):
        n = self.pool.shape[1]
        return [(i + k) % n for k in range(7)]

    def warm_up(self):
        for i in range(2):
            self._serve(self.pool[0][self._frames(i)])

    def request(self, i):
        with self.tracer.span("request"):
            out = self._serve(self.pool[0][self._frames(i)])
        self.keep(i, out)
        self.frames += 1
        return 1

    def window(self, key):
        return self.pool[0][self._frames(key)]
