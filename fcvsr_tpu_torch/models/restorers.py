"""The restorer: a model with its pixel loss, training step and test-time
metrics (counterpart of ``fcvsr_tpu.models.restorers``, after mmedit's
BasicRestorer / BasicVSR restorers).

* :meth:`VideoRestorer.loss_fn` - the forward and the pixel loss; with
  ``center_frame_only`` a (B, T, C, H, W) GT is cut to its centre frame.
* :meth:`VideoRestorer.make_train_step` - forward, backward and one Adam
  update of a ``train.trainer.TrainState``; while ``state.step <
  fix_iter`` every parameter whose name holds ``spynet`` or ``edvr`` gets
  a zero gradient.  The gradients are zeroed, never dropped: optax counts
  one step for every parameter, and ``torch.optim.Adam`` advances a
  parameter's own count only when it has a gradient, so a frozen
  parameter left without one would take its first updates with another
  bias correction than optax's.  For the same reason a parameter that the
  loss does not reach gets a zero gradient too, as ``jax.grad`` gives it.
* :meth:`VideoRestorer.forward_test` - inference and PSNR / SSIM / tOF;
  the previous frame's (sr, gt) pair for tOF is carried by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..metrics import calculate_psnr, calculate_ssim, calculate_tof
from ..train.losses import LOSSES

__all__ = ["VideoRestorer", "tensor2img"]

FROZEN_NAMES = ("spynet", "edvr")


def tensor2img(t) -> np.ndarray:
    """(1, C, H, W) in [0, 1], a tensor or an array -> HWC float in [0, 255],
    rounded (mmedit's tensor2img without the cast to uint8, which the
    metrics do not need)."""
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    arr = np.clip(arr[0], 0, 1) * 255.0
    return np.round(np.transpose(arr, (1, 2, 0)))


@dataclass
class VideoRestorer:
    """A model, its pixel loss and its test-time metrics."""

    model: torch.nn.Module
    pixel_loss: str = "charbonnier_mean"  # or "charbonnier_sum"
    center_frame_only: bool = False       # FCVSR / EDVR: centre-frame GT
    fix_iter: int = 0                     # freeze spynet / edvr params early
    metrics: Sequence[str] = ("PSNR", "SSIM")
    crop_border: int = 0
    convert_to: Optional[str] = "Y"

    _ALLOWED = ("PSNR", "SSIM", "tOF")

    def loss_fn(self, lq: torch.Tensor, gt: torch.Tensor):
        """(loss, sr) of one batch: lq (B, T, C, H, W); gt the model's output
        shape, or (B, T, C, 4H, 4W) cut to its centre frame."""
        if self.pixel_loss not in LOSSES:
            raise ValueError(f"unknown loss {self.pixel_loss}; options: "
                             f"{list(LOSSES)}")
        sr = self.model(lq)
        if self.center_frame_only and gt.ndim == 5:
            gt = gt[:, gt.shape[1] // 2]
        return LOSSES[self.pixel_loss](sr, gt), sr

    @staticmethod
    def is_frozen(name: str) -> bool:
        name = name.lower()
        return any(part in name for part in FROZEN_NAMES)

    def make_train_step(self, state):
        """``step(lq, gt) -> {"loss": tensor}``: one forward, backward and
        update of ``state`` (a ``TrainState`` over this restorer's model)."""
        if state.model is not self.model:
            raise ValueError("the train state holds another model than the "
                             "restorer's")
        named = list(self.model.named_parameters())
        frozen = [p for n, p in named if self.is_frozen(n)]

        def step(lq: torch.Tensor, gt: torch.Tensor) -> Dict[str, Any]:
            state.optimizer.zero_grad(set_to_none=True)
            loss, _ = self.loss_fn(lq, gt)
            loss.backward()
            for _, p in named:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if state.step < self.fix_iter:
                for p in frozen:
                    p.grad.zero_()
            state.apply_gradients()
            return {"loss": loss.detach()}

        return step

    def forward_test(self, lq: torch.Tensor, gt=None,
                     prev_state: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        """Inference and metrics.  lq: (1, T, C, H, W); gt: (1, T, C, 4H,
        4W), a sequence, or (1, C, 4H, 4W), the centre frame (a tensor or
        an array).  ``prev_state`` is the previous call's (sr, gt) images,
        0-255, for tOF.  Returns (results, new_state)."""
        with torch.no_grad():
            sr = self.model(lq).float().cpu().numpy()
        results: Dict[str, Any] = {}
        new_state = prev_state
        if gt is None:
            results["output"] = sr
            return results, new_state
        gt = gt.detach().cpu().numpy() if isinstance(gt, torch.Tensor) \
            else np.asarray(gt)
        if sr.ndim == 5 and gt.ndim == 5:  # sequence metrics, averaged
            vals = {m: [self._metric(m, tensor2img(sr[:, i]),
                                     tensor2img(gt[:, i]), None, None)
                        for i in range(sr.shape[1])] for m in self.metrics}
            results["eval_result"] = {m: float(np.mean(v))
                                      for m, v in vals.items()}
        else:  # centre-frame metrics, threading the previous frame for tOF
            sr_img = tensor2img(sr[:, sr.shape[1] // 2] if sr.ndim == 5
                                else sr)
            gt_img = tensor2img(gt if gt.ndim == 4
                                else gt[:, gt.shape[1] // 2])
            sr_pre, gt_pre = prev_state if prev_state else (sr_img, gt_img)
            results["eval_result"] = {
                m: self._metric(m, sr_img, gt_img, sr_pre, gt_pre)
                for m in self.metrics}
            new_state = (sr_img, gt_img)
        return results, new_state

    def _metric(self, name, sr, gt, sr_pre, gt_pre):
        if name == "PSNR":
            return calculate_psnr(sr, gt, self.crop_border, self.convert_to,
                                  "rgb")
        if name == "SSIM":
            return calculate_ssim(sr, gt, self.crop_border, self.convert_to,
                                  "rgb")
        if name == "tOF":
            if sr_pre is None:
                return 0.0
            return calculate_tof(sr, gt, sr_pre, gt_pre, self.convert_to,
                                 "rgb")
        raise KeyError(f"metric {name} not in {self._ALLOWED}")
