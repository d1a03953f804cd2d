"""The CVCP training recipe in plain PyTorch: Charbonnier-sum loss and a
frozen copy of the Adam update (CVSR_train's ``opt/loss.py`` and
``torch.optim.Adam`` with betas (0.9, 0.99), eps 1e-8, no weight decay),
over the reference forward (:mod:`.fcvsr`)."""

from __future__ import annotations

import torch

from . import fcvsr

__all__ = ["charbonnier_sum", "multistep_lr", "adam_update", "train_steps"]


def charbonnier_sum(pred, target, eps=1e-4):
    """sum(sqrt((pred - target)^2 + eps)), eps not squared."""
    diff = pred - target
    return torch.sqrt(diff * diff + eps).sum()


def multistep_lr(step, base_lr, milestones, gamma):
    """MultiStepLR as a function of the updates already taken: the rate
    drops by ``gamma`` at each milestone reached."""
    return base_lr * gamma ** sum(step >= int(m) for m in milestones)


@torch.no_grad()
def adam_update(params, grads, state, lr, betas=(0.9, 0.99), eps=1e-8):
    """One Adam step in place.  ``state``: name -> (m, v), filled on the
    first step; ``state['t']`` counts steps.  A parameter without a
    gradient (None) is left as it is, as torch's Adam leaves it."""
    b1, b2 = betas
    t = state["t"] = state.get("t", 0) + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for name, p in params.items():
        g = grads.get(name)
        if g is None:
            continue
        if name not in state:
            state[name] = (torch.zeros_like(p), torch.zeros_like(p))
        m, v = state[name]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt() / bc2 ** 0.5 + eps
        p.addcdiv_(m, denom, value=-lr / bc1)


def train_steps(sd, batches, topology, recipe):
    """Run ``len(batches)`` training steps of the reference from the weights
    ``sd`` (not modified).  ``batches``: [(lrs, gt)]; ``topology``: the
    forward's keywords; ``recipe``: lr, betas, eps, milestones, gamma,
    charbonnier_eps.  Returns (losses, first gradients, weights after the
    last step), the last two as name -> tensor."""
    params = {k: v.detach().clone() for k, v in sd.items()}
    state, losses, first = {}, [], None
    for i, (lrs, gt) in enumerate(batches):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = charbonnier_sum(fcvsr.forward(live, lrs, **topology), gt,
                               recipe["charbonnier_eps"])
        names = list(live)
        grads = torch.autograd.grad(loss, [live[k] for k in names],
                                    allow_unused=True)
        grads = dict(zip(names, grads))
        for v in live.values():
            v.requires_grad_(False)
        if first is None:
            first = {k: None if g is None else g.clone()
                     for k, g in grads.items()}
        losses.append(float(loss.detach()))
        lr = multistep_lr(i, recipe["lr"], recipe["milestones"],
                          recipe["gamma"])
        adam_update(params, grads, state, lr, tuple(recipe["betas"]),
                    recipe["eps"])
        del loss, grads
    return losses, first, params
