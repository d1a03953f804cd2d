"""The whole model in bfloat16 (counterpart of
``fcvsr_tpu.utils.precision``).

:func:`cast_params` gives a copy of a model whose floating parameters and
buffers are bf16, as the JAX function gives a cast copy of a param tree;
:func:`bf16_apply` runs a model on bf16 inputs with bf16 weights and
returns float32.  The modules follow their inputs' type: convs compute and
store bf16, the FFTs still transform in float32 and store bf16
(``ops.freq``), MGAA's warp offsets stay float32, and the kernels (the
IAC iteration, the conv pair and conv) run on bf16 maps, taking the bf16
weights cast up to float32 at their wrappers, which loses nothing.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["cast_params", "bf16_apply"]


def _floating(model: torch.nn.Module):
    return [t for t in list(model.parameters()) + list(model.buffers())
            if t.is_floating_point()]


def cast_params(model: torch.nn.Module,
                dtype=torch.bfloat16) -> torch.nn.Module:
    """A copy of ``model`` with every floating parameter and buffer in
    ``dtype`` (``model`` itself unchanged)."""
    out = copy.deepcopy(model)
    for t in _floating(out):
        t.data = t.data.to(dtype)
    return out


def _to_f32(v):
    if isinstance(v, torch.Tensor):
        return v.float() if v.is_floating_point() else v
    if isinstance(v, (list, tuple)):
        return type(v)(_to_f32(u) for u in v)
    if isinstance(v, dict):
        return {k: _to_f32(u) for k, u in v.items()}
    return v


def bf16_apply(model: torch.nn.Module, *args):
    """``model(*args)`` in bfloat16: the weights cast (a cast copy unless
    they already are bf16), floating tensor inputs cast, every floating
    output returned as float32."""
    if any(t.dtype != torch.bfloat16 for t in _floating(model)):
        model = cast_params(model)
    args16 = tuple(a.to(torch.bfloat16)
                   if isinstance(a, torch.Tensor) and a.is_floating_point()
                   else a for a in args)
    return _to_f32(model(*args16))
