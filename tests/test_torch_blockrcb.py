"""The BlockRCB level (K11) of the port against the JAX package, on the CPU.

* ``ops.fused_blockrcb.block_rcb`` (its plain version on CPU tensors)
  against ``block_rcb_rows(..., interpret=True)``, the Pallas kernel of the
  JAX package's ``benchmarks/microbench_blockrcb_kernel.py``, loaded by
  path.  The weights cross in the JAX kernel's cat3 layout through
  ``utils.convert.block_rcb_args_from_jax``.  Batches of 1 and 2, at 19x23
  and 33x130 with C = 16: H and W below and above the JAX kernel's 16-row
  tile, and two 128-lane tiles of width.
* The port's unfused level (``scnet_rows.block_rcb_level``, two pair
  launches, the ContextBlock, the leaky relu and the add) against the JAX
  unfused path (two ``conv3x3_pair_rows(interpret=True)``, then
  ``scnet_rows._context_block``, the leaky relu and the add).
* The A/B entry point on the CPU, and the wrapper's refusals.

Tolerance: max abs <= 1.6e-2 x max|JAX| (the port's bf16 bar, two bf16
steps of the output's magnitude) and mean abs <= 1e-3 x max|JAX|.  Both
sides round the conv weights to bf16, store the four conv outputs as bf16
and sum in other orders: a value within reassociation noise of a rounding
boundary rounds either way, one bf16 step that the later convs carry on.
The port's unfused path keeps its conv weights float32 where the JAX pair
kernel rounds them to bf16, so that comparison runs on bf16-exact weights.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.scnet_rows import _context_block
from fcvsr_tpu.ops.pallas_conv import (conv3x3_pair_rows, pad_to_rows,
                                       prep_weight, rows_to_nhwc)
from fcvsr_tpu_torch.benchmarks import microbench_blockrcb_kernel as ab
from fcvsr_tpu_torch.models.scnet_rows import block_rcb_level
from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb
from fcvsr_tpu_torch.profiling import BF16_FLOP_S, bound
from fcvsr_tpu_torch.utils.convert import (block_rcb_args,
                                           block_rcb_args_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_RTOL, MEAN_RTOL = 1.6e-2, 1e-3


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_microbench_blockrcb",
        os.path.join(REPO, "benchmarks", "microbench_blockrcb_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(got, ref):
    scale = float(np.abs(ref).max())
    d = np.abs(np.asarray(got, np.float32) - ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert d.max() <= MAX_RTOL * scale, (d.max(), scale)
    assert d.mean() <= MEAN_RTOL * scale, (d.mean(), scale)


def _jax_args(rng, c):
    """block_rcb_rows's arguments, drawn as the JAX A/B draws them: cat3
    conv weights and biases, the mask and the MLP matrices."""
    arr = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    hwio = dict(wb0=arr(3, 3, c, c), bb0=arr(c), wb1=arr(3, 3, c, c),
                bb1=arr(c), wr0=arr(3, 3, c, c), wr1=arr(3, 3, c, c),
                w_mask=arr(c), w_add0=arr(c, c), w_add1=arr(c, c))
    return {k: np.asarray(prep_weight(jnp.asarray(v))) if v.ndim == 4 else v
            for k, v in hwio.items()}


@pytest.mark.parametrize("b,h,w", [(1, 19, 23), (2, 33, 130)])
def test_block_rcb_matches_jax_block_rcb_rows(b, h, w):
    c = 16
    rng = np.random.default_rng(h)
    x = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    ja = _jax_args(rng, c)
    ref = _jax_bench().block_rcb_rows(
        pad_to_rows(jnp.asarray(x, jnp.bfloat16)), *ja.values(), h=h, w=w,
        interpret=True)
    ref = np.asarray(rows_to_nhwc(ref, h, w).astype(jnp.float32))
    before = block_rcb.launches
    got = block_rcb(torch.from_numpy(x).to(torch.bfloat16),
                    **block_rcb_args_from_jax(*ja.values()))
    assert got.dtype == torch.bfloat16 and block_rcb.launches == before
    _assert_close(got.float().numpy(), ref)


def test_unfused_level_matches_jax_unfused_path():
    h, w, c = 19, 23, 16
    x, blk = ab.seeded_level(5, h, w, c, c)
    with torch.no_grad():
        # the JAX pair kernel rounds its weights to bf16 and the port's
        # keeps them float32 (1.9% of max|JAX| apart here at the seeded
        # draws): give both the same bf16-exact 3x3 weights
        for conv in (blk.body[0], blk.body[2], blk.body[3].body[0],
                     blk.body[3].body[2]):
            conv.weight.copy_(conv.weight.bfloat16().float())
        kw = {k: None if v is None else v.numpy()
              for k, v in block_rcb_args(blk).items()}
    cat3 = {k: prep_weight(jnp.asarray(kw[k])) for k in
            ("wb0", "wb1", "wr0", "wr1")}
    xr = pad_to_rows(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    y = conv3x3_pair_rows(xr, cat3["wb0"], jnp.asarray(kw["bb0"]),
                          cat3["wb1"], jnp.asarray(kw["bb1"]), h=h, w=w,
                          ns1=0.1, interpret=True)
    r = conv3x3_pair_rows(y, cat3["wr0"], None, cat3["wr1"], None, h=h, w=w,
                          ns1=0.2, interpret=True)
    gc = {"conv_mask": {"Conv_0": {"kernel": kw["w_mask"].reshape(1, 1, -1,
                                                                  1)}},
          "add0": {"Conv_0": {"kernel": kw["w_add0"][None, None]}},
          "add1": {"Conv_0": {"kernel": kw["w_add1"][None, None]}}}
    r = _context_block(gc, r, h, w, 16)
    ref = y + jnp.where(r >= 0, r, 0.2 * r)
    ref = np.asarray(rows_to_nhwc(ref, h, w).astype(jnp.float32))
    with torch.no_grad():
        got = block_rcb_level(blk, x, "pair")
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("c1", [16, 32])
def test_ab_entry_point_on_cpu(c1):
    rep = ab.main(["--device", "cpu", "--h", "19", "--w", "23", "--c", "16",
                   "--c1", str(c1)])
    assert rep["finite"] and rep["c1"] == c1
    assert rep["rel_dev"] <= 2e-2  # the JAX A/B's "max dev 2% of scale"
    assert rep["fused_ms"] is None and rep["unfused_ms"] is None
    assert rep["card"] is None
    # the bound at the bf16 tensor-core rate, and beside it at the float32
    # FMA pipes' (at this size the bytes bound the one, the operations the
    # other)
    work = ab.level_work(1, 19, 23, 16, c1)
    assert (rep["bound_ms"], rep["bound_by"]) == bound(*work, BF16_FLOP_S)
    assert rep["f32_pipes_bound_ms"] == bound(*work)[0] > rep["bound_ms"]


def test_block_rcb_refuses_float32_and_autograd():
    x, blk = ab.seeded_level(1, 5, 7, 16, 16)
    with torch.no_grad():
        kw = block_rcb_args(blk)
    with pytest.raises(TypeError, match="bfloat16"):
        block_rcb(x.float(), **kw)
    kw["wb0"] = kw["wb0"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        block_rcb(x, **kw)
    with torch.no_grad():
        assert block_rcb(x, **kw).shape == x.shape


def test_block_rcb_args_from_jax_inverts_prep_weight():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    got = block_rcb_args_from_jax(prep_weight(jnp.asarray(w)), None,
                                  prep_weight(jnp.asarray(w)), None,
                                  prep_weight(jnp.asarray(w)),
                                  prep_weight(jnp.asarray(w)),
                                  np.ones(7), np.eye(7), np.eye(7))
    np.testing.assert_array_equal(got["wb0"].numpy(), w)
    assert got["bb0"] is None and got["w_mask"].shape == (7,)
