"""The routes of the window probes' kernels, on the CPU.

* im2col (K9, ``csrc/microbench/conv2.cu``) builds no (9C, WP) operand on
  the card: it takes the channel sums of the bf16-rounded window and their
  3x3 box, lanes x + 1 and x + 2 past WP wrapping to lanes 0 and 1.
  ``microbench_conv2.im2col_boxsum_emulated`` is that route in PyTorch;
  it is held to ``im2col_plain`` (the operand built and summed, as the JAX
  kernel does) within 1e-4 of max|plain| at the GPU tests' shapes: float32
  sums of up to 576 bf16 values taken in another order.
* ``benchmarks/probe_ab.py``'s edits match the sources they edit: each
  takeout's old text is in the tree's kernel once, gone from its variant,
  and the new text stands in its place; the parent's takeouts become edits
  of the ``--parent`` checkout's copy.
"""

import pytest
import torch

from fcvsr_tpu_torch.benchmarks import microbench_conv2 as conv2
from fcvsr_tpu_torch.benchmarks import probe_ab
from fcvsr_tpu_torch.ops import _native

K9_RTOL = 1e-4
# tests/test_torch_kernels_gpu.py's window shapes (MB_SHAPES, WIN_SHAPES)
SHAPES = [dict(th=16, c=64, wp=512, tiles=17), dict(th=16, c=64, wp=200, tiles=3),
          dict(th=3, c=64, wp=136, tiles=2), dict(th=5, c=24, wp=100, tiles=1),
          dict(th=1, c=96, wp=40, tiles=4), dict(th=2, c=160, wp=20, tiles=3)]


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["real", "odd", "short", "wrap", "c96", "c160"])
def test_im2col_boxsum_route_matches_plain(shape):
    _, _, src = conv2.seeded_operands(2, **shape)
    ref = conv2.im2col_plain(src, shape["th"])
    got = conv2.im2col_boxsum_emulated(src, shape["th"])
    assert got.shape == ref.shape == (shape["tiles"], shape["th"], shape["wp"])
    assert float((got - ref).abs().max()) <= K9_RTOL * float(ref.abs().max())


def test_im2col_boxsum_route_wraps_the_lanes():
    """A source that is zero but at lane 0 of one row and channel: the box
    puts it at output lanes WP - 2, WP - 1 and 0 of the three rows above
    it, as the plain version's roll does."""
    src = torch.zeros(1, 2 * 4 + 2, 3, 8)
    src[0, 5, 1, 0] = 1.0
    got = conv2.im2col_boxsum_emulated(src, 4)
    assert torch.equal(got, conv2.im2col_plain(src, 4))
    rows = got.reshape(8, 8)
    assert torch.equal(rows.nonzero()[:, 0].unique(), torch.tensor([3, 4, 5]))
    assert torch.equal(rows[4].nonzero()[:, 0], torch.tensor([0, 6, 7]))


@pytest.mark.parametrize("group", list(probe_ab.SOURCES))
def test_probe_ab_takeouts_apply(group):
    src = probe_ab.SOURCES[group]
    base = _native.edited_sources(src, [])[src]
    assert list(probe_ab.variants(True, None, {}, group)) == \
        ["base", *probe_ab.TAKEOUTS[group]]
    for name, edits in probe_ab.TAKEOUTS[group].items():
        text = _native.edited_sources(src, edits)[src]
        for old, new in edits:
            assert base.count(old) == 1 and old not in text \
                and new in text, name
    runs = probe_ab.variants(True, "DIR", {}, group, tree=False)
    assert list(runs) == ["parent", *(f"parent_{n}" for n in
                                      probe_ab.PARENT_TAKEOUTS[group])]
    for name, edits in probe_ab.PARENT_TAKEOUTS[group].items():
        assert runs[f"parent_{name}"] == {"dir": "DIR", "edits": edits}
    # every variant names the probes it changes among its group's
    for name, probes in probe_ab.TAKEOUT_PROBES.items():
        if name.removeprefix("parent_") in {**probe_ab.TAKEOUTS[group],
                                            **probe_ab.PARENT_TAKEOUTS[group]}:
            assert set(probes) <= set(probe_ab.PROBES[group]), name
