"""LIIF and DUF's filter in the port against the JAX package on the CPU.

``make_coord`` and ``generate_coordinate_and_cell`` bit for bit (the same
``np.random.Generator`` state); the nearest sampling, also at coordinates
exactly half-way between two pixels (``floor(p + 0.5)`` takes the upper
one; ``grid_sample``'s half to even would take the even one); the
channel-major 3x3 unfold; LIIF-EDSR and LIIF-RDN (mid 8, 2 blocks, RDN 2
layers, imnet (16, 16)) at 8 x 8 queried on the x2 grid with random cells,
all switches on and each of local ensemble, feature unfold and cell decode
off once; LIIF-EDSR's gradient; DUF's dynamic upsampling filter.

Weights as in tests/test_torch_sisr.py (numpy draws on the JAX shapes,
``state_dict_from_jax``, ``strict=True``).  Bars: outputs within 1e-4 abs
and 1e-5 of max |out|; the gradient relative to the JAX gradient's norms,
the whole gradient and the median tensor within 1e-3, each imnet tensor
within 1e-3 and each trunk tensor, upstream of the nearest sampling,
within 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.data.pipelines import \
    generate_coordinate_and_cell as j_coordinate_and_cell
from fcvsr_tpu.models import liif as J
from fcvsr_tpu.models.duf import \
    dynamic_upsampling_filter as j_dynamic_upsampling_filter
from fcvsr_tpu.train import losses as JL
from fcvsr_tpu_torch.data.pipelines import generate_coordinate_and_cell
from fcvsr_tpu_torch.models import LIIFEDSR, LIIFRDN
from fcvsr_tpu_torch.models.duf import dynamic_upsampling_filter
from fcvsr_tpu_torch.models.liif import (_nearest_sample, _unfold3x3,
                                         make_coord)
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.train import losses as PL
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_cvcp_zoo import FAST, jax_variables, jit_apply, uniform
from test_torch_sisr import check, compare_grads, port

SAMPLE_RTOL = 5e-2
SMALL = dict(mid_channels=8, num_blocks=2, imnet_hidden=(16, 16))
MODELS = {"LIIFEDSR": (J.LIIFEDSR, LIIFEDSR, SMALL),
          "LIIFRDN": (J.LIIFRDN, LIIFRDN,
                      dict(SMALL, num_layers=2, channel_growth=8))}
SWITCHES = {"all_on": {}, "no_ensemble": dict(local_ensemble=False),
            "no_unfold": dict(feat_unfold=False),
            "no_cell": dict(cell_decode=False)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,ranges,flatten", [
    ((16, 16), None, True), ((7, 13), None, False), ((3, 40), None, True),
    ((5, 6), [(-0.5, 2.0), (0.0, 1.0)], False)])
def test_make_coord_bit_for_bit(shape, ranges, flatten):
    want = np.asarray(J.make_coord(shape, ranges, flatten))
    got = make_coord(shape, ranges, flatten).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("quantity", [None, 37, 1000])
def test_generate_coordinate_and_cell_bit_for_bit(quantity):
    gt = uniform(1, (13, 17, 3), 0, 1)
    want = j_coordinate_and_cell(np.random.default_rng(2), gt, quantity)
    got = generate_coordinate_and_cell(np.random.default_rng(2), gt,
                                       quantity)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) == min(quantity or 13 * 17, 13 * 17)


def test_nearest_sample_matches_jax_at_half_pixels():
    feat = uniform(3, (2, 4, 8, 4))
    coord = uniform(4, (2, 40, 2), -0.99, 0.99)
    # the first 14 queries sit exactly half-way between two pixel centres,
    # p = 0.5 ... 6.5 in x and 0.5 ... 2.5 in y (exact in float32)
    hx = np.arange(14) % 7 + 0.5
    hy = np.arange(14) % 3 + 0.5
    coord[:, :14, 1] = (hx + 0.5) * 2 / 8 - 1
    coord[:, :14, 0] = (hy + 0.5) * 2 / 4 - 1
    want = np.asarray(J._nearest_sample(jnp.asarray(feat),
                                        jnp.asarray(coord)))
    got = _nearest_sample(torch.from_numpy(feat), torch.from_numpy(coord))
    assert np.array_equal(got.numpy(), want)
    # half-way rounds up: those queries read pixel (hy + 0.5, hx + 0.5)
    iy, ix = (hy + 0.5).astype(int), (hx + 0.5).astype(int)
    assert np.array_equal(got.numpy()[0, :14], feat[0, iy, ix])


def test_unfold3x3_matches_jax():
    feat = uniform(5, (2, 5, 6, 3))
    want = np.asarray(J._unfold3x3(jnp.asarray(feat)))
    got = _unfold3x3(torch.from_numpy(feat)).numpy()
    assert np.array_equal(got, want)


def queries(seed: int, b: int, h: int, w: int):
    """The x2 grid's coordinates (shuffled) and random cells."""
    rng = np.random.default_rng(seed)
    coord = np.asarray(J.make_coord((2 * h, 2 * w)))
    coord = np.stack([coord[rng.permutation(len(coord))] for _ in range(b)])
    cell = rng.uniform(0.5, 2.0, coord.shape).astype(np.float32) / (2 * h)
    return coord.astype(np.float32), cell


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("name", MODELS)
def test_liif_matches_jax(name, switch):
    jcls, pcls, kw = MODELS[name]
    kw = dict(kw, **SWITCHES[switch])
    lq = uniform(6, (2, 3, 8, 8), 0, 1)
    coord, cell = queries(7, 2, 8, 8)
    jm = jcls(**kw)
    variables = jax_variables(jm, [lq, coord, cell], 8)
    want = np.asarray(jit_apply(jm, variables, lq, coord, cell))
    model = port(pcls, variables, **kw)
    before = launch_counts()
    with torch.no_grad():
        got = model(*[torch.from_numpy(a) for a in (lq, coord, cell)])
    assert launch_counts() == before
    assert got.shape == (2, 256, 3)
    check(got, want, f"{name} {switch}")


def test_liif_edsr_grads_match_jax():
    lq = uniform(9, (1, 3, 8, 8), 0, 1)
    coord, cell = queries(10, 1, 8, 8)
    gt = uniform(11, (1, 256, 3), 0, 1)
    jm = J.LIIFEDSR(**SMALL)
    variables = jax_variables(jm, [lq, coord, cell], 12)

    def loss_fn(v, *args):
        return JL.l1_loss(jm.apply(v, *args[:3]), args[3])

    args = [jnp.asarray(a) for a in (lq, coord, cell, gt)]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn)).lower(
        variables, *args).compile(FAST)(variables, *args)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = port(LIIFEDSR, variables, **SMALL)
    out = model(*[torch.from_numpy(a) for a in (lq, coord, cell)])
    loss = PL.l1_loss(out, torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    trunk = {k: SAMPLE_RTOL for k in ref if not k.startswith("imnet.")}
    compare_grads(dict(model.named_parameters()), ref, trunk)


@pytest.mark.parametrize("size,up", [((6, 7), 2), ((5, 9), 3)])
def test_dynamic_upsampling_filter_matches_jax(size, up):
    x = uniform(13, (2, *size, 3))
    filters = uniform(14, (2, *size, 25, up * up))
    want = np.asarray(j_dynamic_upsampling_filter(jnp.asarray(x),
                                                  jnp.asarray(filters)))
    got = dynamic_upsampling_filter(torch.from_numpy(x),
                                    torch.from_numpy(filters))
    assert got.shape == (2, *size, 3 * up * up)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="filter_size"):
        dynamic_upsampling_filter(torch.from_numpy(x),
                                  torch.from_numpy(filters), (3, 3))
