"""TTSR in the port against the JAX package on the CPU: the search
transformer alone (random features, and features with repeated patches,
whose relevances tie exactly), then the whole model at mid 8, blocks (1,
1, 1, 1), an 8 x 8 LR against a 32 x 32 reference: its output, its
hard-attention picks and its gradient.  A file of its own: the JAX
model's jitted value-and-gradient takes most of its time.

The JAX picks are ``jnp.argmax`` over the relevance the JAX
``SearchTransformer`` computes (its ``_unfold``, the same normalisation, a
``Precision.HIGHEST`` product); the port's come from ``return_index`` /
``TTSR.search``.  They must be equal, ties included (both take the first
maximum); the tests print how many picks there were and how many tied.

Weights as in tests/test_torch_sisr.py.  Bars: the soft attention and the
textures within 1e-5 abs, the output within 1e-4 abs and 1e-5 of max
|out|; the gradient relative to the JAX gradient's norms, the whole
gradient, the median tensor and each tensor within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models import ttsr as J
from fcvsr_tpu.train import losses as JL
from fcvsr_tpu_torch.models import TTSR
from fcvsr_tpu_torch.models.ttsr import SearchTransformer
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.train import losses as PL
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_cvcp_zoo import FAST, jax_variables, uniform
from test_torch_sisr import check, compare_grads, port

SMALL = dict(mid_channels=8, num_blocks=(1, 1, 1, 1))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_picks(lq_up, ref_downup):
    """The JAX ``SearchTransformer``'s hard-attention index and the number
    of queries whose best relevance ties."""
    query = J._unfold(jnp.asarray(lq_up), 3, 1, 1)
    key = J._unfold(jnp.asarray(ref_downup), 3, 1, 1)
    query = query / jnp.maximum(
        jnp.linalg.norm(query, axis=-1, keepdims=True), 1e-12)
    key = key / jnp.maximum(jnp.linalg.norm(key, axis=-1, keepdims=True),
                            1e-12)
    rel = np.asarray(jnp.einsum("blc,bmc->blm", key, query,
                                precision=jax.lax.Precision.HIGHEST))
    ties = int(((rel == rel.max(1, keepdims=True)).sum(1) > 1).sum())
    return np.asarray(jnp.argmax(jnp.asarray(rel), axis=1)), ties


def compare_picks(got, want, ties):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    differ = int((got != want).sum())
    print(f"picks {want.size}, tied {ties}, differ {differ}")
    assert got.shape == want.shape and differ == 0


@pytest.mark.parametrize("repeat", [False, True])
def test_search_transformer_matches_jax(repeat):
    h, w, c = 6, 7, 8
    lq_up = uniform(1, (2, h, w, c))
    ref_downup = uniform(2, (2, h, w, c))
    if repeat:   # a 2 x 2 tile repeated: its interior patches tie exactly
        ref_downup = np.tile(ref_downup[:, :2, :2], (1, 3, 4, 1))[:, :h, :w]
        lq_up[:, ::2] = ref_downup[:, ::2]
    refs = [uniform(3, (2, h, w, c)), uniform(4, (2, 2 * h, 2 * w, c // 2)),
            uniform(5, (2, 4 * h, 4 * w, c // 4))]
    soft, tex = J.SearchTransformer()(jnp.asarray(lq_up),
                                      jnp.asarray(ref_downup),
                                      [jnp.asarray(r) for r in refs])
    want_idx, ties = jax_picks(lq_up, ref_downup)
    got_soft, got_tex, got_idx = SearchTransformer()(
        torch.from_numpy(lq_up), torch.from_numpy(ref_downup),
        [torch.from_numpy(r) for r in refs], return_index=True)
    compare_picks(got_idx, want_idx, ties)
    if repeat:
        assert ties > 0
    np.testing.assert_allclose(got_soft.numpy(), np.asarray(soft), rtol=0,
                               atol=1e-5)
    for g, t in zip(got_tex, tex):
        assert g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def ttsr_case():
    """The JAX TTSR's output and Charbonnier-mean gradient, one jitted
    ``value_and_grad``, and its picks."""
    lq = uniform(6, (1, 3, 8, 8), 0, 1)
    ref = uniform(7, (1, 3, 32, 32), 0, 1)
    gt = uniform(8, (1, 3, 32, 32), -1, 1)
    jm = J.TTSR(**SMALL)
    variables = jax_variables(jm, [lq, ref], 9)

    def loss_fn(v, lq, ref, gt):
        out = jm.apply(v, lq, ref)
        return JL.charbonnier(out, gt), out

    args = [jnp.asarray(a) for a in (lq, ref, gt)]
    (loss, out), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True)).lower(variables, *args).compile(FAST)(
        variables, *args)
    lte = J.LTE()
    ext = {"params": variables["params"]["extractor"]}
    lq_up = J._up_bicubic(args[0].transpose(0, 2, 3, 1), 4)
    ref_nhwc = args[1].transpose(0, 2, 3, 1)
    ref_downup = J._up_bicubic(J.resize_bicubic(ref_nhwc, 8, 8), 4)
    picks = jax_picks(lte.apply(ext, lq_up)[0], lte.apply(ext, ref_downup)[0])
    return dict(variables=variables, lq=lq, ref=ref, gt=gt,
                loss=float(loss), out=np.asarray(out), picks=picks,
                grads=state_dict_from_jax(jax.tree_util.tree_map(
                    np.asarray, grads)))


def test_ttsr_output_and_picks_match_jax(ttsr_case):
    case = ttsr_case
    model = port(TTSR, case["variables"], **SMALL)
    lq, ref = torch.from_numpy(case["lq"]), torch.from_numpy(case["ref"])
    before = launch_counts()
    with torch.no_grad():
        picks = model.search(lq, ref)[3]
        out = model(lq, ref)
    assert launch_counts() == before
    compare_picks(picks, *case["picks"])
    assert out.shape == (1, 3, 32, 32)
    assert float(out.abs().max()) <= 1.0
    check(out, case["out"], "TTSR")


def test_ttsr_grads_match_jax(ttsr_case):
    case = ttsr_case
    model = port(TTSR, case["variables"], **SMALL)
    out = model(torch.from_numpy(case["lq"]), torch.from_numpy(case["ref"]))
    loss = PL.charbonnier(out, torch.from_numpy(case["gt"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    rel = compare_grads(dict(model.named_parameters()), case["grads"], {})
    assert any(k.startswith("extractor.") for k in rel)
