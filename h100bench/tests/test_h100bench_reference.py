"""The benchmark's plain reference against the port on the CPU, at
1 x 7 x 1 x 32 x 48: both configurations' forwards and one training step
of the CVCP recipe (the port's CPU path is its plain versions)."""

import pytest
import torch

from h100bench import common
from h100bench.reference import fcvsr as ref
from h100bench.reference import train as ref_train
from h100bench.traffic.train import leaf_gap

CFGS = {
    "fcvsr": dict(n_feats=64, in_channels=1, num_frames=7, ac_num=6,
                  freq_inv=8, sc_groups=10, up_ksize=3),
    "fcvsr_s": dict(n_feats=64, in_channels=1, num_frames=7, ac_num=3,
                    freq_inv=4, sc_groups=4, up_ksize=1),
}
EXACT = dict(batch_mgaa=False, k_fused=False, tail_impl="xla",
             iac_chain="periter", iac_dtype="f32", scnet_dtype="f32",
             scnet_fuse="pair", head_dtype="f32", mffr_dtype="f32",
             tail_dtype="f32")


def _weights(cfg, seed):
    w = common.make_weights({**cfg, "serving_flags": EXACT}, seed,
                            torch.device("cpu"))
    # DivEnh's a starts at 0; give it values so that its term is checked
    g = torch.Generator().manual_seed(seed)
    for k in w:
        if k.endswith(".a"):
            w[k] = torch.rand(w[k].shape, generator=g) - 0.5
    return w


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_matches_port(name):
    torch.manual_seed(0)
    cfg = {**CFGS[name], "serving_flags": EXACT}
    w = _weights(cfg, 7)
    model = common.build_model(cfg, w, torch.device("cpu")).eval()
    x = torch.rand(1, 7, 1, 32, 48, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
        stages = {}
        want = ref.forward(w, x, **common.topology(cfg), stages=stages)
    assert got.shape == want.shape == (1, 1, 128, 192)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    # the network's own part is not negligible beside the bilinear base
    base = torch.nn.functional.interpolate(x[:, 3], size=(128, 192),
                                           mode="bilinear")
    assert float((want - base).abs().max()) > 1e-2


def test_train_step_matches_port():
    from fcvsr_tpu_torch.train.lr_schedule import multistep
    from fcvsr_tpu_torch.train.trainer import TrainState, make_train_step

    cfg = {**CFGS["fcvsr_s"], "serving_flags": EXACT}
    recipe = dict(lr=1e-4, betas=[0.9, 0.99], eps=1e-8, gamma=0.25,
                  milestones=[2000, 6000], charbonnier_eps=1e-4)
    w = _weights(cfg, 3)
    model = common.build_model(cfg, w, torch.device("cpu")).train()
    state = TrainState(model, multistep(1e-4, [2000, 6000], 0.25),
                       betas=(0.9, 0.99))
    step = make_train_step(state, "charbonnier_sum")
    g = torch.Generator().manual_seed(5)
    batch = (torch.rand(2, 7, 1, 32, 48, generator=g),
             torch.rand(2, 1, 128, 192, generator=g))
    loss = float(step(*batch)["loss"])
    losses, grads, params = ref_train.train_steps(
        w, [batch], common.topology(cfg), recipe)
    assert abs(loss - losses[0]) <= 1e-5 * abs(losses[0])
    opt = state.optimizer
    live, first = [], {}
    for n, p in model.named_parameters():
        if grads[n] is None:
            assert p not in opt.state
            continue
        live.append(n)
        first[n] = opt.state[p]["exp_avg"] / 0.1
    # by leaf norms against the larger of the leaf's and the median leaf's,
    # as the benchmark's check takes them (a tiny leaf's norm is noise)
    assert leaf_gap(first, grads, live) <= 1e-4
    # Adam's first step is lr * sign(g) where |g| >> eps, so an element
    # whose gradient is round-off flips: the change is compared by norms
    change = {n: p.detach() - w[n] for n, p in model.named_parameters()}
    want = {n: params[n] - w[n] for n in live}
    assert leaf_gap(change, want, live) <= 1e-3


def test_adam_update_is_torch_adam():
    g = torch.Generator().manual_seed(0)
    p = torch.randn(5, 3, generator=g)
    grads = [torch.randn(5, 3, generator=g) for _ in range(3)]
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=1e-3, betas=(0.9, 0.99), eps=1e-8)
    mine, state = {"p": p.clone()}, {}
    for gr in grads:
        q.grad = gr.clone()
        opt.step()
        ref_train.adam_update(mine, {"p": gr}, state, 1e-3)
    assert torch.allclose(mine["p"], q.detach(), rtol=0, atol=1e-7)
