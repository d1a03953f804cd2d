"""Every cell's configuration, traffic mix, driver, limits and per-layer
readers are found by name, and the same seed gives the same inputs."""

import json

import pytest
import torch

from h100bench import common, harness, inputs

BENCH = harness.load_benchmark()
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = harness.find(BENCH["workloads"], cell)
    cfg = harness.load_config(BENCH, w["config"])
    mix = harness.load_mix(w["traffic"])
    assert harness.driver_class(mix["kind"]).__name__ == "Driver"
    limits = harness.load_limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    assert cfg["tf32"] is False and cfg["precision"] == "float32"
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert callable(harness.reader(m["name"]))


def test_configs_files_and_keys():
    for c in BENCH["configs"]:
        cfg = harness.load_config(BENCH, c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert set(common.TOPOLOGY) <= set(cfg)
        assert common.weight_shapes(cfg)


def test_same_seed_same_weights():
    cfg = harness.load_config(BENCH, "fcvsr_s_cvcp_y")
    a = common.make_weights(cfg, 2 ** 31 + 5, CPU)
    b = common.make_weights(cfg, 2 ** 31 + 5, CPU)
    c = common.make_weights(cfg, 2 ** 31 + 6, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["feat_extract.0.weight"],
                           c["feat_extract.0.weight"])
    # the rules: PReLU slopes, DivEnh's a and b, SCNet's zero biases
    assert float(a["lrelu.weight"]) == 0.25
    assert not a["MFFRblock.DivEnh_block.0.a"].any()
    assert not a["recorb1.body.0.body.0.body.0.bias"].any()
    assert a["recorb1.body.0.conv.bias"].any()


@pytest.mark.parametrize("hr", [1, 4])
def test_same_seed_same_video(hr):
    def make(seed):
        g = inputs.generator(seed, "video", CPU)
        return inputs.video(g, 2, 5, 12, 16, 1, hr_scale=hr)

    a, b, c = make(3 * 10 ** 9), make(3 * 10 ** 9), make(3 * 10 ** 9 + 1)
    first = a if hr == 1 else a[1]
    assert first.dtype == torch.uint8 and first.shape == (2, 5, 1, 12, 16)
    flat = (lambda v: v) if hr == 1 else (lambda v: torch.cat(
        [v[0].flatten(), v[1].flatten()]))
    assert torch.equal(flat(a), flat(b))
    assert not torch.equal(flat(a), flat(c))
    # the two clips are distinct scenes, and the frames move
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[0, 0], first[0, 1])


@pytest.mark.parametrize("cell,overrides", [
    ("fcvsr_s.stream1080", dict(height=9, width=12, clip_frames=8)),
    ("fcvsr.clip1080", dict(height=9, width=12, clip_frames=5, clips=2)),
    ("fcvsr.train_cvcp", dict(clips=2, patch=8, batches=3)),
])
def test_same_seed_same_driver_inputs(cell, overrides):
    traffic = {"fcvsr.train_cvcp": "train_cvcp"}.get(cell) or \
        harness.find(BENCH["workloads"], cell)["traffic"]
    cfg = harness.load_config(BENCH, "fcvsr_cvcp_y")
    mix = {**harness.load_mix(traffic), **overrides}
    made = []
    for _ in range(2):
        d = harness.driver_class(mix["kind"])(cfg, mix, 77, CPU, None)
        if mix["kind"] == "train":
            made.append(torch.cat([torch.cat([x.flatten(), y.flatten()])
                                   for x, y in d._batches()]))
        else:
            g = inputs.generator(77, "video", CPU)
            made.append(inputs.video(g, mix["clips"], mix["clip_frames"],
                                     mix["height"], mix["width"]))
    assert torch.equal(made[0], made[1])


def test_benchmark_json_is_well_formed():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert json.loads(json.dumps(BENCH)) == BENCH
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        moved = harness.find(BENCH["end_to_end"], m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
