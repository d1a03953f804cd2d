"""The port's GPU toolchain probe (``fcvsr_tpu_torch.tools.gpu_probe``) on
a machine without a card: it fails, says why, and writes only its JSON."""

import json
import os

import pytest
import torch

from fcvsr_tpu_torch.tools import gpu_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_probe_without_cuda_fails_and_names_the_cause(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root_before = sorted(os.listdir(REPO))
    default_before = gpu_probe.DEFAULT_OUT.exists()
    out = tmp_path / "probe.json"
    assert gpu_probe.main(["--skip-kernel", "--out", str(out)]) == 1
    res = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["ok"] is False and res["dot"]["ok"] is False
    assert "torch.cuda.is_available() is False" in res["dot"]["error"]
    assert res["bf16_conv"]["error"] == "skipped: the dot probe failed"
    assert res["kernel"]["error"] == "skipped by flag"
    assert os.listdir(tmp_path) == ["probe.json"]
    assert sorted(os.listdir(REPO)) == root_before
    assert gpu_probe.DEFAULT_OUT.exists() == default_before


def test_probe_runs_what_its_flags_ask(tmp_path, monkeypatch, capsys):
    ran = []
    results = {"dot": True, "bf16_conv": True, "kernel": True}

    def fake(name):
        ran.append(name)
        return {"ok": results[name]}

    monkeypatch.setattr(gpu_probe, "_run", fake)
    out = str(tmp_path / "p.json")
    assert gpu_probe.main(["--skip-kernel", "--out", out]) == 0
    assert ran == ["dot", "bf16_conv"]
    assert json.load(open(out))["kernel"]["error"] == "skipped by flag"
    ran.clear()
    assert gpu_probe.main(["--out", out]) == 0
    assert ran == ["dot", "bf16_conv", "kernel"]
    results["kernel"] = False
    assert gpu_probe.main(["--out", out]) == 1
    results["dot"] = False
    ran.clear()
    assert gpu_probe.main(["--out", out]) == 1 and ran == ["dot"]
    capsys.readouterr()


def test_scale2_on_cpu_is_its_plain_version():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    before = gpu_probe.scale2.launches
    assert torch.equal(gpu_probe.scale2(x), 2 * x)
    assert gpu_probe.scale2.launches == before


def test_launch_path_refuses_without_a_card():
    """The launch-path timing (K12 against torch.mul) needs a card: without
    one it exits with the reason and writes nothing."""
    from fcvsr_tpu_torch.benchmarks import launch_path

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="is_available"):
        launch_path.main([])


def test_side_lib_serves_a_loaded_library_without_the_lock(monkeypatch):
    """A library already loaded is served without taking the build lock,
    and a failed build raises again on every call, without rebuilding."""
    from fcvsr_tpu_torch.ops import _native

    class Held:
        def __enter__(self):
            raise AssertionError("took the lock")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setitem(_native._side_libs, "served", (lib, None))
    monkeypatch.setitem(_native._side_libs, "broken", RuntimeError("nvcc"))
    monkeypatch.setattr(_native, "_lock", Held())
    assert _native.side_lib("served", [], {}, "e") == (lib, None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc"):
            _native.side_lib("broken", [], {}, "e")
    monkeypatch.setattr(_native, "_lib", lib)
    assert _native.lib() is lib
