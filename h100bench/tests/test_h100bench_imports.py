"""The import guard: nothing the benchmark runs loads JAX or the JAX
package (top-level module names compared whole: the port's name,
``fcvsr_tpu_torch``, begins with the JAX package's), the reference imports
nothing of the measured program, and no file of the benchmark reads the
JAX package's benchmark (the root ``benchmarks/``, ``bench.py``,
``BENCH_*.json``)."""

import ast
import subprocess
import sys

from h100bench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "fcvsr_tpu"}
# what the reference may import: the standard library's, torch, numpy and
# its own modules
REFERENCE_OK = {"__future__", "math", "functools", "torch", "numpy"}


def _sources(root):
    return sorted(p for p in root.rglob("*.py") if "_cache" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(HERE):
        for name, level in _imports(path):
            if level == 0:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(HERE / "reference"):
        for name, level in _imports(path):
            if level:
                continue  # its own modules
            assert name.split(".")[0] in REFERENCE_OK, (path, name)


def test_no_source_reads_the_jax_benchmark():
    for path in _sources(HERE):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in ("bench.py", "BENCH_", "benchmarks/", "bench_baseline"):
            assert word not in text, (path, word)


def test_a_run_loads_no_jax():
    kinds = sorted(p.stem for p in (HERE / "traffic").glob("*.py")
                   if p.stem != "__init__")
    metrics = sorted(p.name[:-3] for p in (HERE / "metrics").glob("*.py"))
    code = f"""
import sys, importlib
sys.path.insert(0, {str(harness.ROOT)!r})
import h100bench.run, h100bench.control
from h100bench import harness, common, inputs, serve, trace, work
from h100bench.reference import fcvsr, train
for k in {kinds!r}:
    harness.driver_class(k)
for m in {metrics!r}:
    harness.reader(m)
# what the drivers import from the port when they run
for m in ("fcvsr_tpu_torch.cli", "fcvsr_tpu_torch.models.inference",
          "fcvsr_tpu_torch.models.fcvsr", "fcvsr_tpu_torch.train.trainer",
          "fcvsr_tpu_torch.train.lr_schedule"):
    importlib.import_module(m)
print(sorted(n for n in sys.modules if n.split('.')[0] in {sorted(FORBIDDEN)!r}))
print(h100bench.run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"], out.stdout
    assert "fcvsr_tpu_torch" not in h100bench_forbidden_sample()


def h100bench_forbidden_sample():
    """The guard's test of names: the port's own module is not caught."""
    from h100bench import run

    saved = dict(sys.modules)
    try:
        sys.modules["fcvsr_tpu_torch_probe"] = sys
        sys.modules["jax.numpy_probe"] = sys
        found = run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    assert "jax.numpy_probe" in found
    return found
