"""The port's parity inventory: for every module of the JAX package
(``fcvsr_tpu/``), every public top-level name (a function, class or
assignment not starting with ``_``, the names in ``__all__``, and what a
package's ``__init__`` imports) exists at the top level of the same-named
module of ``fcvsr_tpu_torch/`` (defined or imported there), or is listed
in ``COUNTERPARTS`` with the port's name for it, which the test resolves,
or in ``NO_COUNTERPART`` with the reason the port has none.

Only ``ast``: nothing of either package is imported.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "fcvsr_tpu"
PORT_PKG = REPO / "fcvsr_tpu_torch"

_ROWS = ("the TPU kernels' padded-rows layout; the port's CUDA kernels read "
         "NHWC tensors")
_DEVICE = ("a process-wide switch of the JAX package; the port picks its "
           "kernel by the tensors' device: the CUDA kernel on the card, the "
           "plain version on the CPU")
_FFT = ("a process-wide switch between XLA's FFT and a matmul DFT for the "
        "TPU; the port's transforms are torch.fft (cuFFT on the card)")

# "module:name" of the JAX package -> the port's dotted name for it; a
# trailing "(arg)" names a constructor argument, which must exist
COUNTERPARTS = {
    "ops.pallas_conv:conv3x3_rows": "fcvsr_tpu_torch.ops.fused_conv.conv3x3",
    "ops.pallas_conv:conv3x3_rows_nhwc":
        "fcvsr_tpu_torch.ops.fused_conv.conv3x3",
    "ops.pallas_conv:conv3x3_pair_rows":
        "fcvsr_tpu_torch.ops.fused_conv.conv3x3_pair",
    "ops.pallas_conv:conv3x3_quad_rows":
        "fcvsr_tpu_torch.ops.fused_conv.conv3x3_quad",
    "ops.pallas_conv:prep_weight": "fcvsr_tpu_torch.ops.fused_conv.prep_weight",
    "ops.pallas_dcn:modulated_deform_conv2d_fused":
        "fcvsr_tpu_torch.ops.fused_dcn.modulated_deform_conv2d_fused",
    "ops.pallas_dcn:modulated_deform_conv2d_fused_vjp":
        "fcvsr_tpu_torch.ops.fused_dcn.modulated_deform_conv2d_fused_vjp",
    "ops.pallas_iac:iac_fused": "fcvsr_tpu_torch.ops.fused_iac.iac_fused",
    "ops.pallas_iac:iac_fused_kf": "fcvsr_tpu_torch.ops.fused_iac.iac_fused_kf",
    "ops.pallas_iac:iac_fused_resident":
        "fcvsr_tpu_torch.ops.fused_iac.iac_fused_resident",
    "ops.pallas_iac:iac_fused_vjp": "fcvsr_tpu_torch.ops.fused_iac.warp_sac_bwd",
    "ops.pallas_iac:warp_sac_fused":
        "fcvsr_tpu_torch.ops.fused_iac.warp_sac_fused",
    "ops.sac:set_iac_chain": "fcvsr_tpu_torch.models.fcvsr.FCVSRNet(iac_chain)",
    "models.scnet_rows:scnet_rows_apply":
        "fcvsr_tpu_torch.models.scnet_rows.scnet_apply",
    # the rows forward under autograd: the port's scnet_apply differentiates
    "models.scnet_rows:scnet_rows_diff":
        "fcvsr_tpu_torch.models.scnet_rows.scnet_apply",
    "train:create_train_state": "fcvsr_tpu_torch.train.trainer.TrainState",
    "train.trainer:create_train_state":
        "fcvsr_tpu_torch.train.trainer.TrainState",
    "parallel:data_parallel_shardings":
        "fcvsr_tpu_torch.parallel.mesh.data_parallel",
    "parallel.mesh:data_parallel_shardings":
        "fcvsr_tpu_torch.parallel.mesh.data_parallel",
    "utils:flax_to_torch_key": "fcvsr_tpu_torch.utils.convert.flax_to_torch_key",
    "utils.torch_import:flax_to_torch_key":
        "fcvsr_tpu_torch.utils.convert.flax_to_torch_key",
    # the newest iter_<step>.pt file, the step in its name (orbax's step
    # number in the JAX package)
    "utils.checkpoint:latest_step":
        "fcvsr_tpu_torch.utils.checkpoint.latest_checkpoint",
    # the reference's key names in a float32 .npz, which test.py reads
    "utils.checkpoint:export_torch_style":
        "fcvsr_tpu_torch.utils.checkpoint.export_npz",
}

NO_COUNTERPART = {
    "ops.pallas_conv:COL_OFF": _ROWS,
    "ops.pallas_conv:ROW_OFF": _ROWS,
    "ops.pallas_conv:pad_to_rows": _ROWS,
    "ops.pallas_conv:rows_geometry": _ROWS,
    "ops.pallas_conv:rows_to_nhwc": _ROWS,
    "ops.sac:set_iac_bwd": _DEVICE,
    "ops.dcn:set_dcn_impl": _DEVICE,
    "ops.dcn:set_dcn_bwd": _DEVICE,
    "ops.freq:set_fft_impl": _FFT,
    "ops.freq:set_dft_ct": _FFT,
    "models.spynet:convert_spynet_state_dict":
        "JAX-side: loads a torch SPyNet state_dict into flax params; the "
        "port's SPyNet is a torch module and loads it as it is",
    "utils:convert_torch_state_dict":
        "JAX-side: maps a torch checkpoint onto flax params; the port "
        "loads torch checkpoints with load_state_dict",
    "utils.torch_import:convert_torch_state_dict":
        "JAX-side: maps a torch checkpoint onto flax params; the port "
        "loads torch checkpoints with load_state_dict",
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def public_names(path: Path) -> set:
    """The JAX module's public top-level names."""
    names, exported = set(), set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        exported |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")} | exported


def top_level(path: Path) -> dict:
    """Every name bound at the port module's top level -> its node (a def
    or class) or None."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update({t.id: None for t in targets
                        if isinstance(t, ast.Name)})
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update({(a.asname or a.name).split(".")[0]: None
                        for a in node.names})
    return out


def module_file(root: Path, dotted: str):
    """The file of module ``dotted`` (relative to the package ``root``), or
    None."""
    base = root.joinpath(*dotted.split(".")) if dotted else root
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def jax_modules() -> list:
    mods = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append((".".join(parts), path))
    return mods


def resolve(dotted: str) -> bool:
    """Whether the port's ``a.b.name``, ``a.b.Class.method`` or
    ``a.b.Class(arg)`` exists: the longest module prefix with a file, then
    top-level names, class members and constructor arguments by ast."""
    arg = None
    if dotted.endswith(")"):
        dotted, arg = dotted[:-1].split("(")
    parts = dotted.split(".")
    assert parts[0] == "fcvsr_tpu_torch", dotted
    for cut in range(len(parts), 0, -1):
        path = module_file(PORT_PKG, ".".join(parts[1:cut]))
        if path is not None:
            break
    rest = parts[cut:]
    if not rest:
        return arg is None
    node = top_level(path).get(rest[0], False)
    if node is False:
        return False
    for name in rest[1:]:
        if not isinstance(node, ast.ClassDef):
            return False
        node = next((n for n in node.body if getattr(n, "name", None)
                     == name), False)
        if node is False:
            return False
    if arg is None:
        return True
    if isinstance(node, ast.ClassDef):
        node = next((n for n in node.body if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
    return node is not None and arg in [
        a.arg for a in node.args.args + node.args.kwonlyargs]


def missing_names() -> list:
    """Every "module:name" of the JAX package that the same-named port
    module does not bind."""
    missing = []
    for mod, path in jax_modules():
        port = module_file(PORT_PKG, mod)
        have = top_level(port) if port is not None else {}
        missing += [f"{mod}:{n}" for n in sorted(public_names(path))
                    if n not in have]
    return missing


def test_every_jax_name_has_a_port_counterpart():
    """The tested statement that the port does all the JAX package does:
    each name the port lacks under its JAX module's name is mapped or
    explained."""
    unexplained = [k for k in missing_names()
                   if k not in COUNTERPARTS and k not in NO_COUNTERPART]
    assert not unexplained, unexplained


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_counterpart_resolves(key):
    assert resolve(COUNTERPARTS[key]), (key, COUNTERPARTS[key])


def test_inventory_lists_no_stale_entry():
    """Every listed name is a public JAX name that the port's same-named
    module lacks: a name the port gained leaves the lists."""
    missing = set(missing_names())
    listed = set(COUNTERPARTS) | set(NO_COUNTERPART)
    assert not set(COUNTERPARTS) & set(NO_COUNTERPART)
    assert listed <= missing, sorted(listed - missing)
    assert all(NO_COUNTERPART.values())


def test_resolver_refuses_what_is_not_there():
    """The resolver's own check: a name, a member and a constructor
    argument that the port lacks do not resolve."""
    assert resolve("fcvsr_tpu_torch.models.fcvsr.FCVSRNet(iac_chain)")
    assert resolve("fcvsr_tpu_torch.models.blocks_ext.FSAS.forward")
    assert not resolve("fcvsr_tpu_torch.models.fcvsr.FCVSRNet(no_such)")
    assert not resolve("fcvsr_tpu_torch.models.blocks_ext.NoSuchBlock")
    assert not resolve("fcvsr_tpu_torch.models.blocks_ext.FSAS.no_such")
    assert not resolve("fcvsr_tpu_torch.no_such_module.name")
