"""The port stands alone: importing ``diffopt_tpu_torch`` or ``chip_smoke``
pulls in neither ``jax`` nor the JAX package, and needs no compiler or card."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.path.insert(0, {root!r})
import {module}
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "diffopt_tpu" or m.startswith("diffopt_tpu."))
print("BAD", bad)
print("TORCH", "torch" in sys.modules)
"""


_MODULES = ["diffopt_tpu_torch", "chip_smoke", "diffopt_tpu_torch.parallel", "diffopt_tpu_torch.native",
            "diffopt_tpu_torch.graft_entry"]


@pytest.fixture(scope="module")
def probes():
    """One interpreter per module, started together (each takes seconds to import torch)."""
    # -S -E: skip site hooks and environment, so that nothing but the module
    # under test decides what gets imported; site-packages is added back by hand
    import torch

    site = str(pathlib.Path(torch.__file__).resolve().parents[1])
    procs = {}
    for module in _MODULES:
        code = "import sys; sys.path.append(%r)\n" % site + _PROBE.format(root=str(ROOT), module=module)
        procs[module] = subprocess.Popen(
            [sys.executable, "-S", "-E", "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(ROOT),
        )
    # and the smoke script itself, as a user would start it on a machine without a card
    procs["run chip_smoke"] = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT),
    )
    results = {}
    for module, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        results[module] = (proc.returncode, out, err)
    return results


@pytest.mark.parametrize("module", _MODULES)
def test_import_pulls_in_no_jax(probes, module):
    returncode, out, err = probes[module]
    assert returncode == 0, err
    assert "BAD []" in out, out
    assert "TORCH True" in out


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_import_statement_names_jax():
    files = list((ROOT / "diffopt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "diffopt_tpu", "flax", "optax"), (f, mod)


def test_every_port_module_imports_without_a_compiler():
    import importlib

    names = []
    for f in sorted((ROOT / "diffopt_tpu_torch").rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        names.append(".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts))
        importlib.import_module(names[-1])
    # the modules of the staged QP path, the symmetric-cone path, the nonsymmetric-cone path, the multi-process
    # modules and the native packer are among them
    for mod in ("api", "parameters", "qp_diff", "ops.linalg", "solvers.qp", "utils.batching", "ops.cuda.chol",
                "cones", "conic_diff", "ops.smalleig", "ops.lsqr", "solvers.conic", "solvers.conic_ipm",
                "ops.cuda.conic_pdip", "ops.jordan", "ops.ns_barrier", "ops.cuda.ns_pdip", "solvers.conic_nsipm",
                "parallel", "parallel.schur", "parallel.sharding", "parallel.runtime", "parallel.tp_chol", "native",
                "graft_entry"):
        assert f"diffopt_tpu_torch.{mod}" in names
    from diffopt_tpu_torch.ops.cuda import _build

    assert _build.build_seconds is None  # nothing was built by importing


def test_chip_smoke_fails_without_a_card(probes):
    returncode, out, _ = probes["run chip_smoke"]
    assert returncode != 0
    assert '"ok": true' not in out
