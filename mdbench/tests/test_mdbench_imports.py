"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX
package, compared by whole top-level module name (the port's name begins
with the JAX package's); the reference and the work counts import nothing
of the program either."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from mdbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "lammps_buck_intel_tpu"}
FILES = sorted(glob.glob(os.path.join(spec.HERE, "**", "*.py"),
                         recursive=True))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_forbidden_import(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    rel = os.path.relpath(path, spec.HERE)
    if rel.startswith(("reference", "work")):
        assert "lammps_buck_intel_tpu_torch" not in names


def test_loaded_modules_after_import():
    code = (
        "import sys, glob, os, importlib\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "import mdbench.run as r\n"
        "from mdbench.harness import cell, checks, trace, layers\n"
        "from mdbench.reference import model\n"
        "from mdbench.work import pair, kspace\n"
        "import mdbench.control\n"
        "import lammps_buck_intel_tpu_torch.run\n"
        "from lammps_buck_intel_tpu_torch.io import dump\n"
        "from lammps_buck_intel_tpu_torch import computes\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_the_check_compares_whole_names(monkeypatch):
    from mdbench import run as r

    monkeypatch.setitem(sys.modules, "lammps_buck_intel_tpu_torch_x", sys)
    assert r.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert r.forbidden_modules() == ["jax"]
