"""No module the benchmark runs is jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's begins with the JAX
package's), and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import PB, ROOT
from portbench.harness import forbidden_modules

BANNED = {"jax", "jaxlib", "flax", "minigraph_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in PB.rglob("*.py"):
        assert not set(_imports(path)) & BANNED, path


@pytest.mark.parametrize("engine", ["ref", "pyref"])
def test_reference_imports_nothing_of_the_port(engine):
    for path in (PB / engine).rglob("*.py"):
        mods = set(_imports(path))
        assert not mods & {"minigraph_tpu_torch", "portbench", "torch"}, \
            path


def test_loaded_modules_in_a_process():
    """Every module of the harness, imported with the port's modules the
    run imports, leaves no banned top-level name in sys.modules."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.harness, portbench.control, portbench.indep\n"
        "import portbench.ref.mapper, portbench.pyref.mapping.mapper\n"
        "from minigraph_tpu_torch import kernels\n"
        "from minigraph_tpu_torch.mapping import mapper, device_front\n"
        "from minigraph_tpu_torch.graph.gfa_io import read_gfa\n"
        "from minigraph_tpu_torch.index.midx import build_index\n"
        "from portbench.harness import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "minigraph_tpu_torch_x", sys)
    assert "minigraph_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "minigraph_tpu.ops", sys)
    assert "minigraph_tpu" in forbidden_modules()
