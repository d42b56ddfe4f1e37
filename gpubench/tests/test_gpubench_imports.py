"""What the benchmark's modules import, by whole top-level names: no JAX
and no JAX package anywhere, the port only through ``gpubench/port.py``,
and nothing of the port in the reference."""

from __future__ import annotations

import ast
import os

import pytest

from gpubench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "photon_ml_tpu"}


def _modules():
    for root, _, files in os.walk(manifest.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                yield os.path.relpath(path, manifest.HERE), path


def _imports(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


MODULES = sorted(_modules())


@pytest.mark.parametrize("rel,path", MODULES)
def test_no_jax(rel, path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("rel,path", MODULES)
def test_only_the_adapter_imports_the_port(rel, path):
    tops = {m.split(".")[0] for m in _imports(path)}
    if rel != "port.py":
        assert "photon_ml_torch" not in tops


@pytest.mark.parametrize("rel,path", [m for m in MODULES
                                      if m[0].startswith("reference")])
def test_the_reference_uses_nothing_of_the_port(rel, path):
    for name in _imports(path):
        assert name.split(".")[0] in {"numpy", "torch", "gpubench",
                                      "__future__"}
        assert not name.startswith(("gpubench.port", "gpubench.entries",
                                    "gpubench.run"))


def test_the_whole_name_is_compared():
    """The port's name begins with the JAX package's; whole top-level
    names tell them apart."""
    from gpubench import run

    assert "photon_ml_torch" not in FORBIDDEN
    assert all(m.split(".")[0] != "photon_ml_tpu"
               for m in run.forbidden_modules()
               if m.startswith("photon_ml_torch"))
