"""``photon_ml_torch`` stands alone: it imports neither ``jax`` nor
anything of ``photon_ml_tpu``, and it runs on the GPU unless the caller
asks for the CPU."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from photon_ml_torch import resolve_device

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "photon_ml_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_has_the_serving_slice():
    for rel in ("photon_ml_torch/serving/engine.py",
                "photon_ml_torch/serving/server.py",
                "photon_ml_torch/csrc/gather_rowsum.cu", "chip_smoke.py"):
        assert (REPO / rel).is_file(), rel


def test_port_has_the_training_slice():
    for rel in ("photon_ml_torch/csrc/grr_contract.cu",
                "photon_ml_torch/native/fast_etl.cpp",
                "photon_ml_torch/data/grr.py",
                "photon_ml_torch/optim/lbfgs.py"):
        assert (REPO / rel).is_file(), rel
    # The C++ ETL source is the JAX package's, byte for byte.
    assert (REPO / "photon_ml_torch/native/fast_etl.cpp").read_bytes() == (
        REPO / "photon_ml_tpu/native/fast_etl.cpp").read_bytes()


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_import_in_port_source(rel):
    bad = [m for m in _imported_modules(REPO / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_fresh_import_leaves_jax_out():
    code = (
        "import json, sys\n"
        "import photon_ml_torch\n"
        "import photon_ml_torch.serving.server\n"
        "import photon_ml_torch.serving.__main__\n"
        "import photon_ml_torch.io.model_io\n"
        "import photon_ml_torch.ops.kernels\n"
        "import photon_ml_torch.kernels._build\n"
        "import photon_ml_torch.native\n"
        "import photon_ml_torch.data.grr\n"
        "import photon_ml_torch.data.batch\n"
        "import photon_ml_torch.data.statistics\n"
        "import photon_ml_torch.io.libsvm\n"
        "import photon_ml_torch.cache.plan_cache\n"
        "import photon_ml_torch.ops.objective\n"
        "import photon_ml_torch.optim.problem\n"
        "import photon_ml_torch.evaluation.evaluators\n"
        f"print(json.dumps(sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("tpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert resolve_device("cuda:0") == torch.device("cuda:0")
    else:
        for asked in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(asked)
