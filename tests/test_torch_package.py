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


def test_port_has_the_game_training_slice():
    for rel in ("photon_ml_torch/optim/tron.py",
                "photon_ml_torch/optim/variance.py",
                "photon_ml_torch/data/colmajor.py",
                "photon_ml_torch/game/coordinates.py",
                "photon_ml_torch/game/coordinate_descent.py",
                "photon_ml_torch/estimators/game_estimator.py",
                "photon_ml_torch/estimators/game_transformer.py",
                "photon_ml_torch/cli/game_training_driver.py"):
        assert (REPO / rel).is_file(), rel


def test_port_has_the_sweep_and_scoring_slice():
    for rel in ("photon_ml_torch/hyperparameter/__init__.py",
                "photon_ml_torch/hyperparameter/kernels.py",
                "photon_ml_torch/hyperparameter/gp.py",
                "photon_ml_torch/hyperparameter/search.py",
                "photon_ml_torch/hyperparameter/tuner.py",
                "photon_ml_torch/io/score_sink.py",
                "photon_ml_torch/cli/game_scoring_driver.py",
                "photon_ml_torch/cli/feature_indexing_driver.py"):
        assert (REPO / rel).is_file(), rel
        assert rel in PORT_FILES     # so the import scan covers it


def test_port_has_the_streaming_and_checkpoint_slice():
    """Checkpoints and resume (A8a) and the chunk-streamed fixed effect
    (A5a); ``reliability/faults.py`` and ``utils/checkpoint.py`` are the
    port's own copies."""
    for rel in ("photon_ml_torch/reliability/faults.py",
                "photon_ml_torch/reliability/checkpoint.py",
                "photon_ml_torch/utils/checkpoint.py",
                "photon_ml_torch/data/chunk_store.py",
                "photon_ml_torch/data/chunked_batch.py",
                "photon_ml_torch/optim/streaming.py"):
        assert (REPO / rel).is_file(), rel
        assert rel in PORT_FILES     # so the import scan covers it


def test_port_has_the_out_of_core_game_slice():
    """The streamed random effect with retirement and the fused cycle
    (A5b, its training half): ``game/fused_sweep.py`` and the entity and
    sidecar codecs of the chunk store."""
    rel = "photon_ml_torch/game/fused_sweep.py"
    assert (REPO / rel).is_file() and rel in PORT_FILES
    from photon_ml_torch.data import chunk_store
    from photon_ml_torch.game import coordinates

    assert chunk_store.ENTITY_CHUNK_CODEC and chunk_store.FUSED_CHUNK_CODEC
    assert coordinates.StreamedRandomEffectCoordinate.retire_converged


def test_port_has_the_lane_kernel_source():
    """The lane kernel has its own source (built by ``_build`` at first
    use); B1's source no longer holds it."""
    assert (REPO / "photon_ml_torch/csrc/gather_rowsum_lanes.cu").is_file()
    from photon_ml_torch.kernels import _build

    assert "gather_rowsum_lanes" in _build._SIGNATURES
    assert "gather_rowsum_lanes" not in (
        REPO / "photon_ml_torch/csrc/gather_rowsum.cu").read_text()


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
        "import photon_ml_torch.optim.tron\n"
        "import photon_ml_torch.optim.variance\n"
        "import photon_ml_torch.data.colmajor\n"
        "import photon_ml_torch.game.dataset\n"
        "import photon_ml_torch.game.sampling\n"
        "import photon_ml_torch.game.projector\n"
        "import photon_ml_torch.game.coordinates\n"
        "import photon_ml_torch.game.coordinate_descent\n"
        "import photon_ml_torch.game.fused_sweep\n"
        "import photon_ml_torch.estimators.game_transformer\n"
        "import photon_ml_torch.estimators.game_estimator\n"
        "import photon_ml_torch.config\n"
        "import photon_ml_torch.io.avro\n"
        "import photon_ml_torch.io.avro_schemas\n"
        "import photon_ml_torch.io.index_map\n"
        "import photon_ml_torch.io.dataset\n"
        "import photon_ml_torch.utils.run_log\n"
        "import photon_ml_torch.cli.game_training_driver\n"
        "import photon_ml_torch.cli.game_scoring_driver\n"
        "import photon_ml_torch.cli.feature_indexing_driver\n"
        "import photon_ml_torch.io.score_sink\n"
        "import photon_ml_torch.hyperparameter\n"
        "import photon_ml_torch.hyperparameter.gp\n"
        "import photon_ml_torch.hyperparameter.search\n"
        "import photon_ml_torch.hyperparameter.tuner\n"
        "import photon_ml_torch.reliability.faults\n"
        "import photon_ml_torch.reliability.checkpoint\n"
        "import photon_ml_torch.utils.checkpoint\n"
        "import photon_ml_torch.data.chunk_store\n"
        "import photon_ml_torch.data.chunked_batch\n"
        "import photon_ml_torch.optim.streaming\n"
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
