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
# The examples that run the port's phases alone on the card.
PORT_FILES += sorted(str(p.relative_to(REPO))
                     for p in (REPO / "examples").glob("chip_phase*.py"))


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


def test_port_has_the_streamed_scoring_slice():
    """The one-pass streamed scorer with its sinks' writer thread, the
    streaming evaluators and the chunked readers (A5b.3, D8)."""
    for rel in ("photon_ml_torch/estimators/streaming_scorer.py",
                "photon_ml_torch/evaluation/streaming.py",
                "photon_ml_torch/io/chunked.py"):
        assert (REPO / rel).is_file() and rel in PORT_FILES, rel
    from photon_ml_torch.estimators import streaming_scorer
    from photon_ml_torch.estimators.game_transformer import GameTransformer

    assert streaming_scorer.StreamingGameScorer.score
    assert GameTransformer.transform_streamed


def test_port_has_the_telemetry_slice():
    """The telemetry tier (A8b): the session, its exporters, the report
    and history CLI, the guards, CUDA-event timing and the synthetic
    fixtures; the kernel builds bridge into it."""
    for rel in ("photon_ml_torch/telemetry/__init__.py",
                "photon_ml_torch/telemetry/__main__.py",
                "photon_ml_torch/telemetry/export.py",
                "photon_ml_torch/telemetry/device.py",
                "photon_ml_torch/telemetry/convergence.py",
                "photon_ml_torch/telemetry/report.py",
                "photon_ml_torch/telemetry/history.py",
                "photon_ml_torch/analysis/guards.py",
                "photon_ml_torch/utils/timing.py",
                "photon_ml_torch/utils/synthetic.py"):
        assert (REPO / rel).is_file() and rel in PORT_FILES, rel
    from photon_ml_torch.kernels import _build
    from photon_ml_torch.telemetry import report

    assert _build.add_build_listener and report.reconcile


def test_port_has_the_fleet_slice():
    """The supervised replica fleet and its frontend (D5), behind the
    serving CLI's ``--replicas``."""
    for rel in ("photon_ml_torch/serving/fleet.py",
                "photon_ml_torch/serving/frontend.py",
                "examples/chip_phase15.py"):
        assert (REPO / rel).is_file(), rel
    for rel in ("photon_ml_torch/serving/fleet.py",
                "photon_ml_torch/serving/frontend.py"):
        assert rel in PORT_FILES, rel
    import photon_ml_torch.serving as serving
    from photon_ml_torch.serving.fleet import FleetServer

    assert serving.FleetServer is FleetServer


def test_port_has_the_training_fleet_slice():
    """The multi-host training fleet over tcp (A7a): ``parallel.fleet``,
    the ``fleet-report`` CLI, the environment registry, and phase 16's
    example; importing the fleet pulls in neither jax nor the JAX
    package."""
    for rel in ("photon_ml_torch/parallel/__init__.py",
                "photon_ml_torch/parallel/fleet.py",
                "photon_ml_torch/telemetry/fleet_report.py",
                "examples/chip_phase16.py"):
        assert (REPO / rel).is_file() and rel in PORT_FILES, rel
    from photon_ml_torch.config import SANCTIONED_ENV, read_env

    assert "PHOTON_FLEET_COORDINATOR" in SANCTIONED_ENV and read_env
    code = ("import json, sys\n"
            "import photon_ml_torch.parallel.fleet\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'photon_ml_tpu')))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_has_the_lane_kernel_source():
    """The lane kernel has its own source (built by ``_build`` at first
    use); B1's source no longer holds it."""
    assert (REPO / "photon_ml_torch/csrc/gather_rowsum_lanes.cu").is_file()
    from photon_ml_torch.kernels import _build

    assert "gather_rowsum_lanes" in _build._SIGNATURES
    assert "gather_rowsum_lanes" not in (
        REPO / "photon_ml_torch/csrc/gather_rowsum.cu").read_text()


def test_port_has_the_lint_and_compile_cache_slice():
    """photon-lint (``analysis.checkers`` and its CLI) and the kernel
    build cache: with them every module of the JAX package has its
    counterpart; importing them pulls in neither jax nor the JAX
    package."""
    rels = ("photon_ml_torch/analysis/checkers.py",
            "photon_ml_torch/analysis/__main__.py",
            "photon_ml_torch/cache/compile_cache.py")
    for rel in rels:
        assert (REPO / rel).is_file() and rel in PORT_FILES, rel
    ref = {p.relative_to(REPO / "photon_ml_tpu")
           for p in (REPO / "photon_ml_tpu").rglob("*.py")}
    port = {p.relative_to(REPO / "photon_ml_torch")
            for p in (REPO / "photon_ml_torch").rglob("*.py")}
    assert sorted(map(str, ref - port)) == []
    code = ("import json, sys\n"
            "import photon_ml_torch.analysis.__main__\n"
            "import photon_ml_torch.cache.compile_cache\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'photon_ml_tpu')))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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
        "import photon_ml_torch.estimators.streaming_scorer\n"
        "import photon_ml_torch.evaluation.streaming\n"
        "import photon_ml_torch.io.chunked\n"
        "import photon_ml_torch.telemetry\n"
        "import photon_ml_torch.telemetry.__main__\n"
        "import photon_ml_torch.telemetry.export\n"
        "import photon_ml_torch.telemetry.device\n"
        "import photon_ml_torch.telemetry.convergence\n"
        "import photon_ml_torch.telemetry.report\n"
        "import photon_ml_torch.telemetry.history\n"
        "import photon_ml_torch.telemetry.monitor\n"
        "import photon_ml_torch.telemetry.watch\n"
        "import photon_ml_torch.telemetry.serve_report\n"
        "import photon_ml_torch.serving.tracing\n"
        "import photon_ml_torch.serving.fleet\n"
        "import photon_ml_torch.serving.frontend\n"
        "import photon_ml_torch.analysis.guards\n"
        "import photon_ml_torch.analysis.checkers\n"
        "import photon_ml_torch.cache.compile_cache\n"
        "import photon_ml_torch.utils.timing\n"
        "import photon_ml_torch.utils.synthetic\n"
        f"print(json.dumps(sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _runs_reference(path: pathlib.Path) -> bool:
    """The file imports the JAX package, or a reference test module."""
    return any(m.split(".")[0] == "photon_ml_tpu"
               or (m.startswith("test_") and not m.startswith("test_torch_"))
               for m in _imported_modules(path))


def test_port_test_files_clear_jax_caches():
    """Every port test file that runs the JAX package clears jax's caches
    when it ends (ROADMAP C5): it imports the module-scoped autouse
    fixture ``jax_fresh_caches`` of ``tests/test_torch_training.py``."""
    files = sorted((REPO / "tests").glob("test_torch_*.py"))
    running = [p for p in files if _runs_reference(p)]
    assert len(running) >= 18, [p.name for p in running]
    missing = []
    for p in running:
        tree = ast.parse(p.read_text(), filename=str(p))
        names = {a.asname or a.name for node in tree.body
                 if isinstance(node, ast.ImportFrom)
                 and node.module == "test_torch_training"
                 for a in node.names}
        defined = {node.name for node in tree.body
                   if isinstance(node, ast.FunctionDef)}
        if "jax_fresh_caches" not in names | defined:
            missing.append(p.name)
    assert not missing, missing


def test_port_scorer_test_leaves_reference_compile_budget():
    """C5 end to end: the port's scorer parity test that runs the JAX
    package's chunk program at the shapes of the reference's compile
    budget test, then that test, in one process: both pass."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTEST_ADDOPTS")}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
         "-p", "no:randomly", "-p", "no:cacheprovider",
         "tests/test_torch_streaming_scorer.py::"
         "test_streamed_matches_resident_all_mixes[96]",
         "tests/test_scoring_stream.py::test_scorer_compile_budget"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "2 passed" in out.stdout, out.stdout[-2000:]


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
