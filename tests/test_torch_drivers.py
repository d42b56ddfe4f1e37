"""The port's training driver (``photon_ml_torch.cli.game_training_driver``)
on the committed fixtures, on the CPU.

It must reproduce ``tests/resources/golden.json`` at the tolerances of
``tests/test_fixtures.py``: held-out AUC within 2e-3, fixed-effect
coefficients within 2e-3 (config 4: a fixed effect plus a per-user
random effect from the Avro containers; config 1: one fixed effect from
LIBSVM).  The saved model loads in both packages and scores the same.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_torch.cli import game_training_driver
from photon_ml_torch.io.model_io import load_game_model
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

HERE = os.path.join(os.path.dirname(__file__), "resources")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "golden.json")) as f:
        return json.load(f)


def config4(out_dir: str) -> dict:
    """``tests/test_fixtures.py``'s config-4 run."""
    return {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [
            {"name": "global", "kind": "FIXED_EFFECT",
             "feature_shard": "global",
             "optimizer": {"optimizer": "LBFGS", "reg_weight": 1.0,
                           "max_iters": 100}},
            {"name": "per_user", "kind": "RANDOM_EFFECT",
             "feature_shard": "user_re", "entity_key": "userId",
             "optimizer": {"optimizer": "LBFGS", "reg_weight": 2.0,
                           "max_iters": 60}},
        ],
        "update_sequence": ["global", "per_user"],
        "n_iterations": 2,
        "input_path": os.path.join(HERE, "config4_train.avro"),
        "validation_path": os.path.join(HERE, "config4_valid.avro"),
        "output_dir": out_dir,
        "evaluators": ["AUC"],
    }


def _write(tmp_path, cfg) -> str:
    p = str(tmp_path / "cfg.json")
    with open(p, "w") as f:
        json.dump(cfg, f)
    return p


def _fixed(model_dir: str) -> np.ndarray:
    model, _ = load_game_model(model_dir)
    return np.asarray(model.models["global"].coefficients.means)


def test_config4_avro_golden(tmp_path, golden):
    out = str(tmp_path / "out")
    summary = game_training_driver.main(
        ["--config", _write(tmp_path, config4(out)), "--device", "cpu"])
    want = golden["config4"]
    got_auc = summary["models"][0]["evaluations"]["AUC"]
    assert abs(got_auc - want["auc"]) < 2e-3, (got_auc, want["auc"])
    np.testing.assert_allclose(_fixed(os.path.join(out, "model")),
                               np.asarray(want["fixed_coefficients"]),
                               rtol=2e-3, atol=2e-3)
    assert len(summary["models"][0]["validation_history"]) == 2
    for name in ("summary.json", "config.json", "run_log.jsonl"):
        assert os.path.isfile(os.path.join(out, name)), name
    assert os.path.isdir(os.path.join(out, "index_maps"))
    events = [json.loads(line)
              for line in open(os.path.join(out, "run_log.jsonl"))]
    assert events[0]["event"] == "run_header" and "torch" in events[0]
    assert {"cd_coordinate", "cd_validation", "done"} <= {
        e["event"] for e in events}
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["device"] == "cpu"


def test_config4_model_scores_alike_in_both_packages(tmp_path):
    """The saved model, loaded by the JAX package's transformer and by the
    port's, gives the same validation margins (1e-4)."""
    from photon_ml_tpu.estimators.game_transformer import (
        GameTransformer as JT,
    )
    from photon_ml_tpu.io.dataset import read_game_dataset as jread
    from photon_ml_tpu.io.index_map import load_index_maps as jmaps
    from photon_ml_tpu.io.model_io import load_game_model as jload

    from photon_ml_torch.estimators.game_transformer import GameTransformer
    from photon_ml_torch.io.dataset import read_game_dataset
    from photon_ml_torch.io.index_map import load_index_maps

    out = str(tmp_path / "out")
    game_training_driver.main(
        ["--config", _write(tmp_path, config4(out)), "--device", "cpu"])
    valid = os.path.join(HERE, "config4_valid.avro")
    fm, em = load_index_maps(os.path.join(out, "index_maps"))
    model, task = load_game_model(os.path.join(out, "model"))
    got = GameTransformer(model=model, task=task, device="cpu").transform(
        read_game_dataset(valid, fm, em))
    jfm, jem = jmaps(os.path.join(out, "index_maps"))
    jmodel, jtask = jload(os.path.join(out, "model"))
    want = np.asarray(JT(model=jmodel, task=jtask).transform(
        jread(valid, jfm, jem)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_config1_libsvm_golden(tmp_path, golden):
    cfg = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{
            "name": "global", "kind": "FIXED_EFFECT",
            "feature_shard": "features",
            "optimizer": {"optimizer": "LBFGS", "reg_weight": 1.0,
                          "max_iters": 100}}],
        "update_sequence": ["global"],
        "input_path": os.path.join(HERE, "config1.libsvm"),
        "validation_path": os.path.join(HERE, "config1.t.libsvm"),
        "output_dir": str(tmp_path / "out"),
        "evaluators": ["AUC"],
        "device": "cpu",
    }
    summary = game_training_driver.main(["--config", _write(tmp_path, cfg)])
    want = golden["config1"]
    got_auc = summary["models"][0]["evaluations"]["AUC"]
    assert abs(got_auc - want["auc"]) < 2e-3, (got_auc, want["auc"])
    model, _ = load_game_model(str(tmp_path / "out" / "model"))
    np.testing.assert_allclose(
        np.asarray(model.models["global"].coefficients.means),
        np.asarray(want["coefficients"]), rtol=2e-3, atol=2e-3)


def test_driver_subprocess_defaults_to_cuda(tmp_path):
    """``python -m photon_ml_torch.cli.game_training_driver`` without
    ``--device``: on the card where there is one, else it raises and
    writes no model; with ``--device cpu`` it ends with a JSON summary
    line."""
    cfg = _write(tmp_path, config4(str(tmp_path / "out")))
    cmd = [sys.executable, "-m", "photon_ml_torch.cli.game_training_driver",
           "--config", cfg]
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
        assert not os.path.exists(str(tmp_path / "out" / "model"))
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["best_index"] == 0


def test_driver_rejects_unported_knobs(tmp_path, golden):
    # The mesh is ported now (A7b; it raised before): config 4 with
    # n_devices 2 and distributed_init (a world of one gloo process)
    # reproduces the golden at its tolerances, and the driver leaves no
    # process group behind.  Its validation is the reference's.
    cfg = config4(str(tmp_path / "out"))
    cfg["n_devices"] = 2
    cfg["distributed_init"] = True
    summary = game_training_driver.main(
        ["--config", _write(tmp_path, cfg), "--device", "cpu"])
    want = golden["config4"]
    assert abs(summary["models"][0]["evaluations"]["AUC"]
               - want["auc"]) < 2e-3
    np.testing.assert_allclose(
        _fixed(os.path.join(str(tmp_path / "out"), "model")),
        np.asarray(want["fixed_coefficients"]), rtol=2e-3, atol=2e-3)
    assert not torch.distributed.is_initialized()
    cfg["n_devices"] = 0
    with pytest.raises(ValueError, match="n_devices must be positive"):
        game_training_driver.main(["--config", _write(tmp_path, cfg),
                                   "--device", "cpu"])
