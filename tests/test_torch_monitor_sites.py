"""The live monitor's training and scoring sites held against the JAX
package's.

Each case runs the same inputs through both packages with a monitor
active (snapshots at every call) and compares the ``progress`` events
stage by stage (stage, done, total, unit): the streaming solvers
(``train.sweep``, ``solver``, ``train.tron.<label>``, the swept
``solver.<label>``), coordinate descent (``cd``), the fused cycle
(``train.cd_fused`` and ``cd`` cycles), streamed random effects
(``re.<coordinate>``), the swept grid (``swept``), the tuner
(``tuner``) and the streamed scorer (``score``).  Then the estimator and
the three drivers open the monitor from their config or flags
(``monitor``, ``status_port``), as the reference's do.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import pytest

from photon_ml_tpu.telemetry import monitor as j_monitor
from photon_ml_torch.config import training_config_from_json
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.telemetry import monitor as t_monitor
from photon_ml_torch.utils.run_log import RunLogger, read_run_log
from test_torch_fused_cd import _arrays, _cfg_dict, _dataset
from test_torch_game import _config, _datasets, _movielens
from test_torch_streaming_scorer import _both, _ref_scorer
from test_torch_telemetry import (
    D as TEL_D,
    N_CHUNKS,
    _fit,
    _ref_fit,
    _ref_spilled_objective,
    _spilled_objective,
)
from test_torch_training import jax_c1, jax_fresh_caches  # noqa: F401

CPU = "cpu"
MONITORS = {"jax": j_monitor, "port": t_monitor}


@pytest.fixture(autouse=True)
def _no_leaked_monitor():
    assert j_monitor.active() is None and t_monitor.active() is None
    yield
    leaked = [p for p, m in MONITORS.items() if m.active() is not None]
    for p in leaked:
        MONITORS[p].active().close()
    assert not leaked, leaked


class _Sink:
    """RunLogger stand-in collecting events."""

    def __init__(self):
        self.events: list = []

    def now(self) -> float:
        return 0.0

    def event(self, kind: str, **fields) -> None:
        self.events.append({"event": kind, **fields})

    def close(self) -> None:
        pass


@contextlib.contextmanager
def _watching(pkg):
    """``pkg``'s monitor over the block, a snapshot at every call."""
    sink = _Sink()
    mon = MONITORS[pkg].start(run_logger=sink, every_s=0.0)
    try:
        yield sink
    finally:
        mon.close()


def _progress(sink, prefix: str = "") -> list:
    return [(e["stage"], e["done"], e.get("total"), e["unit"])
            for e in sink.events if e["event"] == "progress"
            and e["stage"].startswith(prefix)]


def _both_progress(run_jax, run_port, prefix: str = "") -> tuple:
    with _watching("jax") as js:
        run_jax()
    with _watching("port") as ts:
        run_port()
    return _progress(js, prefix), _progress(ts, prefix)


@pytest.mark.parametrize("kind,stages", [
    ("lbfgs", {"train.sweep", "solver"}),
    ("tron", {"train.sweep", "train.tron.t"}),
    ("swept", {"train.sweep", "solver.global"}),
])
def test_streaming_solver_progress_matches_jax(jax_c1, tmp_path, kind,
                                               stages):
    """A streamed solve: each chunk of each pass and each iteration
    against the budget, the same in both packages."""
    j, t = _both_progress(
        lambda: _ref_fit(_ref_spilled_objective(tmp_path), kind),
        lambda: _fit(_spilled_objective(tmp_path), kind))
    assert t == j
    assert {s for s, *_ in t} == stages
    sweep = [p for p in t if p[0] == "train.sweep"]
    assert sweep[0][1:] == (1.0, float(N_CHUNKS), "chunks")


def test_predict_margins_pass_progress_matches_jax(tmp_path):
    j, t = _both_progress(
        lambda: _ref_spilled_objective(tmp_path).predict_margins(
            np.zeros(TEL_D, np.float32)),
        lambda: _spilled_objective(tmp_path).predict_margins(
            np.zeros(TEL_D, np.float32)))
    assert t == j == [("train.pass", float(i), float(N_CHUNKS), "chunks")
                      for i in range(1, N_CHUNKS + 1)]


def _cd_fit(pkg, cfg: dict):
    data = _movielens(n_users=20, n_items=8, n_obs=400, seed=3)
    tr, va = _datasets(data, 300, "jax" if pkg == "jax" else "torch")
    if pkg == "jax":
        from photon_ml_tpu.config import training_config_from_json as jcfg
        from photon_ml_tpu.estimators.game_estimator import (
            GameEstimator as JE,
        )

        return JE(jcfg(json.dumps(cfg))).fit(tr, va)
    return GameEstimator(training_config_from_json(
        json.dumps({**cfg, "device": CPU}))).fit(tr, va)


def test_cd_progress_matches_jax(jax_c1):
    """Coordinate descent reports each coordinate update against the
    plan (3 coordinates x 2 sweeps)."""
    cfg = _config()
    j, t = _both_progress(lambda: _cd_fit("jax", cfg),
                          lambda: _cd_fit("port", cfg), "cd")
    assert t == j == [("cd", float(i), 6.0, "updates")
                      for i in range(1, 7)]


def test_swept_progress_matches_jax(jax_c1):
    """A swept λ grid over the fixed effect reports its sweeps."""
    cfg = _config(coordinates=_config()["coordinates"][:1],
                  update_sequence=["global"],
                  reg_weight_grid={"global": [0.1, 1.0, 10.0]})
    j, t = _both_progress(lambda: _cd_fit("jax", cfg),
                          lambda: _cd_fit("port", cfg), "swept")
    assert t == j == [("swept", 1.0, 2.0, "sweeps"),
                      ("swept", 2.0, 2.0, "sweeps")]


def _fused_fit(pkg, cfg: dict, a: dict):
    ds = _dataset(a, pkg)
    if pkg == "jax":
        from photon_ml_tpu.config import training_config_from_json as jcfg
        from photon_ml_tpu.estimators.game_estimator import (
            GameEstimator as JE,
        )

        return JE(jcfg(json.dumps(cfg))).fit(ds)
    return GameEstimator(training_config_from_json(
        json.dumps({**cfg, "device": CPU}))).fit(ds)


def test_fused_cycle_progress_matches_jax(jax_c1, rng):
    """The fused cycle: each pass's chunks (``train.cd_fused``) and the
    cycles (``cd``)."""
    a = _arrays(rng)
    cfg = _cfg_dict(True, 3)
    j, t = _both_progress(lambda: _fused_fit("jax", cfg, a),
                          lambda: _fused_fit("port", cfg, a))
    assert [p for p in t if p[0] == "cd"] == \
        [p for p in j if p[0] == "cd"] == \
        [("cd", float(i), 3.0, "cycles") for i in range(1, 4)]
    fused = [p for p in t if p[0] == "train.cd_fused"]
    assert fused and all(p[2] == 4.0 and p[3] == "chunks" for p in fused)
    assert fused[:4] == [("train.cd_fused", float(i), 4.0, "chunks")
                         for i in range(1, 5)]
    assert {p[2] for p in j if p[0] == "train.cd_fused"} == {4.0}


def test_streamed_random_effect_progress_matches_jax(jax_c1, rng, tmp_path):
    """A random effect streamed in entity chunks reports its chunks a
    sweep (``re.<coordinate>``)."""
    a = _arrays(rng)
    cfg = _cfg_dict(False, 2, chunk_rows=None, re_chunk_entities=8,
                    spill_dir=str(tmp_path / "spill"), re_retirement=False)
    j, t = _both_progress(lambda: _fused_fit("jax", cfg, a),
                          lambda: _fused_fit("port", cfg, a), "re.")
    assert t == j
    assert t and {p[0] for p in t} == {"re.per_u"}
    assert t[-1][1] == t[-1][2]


def test_tuner_progress_matches_jax():
    """Each trial (one at a time) and each round (batched) against the
    budget."""
    from photon_ml_tpu.hyperparameter import search as js
    from photon_ml_tpu.hyperparameter import tuner as jt
    from photon_ml_torch.hyperparameter import search as ts
    from photon_ml_torch.hyperparameter import tuner as tt

    def run(search_mod, tuner_mod):
        space = search_mod.SearchSpace([search_mod.ParamRange(
            "a", 0.1, 10.0)])
        tuner = tuner_mod.HyperparameterTuner(
            space, mode=tuner_mod.TunerMode.RANDOM, seed=3)
        tuner.run(lambda c: (c["a"], None), 3)
        tuner.run_batched(lambda cs: [(c["a"], None) for c in cs], 4,
                          batch_size=2)

    j, t = _both_progress(lambda: run(js, jt), lambda: run(ts, tt))
    assert t == j == [("tuner", float(i), 3.0, "trials")
                      for i in (1, 2, 3)] + \
        [("tuner", float(i), 4.0, "trials") for i in (2, 4)]


def test_scorer_progress_matches_jax(rng):
    """The streamed scorer reports rows against the dataset's."""
    from photon_ml_torch.estimators.streaming_scorer import (
        StreamingGameScorer,
    )
    from photon_ml_torch.models.glm import TaskType

    (model, ds), (jmodel, jds) = _both(rng, n=500)
    task = TaskType.LOGISTIC_REGRESSION
    j, t = _both_progress(
        lambda: _ref_scorer(jmodel, task, chunk_rows=128).score(jds),
        lambda: StreamingGameScorer(model, task, chunk_rows=128,
                                    device=CPU).score(ds))
    assert t == j == [("score", float(r), 500.0, "rows")
                      for r in (128, 256, 384, 500)]


# ---------------------------------------------------------------------------
# the estimator and the drivers open the monitor from their config
# ---------------------------------------------------------------------------


def _events(path) -> list:
    return [e["event"] for e in read_run_log(path)]


def test_estimator_opens_monitor_from_config(tmp_path):
    """``monitor: on`` (or a ``status_port``) opens a monitor over the
    fit on the fit's run log; it is closed when the fit returns."""
    data = _movielens(n_users=20, n_items=8, n_obs=400, seed=3)
    tr, va = _datasets(data, 300, "torch")
    for i, extra in enumerate(({"monitor": "on"}, {"status_port": 0})):
        cfg = training_config_from_json(json.dumps(
            {**_config(n_iterations=1), **extra, "device": CPU}))
        path = str(tmp_path / f"run_{i}.jsonl")
        with RunLogger(path) as log:
            GameEstimator(cfg).fit(tr, va, run_logger=log)
        events = _events(path)
        assert events.count("monitor_start") == 1
        assert "progress" in events and "monitor_summary" in events
        assert ("status_server" in events) == ("status_port" in extra)
        assert t_monitor.active() is None


def _driver_config(tmp_path) -> str:
    """The config-4 fixture's training config (1 sweep) as a file."""
    from test_torch_drivers import config4

    path = str(tmp_path / "train.json")
    with open(path, "w") as f:
        json.dump({**config4(str(tmp_path / "out")), "n_iterations": 1},
                  f)
    return path


def test_training_driver_monitor_flags(tmp_path):
    from photon_ml_torch.cli import game_training_driver as drv

    out = tmp_path / "out"
    drv.main(["--config", _driver_config(tmp_path), "--device", CPU,
              "--monitor", "on", "--monitor-every-s", "0.5",
              "--status-port", "0"])
    events = read_run_log(str(out / "run_log.jsonl"))
    kinds = [e["event"] for e in events]
    assert kinds.count("monitor_start") == 1
    assert "status_server" in kinds and "monitor_summary" in kinds
    start = next(e for e in events if e["event"] == "monitor_start")
    assert start["every_s"] == 0.5
    summary = next(e for e in events if e["event"] == "monitor_summary")
    assert summary["stages"]["cd"]["done"] == \
        summary["stages"]["cd"]["total"] == 2.0


def test_scoring_and_indexing_drivers_monitor_flags(tmp_path):
    from photon_ml_torch.cli import feature_indexing_driver as idx
    from photon_ml_torch.cli import game_scoring_driver as sdrv
    from photon_ml_torch.cli import game_training_driver as tdrv
    from test_torch_drivers import HERE

    out = tmp_path / "out"
    tdrv.main(["--config", _driver_config(tmp_path), "--device", CPU])
    score_cfg = str(tmp_path / "score.json")
    with open(score_cfg, "w") as f:
        json.dump({"input_path": os.path.join(HERE, "config4_valid.avro"),
                   "model_dir": str(out / "model"),
                   "output_path": str(tmp_path / "scored" / "scores.npz"),
                   "evaluators": ["AUC"]}, f)
    sdrv.main(["--config", score_cfg, "--device", CPU, "--monitor", "on",
               "--score-chunk-rows", "64"])
    events = read_run_log(str(tmp_path / "scored" / "scoring_log.jsonl"))
    prog = [e for e in events if e["event"] == "progress"
            and e["stage"] == "score"]
    assert prog and prog[-1]["done"] == prog[-1]["total"]
    assert "monitor_summary" in [e["event"] for e in events]
    log_path = str(tmp_path / "index_log.jsonl")
    with RunLogger(log_path) as log:
        idx.run(os.path.join(HERE, "config4_train.avro"),
                str(tmp_path / "maps"), log=log, status_port=0)
    kinds = _events(log_path)
    assert "status_server" in kinds and "monitor_summary" in kinds
