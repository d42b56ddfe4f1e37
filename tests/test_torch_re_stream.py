"""Parity of the port's streamed random effect with the JAX package.

Mirrors ``tests/test_re_stream.py`` (less the mesh case, ROADMAP A7):
the streamed entity-bucket solves against the resident coordinate in
the port and against the JAX package's streamed coordinate, for every
bucket mix × chunk grid and a projected sparse shard; the chunk store's
host window, visit order, warm reuse (across packages too) and lineage
rebuild; converged-entity retirement (monotone, within 1e-5 of
retirement off, woken by drift); the streamed CD loop, warm starts,
scoring of foreign blocks, the estimator, the training driver and the
config.  The port runs on ``device="cpu"``.

Tolerances.  A chunk grid changes the lane count of a batched solve, and
with it the float32 summation order of its products, so the lane solves
walk other trajectories and their float32 line searches stop up to
~1e-3 apart (the resolution ROADMAP C records, and the tolerance
``tests/test_re_stream.py`` holds the JAX package's own streamed and
resident coordinates to, which differ by up to 6e-4 here): coefficients
and variances 1e-3, scores 2e-3, in the port and against the JAX
package.  Where the lane counts match (retirement on against off, a
warm store, one chunk a bucket) the results are held to 1e-5 or
bitwise.  Four coordinate-descent sweeps compound the resolution:
coefficients 2e-3 and total scores 5e-3 at a 6-entity grid.  Against
the JAX package coefficients are held as ``tests/test_torch_game.py``
holds them (1e-3 absolute, or relative past 1 in magnitude).  AUC 1e-3.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    TrainingConfig,
    config_to_json,
    training_config_from_json,
)
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_torch.game.coordinates import (
    build_random_effect_coordinate,
    build_random_effect_coordinate_sparse,
    build_streamed_random_effect_coordinate,
)
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig
from test_torch_training import jax_c1  # noqa: F401  (the C1 fixture)

CPU = "cpu"
COEF_ATOL, SCORE_ATOL, EXACT_ATOL, AUC_ATOL = 1e-3, 2e-3, 1e-5, 1e-3
CFG = OptimizerConfig(max_iters=50, tolerance=1e-7)


def _objective(l2=0.5):
    return GLMObjective(loss=losses.LOGISTIC,
                        reg=RegularizationContext.l2(l2),
                        norm=NormalizationContext.identity())


def _jax_objective(l2=0.5):
    from photon_ml_tpu.data.normalization import NormalizationContext as N
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as O
    from photon_ml_tpu.ops.regularization import RegularizationContext as R

    return O(loss=jl.LOGISTIC, reg=R.l2(l2), norm=N.identity())


def _jcfg(cfg: OptimizerConfig):
    from photon_ml_tpu.optim import OptimizerConfig as J

    return J(max_iters=cfg.max_iters, tolerance=cfg.tolerance)


def _ids(rng, mix: str, n: int) -> np.ndarray:
    if mix == "skewed":
        # A long tail of small entities and a head of heavy ones:
        # several size buckets, uneven fill.
        return np.concatenate([rng.integers(0, 30, (2 * n) // 3),
                               rng.integers(100, 106, n - (2 * n) // 3)])
    return rng.integers(0, 25, n)


def _arrays(rng, n=420, p=3, mix="skewed") -> dict:
    return {"x": rng.normal(0, 1, (n, p)).astype(np.float32),
            "y": (rng.uniform(size=n) < 0.5).astype(np.float32),
            "w": rng.uniform(0.5, 1.5, n).astype(np.float32),
            "ids": _ids(rng, mix, n)}


def _dataset(a: dict, pkg: str = "torch"):
    if pkg == "jax":
        from photon_ml_tpu.game.dataset import GameDataset as D
    else:
        D = GameDataset
    return D(labels=a["y"], features={"re": a["x"]},
             entity_ids={"u": a["ids"]}, weights=a["w"])


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_blocks_close(a, b, atol=COEF_ATOL, rtol=0.0):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        np.testing.assert_allclose(_np(ba), _np(bb), atol=atol, rtol=rtol)


def _streamed(ds, spill, chunk_entities, **kw):
    kw.setdefault("config", CFG)
    return build_streamed_random_effect_coordinate(
        "u", ds, "re", _objective(), spill_dir=str(spill),
        chunk_entities=chunk_entities, device=CPU, **kw)


@pytest.mark.parametrize("mix", ["skewed", "uniform"])
@pytest.mark.parametrize("chunk_entities", [1, 7, 512])
def test_streamed_matches_resident_and_jax(jax_c1, rng, tmp_path, mix,
                                           chunk_entities):
    """Coefficients, scores and variances: the port's streamed
    coordinate against its resident one and against the JAX package's
    streamed coordinate on the same data and chunk grid."""
    from photon_ml_tpu.game.coordinates import (
        build_streamed_random_effect_coordinate as jbuild,
    )

    a = _arrays(rng, mix=mix)
    off_np = rng.normal(0, 0.3, len(a["y"])).astype(np.float32)
    off = torch.from_numpy(off_np)
    res = build_random_effect_coordinate("u", _dataset(a), "re",
                                         _objective(), config=CFG,
                                         device=CPU)
    st = _streamed(_dataset(a), tmp_path / "torch", chunk_entities)
    w_r, _ = res.train(off)
    w_s, diag = st.train(off)
    assert diag["entities_solved"] == st.grouping.n_total_entities
    # One chunk a bucket keeps the resident lane counts.
    _assert_blocks_close(w_r, w_s, atol=(EXACT_ATOL if chunk_entities == 512
                                         else COEF_ATOL))
    np.testing.assert_allclose(_np(st.score(w_s)), _np(res.score(w_r)),
                               atol=SCORE_ATOL)
    _assert_blocks_close(res.compute_variance_blocks(w_r, off),
                         st.compute_variance_blocks(w_s, off))

    jst = jbuild("u", _dataset(a, "jax"), "re", _jax_objective(),
                 spill_dir=str(tmp_path / "jax"),
                 chunk_entities=chunk_entities, config=_jcfg(CFG))
    assert jst.chunk_ents == st.chunk_ents
    w_j, jdiag = jst.train(jax_c1.numpy.asarray(off_np))
    assert jdiag["entities_solved"] == diag["entities_solved"]
    _assert_blocks_close(w_j, w_s, rtol=COEF_ATOL)
    np.testing.assert_allclose(_np(st.score(w_s)), np.asarray(jst.score(w_j)),
                               atol=SCORE_ATOL)


def test_streamed_sparse_projected_matches_resident(jax_c1, rng, tmp_path):
    """A sparse shard streams through the subspace projection: the solve
    matches the port's resident projected coordinate and the JAX
    package's streamed one."""
    from photon_ml_tpu.game.coordinates import (
        build_streamed_random_effect_coordinate as jbuild,
    )
    from photon_ml_tpu.game.dataset import GameDataset as JD

    n, d_re = 300, 12
    ids = _ids(rng, "skewed", n)
    rows = []
    for _ in range(n):
        k = rng.integers(1, 4)
        cols = rng.choice(d_re, size=k, replace=False).astype(np.int32)
        rows.append((cols, rng.normal(0, 1, k).astype(np.float32)))
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    ds = GameDataset(labels=y, features={"re": rows},
                     entity_ids={"u": ids}, feature_dims={"re": d_re})
    off_np = rng.normal(0, 0.3, n).astype(np.float32)
    off = torch.from_numpy(off_np)
    res = build_random_effect_coordinate_sparse(
        "u", ds, "re", _objective(), global_dim=d_re, config=CFG,
        device=CPU)
    st = _streamed(ds, tmp_path / "torch", 5)
    assert st.projection is not None
    w_r, _ = res.train(off)
    w_s, _ = st.train(off)
    _assert_blocks_close(w_r, w_s)
    # One chunk a bucket: the resident coordinate's lane counts.
    w_1, _ = _streamed(ds, tmp_path / "whole", 512).train(off)
    _assert_blocks_close(w_r, w_1, atol=EXACT_ATOL)
    np.testing.assert_allclose(_np(res.score(w_r)), _np(st.score(w_s)),
                               atol=SCORE_ATOL)
    jst = jbuild("u", JD(labels=y, features={"re": rows},
                         entity_ids={"u": ids}, feature_dims={"re": d_re}),
                 "re", _jax_objective(), spill_dir=str(tmp_path / "jax"),
                 chunk_entities=5, config=_jcfg(CFG))
    w_j, _ = jst.train(jax_c1.numpy.asarray(off_np))
    _assert_blocks_close(w_j, w_s, rtol=COEF_ATOL)


def test_lru_window_bound_and_sequential_order(rng, tmp_path):
    """At most host_max_resident decoded chunks live through the build
    and every training and scoring sweep; each pass visits the store in
    ascending order; the store is quiesced after it."""
    a = _arrays(rng)
    st = _streamed(_dataset(a), tmp_path, 4, host_max_resident=2)
    total = st.store.n_chunks
    assert total >= 6
    off = torch.from_numpy(rng.normal(0, 0.3, len(a["y"]))
                           .astype(np.float32))
    w, _ = st.train(off)
    st.compute_variance_blocks(w, off)
    assert st.store.peak_resident <= 2
    st.store.assert_quiesced()
    log = st.store.access_log
    for i in range(0, len(log), total):
        assert log[i:i + total] == sorted(log[i:i + total])


def test_warm_store_reuse_across_builds_and_packages(rng, tmp_path):
    """The same data and configuration reuse every chunk file: a second
    port build and a port build on the JAX package's spill dir spill
    nothing and train to the same result; other data gets another key."""
    from photon_ml_tpu.game.coordinates import (
        build_streamed_random_effect_coordinate as jbuild,
    )

    a = _arrays(rng)
    off = torch.from_numpy(rng.normal(0, 0.3, len(a["y"]))
                           .astype(np.float32))
    st1 = _streamed(_dataset(a), tmp_path / "t", 6)
    assert st1.store.spills == st1.store.n_chunks
    w1, _ = st1.train(off)
    st2 = _streamed(_dataset(a), tmp_path / "t", 6)
    assert st2.store.spills == 0 and st2.store.key == st1.store.key
    w2, _ = st2.train(off)
    _assert_blocks_close(w1, w2, atol=0)
    # The JAX package's spill dir: the same key, the files reused.
    jst = jbuild("u", _dataset(a, "jax"), "re", _jax_objective(),
                 spill_dir=str(tmp_path / "j"), chunk_entities=6,
                 config=_jcfg(CFG))
    st3 = _streamed(_dataset(a), tmp_path / "j", 6)
    assert st3.store.key == jst.store.key and st3.store.spills == 0
    w3, _ = st3.train(off)
    _assert_blocks_close(w1, w3, atol=0)
    st4 = _streamed(_dataset(_arrays(np.random.default_rng(7))),
                    tmp_path / "t", 6)
    assert st4.store.key != st2.store.key


def test_corrupt_and_missing_chunks_rebuild_from_lineage(rng, tmp_path):
    """A deleted chunk file and a truncated one both rebuild from the
    example rows mid-sweep, and the result is unchanged."""
    a = _arrays(rng)
    off = torch.from_numpy(rng.normal(0, 0.3, len(a["y"]))
                           .astype(np.float32))
    res = build_random_effect_coordinate("u", _dataset(a), "re",
                                         _objective(), config=CFG,
                                         device=CPU)
    w_r, _ = res.train(off)
    st = _streamed(_dataset(a), tmp_path, 4, host_max_resident=1)
    files = sorted(glob.glob(os.path.join(str(tmp_path), "chunks",
                                          f"{st.store.key}-*.npz")))
    assert len(files) == st.store.n_chunks >= 4
    os.remove(files[-1])
    with open(files[2], "r+b") as f:
        f.truncate(10)
    w_s, _ = st.train(off)
    assert st.store.rebuilds >= 2
    _assert_blocks_close(w_r, w_s)


def _cd_sweeps(coord, schedule):
    """Coordinate-descent sweeps as the loop runs them: train, then the
    retirement hook."""
    w, solved = None, []
    for off in schedule:
        w, diag = coord.train(torch.from_numpy(off), w)
        solved.append(diag["entities_solved"])
        coord.retire_converged()
    return w, solved


def test_retirement_monotone_equivalent_and_woken(rng, tmp_path):
    """On a converging schedule the retired set grows (solved entities a
    sweep never rise and end below E), the model stays within 1e-5 of
    retirement off, and offsets drifting past the tolerance wake every
    retired entity."""
    a = _arrays(rng)
    base = rng.normal(0, 0.3, len(a["y"])).astype(np.float32)
    cfg = OptimizerConfig(max_iters=50, tolerance=1e-6)
    on = _streamed(_dataset(a), tmp_path / "on", 6, config=cfg)
    off_ = _streamed(_dataset(a), tmp_path / "off", 6, config=cfg,
                     retirement=False)
    w_on, solved_on = _cd_sweeps(on, [base] * 4)
    w_off, solved_off = _cd_sweeps(off_, [base] * 4)
    E = on.grouping.n_total_entities
    assert solved_off == [E] * 4
    assert solved_on[0] == E
    assert all(x >= y for x, y in zip(solved_on, solved_on[1:]))
    assert solved_on[-1] < E and on.entities_retired > 0
    _assert_blocks_close(w_on, w_off, atol=EXACT_ATOL)
    w_on, diag = on.train(torch.from_numpy(base + 0.5), w_on)
    assert diag["entities_solved"] == E
    assert diag["entities_woken"] > 0


def test_returned_blocks_and_scores_are_not_the_sweep_state(rng,
                                                           tmp_path):
    """The blocks and the score plane a sweep returns are copies: a later
    sweep, which updates the coordinate's host state in place, leaves
    them as they were (on the CPU a tensor made from a host array would
    share its memory)."""
    a = _arrays(rng)
    st = _streamed(_dataset(a), tmp_path, 6)
    off = torch.from_numpy(rng.normal(0, 0.3, len(a["y"]))
                           .astype(np.float32))
    w1, _ = st.train(off)
    s1 = st.score(w1)
    kept = [b.clone() for b in w1], s1.clone()
    st.train(off + 1.0, w1)
    _assert_blocks_close(w1, kept[0], atol=0)
    np.testing.assert_array_equal(_np(s1), _np(kept[1]))


@pytest.mark.parametrize("chunk_entities,coef_atol,score_atol", [
    (512, EXACT_ATOL, EXACT_ATOL), (6, 2e-3, 5e-3)])
def test_streamed_cd_loop_matches_resident(rng, tmp_path, chunk_entities,
                                           coef_atol, score_atol):
    """``run_coordinate_descent`` with a fixed effect and a streamed
    random effect (retirement committed by the loop) against the
    all-resident loop: to 1e-5 at one chunk a bucket (the resident lane
    counts), within the compounded line-search resolution at a 6-entity
    grid."""
    from photon_ml_torch.data.batch import make_dense_batch
    from photon_ml_torch.game.coordinates import FixedEffectCoordinate
    from photon_ml_torch.optim.problem import OptimizationProblem

    a = _arrays(rng)
    ds = _dataset(a)
    xg = rng.normal(0, 1, (ds.n, 5)).astype(np.float32)
    fixed = FixedEffectCoordinate(
        name="fixed",
        batch=make_dense_batch(xg, ds.labels, weights=ds.weight_array(),
                               device=CPU),
        problem=OptimizationProblem(objective=_objective(1.0), config=CFG))

    def run(re_coord):
        return run_coordinate_descent({"fixed": fixed, "u": re_coord},
                                      ["fixed", "u"], 4)

    cd_r = run(build_random_effect_coordinate("u", ds, "re", _objective(),
                                              config=CFG, device=CPU))
    cd_s = run(_streamed(ds, tmp_path, chunk_entities))
    np.testing.assert_allclose(_np(cd_s.total_scores),
                               _np(cd_r.total_scores), atol=score_atol)
    np.testing.assert_allclose(_np(cd_s.coefficients["fixed"]),
                               _np(cd_r.coefficients["fixed"]),
                               atol=coef_atol)
    _assert_blocks_close(cd_r.coefficients["u"], cd_s.coefficients["u"],
                         atol=coef_atol)
    assert "entities_newly_retired" not in cd_s.history[0]["fixed"]
    assert cd_s.history[-1]["u"]["entities"] == \
        cd_s.history[0]["u"]["entities_solved"]


def test_score_external_blocks_and_zero_shortcut(rng, tmp_path):
    """Blocks the coordinate did not train stream one scoring pass that
    matches the resident score; zero blocks touch no chunk."""
    a = _arrays(rng)
    res = build_random_effect_coordinate("u", _dataset(a), "re",
                                         _objective(), config=CFG,
                                         device=CPU)
    st = _streamed(_dataset(a), tmp_path, 5)
    blocks = [torch.from_numpy(rng.normal(0, 0.2, (e, p))
                               .astype(np.float32))
              for e, p in st.coefficient_shapes]
    np.testing.assert_allclose(_np(st.score(blocks)),
                               _np(res.score(blocks)), atol=SCORE_ATOL)
    before = st.store.loads + st.store.hits
    assert not _np(st.score(st.initial_coefficients())).any()
    assert st.store.loads + st.store.hits == before


def test_external_warm_start_adopted(rng, tmp_path):
    """An external warm start (a model import) is adopted: a 3-iteration
    solve continues from it as the resident one does."""
    a = _arrays(rng)
    off = torch.from_numpy(rng.normal(0, 0.3, len(a["y"]))
                           .astype(np.float32))
    cfg = OptimizerConfig(max_iters=3, tolerance=1e-7)
    res = build_random_effect_coordinate("u", _dataset(a), "re",
                                         _objective(), config=cfg,
                                         device=CPU)
    st = _streamed(_dataset(a), tmp_path, 6, config=cfg)
    warm = [torch.from_numpy(rng.normal(0, 0.1, (e, p)).astype(np.float32))
            for e, p in st.coefficient_shapes]
    w_r, _ = res.train(off, [w.clone() for w in warm])
    w_s, _ = st.train(off, warm)
    _assert_blocks_close(w_r, w_s)


def _est_config(re_chunk, spill, **kw) -> TrainingConfig:
    return TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[
            CoordinateConfig(name="fixed", kind=CoordinateKind.FIXED_EFFECT,
                             feature_shard="g",
                             optimizer=OptimizerSettings(max_iters=25)),
            CoordinateConfig(name="per_u",
                             kind=CoordinateKind.RANDOM_EFFECT,
                             feature_shard="re", entity_key="u",
                             optimizer=OptimizerSettings(
                                 max_iters=25, variance_type="SIMPLE")),
        ],
        update_sequence=["fixed", "per_u"], n_iterations=2,
        evaluators=[EvaluatorType.AUC], re_chunk_entities=re_chunk,
        spill_dir=spill, device=CPU, **kw)


def test_estimator_streamed_fit_matches_resident(rng, tmp_path):
    """``GameEstimator`` with ``re_chunk_entities``: the model
    (coefficients and variances) and the held-out AUC of the resident
    fit, and a warm second fit that reuses the chunk files."""
    n = 400
    ds = GameDataset(
        labels=(rng.uniform(size=n) < 0.5).astype(np.float32),
        features={"g": rng.normal(0, 1, (n, 6)).astype(np.float32),
                  "re": rng.normal(0, 1, (n, 3)).astype(np.float32)},
        entity_ids={"u": _ids(rng, "skewed", n)})
    train, valid = ds.take(slice(0, 300)), ds.take(slice(300, n))
    r_r = GameEstimator(_est_config(None, None)).fit(train, valid)[0]
    est = GameEstimator(_est_config(5, str(tmp_path)))
    r_s = est.fit(train, valid)[0]
    m_r, m_s = r_r.model.models, r_s.model.models
    np.testing.assert_allclose(_np(m_s["fixed"].coefficients.means),
                               _np(m_r["fixed"].coefficients.means),
                               atol=COEF_ATOL)
    _assert_blocks_close(m_r["per_u"].coefficient_blocks,
                         m_s["per_u"].coefficient_blocks)
    _assert_blocks_close(m_r["per_u"].variance_blocks,
                         m_s["per_u"].variance_blocks)
    assert abs(r_s.evaluations[EvaluatorType.AUC]
               - r_r.evaluations[EvaluatorType.AUC]) <= AUC_ATOL
    files = glob.glob(str(tmp_path / "chunks" / "*.npz"))
    assert files
    mtimes = {f: os.path.getmtime(f) for f in files}
    GameEstimator(_est_config(5, str(tmp_path))).fit(train, valid)
    assert {f: os.path.getmtime(f) for f in files} == mtimes


def test_training_driver_streamed_random_effects(tmp_path):
    """``--re-chunk-entities`` with ``--spill-dir`` through the training
    driver: the model within 1e-5 of the resident run's, entity-chunk
    files in the spill dir, the per-sweep diagnostics in the run log."""
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.io.model_io import load_game_model
    from test_torch_drivers import config4

    def run(out, *args):
        cfg = config4(str(tmp_path / out))
        path = str(tmp_path / f"{out}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        game_training_driver.main(["--config", path, "--device", CPU,
                                   *args])
        return load_game_model(str(tmp_path / out / "model"))[0]

    spill = str(tmp_path / "spill")
    m_r = run("resident")
    m_s = run("streamed", "--re-chunk-entities", "8", "--spill-dir", spill,
              "--re-retirement", "on")
    assert glob.glob(os.path.join(spill, "chunks", "*.npz"))
    for name, comp in m_r.models.items():
        if hasattr(comp, "coefficient_blocks"):
            _assert_blocks_close(comp.coefficient_blocks,
                                 m_s.models[name].coefficient_blocks)
        else:
            np.testing.assert_allclose(
                _np(m_s.models[name].coefficients.means),
                _np(comp.coefficients.means), atol=COEF_ATOL)
    with open(tmp_path / "streamed" / "run_log.jsonl") as f:
        events = [json.loads(line) for line in f]
    re_events = [e for e in events if e.get("event") == "cd_coordinate"
                 and "entities_solved" in e]
    assert re_events and all("entities_newly_retired" in e
                             for e in re_events)


def test_config_validation_re_knobs(tmp_path, monkeypatch):
    """``re_chunk_entities``: positive, needs a spill dir (the
    environment's default honored), legal without chunk_rows, carried by
    the JSON form; ``re_retirement`` too."""
    def cfg(**kw):
        return TrainingConfig(
            task_type=TaskType.LOGISTIC_REGRESSION,
            coordinates=[CoordinateConfig(
                name="per_u", kind=CoordinateKind.RANDOM_EFFECT,
                feature_shard="re", entity_key="u")],
            update_sequence=["per_u"], device=CPU, **kw)

    monkeypatch.delenv("PHOTON_ML_TPU_SPILL_DIR", raising=False)
    with pytest.raises(ValueError, match="re_chunk_entities"):
        cfg(re_chunk_entities=0, spill_dir=str(tmp_path)).validate()
    with pytest.raises(ValueError, match="spill_dir"):
        cfg(re_chunk_entities=4).validate()
    monkeypatch.setenv("PHOTON_ML_TPU_SPILL_DIR", str(tmp_path))
    cfg(re_chunk_entities=4).validate()
    monkeypatch.delenv("PHOTON_ML_TPU_SPILL_DIR")
    c = cfg(re_chunk_entities=4, spill_dir=str(tmp_path),
            re_retirement=False)
    c.validate()
    c2 = training_config_from_json(config_to_json(c))
    assert c2.re_chunk_entities == 4 and c2.re_retirement is False
    # The mesh stays A7.
    with pytest.raises(NotImplementedError, match="A7"):
        build_streamed_random_effect_coordinate(
            "u", _dataset(_arrays(np.random.default_rng(0))), "re",
            _objective(), spill_dir=str(tmp_path), chunk_entities=4,
            mesh=object(), device=CPU)
