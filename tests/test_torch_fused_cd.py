"""Parity of the port's fused coordinate-descent cycle with the JAX
package.

Mirrors ``tests/test_fused_cd.py`` less its telemetry, compile-budget
and monitor cases (ROADMAP A8b, D3) and the mesh: one chunk's fused
statistics and the Jacobi steps against the JAX functions; the fused fit
against the per-coordinate fit over the reference's matrix of
coordinate mixes × chunk grids, and against the JAX package's fused fit
(coefficients and the per-cycle value and step-scale trajectory); scores
and the validation trajectory; retirement; spilled sidecars; the
training driver; checkpoint and resume with its refusals; shard probing;
the config; the shared host window.  The port runs on
``device="cpu"``.

Tolerances: a chunk's statistics within 1e-5·max of the JAX function's
(the port accumulates in float64, the JAX package in float32); the steps
1e-6; fused against per-coordinate fits, and the port's fused fit
against the JAX package's, the reference's ``PARITY_ATOL`` 5e-3 (the
fused path walks damped Jacobi Newton steps, the per-coordinate one full
inner solves, to the same block-stationary point); the first 10 cycles'
(value, alpha) 1e-5 relative (the safeguard's branch is taken alike at
this size); a resume 1e-5.
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
from photon_ml_torch.data.batch import SparseBatch
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game import fused_sweep
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.regularization import RegularizationType
from photon_ml_torch.utils.run_log import RunLogger, read_run_log
from test_torch_training import jax_c1  # noqa: F401  (the C1 fixture)

CPU = "cpu"
PARITY_ATOL = 5e-3
STEP_TOL, TRAJ_RTOL, RESUME_ATOL = 1e-6, 1e-5, 1e-5


def _arrays(rng, n=360, d=30, k=4, d_re=2, re_kind="dense") -> dict:
    """A sparse fixed-effect shard and, optionally, a dense or sparse
    (projected) random-effect shard; labels from both."""
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    w_true = rng.normal(0, 1, d)
    ids = np.concatenate([rng.integers(0, 20, (2 * n) // 3),
                          rng.integers(100, 104, n - (2 * n) // 3)])
    b_true = rng.normal(0, 0.7, 200)
    m = np.einsum("nk,nk->n", vals, w_true[cols]) + b_true[ids % 200]
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    a = {"rows": [(cols[i], vals[i]) for i in range(n)], "y": y, "d": d,
         "ids": ids, "re_kind": re_kind}
    if re_kind == "dense":
        a["re"] = rng.normal(0, 1, (n, d_re)).astype(np.float32)
    elif re_kind == "sparse":
        re_rows = []
        for _ in range(n):
            kk = rng.integers(1, 4)
            rc = rng.choice(10, size=kk, replace=False).astype(np.int32)
            re_rows.append((rc, rng.normal(0, 1, kk).astype(np.float32)))
        a["re"] = re_rows
    return a


def _dataset(a: dict, pkg: str = "torch"):
    if pkg == "jax":
        from photon_ml_tpu.game.dataset import GameDataset as D
    else:
        D = GameDataset
    features, dims = {"f": a["rows"]}, {"f": a["d"]}
    if a["re_kind"] != "none":
        features["re"] = a["re"]
        if a["re_kind"] == "sparse":
            dims["re"] = 10
    return D(labels=a["y"], features=features,
             entity_ids={} if a["re_kind"] == "none" else {"u": a["ids"]},
             feature_dims=dims)


def _workload(rng, **kw):
    return _dataset(_arrays(rng, **kw))


def _cfg_dict(fused, iters, re=True, chunk_rows=96, tolerance=1e-6,
              **kw) -> dict:
    coords = [{"name": "global", "kind": "FIXED_EFFECT", "feature_shard": "f",
               "optimizer": {"max_iters": 60, "reg_weight": 1.0,
                             "tolerance": tolerance}}]
    seq = ["global"]
    if re:
        coords.append({"name": "per_u", "kind": "RANDOM_EFFECT",
                       "feature_shard": "re", "entity_key": "u",
                       "optimizer": {"max_iters": 40, "reg_weight": 2.0,
                                     "tolerance": tolerance}})
        seq.append("per_u")
    cfg = {"task_type": "LOGISTIC_REGRESSION", "coordinates": coords,
           "update_sequence": seq, "n_iterations": iters,
           "intercept": False, "chunk_rows": chunk_rows,
           "chunk_layout": "ELL", "cd_fused": fused,
           "validation_fraction": 0.0, "validate_per_iteration": False}
    cfg.update(kw)
    return cfg


def _cfg(fused, iters, **kw) -> TrainingConfig:
    cfg = training_config_from_json(json.dumps(
        {**_cfg_dict(fused, iters, **kw), "device": CPU}))
    cfg.validate()
    return cfg


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fe(models):
    return _np(models["global"].coefficients.means)


def _assert_model_parity(m_a, m_b, atol=PARITY_ATOL):
    np.testing.assert_allclose(_fe(m_a), _fe(m_b), atol=atol, rtol=0)
    if "per_u" in m_a:
        for ba, bb in zip(m_a["per_u"].coefficient_blocks,
                          m_b["per_u"].coefficient_blocks):
            np.testing.assert_allclose(_np(ba), _np(bb), atol=atol, rtol=0)


def _fit(cfg, ds, valid=None, log_path=None):
    if log_path is None:
        return GameEstimator(cfg).fit(ds, valid)[0]
    with RunLogger(log_path) as log:
        return GameEstimator(cfg).fit(ds, valid, run_logger=log)[0]


def _cycles(log_path) -> list:
    return [e for e in read_run_log(log_path)
            if e.get("event") == "cd_fused_cycle"]


# -- the per-chunk program and the steps against the JAX functions -----------


def _chunk_inputs(rng, R=64, d=40, k=5, p=3, E=9):
    cols = rng.integers(0, d, (R, k)).astype(np.int32)
    vals = rng.normal(0, 1, (R, k)).astype(np.float32)
    vals[-5:] = 0.0                      # padding rows
    labels = (rng.uniform(size=R) < 0.5).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, R).astype(np.float32)
    mask = np.ones(R, np.float32)
    mask[-5:] = 0.0
    idx = rng.integers(0, E, R).astype(np.int32)
    idx[-5:] = E                         # the dump row
    act = np.ones(E + 1, np.float32)
    act[[2, E]] = 0.0                    # a retired entity, the dump row
    tab = rng.normal(0, 0.3, (E + 1, p)).astype(np.float32)
    tab[E] = 0.0
    return {"cols": cols, "vals": vals, "labels": labels,
            "weights": weights, "mask": mask, "idx": idx, "act": act,
            "tab": tab, "x": rng.normal(0, 1, (R, p)).astype(np.float32),
            "w": rng.normal(0, 0.2, d).astype(np.float32), "d": d}


def test_fused_chunk_statistics_match_jax(jax_c1, rng):
    """One chunk's value, fixed-effect gradient and Hessian diagonal,
    per-entity g and G and both score planes against the JAX
    ``_fused_chunk``, within 1e-5 of each statistic's largest entry."""
    from photon_ml_tpu.data.batch import SparseBatch as JB
    from photon_ml_tpu.game.fused_sweep import _fused_chunk as jfused
    from photon_ml_tpu.ops import losses as jl

    jnp = jax_c1.numpy
    c = _chunk_inputs(rng)
    R = len(c["labels"])
    tb = SparseBatch(values=torch.from_numpy(c["vals"]),
                     col_ids=torch.from_numpy(c["cols"]),
                     labels=torch.from_numpy(c["labels"]),
                     weights=torch.from_numpy(c["weights"]),
                     offsets=torch.zeros(R), mask=torch.from_numpy(c["mask"]),
                     dim=c["d"])
    E1, p = c["tab"].shape
    acc = fused_sweep._zero_stats(c["d"], [(E1, p)], "cpu")
    fe_s, re_s = fused_sweep._fused_chunk(
        losses.LOGISTIC, torch.from_numpy(c["w"]),
        [torch.from_numpy(c["tab"])], [torch.from_numpy(c["act"])], tb,
        [torch.from_numpy(c["x"])], [torch.from_numpy(c["idx"])], acc)
    jb = JB(values=jnp.asarray(c["vals"]), col_ids=jnp.asarray(c["cols"]),
            labels=jnp.asarray(c["labels"]),
            weights=jnp.asarray(c["weights"]),
            offsets=jnp.zeros(R, jnp.float32),
            mask=jnp.asarray(c["mask"]), dim=c["d"])
    out = jfused(jl.LOGISTIC, jnp.asarray(c["w"]),
                 (jnp.asarray(c["tab"]),), (jnp.asarray(c["act"]),), jb,
                 (jnp.asarray(c["x"]),), (jnp.asarray(c["idx"]),))
    got = [acc[0], acc[1], acc[2], acc[3][0], acc[4][0], fe_s, re_s[0]]
    want = [out[0], out[1], out[2], out[3][0], out[4][0], out[5], out[6][0]]
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(_np(g).astype(np.float64), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
    # A gated entity and the dump row accumulate nothing.
    assert not _np(acc[4][0])[[2, E1 - 1]].any()


def test_re_and_fe_steps_match_jax(jax_c1, rng):
    """``_re_step`` (the table and the undamped movement) and
    ``_fe_step`` against the JAX functions at a damped alpha."""
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.game.fused_sweep import _fe_step as jfe
    from photon_ml_tpu.game.fused_sweep import _re_step as jre
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    from photon_ml_torch.data.normalization import NormalizationContext
    from photon_ml_torch.ops.objective import GLMObjective
    from photon_ml_torch.ops.regularization import RegularizationContext

    jnp = jax_c1.numpy
    E1, p, d = 7, 3, 12
    tab = rng.normal(0, 0.3, (E1, p)).astype(np.float32)
    tab[-1] = 0.0
    g = rng.normal(0, 1, (E1, p))
    A = rng.normal(0, 1, (E1, p, p))
    G = np.einsum("eij,ekj->eik", A, A)
    act = np.ones(E1, np.float32)
    act[[1, E1 - 1]] = 0.0
    t_tab, t_move = fused_sweep._re_step(
        torch.from_numpy(tab), torch.from_numpy(g), torch.from_numpy(G),
        torch.from_numpy(act), 2.0, 0.5)
    j_tab, j_move = jre(jnp.asarray(tab), jnp.asarray(g, jnp.float32),
                        jnp.asarray(G, jnp.float32), jnp.asarray(act), 2.0,
                        0.5)
    np.testing.assert_allclose(_np(t_tab), np.asarray(j_tab), rtol=STEP_TOL,
                               atol=STEP_TOL)
    np.testing.assert_allclose(_np(t_move), np.asarray(j_move),
                               rtol=STEP_TOL, atol=STEP_TOL)
    assert not _np(t_tab)[-1].any()

    w = rng.normal(0, 0.5, d).astype(np.float32)
    gf = rng.normal(0, 1, d)
    hf = rng.uniform(0.0, 2.0, d)
    mask = np.ones(d, np.float32)
    mask[-1] = 0.0
    tobj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(
        1.5, torch.from_numpy(mask)), NormalizationContext.identity())
    jobj = JO(jl.LOGISTIC, JR.l2(1.5, jnp.asarray(mask)), JN.identity())
    t_out = fused_sweep._fe_step(tobj, torch.from_numpy(w),
                                 torch.from_numpy(gf), torch.from_numpy(hf),
                                 0.25)
    j_out = jfe(jobj, jnp.asarray(w), jnp.asarray(gf, jnp.float32),
                jnp.asarray(hf, jnp.float32), 0.25)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=STEP_TOL,
                                   atol=STEP_TOL)


def test_re_step_retirement_movement_is_undamped():
    """The movement plane is the full Newton step's norm: at alpha 1/64
    a moving entity does not read as converged, while the applied step
    is damped."""
    tab = torch.zeros((3, 2))
    g = torch.full((3, 2), 0.1)
    G = torch.eye(2).repeat(3, 1, 1)
    active = torch.ones(3)
    _, move_full = fused_sweep._re_step(tab, g, G, active, 0.0, 1.0)
    tab_d, move_damped = fused_sweep._re_step(tab, g, G, active, 0.0,
                                              1.0 / 64)
    np.testing.assert_allclose(_np(move_damped), _np(move_full), rtol=1e-6)
    assert float(tab_d.abs().max()) < float(move_full[0])


# -- fused against per-coordinate, and against the JAX package ----------------


@pytest.mark.parametrize("re_kind,chunk_rows", [
    ("none", 96), ("dense", 96), ("dense", 64), ("sparse", 96)])
def test_fused_matches_percoord(rng, re_kind, chunk_rows):
    """The reference's parity matrix: 80 fused cycles against 3
    per-coordinate sweeps, fixed-only, with a dense and with a sparse
    (projected) random effect, on two chunk grids."""
    ds = _workload(rng, re_kind=re_kind)
    re = re_kind != "none"
    m_l = _fit(_cfg(False, 3, re=re, chunk_rows=chunk_rows), ds).model.models
    m_f = _fit(_cfg(True, 80, re=re, chunk_rows=chunk_rows), ds).model.models
    _assert_model_parity(m_l, m_f)


def test_fused_matches_jax_fused(jax_c1, rng, tmp_path):
    """The port's fused fit against the JAX package's on the same data:
    coefficients within 5e-3, and the first 10 cycles' joint value and
    step scale within 1e-5 relative."""
    from photon_ml_tpu.config import training_config_from_json as jcfg
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JE
    from photon_ml_tpu.utils.run_log import RunLogger as JLog

    a = _arrays(rng)
    cfg = _cfg_dict(True, 40)
    jlog = str(tmp_path / "jax.jsonl")
    with JLog(jlog) as log:
        jres = JE(jcfg(json.dumps(cfg))).fit(_dataset(a, "jax"),
                                             run_logger=log)[0]
    tlog = str(tmp_path / "torch.jsonl")
    tres = _fit(_cfg(True, 40), _dataset(a), log_path=tlog)
    _assert_model_parity(jres.model.models, tres.model.models)
    jc = [e for e in read_run_log(jlog) if e.get("event") == "cd_fused_cycle"]
    tc = _cycles(tlog)
    assert len(jc) == len(tc) == 40
    for j, t in zip(jc[:10], tc[:10]):
        assert t["value"] == pytest.approx(j["value"], rel=TRAJ_RTOL)
        assert t["alpha"] == pytest.approx(j["alpha"], rel=TRAJ_RTOL)


def test_fused_scores_match_percoord(rng):
    """The two fits' models score the training data alike."""
    ds = _workload(rng)
    r_l = _fit(_cfg(False, 4), ds)
    r_f = _fit(_cfg(True, 80), ds)
    s_l = GameTransformer(model=r_l.model, task=TaskType.LOGISTIC_REGRESSION,
                          device=CPU).transform(ds)
    s_f = GameTransformer(model=r_f.model, task=TaskType.LOGISTIC_REGRESSION,
                          device=CPU).transform(ds)
    np.testing.assert_allclose(_np(s_f), _np(s_l), atol=1e-2, rtol=0)


def test_fused_validation_trajectory(rng):
    """Per-cycle validation rides the fused loop: one entry a cycle, the
    end metric close to the per-coordinate fit's, no worse than the
    first cycle's."""
    ds = _workload(rng, n=420)
    val = _workload(np.random.default_rng(7), n=200)
    kw = dict(validate_per_iteration=True, evaluators=["AUC"])
    r_l = _fit(_cfg(False, 3, **kw), ds, val)
    r_f = _fit(_cfg(True, 60, **kw), ds, val)
    assert len(r_f.validation_history) == 60
    auc_l = r_l.evaluations[EvaluatorType.AUC]
    auc_f = r_f.evaluations[EvaluatorType.AUC]
    assert abs(auc_l - auc_f) < 0.02
    assert auc_f >= r_f.validation_history[0][EvaluatorType.AUC] - 1e-6


def test_fused_retirement_equivalent_and_active(rng, tmp_path):
    """Retirement gates per-entity accumulation without moving the model
    beyond tolerance, and retires entities on a converging fit."""
    ds = _workload(rng)

    def run(retirement, tag):
        path = str(tmp_path / f"log_{tag}.jsonl")
        r = _fit(_cfg(True, 80, tolerance=1e-4, re_retirement=retirement),
                 ds, log_path=path)
        return r, _cycles(path)

    r_on, cyc_on = run(True, "on")
    r_off, cyc_off = run(False, "off")
    _assert_model_parity(r_on.model.models, r_off.model.models, atol=1e-2)
    assert max(e["entities_retired"] for e in cyc_on) > 0
    assert all(e["entities_retired"] == 0 for e in cyc_off)


def test_fused_spilled_matches_resident_sidecars(rng, tmp_path):
    """Sidecars spilled through the chunk store give the resident
    sidecars' model, share one host window with the fixed effect's
    chunks, load once a chunk a pass, and a second fit reuses them."""
    ds = _workload(rng)
    m_res = _fit(_cfg(True, 40), ds).model.models
    cfg = _cfg(True, 40, spill_dir=str(tmp_path), host_max_resident=2)
    est = GameEstimator(cfg)
    m_sp = est.fit(ds)[0].model.models
    _assert_model_parity(m_res, m_sp, atol=1e-6)
    group = est._chunk_window_group
    assert group is not None and group.budget == 2
    assert group.n_resident <= 2
    files = glob.glob(str(tmp_path / "chunks" / "*.npz"))
    assert files
    mtimes = {f: os.path.getmtime(f) for f in files}
    m_sp2 = GameEstimator(cfg).fit(ds)[0].model.models
    _assert_model_parity(m_sp, m_sp2, atol=0)
    assert {f: os.path.getmtime(f) for f in files} == mtimes


def test_fused_engine_one_pass_a_cycle(rng, tmp_path):
    """A cycle is one pass: every fixed-effect chunk and every sidecar
    is read once; a fit of N cycles is N + 1 passes (the last brings the
    scores to the final coefficients)."""
    from photon_ml_torch.game.coordinate_descent import run_coordinate_descent

    ds = _workload(rng)
    cfg = _cfg(True, 5, spill_dir=str(tmp_path))
    est = GameEstimator(cfg)
    prep = est._prepare(ds)
    coords = est._build_coordinates(ds, prep, {})
    engine = est._fused_engine(ds, coords)
    stores = [engine.chunked.store, engine.sidecar_store]
    before = [s.loads + s.hits for s in stores]
    run_coordinate_descent(coords, cfg.update_sequence, 5,
                           fused_engine=engine)
    K = engine.chunked.n_chunks
    assert [s.loads + s.hits - b for s, b in zip(stores, before)] == \
        [6 * K] * 2
    for s in stores:
        s.assert_quiesced()


def test_training_driver_cd_fused_e2e(tmp_path):
    """``--cd-fused on --device cpu`` through the training driver: the
    run log holds one ``cd_fused_cycle`` event a cycle and the model is
    the fused estimator's."""
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.io.libsvm import write_libsvm
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_tpu.utils.synthetic import make_a1a_like

    rows, labels, _ = make_a1a_like(n=600, seed=5)
    train_path = str(tmp_path / "a1a.libsvm")
    write_libsvm(train_path, rows, np.where(labels > 0, 1, -1))
    config = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{
            "name": "global", "kind": "FIXED_EFFECT",
            "feature_shard": "features",
            "optimizer": {"optimizer": "LBFGS", "reg_weight": 1.0,
                          "max_iters": 60}}],
        "update_sequence": ["global"], "n_iterations": 20,
        "input_path": train_path, "output_dir": str(tmp_path / "out"),
        "chunk_rows": 200, "chunk_layout": "ELL", "intercept": False,
        "validation_fraction": 0.0,
    }
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    summary = game_training_driver.main(["--config", cfg_path, "--cd-fused",
                                         "on", "--device", CPU])
    assert summary["best_index"] == 0
    cycles = _cycles(str(tmp_path / "out" / "run_log.jsonl"))
    assert [e["iteration"] for e in cycles] == list(range(1, 21))
    model, _ = load_game_model(str(tmp_path / "out" / "model"))
    with open(tmp_path / "out" / "config.json") as f:
        assert json.load(f)["cd_fused"] is True
    assert np.isfinite(_np(model.models["global"].coefficients.means)).all()


# -- checkpoints -------------------------------------------------------------


def test_fused_checkpoint_resume_parity(rng, tmp_path):
    """3 checkpointed cycles, then a resume to 8, land where the
    uninterrupted 8-cycle run lands (the engine's step scale, last value
    and retirement state ride ``re_state["__cd_fused__"]``)."""
    ds = _workload(rng)
    full = _fit(_cfg(True, 8, tolerance=1e-4), ds).model.models
    ck = str(tmp_path / "ckpt")
    _fit(_cfg(True, 3, tolerance=1e-4, checkpoint_dir=ck), ds)
    resumed = _fit(_cfg(True, 8, tolerance=1e-4, checkpoint_dir=ck,
                        resume=True), ds).model.models
    _assert_model_parity(full, resumed, atol=RESUME_ATOL)


def test_fused_checkpoint_refuses_cross_mode_resume(rng, tmp_path):
    """A fused snapshot resumed per coordinate is refused, and so is a
    per-coordinate snapshot resumed fused."""
    ds = _workload(rng)
    ck = str(tmp_path / "ckpt")
    _fit(_cfg(True, 3, checkpoint_dir=ck), ds)
    with pytest.raises(ValueError, match="fused"):
        _fit(_cfg(False, 6, checkpoint_dir=ck, resume=True), ds)
    ck2 = str(tmp_path / "ckpt2")
    _fit(_cfg(False, 2, checkpoint_dir=ck2), ds)
    with pytest.raises(ValueError, match="per-coordinate"):
        _fit(_cfg(True, 40, checkpoint_dir=ck2, resume=True), ds)


@pytest.mark.parametrize("edit", ["reg_weight", "retirement"])
def test_fused_resume_rejects_config_edit(rng, tmp_path, edit):
    """The engine's snapshot carries a fingerprint of its configuration:
    a regularization edit, or a retirement flip, refuses the stale
    state."""
    ds = _workload(rng)
    ck = str(tmp_path / "ckpt")
    _fit(_cfg(True, 3, tolerance=1e-4, checkpoint_dir=ck,
              re_retirement=True), ds)
    edited = _cfg(True, 6, tolerance=1e-4, checkpoint_dir=ck, resume=True,
                  re_retirement=(edit != "retirement"))
    if edit == "reg_weight":
        edited.coordinates[1].optimizer.reg_weight = 50.0
    with pytest.raises(ValueError, match="different configuration"):
        GameEstimator(edited).fit(ds)


# -- shard probing, the config, the shared window ------------------------------


def test_find_shard_ambiguity_is_an_error():
    """Shard probing refuses to guess between two sparse shards of one
    length (the first could be the fixed effect's)."""
    n = 40
    rows_a = [(np.array([0], np.int32), np.ones(1, np.float32))] * n
    rows_b = [(np.array([1], np.int32), np.ones(1, np.float32))] * n
    ds = GameDataset(labels=np.zeros(n, np.float32),
                     features={"fe": rows_a, "re": rows_b},
                     entity_ids={"u": np.zeros(n, np.int64)},
                     feature_dims={"fe": 4, "re": 4})

    class _Coord:
        name = "per_u"

        class grouping:
            n_examples = n

    with pytest.raises(ValueError, match="ambiguous"):
        fused_sweep._find_shard(ds, _Coord, sparse=True)


def test_cd_fused_config_validation():
    base = dict(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[CoordinateConfig(
            name="g", kind=CoordinateKind.FIXED_EFFECT, feature_shard="f",
            optimizer=OptimizerSettings())],
        update_sequence=["g"], device=CPU)
    with pytest.raises(ValueError, match="chunk_rows"):
        TrainingConfig(cd_fused=True, **base).validate()
    with pytest.raises(ValueError, match="locked"):
        TrainingConfig(cd_fused=True, chunk_rows=100,
                       locked_coordinates=["g"],
                       warm_start_model_dir="/tmp/m", **base).validate()
    with pytest.raises(ValueError, match="single-device"):
        TrainingConfig(cd_fused=True, chunk_rows=100, n_devices=2,
                       **base).validate()
    two_fe = dict(base)
    two_fe["coordinates"] = base["coordinates"] + [CoordinateConfig(
        name="g2", kind=CoordinateKind.FIXED_EFFECT, feature_shard="f2",
        optimizer=OptimizerSettings())]
    two_fe["update_sequence"] = ["g", "g2"]
    with pytest.raises(ValueError, match="exactly one fixed-effect"):
        TrainingConfig(cd_fused=True, chunk_rows=100, **two_fe).validate()
    l1 = dict(base)
    l1["coordinates"] = [CoordinateConfig(
        name="g", kind=CoordinateKind.FIXED_EFFECT, feature_shard="f",
        optimizer=OptimizerSettings(regularization=RegularizationType.L1))]
    with pytest.raises(ValueError, match="smooth regularization"):
        TrainingConfig(cd_fused=True, chunk_rows=100, **l1).validate()
    cfg = TrainingConfig(cd_fused=True, chunk_rows=100, **base)
    cfg.validate()
    assert training_config_from_json(config_to_json(cfg)).cd_fused is True


def test_shared_chunk_window_bounds_total_residency(tmp_path):
    """The group's budget bounds the sum of resident chunks over its
    stores; eviction takes the least recently used chunk of any store."""
    from photon_ml_torch.data.chunk_store import (
        ChunkStore,
        SharedChunkWindow,
        decode_array_chunk,
        encode_array_chunk,
    )

    group = SharedChunkWindow(2)
    stores = [ChunkStore(str(tmp_path), f"k{j}", 4, host_max_resident=4,
                         codec=(encode_array_chunk, decode_array_chunk),
                         window_group=group)
              for j in range(2)]
    for j, store in enumerate(stores):
        for i in range(4):
            store.put(i, {"a": np.full(8, 10 * j + i, np.float32)},
                      keep_resident=False)
    for i in range(4):
        for store in stores:
            store.get(i)
            assert sum(s.n_resident for s in stores) <= 2
    assert group.evictions > 0
    stores[0].get(3)
    stores[1].get(0)
    stores[0].get(3)                      # touched: the most recent
    stores[1].get(1)                      # evicts (s1, 0), not (s0, 3)
    assert 3 in stores[0]._resident
    stores[0].drop_resident()
    assert stores[0].n_resident == 0
    assert group.n_resident == sum(s.n_resident for s in stores)


def test_estimator_shares_window_across_coordinates(rng, tmp_path):
    """A spilled chunked fixed effect and a streamed random effect share
    one ``host_max_resident`` budget in the per-coordinate descent."""
    ds = _workload(rng)
    est = GameEstimator(_cfg(False, 2, spill_dir=str(tmp_path),
                             host_max_resident=2, re_chunk_entities=6))
    est.fit(ds)
    group = est._chunk_window_group
    assert group is not None and group.budget == 2
    assert group.n_resident <= 2


def _overshooting() -> dict:
    """Rows of 30 fixed-effect non-zeros with an intercept, and a random
    effect with its own: the Jacobi steps of all coordinates at once
    overshoot."""
    rng = np.random.default_rng(3)
    n, d, k = 2000, 300, 30
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    return {"rows": [(cols[i],
                      np.abs(rng.normal(1, 0.3, k)).astype(np.float32))
                     for i in range(n)],
            "y": (rng.uniform(size=n) < 0.3).astype(np.float32), "d": d,
            "ids": rng.integers(0, 50, n), "re_kind": "dense",
            "re": np.stack([np.ones(n), rng.normal(size=n)], 1)
            .astype(np.float32)}


def test_fused_safeguard_rejects_a_rising_step(jax_c1, tmp_path):
    """On ``_overshooting`` data the JAX package halves the step scale
    and steps on from the worse point, and its joint objective runs
    away; the port rejects the step (a rejected cycle) and steps again
    from the last accepted point with half the scale, so its accepted
    values never rise.  The two agree until the first rise."""
    from photon_ml_tpu.config import training_config_from_json as jcfg
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JE

    a = _overshooting()
    cfg = _cfg_dict(True, 12, intercept=True)
    jlog, tlog = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    from photon_ml_tpu.utils.run_log import RunLogger as JLog

    with JLog(jlog) as log:
        JE(jcfg(json.dumps(cfg))).fit(_dataset(a, "jax"), run_logger=log)
    _fit(_cfg(True, 12, intercept=True), _dataset(a), log_path=tlog)
    jv = [e["value"] for e in read_run_log(jlog)
          if e.get("event") == "cd_fused_cycle"]
    cyc = _cycles(tlog)
    hist = [e["value"] for e in cyc]
    assert hist[0] == pytest.approx(jv[0], rel=TRAJ_RTOL)
    assert max(jv) > 100 * jv[0]              # the JAX package runs away
    assert any(e["rejected"] for e in cyc)
    # A rejected cycle's value rose above the last accepted one and
    # halved the step scale; the next cycle evaluates the shorter step
    # (a new point, not the accepted one again).
    last = None
    for i, e in enumerate(cyc):
        if e["rejected"]:
            assert e["value"] > last["value"]
            assert e["alpha"] == pytest.approx(cyc[i - 1]["alpha"] / 2,
                                               abs=1e-6)   # logged to 6 places
            if i + 1 < len(cyc):
                assert cyc[i + 1]["value"] != last["value"]
        else:
            assert last is None or e["value"] <= last["value"]
            last = e
    assert hist[-1] < hist[0]
    assert max(hist) < 100 * hist[0]


def test_fused_final_model_is_the_last_accepted_point(tmp_path):
    """When the last cycle's step rises, the fit returns that cycle's
    input (the last accepted point), so the returned model is the run of
    one cycle fewer and its joint value never lies above the last
    accepted value."""
    a = _overshooting()
    log = str(tmp_path / "cycles.jsonl")
    _fit(_cfg(True, 12, intercept=True), _dataset(a), log_path=log)
    cyc = _cycles(log)
    # Cycle n + 1 rejects the step of cycle n, itself accepted.
    n = next(i for i, e in enumerate(cyc)
             if i >= 2 and e["rejected"] and not cyc[i - 1]["rejected"])
    shorter = _fit(_cfg(True, n - 1, intercept=True), _dataset(a))
    ended = _fit(_cfg(True, n, intercept=True), _dataset(a))
    _assert_model_parity(shorter.model.models, ended.model.models, atol=0.0)


def test_fused_resume_across_a_rejection(tmp_path):
    """A snapshot taken just before a rejected cycle carries the accepted
    point's statistics: the resumed run rejects and steps from them as
    the uninterrupted one does, to the last bit."""
    a = _overshooting()
    log = str(tmp_path / "cycles.jsonl")
    full = _fit(_cfg(True, 12, intercept=True), _dataset(a), log_path=log)
    first = next(i for i, e in enumerate(_cycles(log)) if e["rejected"])
    ck = str(tmp_path / "ckpt")
    _fit(_cfg(True, first, intercept=True, checkpoint_dir=ck), _dataset(a))
    resumed = _fit(_cfg(True, 12, intercept=True, checkpoint_dir=ck,
                        resume=True), _dataset(a))
    _assert_model_parity(full.model.models, resumed.model.models, atol=0.0)
