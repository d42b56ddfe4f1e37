"""Parity of the port's GAME training path with the JAX package.

Grouping, block scatter/gather, subspace projection and down-sampling
(host numpy, so identical); random-effect coordinates (lane-batched
solves) and ``GameEstimator`` fits at the ``tests/test_game.py`` and
``tests/test_estimator.py`` shapes: the config-5 shape (a sparse fixed
effect plus per-user and per-item random effects), a locked coordinate,
down-sampling, standardization, TRON coordinates, variances, a sparse
(projected) random effect against a dense one, the transposed-ELL
layout and the per-sweep validation history.  The port runs on
``device="cpu"``.  Tolerances: scores of one model within 1e-4 in both
packages; trained coefficients within 1e-3 (absolute, or relative for
coefficients past 1 in magnitude); AUC within 1e-3.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_ml_torch.config import training_config_from_json
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game import dataset as tds
from photon_ml_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_torch.game.coordinates import (
    build_random_effect_coordinate,
    build_random_effect_coordinate_sparse,
)
from photon_ml_torch.game.projector import build_subspace_projection
from photon_ml_torch.game.sampling import binary_classification_down_sample
from photon_ml_torch.io.model_io import load_game_model, save_game_model
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"
COEF_ATOL, SCORE_ATOL, AUC_ATOL = 1e-3, 1e-4, 1e-3


def _movielens(n_users=80, n_items=40, n_obs=3000, seed=41):
    from photon_ml_tpu.utils.synthetic import make_movielens_like

    return make_movielens_like(n_users=n_users, n_items=n_items, n_obs=n_obs,
                               seed=seed)


def _datasets(data, n_train, pkg, sparse_global=True):
    """(train, valid) GameDatasets of the config-5 shape for ``pkg``
    ("jax" or "torch"): global features as sparse rows (or dense), a
    per-user [1, x0] shard, a per-item intercept shard."""
    if pkg == "jax":
        from photon_ml_tpu.data.sparse_rows import SparseRows as Rows
        from photon_ml_tpu.game.dataset import GameDataset
    else:
        Rows, GameDataset = SparseRows, tds.GameDataset
    x = data["x"].astype(np.float32)
    n, d = x.shape
    user = np.stack([np.ones(n, np.float32), x[:, 0]], 1)
    item = np.ones((n, 1), np.float32)

    def part(sl):
        xs = x[sl]
        glob = (Rows.from_flat(np.arange(len(xs) + 1) * d,
                               np.tile(np.arange(d), len(xs)),
                               xs.reshape(-1))
                if sparse_global else xs)
        return GameDataset(
            labels=data["labels"][sl].astype(np.float32),
            features={"global": glob, "user_re": user[sl],
                      "item_re": item[sl]},
            entity_ids={"userId": data["user_ids"][sl],
                        "itemId": data["item_ids"][sl]},
            feature_dims={"global": d})
    return part(slice(0, n_train)), part(slice(n_train, n))


def _config(**over) -> dict:
    cfg = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [
            {"name": "global", "kind": "FIXED_EFFECT",
             "feature_shard": "global",
             "optimizer": {"reg_weight": 1.0, "max_iters": 100}},
            {"name": "per_user", "kind": "RANDOM_EFFECT",
             "feature_shard": "user_re", "entity_key": "userId",
             "optimizer": {"reg_weight": 2.0, "max_iters": 50}},
            {"name": "per_item", "kind": "RANDOM_EFFECT",
             "feature_shard": "item_re", "entity_key": "itemId",
             "optimizer": {"reg_weight": 2.0, "max_iters": 50}},
        ],
        "update_sequence": ["global", "per_user", "per_item"],
        "n_iterations": 2,
        "evaluators": ["AUC", "LOGISTIC_LOSS"],
    }
    cfg.update(over)
    return cfg


def _fit_both(cfg: dict, data, n_train, sparse_global=True):
    """The same config and data through both estimators →
    (jax result, port result, jax valid, port valid)."""
    from photon_ml_tpu.config import training_config_from_json as jcfg
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JE

    jtr, jva = _datasets(data, n_train, "jax", sparse_global)
    ttr, tva = _datasets(data, n_train, "torch", sparse_global)
    jres = JE(jcfg(json.dumps(cfg))).fit(jtr, jva)
    tcfg = training_config_from_json(json.dumps({**cfg, "device": CPU}))
    tres = GameEstimator(tcfg).fit(ttr, tva)
    assert len(jres) == len(tres)
    return jres, tres, jva, tva


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_models_close(jmodel, tmodel):
    for name, jc in jmodel.models.items():
        tc = tmodel.models[name]
        if hasattr(jc, "coefficient_blocks"):
            assert len(jc.coefficient_blocks) == len(tc.coefficient_blocks)
            for jb, tb in zip(jc.coefficient_blocks, tc.coefficient_blocks):
                np.testing.assert_allclose(_np(tb), _np(jb), atol=COEF_ATOL,
                                           rtol=COEF_ATOL, err_msg=name)
            np.testing.assert_array_equal(tc.grouping.entity_ids,
                                          jc.grouping.entity_ids)
        else:
            np.testing.assert_allclose(_np(tc.coefficients.means),
                                       _np(jc.coefficients.means),
                                       atol=COEF_ATOL, rtol=COEF_ATOL,
                                       err_msg=name)


def _assert_evals_close(jr, tr):
    for ev, v in jr.evaluations.items():
        got = tr.evaluations[EvaluatorType(ev.value)]
        tol = AUC_ATOL if ev.value == "AUC" else 1e-3 * max(1.0, abs(v))
        assert abs(got - v) <= tol, (ev, got, v)


# -- host ETL: identical ---------------------------------------------------------


@pytest.mark.parametrize("base,minc", [(4, 4), (2, 1), (8, 16)])
def test_group_by_entity_identical(base, minc):
    from photon_ml_tpu.game.dataset import group_by_entity as jgroup

    rng = np.random.default_rng(0)
    sizes = np.maximum(1, (300 / np.arange(1, 61) ** 1.2)).astype(int)
    ids = rng.permutation(np.repeat(rng.choice(10**6, 60, replace=False),
                                    sizes))
    ref, got = jgroup(ids, base, minc), tds.group_by_entity(ids, base, minc)
    for f in ("entity_ids", "entity_counts", "entity_bucket", "entity_slot",
              "example_bucket", "example_row", "example_col",
              "example_entity"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    assert got.capacities == ref.capacities
    assert got.n_entities == ref.n_entities
    np.testing.assert_array_equal(got.entity_row_map(), ref.entity_row_map())
    from photon_ml_tpu.game.dataset import bucket_occupancy as jocc

    assert tds.bucket_occupancy(got) == jocc(ref)


def test_scatter_gather_round_trip_identical():
    from photon_ml_tpu.game.dataset import group_by_entity as jgroup
    from photon_ml_tpu.game.dataset import scatter_to_blocks as jscatter

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 30, 500)
    vals = rng.normal(0, 1, (500, 2)).astype(np.float32)
    g = tds.group_by_entity(ids)
    blocks = tds.scatter_to_blocks(g, vals, fill=-1.0)
    for a, b in zip(blocks, jscatter(jgroup(ids), vals, fill=-1.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.gather_from_blocks(g, blocks), vals)


def test_dataset_take_and_widths():
    rng = np.random.default_rng(2)
    rows = [(np.sort(rng.choice(50, 3, replace=False)), rng.normal(size=3))
            for _ in range(10)]
    ds = tds.GameDataset(labels=np.arange(10.0),
                         features={"s": rows, "d": np.ones((10, 2))},
                         entity_ids={"u": np.arange(10)},
                         feature_dims={"s": 50})
    assert isinstance(ds.features["s"], SparseRows)
    sub = ds.take(np.arange(3, 7))                   # contiguous: views
    assert sub.n == 4 and np.shares_memory(sub.labels, ds.labels)
    assert sub.feature_dim("s") == 50 and sub.feature_dim("d") == 2
    picked = ds.take(np.array([9, 0]))
    np.testing.assert_array_equal(picked.entity_ids["u"], [9, 0])
    np.testing.assert_array_equal(picked.features["s"][0][0], rows[9][0])


def test_subspace_projection_identical():
    from photon_ml_tpu.game.dataset import group_by_entity as jgroup
    from photon_ml_tpu.game.projector import build_subspace_projection as jp

    rng = np.random.default_rng(3)
    n, gdim = 200, 500
    ids = rng.integers(0, 20, n)
    rows = []
    for _ in range(n):
        k = int(rng.integers(2, 6))
        rows.append((np.sort(rng.choice(gdim, k, replace=False)),
                     rng.normal(0, 1, k).astype(np.float32)))
    jproj, jx = jp(jgroup(ids), rows, gdim)
    tproj, tx = build_subspace_projection(tds.group_by_entity(ids), rows,
                                          gdim)
    for a, b in zip(tproj.feature_ids, jproj.feature_ids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tx, jx):
        np.testing.assert_array_equal(a, b)


def test_down_sampling_identical():
    from photon_ml_tpu.game.sampling import (
        binary_classification_down_sample as jds,
    )

    rng = np.random.default_rng(4)
    labels = (rng.uniform(size=5000) < 0.1).astype(np.float32)
    w = rng.uniform(0.5, 2, 5000).astype(np.float32)
    for a, b in zip(binary_classification_down_sample(labels, w, 0.25, 7),
                    jds(labels, w, 0.25, 7)):
        np.testing.assert_array_equal(a, b)


# -- random-effect coordinates ---------------------------------------------------


def _re_objectives(l2=2.0):
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    return (JO(loss=jl.LOGISTIC, reg=JR.l2(l2), norm=JN.identity()),
            GLMObjective(losses.LOGISTIC, RegularizationContext.l2(l2),
                         NormalizationContext.identity()))


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_random_effect_coordinate_matches_reference(jax_c1, optimizer):
    """Per-bucket lane-batched solves (offsets scattered into block
    space) against the reference's vmapped ones; scores and variances."""
    import jax.numpy as jnp

    from photon_ml_tpu.game import build_random_effect_coordinate as jbuild
    from photon_ml_tpu.game.dataset import GameDataset as JG
    from photon_ml_tpu.optim.base import OptimizerConfig as JC
    from photon_ml_tpu.optim.base import OptimizerType as JT
    from photon_ml_torch.optim.base import OptimizerType

    data = _movielens(n_users=120, n_items=1, n_obs=4000, seed=23)
    n = len(data["labels"])
    x = np.stack([np.ones(n), data["x"][:, 0]], 1).astype(np.float32)
    feats = {"re": x}
    ids = {"per_user": data["user_ids"]}
    off = np.random.default_rng(5).normal(0, 0.5, n).astype(np.float32)
    jo, to = _re_objectives()
    cfg = dict(max_iters=50, tolerance=1e-6, track_states=False)
    jc = jbuild("per_user", JG(labels=data["labels"], features=feats,
                               entity_ids=ids), "re", jo, config=JC(**cfg),
                optimizer=JT(optimizer))
    tc = build_random_effect_coordinate(
        "per_user", tds.GameDataset(labels=data["labels"], features=feats,
                                    entity_ids=ids), "re", to,
        config=OptimizerConfig(**cfg), optimizer=OptimizerType(optimizer),
        device=CPU)
    assert len(tc.x_blocks) > 2                      # several buckets
    jw, jdiag = jc.train(jnp.asarray(off))
    tw, tdiag = tc.train(torch.from_numpy(off))
    for a, b, ja, ta in zip(jw, tw, jdiag, tdiag):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=COEF_ATOL)
        np.testing.assert_array_equal(ta.converged.numpy(),
                                      np.asarray(ja.converged))
    # The same coefficients score the same.
    same = [torch.from_numpy(np.array(a)) for a in jw]
    np.testing.assert_allclose(tc.score(same).numpy(),
                               np.asarray(jc.score(jw)), atol=SCORE_ATOL)
    jv = jc.compute_variance_blocks(jw, jnp.asarray(off))
    tv = tc.compute_variance_blocks(same, torch.from_numpy(off))
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)


def test_sparse_re_matches_dense_and_reference(jax_c1):
    """A projected sparse random effect against the dense one on the
    same data, and against the reference's projected coordinate."""
    import jax.numpy as jnp

    from photon_ml_tpu.game import (
        build_random_effect_coordinate_sparse as jsparse,
    )
    from photon_ml_tpu.game.dataset import GameDataset as JG
    from photon_ml_tpu.optim.base import OptimizerConfig as JC

    rng = np.random.default_rng(6)
    n, d_re = 300, 6
    ids = rng.integers(0, 15, n)
    x = rng.normal(0, 1, (n, d_re)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    rows = [(np.arange(d_re, dtype=np.int32), x[i]) for i in range(n)]
    jo, to = _re_objectives(1.0)
    cfg = dict(max_iters=50, tolerance=1e-6, track_states=False)
    dense = build_random_effect_coordinate(
        "u", tds.GameDataset(labels=y, features={"re": x},
                             entity_ids={"u": ids}), "re", to,
        config=OptimizerConfig(**cfg), device=CPU)
    sparse = build_random_effect_coordinate_sparse(
        "u", tds.GameDataset(labels=y, features={"re": rows},
                             entity_ids={"u": ids}), "re", to,
        global_dim=d_re, config=OptimizerConfig(**cfg), device=CPU)
    off = torch.zeros(n)
    db, _ = dense.train(off)
    sb, _ = sparse.train(off)
    np.testing.assert_allclose(sparse.score(sb).numpy(),
                               dense.score(db).numpy(), atol=2e-3)
    dm, sm = dense.as_model(db), sparse.as_model(sb)
    for e in np.unique(ids)[:5]:
        np.testing.assert_allclose(sm.global_coefficients_for(e),
                                   dm.coefficients_for(e), atol=2e-3)
    jc = jsparse("u", JG(labels=y, features={"re": rows},
                         entity_ids={"u": ids}), "re", jo, global_dim=d_re,
                 config=JC(**cfg))
    jw, _ = jc.train(jnp.zeros(n, jnp.float32))
    for a, b in zip(jw, sb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=COEF_ATOL)


def test_locked_coordinate_and_validator():
    data = _movielens(n_users=50, n_items=1, n_obs=2000, seed=31)
    ttr, _ = _datasets(data, 2000, "torch", sparse_global=False)
    n = ttr.n
    jo, to = _re_objectives()
    user = build_random_effect_coordinate(
        "userId", ttr, "user_re", to,
        config=OptimizerConfig(max_iters=50, tolerance=1e-6), device=CPU)
    locked = [torch.full((e, 2), 0.1) for e, _ in user.coefficient_shapes]
    seen = []
    res = run_coordinate_descent(
        {"per_user": user}, ["per_user"], 2,
        validator=lambda total: seen.append(float(total.sum())) or 0.5,
        locked_coordinates={"per_user": locked})
    assert res.coefficients["per_user"] is locked
    assert res.history == [{}, {}] and len(seen) == 2
    res = run_coordinate_descent({"per_user": user}, ["per_user"], 1,
                                 initial_coefficients={"per_user": locked})
    assert res.history[0]["per_user"]["entities"] == \
        user.grouping.n_total_entities
    assert res.last_offsets["per_user"].shape == (n,)
    # Checkpoints (A8a), the fused cycle (A5b) and the mesh-sharded
    # random effect (A7b; it raised before) are ported: on a 3-shard
    # entity mesh the blocks pad to the grid and the solves give the
    # unsharded coefficients (lanes batched otherwise: float32 order).
    from photon_ml_torch.parallel.mesh import entity_mesh

    meshed = build_random_effect_coordinate(
        "userId", ttr, "user_re", to, mesh=entity_mesh(3, device=CPU),
        config=OptimizerConfig(max_iters=50, tolerance=1e-6), device=CPU)
    assert all(s[0] % 3 == 0 for s in meshed.coefficient_shapes)
    off = torch.zeros(n)
    w_plain, _ = user.train(off)
    w_mesh, _ = meshed.train(off)
    for a, b in zip(w_plain, w_mesh):
        np.testing.assert_allclose(_np(b)[: a.shape[0]], _np(a),
                                   rtol=COEF_ATOL, atol=COEF_ATOL)


# -- GameEstimator ---------------------------------------------------------------


def test_config5_fit_matches_reference(jax_c1, tmp_path):
    """Sparse fixed effect + per-user [1, x0] + per-item intercept, two
    sweeps: coefficients, evaluations and the per-sweep validation
    history; then the reference's model scored by the port's
    transformer, and the port's model through save/load."""
    from photon_ml_tpu.estimators.game_transformer import (
        GameTransformer as JT,
    )
    from photon_ml_tpu.io.model_io import save_game_model as jsave
    from photon_ml_tpu.models.glm import TaskType as JTask

    data = _movielens(n_users=80, n_items=40, n_obs=3000, seed=41)
    jres, tres, jva, tva = _fit_both(_config(), data, 2400)
    jr, tr = jres[0], tres[0]
    _assert_models_close(jr.model, tr.model)
    _assert_evals_close(jr, tr)
    assert len(tr.validation_history) == 2
    for je, te in zip(jr.validation_history, tr.validation_history):
        assert abs(te[EvaluatorType.AUC] - float(je[next(iter(je))])) \
            <= AUC_ATOL
    assert tr.evaluations == tr.validation_history[-1]
    assert tr.evaluations[EvaluatorType.AUC] > 0.7
    # One model, both transformers.
    jsave(jr.model, JTask.LOGISTIC_REGRESSION, str(tmp_path / "jax"))
    shared, task = load_game_model(str(tmp_path / "jax"))
    want = np.asarray(JT(model=jr.model, task=JTask.LOGISTIC_REGRESSION)
                      .transform(jva))
    got = GameTransformer(model=shared, task=task, device=CPU).transform(tva)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL)
    # The port's model survives save → load.
    save_game_model(tr.model, task, str(tmp_path / "port"))
    again, _ = load_game_model(str(tmp_path / "port"))
    np.testing.assert_allclose(
        GameTransformer(model=again, task=task, device=CPU).transform(tva),
        GameTransformer(model=tr.model, task=task, device=CPU).transform(tva),
        atol=1e-6)


@pytest.mark.parametrize("variant", ["tron", "downsample", "standardize",
                                     "variances", "colmajor", "dense"])
def test_estimator_variants_match_reference(jax_c1, variant):
    data = _movielens(n_users=60, n_items=1, n_obs=2400, seed=9)
    cfg = _config(update_sequence=["global", "per_user"])
    cfg["coordinates"] = cfg["coordinates"][:2]
    sparse_global = True
    if variant == "tron":
        for c in cfg["coordinates"]:
            c["optimizer"]["optimizer"] = "TRON"
    elif variant == "downsample":
        cfg["coordinates"][0]["down_sampling_rate"] = 0.5
    elif variant == "standardize":
        data["x"] = data["x"] * 2.5 + 1.7
        cfg["normalization"] = "STANDARDIZATION"
    elif variant == "variances":
        cfg["coordinates"][0]["optimizer"]["variance_type"] = "FULL"
        cfg["coordinates"][1]["optimizer"]["variance_type"] = "SIMPLE"
    elif variant == "colmajor":
        cfg["sparse_layout"] = "COLMAJOR"
    else:
        sparse_global = False
    jres, tres, _, _ = _fit_both(cfg, data, 2000, sparse_global)
    _assert_models_close(jres[0].model, tres[0].model)
    _assert_evals_close(jres[0], tres[0])
    if variant == "variances":
        jm, tm = jres[0].model.models, tres[0].model.models
        np.testing.assert_allclose(
            _np(tm["global"].coefficients.variances),
            _np(jm["global"].coefficients.variances), rtol=1e-3)
        for a, b in zip(jm["per_user"].variance_blocks,
                        tm["per_user"].variance_blocks):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-3)


def test_grid_warm_start_and_locked_match_reference(jax_c1, tmp_path):
    """A two-point grid over a random effect (fit point by point), then a
    warm-started refit with the fixed effect locked."""
    from photon_ml_tpu.io.model_io import save_game_model as jsave
    from photon_ml_tpu.models.glm import TaskType as JTask

    data = _movielens(n_users=60, n_items=20, n_obs=2400, seed=13)
    cfg = _config(reg_weight_grid={"per_user": [0.5, 5.0]})
    jres, tres, _, _ = _fit_both(cfg, data, 2000)
    assert len(tres) == 2
    for jr, tr in zip(jres, tres):
        _assert_models_close(jr.model, tr.model)
        _assert_evals_close(jr, tr)
    warm = str(tmp_path / "warm")
    jsave(jres[0].model, JTask.LOGISTIC_REGRESSION, warm)
    cfg = _config(warm_start_model_dir=warm, locked_coordinates=["global"],
                  n_iterations=1)
    jres, tres, _, _ = _fit_both(cfg, data, 2000)
    _assert_models_close(jres[0].model, tres[0].model)
    np.testing.assert_array_equal(
        _np(tres[0].model.models["global"].coefficients.means),
        _np(jres[0].model.models["global"].coefficients.means))


def test_estimator_defaults_to_cuda_and_rejects_unported():
    base = _config()
    cfg = training_config_from_json(json.dumps(base))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GameEstimator(cfg)
    # cd_fused (A5b), distributed_init and n_devices (A7b; they raised
    # before), telemetry (A8b) and the monitor (D3) are ported and
    # validate.
    for knob, value in (("distributed_init", True), ("n_devices", 2),
                        ("monitor", "on"), ("status_port", 0)):
        assert getattr(training_config_from_json(json.dumps(
            {**base, knob: value, "device": CPU})), knob) == value
    one = _config(update_sequence=["global"],
                  reg_weight_grid={"global": [0.1, 1.0]}, device=CPU)
    one["coordinates"] = one["coordinates"][:1]
    data = _movielens(n_users=20, n_items=5, n_obs=300, seed=2)
    train, _ = _datasets(data, 300, "torch")
    # The swept λ grid of one fixed effect is ported now (it raised
    # naming A6 before): it fits both points.
    results = GameEstimator(training_config_from_json(
        json.dumps(one))).fit(train)
    assert [r.reg_weights["global"] for r in results] == [0.1, 1.0]
