"""Parity of the port's meshes (``parallel.mesh``,
``parallel.distributed_objective``) with the JAX package's.

Mirrors ``tests/test_mesh_training.py`` and ``tests/test_distributed.py``
on 8 shards: the reference on the conftest's 8 virtual CPU devices, the
port with its 8 shards on the CPU (ROADMAP C11: shards share a device
where there are fewer devices than shards).  Cases: ``shard_batch`` and
``shard_sparse_batch`` on the ELL, transposed-ELL and GRR layouts; the
distributed objective's seven methods against the reference's 8-device
objective (value 1e-5 relative, vectors 1e-4·max); estimator fits of
configs 1 (ELL, COLMAJOR, GRR), 2 (TRON) and 4 (fixed + per-user) with
``n_devices=8`` against the reference's (coefficients 1e-3, AUC 1e-3)
and against the port's own single-device fits; balanced entity blocks;
the shard sharing of C11; the validation rules of ``n_devices``.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest
import torch

from photon_ml_torch.config import training_config_from_json
from photon_ml_torch.data.batch import make_dense_batch, make_sparse_batch
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.parallel import mesh as tmesh
from photon_ml_torch.parallel import (
    DistributedGLMObjective,
    data_parallel_mesh,
    shard_batch,
    shard_sparse_batch,
)
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"
COEF_ATOL, AUC_ATOL = 1e-3, 1e-3


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _sparse_rows(seed=7, n=600, d=40, k=6):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 1, d)
    rows, y = [], np.zeros(n, np.float32)
    for i in range(n):
        c = np.sort(rng.choice(d, k, replace=False)).astype(np.int32)
        v = rng.normal(0, 1, k).astype(np.float32)
        rows.append((c, v))
        y[i] = 1.0 if v @ w_true[c] + rng.normal(0, 0.3) > 0 else 0.0
    return rows, y, d


def _sparse_datasets(seed=7, n=600):
    """The same config-1-shaped data as a reference and a port dataset."""
    from photon_ml_tpu.game.dataset import GameDataset as JD

    rows, y, d = _sparse_rows(seed, n)
    return (JD(labels=y, features={"f": rows}, entity_ids={},
               feature_dims={"f": d}),
            GameDataset(labels=y, features={"f": rows}, entity_ids={},
                        feature_dims={"f": d}))


def _game_datasets(seed=7, n=500, d=8, d_re=3, n_entities=24):
    from photon_ml_tpu.game.dataset import GameDataset as JD

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    x_re = rng.normal(0, 1, (n, d_re)).astype(np.float32)
    ids = rng.integers(0, n_entities, n)
    w = rng.normal(0, 1, d)
    w_re = rng.normal(0, 1.5, (n_entities, d_re))
    margin = x @ w + np.einsum("nd,nd->n", x_re, w_re[ids])
    y = (margin + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    kw = dict(labels=y, features={"g": x, "per_user": x_re},
              entity_ids={"user": ids})
    return JD(**kw), GameDataset(**kw)


def _fixed_cfg(n_devices=None, optimizer="LBFGS", **kw) -> dict:
    cfg = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{
            "name": "global", "kind": "FIXED_EFFECT", "feature_shard": "f",
            "optimizer": {"max_iters": 60, "reg_weight": 1.0,
                          "optimizer": optimizer}}],
        "update_sequence": ["global"],
        "evaluators": ["AUC"],
        "n_devices": n_devices,
    }
    cfg.update(kw)
    return cfg


def _game_cfg(n_devices=None) -> dict:
    return {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [
            {"name": "fixed", "kind": "FIXED_EFFECT", "feature_shard": "g",
             "optimizer": {"max_iters": 40, "reg_weight": 0.5}},
            {"name": "per_user", "kind": "RANDOM_EFFECT",
             "feature_shard": "per_user", "entity_key": "user",
             "optimizer": {"max_iters": 40, "reg_weight": 1.0}}],
        "update_sequence": ["fixed", "per_user"],
        "n_iterations": 2,
        "evaluators": ["AUC"],
        "n_devices": n_devices,
    }


def _fit_jax(cfg: dict, train, valid=None):
    from photon_ml_tpu.config import training_config_from_json as jcfg
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JE

    return JE(jcfg(json.dumps(cfg))).fit(train, valid)[0]


def _fit_torch(cfg: dict, train, valid=None):
    tcfg = training_config_from_json(json.dumps({**cfg, "device": CPU}))
    return GameEstimator(tcfg).fit(train, valid)[0]


def _assert_fits_close(jr, tr, name, atol=COEF_ATOL):
    np.testing.assert_allclose(
        _np(tr.model.models[name].coefficients.means),
        _np(jr.model.models[name].coefficients.means),
        rtol=atol, atol=atol)
    for ev, v in jr.evaluations.items():
        got = tr.evaluations[EvaluatorType(ev.value)]
        assert abs(got - v) <= AUC_ATOL, (ev, got, v)


# -- sharding --------------------------------------------------------------------


def _ref_mesh():
    from photon_ml_tpu.parallel.mesh import data_parallel_mesh as jmesh

    return jmesh(8)


@pytest.mark.parametrize("layout", ["ell", "colmajor", "grr"])
def test_shard_sparse_batch_matches_reference(jax_c1, layout):
    """Per-shard ELL rows, labels and masks equal the reference's shards;
    transposed ELLs share one padded virtual-row count; GRR shards are
    congruent and equal the reference's leaves."""
    from photon_ml_tpu.parallel.mesh import shard_sparse_batch as jshard

    rows, y, d = _sparse_rows(3, n=613)
    jb = jshard(rows, d, y, _ref_mesh(), layout=layout)
    tb = shard_sparse_batch(rows, d, y, data_parallel_mesh(8, device=CPU),
                            layout=layout)
    assert len(tb.shards) == 8 and tb.n_padded == jb.n_padded == 616
    per = tb.rows_per_shard
    for i, b in enumerate(tb.shards):
        sl = slice(i * per, (i + 1) * per)
        for leaf in ("values", "col_ids", "labels", "weights", "mask"):
            np.testing.assert_array_equal(_np(getattr(b, leaf)),
                                          np.asarray(getattr(jb, leaf))[sl])
    if layout == "colmajor":
        vs = {b.colmajor.n_virtual_rows for b in tb.shards}
        assert len(vs) == 1
        assert vs.pop() * 8 == jb.colmajor.tvals.shape[0]
        jt = np.asarray(jb.colmajor.tvals)
        jt = jt.reshape((8, -1) + jt.shape[1:])
        for i, b in enumerate(tb.shards):
            np.testing.assert_array_equal(_np(b.colmajor.tvals), jt[i])
    if layout == "grr":
        shapes = {tuple(b.grr.col_dir.vals.shape) for b in tb.shards}
        assert len(shapes) == 1
        jv = np.asarray(jb.grr.col_dir.vals)
        jv = jv.reshape((8, -1) + jv.shape[1:])
        for i, b in enumerate(tb.shards):
            np.testing.assert_array_equal(_np(b.grr.col_dir.vals), jv[i])


def test_shard_batch_dense_and_refusals():
    """``shard_batch`` splits a padded dense or ELL batch into contiguous
    shards; rows that do not divide the mesh, or a layout built over the
    whole batch, raise as in the reference."""
    rng = np.random.default_rng(0)
    mesh = data_parallel_mesh(8, device=CPU)
    x = rng.normal(size=(61, 5)).astype(np.float32)
    y = (rng.random(61) < 0.5).astype(np.float32)
    sb = shard_batch(make_dense_batch(x, y, pad_to=64, device=CPU), mesh)
    assert [b.n_padded for b in sb.shards] == [8] * 8
    np.testing.assert_array_equal(
        torch.cat([b.x for b in sb.shards]).numpy()[:61], x)
    assert float(torch.cat([b.mask for b in sb.shards]).sum()) == 61
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(make_dense_batch(x, y, device=CPU), mesh)
    rows, yy, d = _sparse_rows(1, n=64)
    with pytest.raises(ValueError, match="built globally"):
        shard_batch(make_sparse_batch(rows, d, yy, col_major=True,
                                      device=CPU), mesh)
    ell = shard_batch(make_sparse_batch(rows, d, yy, device=CPU), mesh)
    assert ell.dim == d and len(ell.shards) == 8


# -- the distributed objective -------------------------------------------------


@pytest.mark.parametrize("layout", ["ell", "colmajor", "grr"])
def test_distributed_objective_matches_reference(jax_c1, layout):
    """All seven methods against the reference's 8-device objective on
    the same sharded data (value 1e-5 relative, vectors 1e-4·max), with
    L2 added once outside the sum."""
    import jax.numpy as jnp

    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR
    from photon_ml_tpu.parallel import DistributedGLMObjective as JDO
    from photon_ml_tpu.parallel.mesh import shard_sparse_batch as jshard

    rows, y, d = _sparse_rows(5, n=800, d=60)
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.3, d).astype(np.float32)
    v = rng.normal(0, 1, d).astype(np.float32)
    off = rng.normal(0, 0.1, 800).astype(np.float32)
    jm = _ref_mesh()
    jb = jshard(rows, d, y, jm, layout=layout, offsets=off)
    jo = JDO(objective=JO(loss=jl.LOGISTIC, reg=JR.l2(0.7),
                          norm=JN.identity()), mesh=jm)
    tb = shard_sparse_batch(rows, d, y, data_parallel_mesh(8, device=CPU),
                            layout=layout, offsets=off)
    to = DistributedGLMObjective(
        GLMObjective(loss=losses.LOGISTIC, reg=RegularizationContext.l2(0.7),
                     norm=NormalizationContext.identity()), tb.mesh)
    jw, jv, tw, tv = jnp.asarray(w), jnp.asarray(v), torch.tensor(w), \
        torch.tensor(v)

    def close(got, want, scalar=False):
        got, want = _np(got), np.asarray(want)
        if scalar:
            np.testing.assert_allclose(got, want, rtol=1e-5)
        else:
            np.testing.assert_allclose(
                got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))

    # One compiled program for the reference's seven methods.
    ref = jax_c1.jit(lambda w_, v_, b_: (
        jo.value(w_, b_), jo.value_and_gradient(w_, b_),
        jo.gradient(w_, b_), jo.hessian_vector(w_, v_, b_),
        jo.hessian_diagonal(w_, b_), jo.predict_margins(w_, b_),
        jo.x_dot(v_, b_)))(jw, jv, jb)
    close(to.value(tw, tb), ref[0], scalar=True)
    tv_, tg = to.value_and_gradient(tw, tb)
    close(tv_, ref[1][0], scalar=True)
    close(tg, ref[1][1])
    close(to.gradient(tw, tb), ref[2])
    close(to.hessian_vector(tw, tv, tb), ref[3])
    close(to.hessian_diagonal(tw, tb), ref[4])
    close(to.predict_margins(tw, tb), ref[5])
    close(to.x_dot(tv, tb), ref[6])


def test_distributed_objective_repeats_and_takes_lanes():
    """The shard-order sum repeats bitwise; λ-lane coefficients [L, d]
    give each lane's single-lane result."""
    rows, y, d = _sparse_rows(2, n=400)
    tb = shard_sparse_batch(rows, d, y, data_parallel_mesh(8, device=CPU),
                            layout="colmajor")
    to = DistributedGLMObjective(
        GLMObjective(loss=losses.LOGISTIC, reg=RegularizationContext.l2(0.3),
                     norm=NormalizationContext.identity()), tb.mesh)
    W = torch.randn(3, d, generator=torch.Generator().manual_seed(0))
    a = to.value_and_gradient(W[1], tb)
    b = to.value_and_gradient(W[1], tb)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    fl, gl = to.value_and_gradient(W, tb)
    for lane in range(3):
        f1, g1 = to.value_and_gradient(W[lane], tb)
        np.testing.assert_allclose(_np(fl[lane]), _np(f1), rtol=1e-6)
        np.testing.assert_allclose(_np(gl[lane]), _np(g1), rtol=1e-5,
                                   atol=1e-6)


def test_distributed_objective_adds_l2_and_prior_once():
    """Regularization and the Gaussian prior are example-independent:
    the mesh adds them once, outside the shard sum, so the 8-shard
    objective equals the single-device one (ROADMAP C12: the reference
    keeps the prior inside its per-shard objective and so sums it once a
    shard)."""
    from photon_ml_torch.ops.prior import GaussianPrior

    rows, y, d = _sparse_rows(4, n=480)
    gen = torch.Generator().manual_seed(2)
    prior = GaussianPrior.from_model(torch.randn(d, generator=gen),
                                     torch.rand(d, generator=gen) + 0.5,
                                     weight=3.0)
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(0.9),
                       norm=NormalizationContext.identity(), prior=prior)
    single = make_sparse_batch(rows, d, y, device=CPU)
    sharded = shard_sparse_batch(rows, d, y,
                                 data_parallel_mesh(8, device=CPU),
                                 layout="ell")
    dist = DistributedGLMObjective(obj, sharded.mesh)
    w = torch.randn(d, generator=gen) * 0.3
    v = torch.randn(d, generator=gen)
    f1, g1 = obj.value_and_gradient(w, single)
    f8, g8 = dist.value_and_gradient(w, sharded)
    np.testing.assert_allclose(float(f8), float(f1), rtol=1e-5)
    np.testing.assert_allclose(_np(g8), _np(g1), rtol=1e-4,
                               atol=1e-4 * float(g1.abs().max()))
    np.testing.assert_allclose(
        _np(dist.hessian_vector(w, v, sharded)),
        _np(obj.hessian_vector(w, v, single)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        _np(dist.hessian_diagonal(w, sharded)),
        _np(obj.hessian_diagonal(w, single)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("l1,optimizer", [
    (0.0, "LBFGS"), (2.0, "LBFGS"), (0.0, "TRON")])
def test_problem_runs_the_distributed_objective(l1, optimizer):
    """``OptimizationProblem.run`` takes the 8-shard objective in place of
    the local one and routes it alike (L-BFGS, OWL-QN on an L1 weight,
    TRON; TRON refuses L1 through the mesh too): the mesh solve within
    the fits' 1e-3 of the single-device solve."""
    import dataclasses

    from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
    from photon_ml_torch.optim.problem import OptimizationProblem

    rows, y, d = _sparse_rows(6, n=480)
    reg = RegularizationContext(l1, 0.8, None)
    problem = OptimizationProblem(
        GLMObjective(loss=losses.LOGISTIC, reg=reg,
                     norm=NormalizationContext.identity()),
        optimizer=OptimizerType[optimizer],
        config=OptimizerConfig(max_iters=60))
    single = make_sparse_batch(rows, d, y, device=CPU)
    sharded = shard_sparse_batch(rows, d, y,
                                 data_parallel_mesh(8, device=CPU),
                                 layout="colmajor")
    dist = DistributedGLMObjective(problem.objective, sharded.mesh)
    assert dist.reg is problem.objective.reg and dist.prior is None
    on_mesh = dataclasses.replace(problem, objective=dist)
    w0 = torch.zeros(d)
    got = on_mesh.run(sharded, w0)
    want = problem.run(single, w0)
    np.testing.assert_allclose(_np(got.w), _np(want.w), rtol=COEF_ATOL,
                               atol=COEF_ATOL)
    if l1:
        assert (got.w == 0).any()            # OWL-QN's exact zeros
        with pytest.raises(ValueError, match="TRON requires"):
            dataclasses.replace(on_mesh, optimizer=OptimizerType.TRON).run(
                sharded, w0)


def test_collectives_follow_the_mesh(monkeypatch):
    """A mesh within its process runs no collective whatever the world;
    a mesh spanning processes must match the world it meets."""
    calls = []
    monkeypatch.setattr(tmesh, "all_reduce_sum",
                        lambda leaves, op=None: calls.append("sum") or leaves)
    monkeypatch.setattr(tmesh, "all_gather_rows",
                        lambda t: calls.append("gather") or t)
    local = data_parallel_mesh(2, device=CPU)
    parts = [torch.ones(3), 2 * torch.ones(3)]
    monkeypatch.setattr(tmesh, "_world", lambda: (1, 2))
    assert not tmesh.spans_world(local)
    assert torch.equal(tmesh.reduce_partials(parts, local), 3 * torch.ones(3))
    sb = tmesh.ShardedBatch(shards=(), mesh=local)
    assert torch.equal(sb.gather_rows(torch.ones(4)), torch.ones(4))
    assert calls == []
    spanning = tmesh.Mesh(devices=local.devices, axis=tmesh.DATA_AXIS,
                          process_index=1, process_count=2)
    assert tmesh.spans_world(spanning)
    tmesh.reduce_partials(parts, spanning)
    tmesh.ShardedBatch(shards=(), mesh=spanning).gather_rows(torch.ones(4))
    assert calls == ["sum", "gather"]
    monkeypatch.setattr(tmesh, "_world", lambda: (0, 1))
    with pytest.raises(RuntimeError, match="mesh spans 2 processes"):
        tmesh.reduce_partials(parts, spanning)


# -- estimator fits -----------------------------------------------------------


@pytest.mark.parametrize("layout,optimizer", [
    ("AUTO", "LBFGS"), ("ELL", "LBFGS"), ("GRR", "LBFGS"),
    ("COLMAJOR", "TRON")])
def test_estimator_mesh_fit_matches_reference(jax_c1, layout, optimizer):
    """Config 1 (L-BFGS on each layout) and config 2 (TRON, so the HVP
    through the mesh) with ``n_devices=8``: the port's fit within 1e-3
    of the reference's 8-device fit and of its own single-device fit."""
    jtr, ttr = _sparse_datasets(7, n=600 if optimizer == "LBFGS" else 400)
    cfg = _fixed_cfg(8, optimizer=optimizer, sparse_layout=layout)
    jr = _fit_jax(cfg, jtr, jtr)
    tr = _fit_torch(cfg, ttr, ttr)
    _assert_fits_close(jr, tr, "global")
    t1 = _fit_torch(_fixed_cfg(None, optimizer=optimizer,
                               sparse_layout=layout), ttr, ttr)
    _assert_fits_close(t1, tr, "global")
    assert tr.evaluations[EvaluatorType.AUC] > 0.8


def test_config4_game_mesh_matches_reference(jax_c1):
    """Config 4's shape (a fixed effect plus per-user random effects) on
    the mesh: the sharded fixed solve and entity-sharded random-effect
    solves against the reference's 8-device fit and the port's single
    device."""
    jtr, ttr = _game_datasets()
    jr = _fit_jax(_game_cfg(8), jtr, jtr)
    tr = _fit_torch(_game_cfg(8), ttr, ttr)
    t1 = _fit_torch(_game_cfg(None), ttr, ttr)
    for other in (jr, t1):
        _assert_fits_close(other, tr, "fixed")
        ob, tb = other.model.models["per_user"], tr.model.models["per_user"]
        for e in range(24):
            want, got = ob.coefficients_for(e), tb.coefficients_for(e)
            if want is None:
                assert got is None
                continue
            np.testing.assert_allclose(_np(got), _np(want), rtol=COEF_ATOL,
                                       atol=COEF_ATOL)
    assert tr.evaluations[EvaluatorType.AUC] > 0.85


def test_mesh_normalization_and_dense_fixed_effect():
    """Standardization on a sharded batch: the statistics fold the
    shards' partials, and the dense fixed effect shards through
    ``shard_batch``; both fits match the single-device fit."""
    _, ttr = _game_datasets(seed=3)
    cfg = _game_cfg(None)
    cfg["normalization"] = "STANDARDIZATION"
    t1 = _fit_torch(cfg, ttr, ttr)
    t8 = _fit_torch({**cfg, "n_devices": 8}, ttr, ttr)
    _assert_fits_close(t1, t8, "fixed")


def test_entity_blocks_balanced_on_mesh():
    """Every bucket block pads to a multiple of the mesh size; each shard
    gets an equal slice."""
    mesh = tmesh.entity_mesh(8, device=CPU)
    assert mesh.axis == tmesh.ENTITY_AXIS
    blocks = [torch.ones(13, 4, 3), torch.ones(3, 16)]
    for b in tmesh.shard_entity_blocks(blocks, mesh):
        assert b.shape[0] % 8 == 0
        assert {s.shape[0] for s in tmesh.entity_slices(b, mesh)} == \
            {b.shape[0] // 8}
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.place_entity_chunk({"x": np.zeros((12, 2), np.float32)}, mesh)
    placed = tmesh.place_entity_chunk({"x": np.ones((16, 2), np.float32)},
                                      mesh)
    assert placed["x"].shape == (16, 2)


def test_shards_share_a_device_with_one_warning(monkeypatch, caplog):
    """C11: 8 shards on the one CPU device (the reference would raise for
    more shards than devices); on a host with 8 cards each shard would
    have its own.  One warning per process, whatever the meshes."""
    monkeypatch.setattr(tmesh, "_warned_shared", False)
    with caplog.at_level(logging.WARNING, logger=tmesh.__name__):
        m = data_parallel_mesh(8, device=CPU)
        data_parallel_mesh(4, device=CPU)
    assert m.devices == (torch.device("cpu"),) * 8 and m.size == 8
    assert sum("share a device" in r.message for r in caplog.records) == 1
    # Round-robin over the visible devices of the kind: 3 cards, 8 shards.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    g = data_parallel_mesh(8, device="cuda")
    assert [d.index for d in g.devices] == [0, 1, 2, 0, 1, 2, 0, 1]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert [d.index for d in data_parallel_mesh(8, device="cuda").devices] \
        == list(range(8))
    assert data_parallel_mesh(device=CPU).size == 1
    assert tmesh.padded_rows(613, 8) == 616
    assert tmesh.batch_spec() == (tmesh.DATA_AXIS,)
    assert tmesh.replicated_spec() == ()
    r = tmesh.replicate(torch.ones(3), m)
    assert len(r) == 8 and all(t is r[0] for t in r)


def test_n_devices_validation_matches_reference():
    """The reference's rules: positive, no down-sampling, no cd_fused."""
    from photon_ml_tpu.config import training_config_from_json as jcfg

    base = _game_cfg(8)
    bad = [
        {"n_devices": 0},
        {"coordinates": [{**base["coordinates"][0],
                          "down_sampling_rate": 0.5},
                         base["coordinates"][1]]},
    ]
    for over in bad:
        cfg = json.dumps({**base, **over})
        with pytest.raises(ValueError) as je:
            jcfg(cfg)
        with pytest.raises(ValueError) as te:
            training_config_from_json(json.dumps({**json.loads(cfg),
                                                  "device": CPU}))
        assert str(te.value) == str(je.value)
    assert training_config_from_json(json.dumps(
        {**base, "distributed_init": True, "device": CPU})).distributed_init
