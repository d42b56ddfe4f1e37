"""Model directories cross between the two packages.

A model made from a numpy seed is saved by ``photon_ml_tpu.io.model_io``
and loaded by ``photon_ml_torch.io.model_io`` (manifest and legacy
layouts), and the other way round; ``game_model_from_tree`` carries the
JAX package's state tree into the port.  Weights must come across
exactly (the same float32 bytes).
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.dataset import group_by_entity
from photon_ml_tpu.game.projector import SubspaceProjection as JProj
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.models.coefficients import Coefficients as JCoef
from photon_ml_tpu.models.game import (
    FixedEffectModel as JFixed,
    GameModel as JGame,
    RandomEffectModel as JRandom,
)
from photon_ml_tpu.models.glm import TaskType as JTask
from photon_ml_tpu.reliability import checkpoint as jck
from photon_ml_torch.io import model_io as tio
from photon_ml_torch.models.game import FixedEffectModel, RandomEffectModel
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.reliability import checkpoint as tck
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)


def _jax_model(seed: int = 5):
    """Fixed effect (intercept + variances), a plain random effect with
    several buckets and variance blocks, and a projected one."""
    rng = np.random.default_rng(seed)
    d = 64
    ids_u = rng.integers(0, 40, 300) * 3 + 7
    g_u = group_by_entity(ids_u)
    ids_i = rng.integers(0, 25, 300)
    g_i = group_by_entity(ids_i)
    blocks_u = [rng.normal(0, 0.1, (ne, 2)).astype(np.float32)
                for ne in g_u.n_entities]
    var_u = [rng.random((ne, 2)).astype(np.float32)
             for ne in g_u.n_entities]
    blocks_i = [rng.normal(0, 0.1, (ne, 3)).astype(np.float32)
                for ne in g_i.n_entities]
    fids_i = [rng.integers(-1, d, (ne, 3)).astype(np.int32)
              for ne in g_i.n_entities]
    w = rng.normal(0, 0.1, d + 1).astype(np.float32)
    v = rng.random(d + 1).astype(np.float32)
    return JGame(models={
        "global": JFixed(coefficients=JCoef(means=jnp.asarray(w),
                                            variances=jnp.asarray(v)),
                         feature_shard="global", intercept=True),
        "per_user": JRandom(
            coefficient_blocks=[jnp.asarray(b) for b in blocks_u],
            grouping=g_u, feature_shard="user",
            variance_blocks=[jnp.asarray(b) for b in var_u],
            entity_key="userId"),
        "per_item": JRandom(
            coefficient_blocks=[jnp.asarray(b) for b in blocks_i],
            grouping=g_i, feature_shard="global",
            projection=JProj(feature_ids=fids_i, global_dim=d),
            entity_key="itemId"),
    })


def _assert_same(jm, tm):
    """JAX model ``jm`` and port model ``tm`` hold the same weights."""
    assert list(jm.models) == list(tm.models)
    for name, jc in jm.models.items():
        tc = tm[name]
        assert jc.feature_shard == tc.feature_shard
        if isinstance(jc, JFixed):
            assert isinstance(tc, FixedEffectModel)
            assert tc.intercept == jc.intercept
            assert isinstance(tc.coefficients.means, torch.Tensor)
            np.testing.assert_array_equal(
                tc.coefficients.means.numpy(),
                np.asarray(jc.coefficients.means))
            np.testing.assert_array_equal(
                tc.coefficients.variances.numpy(),
                np.asarray(jc.coefficients.variances))
            continue
        assert isinstance(tc, RandomEffectModel)
        assert tc.entity_key == jc.entity_key
        for f in ("entity_ids", "entity_counts", "entity_bucket",
                  "entity_slot"):
            np.testing.assert_array_equal(getattr(tc.grouping, f),
                                          getattr(jc.grouping, f))
        assert tc.grouping.capacities == list(jc.grouping.capacities)
        assert tc.grouping.n_entities == list(jc.grouping.n_entities)
        assert len(tc.coefficient_blocks) == len(jc.coefficient_blocks)
        for a, b in zip(tc.coefficient_blocks, jc.coefficient_blocks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if jc.variance_blocks is None:
            assert tc.variance_blocks is None
        else:
            for a, b in zip(tc.variance_blocks, jc.variance_blocks):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if jc.projection is None:
            assert tc.projection is None
        else:
            assert tc.projection.global_dim == jc.projection.global_dim
            for a, b in zip(tc.projection.feature_ids,
                            jc.projection.feature_ids):
                np.testing.assert_array_equal(a, b)
        eid = int(jc.grouping.entity_ids[3])
        np.testing.assert_array_equal(tc.global_coefficients_for(eid),
                                      jc.global_coefficients_for(eid))


@pytest.mark.parametrize("layout", ["manifest", "legacy"])
def test_jax_written_model_loads_in_port(tmp_path, layout):
    jm = _jax_model()
    mdir = str(tmp_path / "m")
    jio.save_game_model(jm, JTask.POISSON_REGRESSION, mdir)
    if layout == "legacy":
        os.remove(jio.model_manifest_path(mdir))
    tm, task = tio.load_game_model(mdir)
    assert task is TaskType.POISSON_REGRESSION
    _assert_same(jm, tm)


@pytest.mark.parametrize("layout", ["manifest", "legacy"])
def test_port_written_model_loads_in_jax(tmp_path, layout):
    jm = _jax_model(seed=9)
    tm, _ = tio.game_model_from_tree(
        jio._model_tree(jm, JTask.LOGISTIC_REGRESSION))
    mdir = str(tmp_path / "m")
    tio.save_game_model(tm, TaskType.LINEAR_REGRESSION, mdir)
    if layout == "legacy":
        os.remove(tio.model_manifest_path(mdir))
    back, task = jio.load_game_model(mdir)
    assert task is JTask.LINEAR_REGRESSION
    _assert_same(back, tm)


def test_game_model_from_tree_equals_manifest_load(tmp_path):
    jm = _jax_model(seed=2)
    mdir = str(tmp_path / "m")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    from_tree, t1 = tio.game_model_from_tree(
        jio._model_tree(jm, JTask.LOGISTIC_REGRESSION))
    from_disk, t2 = tio.load_game_model(mdir)
    assert t1 is t2 is TaskType.LOGISTIC_REGRESSION
    _assert_same(jm, from_tree)
    _assert_same(jm, from_disk)


def test_manifest_codec_is_byte_compatible(tmp_path):
    """The same model makes the same manifest tree and arrays in both
    packages."""
    jm = _jax_model(seed=4)
    tree = jio._model_tree(jm, JTask.LOGISTIC_REGRESSION)
    tm, task = tio.game_model_from_tree(tree)
    jmeta, jarr = jck.flatten_tree(tree)
    tmeta, tarr = tck.flatten_tree(tio.model_tree(tm, task))
    assert json.dumps(jmeta) == json.dumps(tmeta)
    assert sorted(jarr) == sorted(tarr)
    for key in jarr:
        assert jarr[key].dtype == tarr[key].dtype
        np.testing.assert_array_equal(jarr[key], tarr[key])
    back = tck.unflatten_tree(tmeta, tarr)
    assert back["task"] == "LOGISTIC_REGRESSION"


def test_port_round_trip(tmp_path):
    tm, task = tio.game_model_from_tree(
        jio._model_tree(_jax_model(seed=6), JTask.LOGISTIC_REGRESSION))
    mdir = str(tmp_path / "m")
    tio.save_game_model(tm, task, mdir)
    for layout in ("manifest", "legacy"):
        if layout == "legacy":
            os.remove(tio.model_manifest_path(mdir))
        back, t2 = tio.load_game_model(mdir)
        assert t2 is task
        for name in tm.models:
            a, b = tm[name], back[name]
            if isinstance(a, FixedEffectModel):
                assert torch.equal(a.coefficients.means,
                                   b.coefficients.means)
            else:
                for x, y in zip(a.coefficient_blocks,
                                b.coefficient_blocks):
                    assert torch.equal(x, y)


def test_corrupt_manifest_raises(tmp_path):
    jm = _jax_model()
    mdir = str(tmp_path / "m")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    with open(tio.model_manifest_path(mdir), "wb") as f:
        f.write(b"not a zip at all")
    with pytest.raises(Exception):
        tio.load_model_manifest(mdir)
    # No silent legacy fallback: a torn publish must be loud.
    with pytest.raises(Exception):
        tio.load_game_model(mdir)


@pytest.mark.parametrize("meta,match", [
    ({"kind": "plan", "schema": 1}, "kind"),
    ({"kind": "game_model", "schema": 99}, "schema"),
])
def test_manifest_kind_and_schema_checked(tmp_path, meta, match):
    from photon_ml_torch.cache.plan_cache import atomic_savez

    mdir = tmp_path / "m"
    atomic_savez(tio.model_manifest_path(str(mdir)),
                 {**meta, "tree": {"k": "none"}}, {})
    with pytest.raises(ValueError, match=match):
        tio.load_model_manifest(str(mdir))
