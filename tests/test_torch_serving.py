"""The port's serving path held against ``photon_ml_tpu.serving``.

One GAME model (sparse fixed effect with intercept, a per-user and a
per-item random effect) is made from a numpy seed as a JAX model and
carried into the port with ``game_model_from_tree``.  The same request
rows — with unseen entities, offsets and rows of every length — go
through both packages' entity stores, engines and HTTP servers.  The
port runs with ``device="cpu"`` (its plain kernel version).  Tolerance
``atol=1e-5``: float32 sums in another order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import ServingConfig as JServingConfig
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
from photon_ml_tpu.serving import engine as jeng
from photon_ml_tpu.serving.entity_store import (
    EntityServeStore as JStore,
)
from photon_ml_torch.config import (
    ServingConfig,
    config_to_json,
    serving_config_from_json,
)
from photon_ml_torch.io import model_io as tio
from photon_ml_torch.serving import engine as teng
from photon_ml_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    ServerClosing,
    ServerOverloaded,
)
from photon_ml_torch.serving.entity_store import EntityServeStore
from photon_ml_torch.serving.server import ModelServer
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

D, K, P_USER, P_ITEM = 64, 8, 2, 1
N_USERS, N_ITEMS, N_ROWS = 40, 25, 48
ATOL = 1e-5
BUCKETS = [1, 2, 4, 8]
TASKS = ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION"]


def _jax_model(seed: int = 3, scale: float = 1.0) -> JGame:
    rng = np.random.default_rng(seed)
    g_u = group_by_entity(rng.integers(0, N_USERS, 400) * 5 + 11)
    g_i = group_by_entity(rng.integers(0, N_ITEMS, 400) + 1000)
    w = (scale * rng.normal(0, 0.2, D + 1)).astype(np.float32)
    return JGame(models={
        "global": JFixed(coefficients=JCoef(means=jnp.asarray(w)),
                         feature_shard="global", intercept=True),
        "per_user": JRandom(
            coefficient_blocks=[jnp.asarray(
                (scale * rng.normal(0, 0.3, (ne, P_USER)))
                .astype(np.float32)) for ne in g_u.n_entities],
            grouping=g_u, feature_shard="user", entity_key="userId"),
        "per_item": JRandom(
            coefficient_blocks=[jnp.asarray(
                (scale * rng.normal(0, 0.3, (ne, P_ITEM)))
                .astype(np.float32)) for ne in g_i.n_entities],
            grouping=g_i, feature_shard="item", entity_key="itemId"),
    })


def _port(jm, task: str = "LOGISTIC_REGRESSION"):
    return tio.game_model_from_tree(jio._model_tree(jm, JTask(task)))


def _requests(jm, seed: int = 7, n: int = N_ROWS) -> list[dict]:
    """Request rows: 0..K non-zeros, ids known and unseen, offsets."""
    rng = np.random.default_rng(seed)
    users = np.asarray(jm["per_user"].grouping.entity_ids)
    items = np.asarray(jm["per_item"].grouping.entity_ids)
    rows = []
    for i in range(n):
        nnz = int(rng.integers(0, K + 1))
        cols = rng.choice(D, nnz, replace=False)
        uid = int(users[rng.integers(len(users))]) if i % 5 else 10 ** 9 + i
        iid = int(items[rng.integers(len(items))]) if i % 7 else -3 - i
        rows.append({
            "features": {
                "global": [[int(c), float(rng.normal())] for c in cols],
                "user": [float(x) for x in rng.normal(size=P_USER)],
                "item": [float(x) for x in rng.normal(size=P_ITEM)],
            },
            "ids": {"userId": uid, "itemId": iid},
            "offset": float(rng.normal(0, 0.3)),
        })
    return rows


def _reference(jm, rows, task="LOGISTIC_REGRESSION"):
    """float64 margins straight from the coefficients, and the JAX
    loss's mean."""
    w = np.asarray(jm["global"].coefficients.means, np.float64)
    out = []
    for r in rows:
        m = r["offset"] + w[-1] + sum(v * w[c]
                                      for c, v in r["features"]["global"])
        for coord, shard, key in (("per_user", "user", "userId"),
                                  ("per_item", "item", "itemId")):
            c = jm[coord].coefficients_for(r["ids"][key])
            if c is not None:
                m += float(np.dot(c.astype(np.float64),
                                  r["features"][shard]))
        out.append(m)
    m = np.asarray(out)
    p = np.asarray(JTask(task).loss.mean(jnp.asarray(m)))
    return m, p


# ---------------------------------------------------------------------------
# entity store
# ---------------------------------------------------------------------------


def _query(jm) -> np.ndarray:
    ids = np.asarray(jm["per_user"].grouping.entity_ids)
    return np.array([ids[0], ids[-1], 10 ** 9, ids[len(ids) // 2], -5,
                     ids[3], ids[0]])


@pytest.mark.parametrize("spilled", [True, False])
def test_entity_store_lookup_matches_jax(tmp_path, spilled):
    jm = _jax_model()
    tm, _ = _port(jm)
    sd = str(tmp_path) if spilled else None
    js = JStore.build("per_user", jm["per_user"], sd, entity_chunk=3,
                      host_max_resident=2)
    ts = EntityServeStore.build("per_user", tm["per_user"], sd,
                                entity_chunk=3, host_max_resident=2)
    assert ts.spilled == js.spilled == spilled
    q = _query(jm)
    for (wj, hj, dj), (wt, ht, dt) in zip([js.lookup(q), js.lookup(q)],
                                          [ts.lookup(q), ts.lookup(q)]):
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(ht, hj)
        np.testing.assert_array_equal(dt, dj)
    assert ts.lookup(q)[1].tolist() == [True, True, False, True, False,
                                        True, True]
    if spilled:
        for eid in jm["per_user"].grouping.entity_ids:
            ts.lookup(np.array([eid]))
        assert ts._store.peak_resident <= 2


def test_entity_store_degraded_rows_match_jax(tmp_path):
    """A chunk that can be neither read nor rebuilt serves zeros for
    its rows, marked degraded, in both packages."""
    jm = _jax_model()
    tm, _ = _port(jm)
    q = _query(jm)

    def boom(i):
        raise RuntimeError("lineage unavailable")

    results = []
    for name, build, model in (("jax", JStore.build, jm["per_user"]),
                               ("port", EntityServeStore.build,
                                tm["per_user"])):
        store = build("per_user", model, str(tmp_path / name),
                      entity_chunk=4, host_max_resident=1)
        store._store._rebuild = boom
        store._store._resident.clear()
        os.remove(store._store.path(0))
        results.append(store.lookup(q))
    (wj, hj, dj), (wt, ht, dt) = results
    assert dj.any() and not dj.all()
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(wt, wj)
    assert np.all(wt[dt] == 0.0)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_entity_store_spill_dir_shared_between_packages(tmp_path, first):
    """A spill dir built by one package is reused by the other with no
    chunk rebuilt."""
    jm = _jax_model()
    tm, _ = _port(jm)
    builders = {
        "jax": lambda: JStore.build("per_user", jm["per_user"],
                                    str(tmp_path), entity_chunk=4),
        "port": lambda: EntityServeStore.build(
            "per_user", tm["per_user"], str(tmp_path), entity_chunk=4),
    }
    second = "port" if first == "jax" else "jax"
    a = builders[first]()
    assert a._store.spills > 0
    b = builders[second]()
    assert b._store.spills == 0
    q = _query(jm)
    np.testing.assert_array_equal(a.lookup(q)[0], b.lookup(q)[0])


def test_id_joins_match_jax():
    from photon_ml_tpu.game import dataset as jds
    from photon_ml_torch.game import dataset as tds

    jm = _jax_model()
    tm, _ = _port(jm)
    q = np.concatenate([_query(jm), np.arange(-3, 70)])
    np.testing.assert_array_equal(
        tm["per_user"].grouping.join_ids(q),
        jm["per_user"].grouping.join_ids(q))
    assert tm["per_user"].grouping.n_total_entities == \
        jm["per_user"].grouping.n_total_entities
    assert tm["per_user"].grouping.entity_index() == \
        jm["per_user"].grouping.entity_index()
    rng = np.random.default_rng(0)
    keys = rng.permutation(50)[:30] * 7
    vals = rng.normal(size=30)
    qk = np.arange(0, 360, 5)
    for presorted in (False, True):
        k, v = ((np.sort(keys), vals[np.argsort(keys)]) if presorted
                else (keys, vals))
        tv, th = tds.sorted_key_join(k, v, qk, presorted=presorted)
        jv, jh = jds.sorted_key_join(k, v, qk, presorted=presorted)
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tv[th], jv[jh])
    empty = tds.sorted_key_join(np.zeros(0), np.zeros(0), qk)
    assert not empty[1].any() and empty[0].shape == qk.shape


def test_npz_member_index_matches_jax_and_follows_rewrites(tmp_path):
    """The memory-mapped load finds the same members at the same offsets
    as the JAX package, and a rewritten file is parsed anew."""
    from photon_ml_tpu.data import chunk_store as jcs
    from photon_ml_torch.cache.plan_cache import atomic_savez
    from photon_ml_torch.data import chunk_store as tcs

    path = str(tmp_path / "c.npz")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    atomic_savez(path, {"v": 1}, {"w": a})
    assert tcs._npz_index(path) == jcs._npz_index(path)
    np.testing.assert_array_equal(tcs._open_npz_mmap(path)["w"], a)
    b = np.ones((5, 2), np.int64)
    atomic_savez(path, {"v": 2}, {"w": b, "x": a})
    idx = tcs._npz_index(path)
    assert idx == jcs._npz_index(path)
    assert sorted(m[0] for m in idx) == ["__meta__", "w", "x"]
    np.testing.assert_array_equal(tcs._open_npz_mmap(path)["w"], b)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine, rows, float64 reference) per task,
    built once per module."""
    cache: dict = {}

    def get(task: str):
        if task not in cache:
            jm = _jax_model()
            tm, ttask = _port(jm, task)
            sd = str(tmp_path_factory.mktemp(task))
            je = jeng.ScoringEngine(jm, JTask(task), version="j",
                                    ell_row_capacity=K, spill_dir=sd,
                                    entity_chunk=4)
            te = teng.ScoringEngine(tm, ttask, version="t",
                                    ell_row_capacity=K, spill_dir=sd,
                                    entity_chunk=4, device="cpu")
            rows = _requests(jm)
            cache[task] = (je, te, rows, _reference(jm, rows, task))
        return cache[task]

    return get


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("task", TASKS)
def test_engine_scores_match_jax(engines, task, bucket):
    je, te, rows, (m64, p64) = engines(task)
    margins = np.empty(len(rows), np.float32)
    for lo in range(0, len(rows), bucket):
        piece = rows[lo: lo + bucket]
        # Fill the bucket, and leave room for padding on the last piece.
        if bucket > 1 and lo % (3 * bucket) == 0:
            piece = piece[: bucket - 1]
        mj, pj, dj = je.score_batch(je.parse_rows(piece), bucket)
        mt, pt, dt = te.score_batch(te.parse_rows(piece), bucket)
        assert mt.dtype == np.float32 and mt.shape == (len(piece),)
        np.testing.assert_allclose(mt, mj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=ATOL)
        assert not dt.any() and not dj.any()
        margins[lo: lo + len(piece)] = mt
        if len(piece) < len(rows[lo: lo + bucket]):
            rest = rows[lo + len(piece): lo + bucket]
            margins[lo + len(piece): lo + bucket] = te.score_batch(
                te.parse_rows(rest), bucket)[0]
    np.testing.assert_allclose(margins, m64, rtol=0, atol=ATOL)


def test_engine_warm_and_describe(engines):
    _je, te, _rows, _ref = engines("LOGISTIC_REGRESSION")
    out = te.warm(BUCKETS)
    assert out["buckets"][-4:] == BUCKETS
    d = te.describe()
    assert d["device"] == "cpu"
    assert d["coordinates"] == {"global": "fixed_sparse",
                                "per_user": "re", "per_item": "re"}
    assert d["shards"]["global"] == {"form": "sparse", "dim": D}
    assert [s["spilled"] for s in d["entity_stores"]] == [True, True]


def test_engine_dense_fixed_effect_matches_jax():
    jm = _jax_model(seed=8)
    tm, task = _port(jm)
    rows = _requests(jm, seed=4, n=6)
    for r in rows:
        dense = np.zeros(D)
        for c, v in r["features"]["global"]:
            dense[c] = v
        r["features"]["global"] = [float(x) for x in dense]
    je = jeng.ScoringEngine(jm, JTask.LOGISTIC_REGRESSION,
                            dense_feature_shards=("global",))
    te = teng.ScoringEngine(tm, task, dense_feature_shards=("global",),
                            device="cpu")
    mj, pj, _ = je.score_batch(je.parse_rows(rows), 8)
    mt, pt, _ = te.score_batch(te.parse_rows(rows), 8)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=ATOL)


def _bad_rows(good: dict) -> list:
    def edit(fn):
        row = json.loads(json.dumps(good))
        fn(row)
        return [row]

    return [
        ([], "non-empty list"),
        (["not a dict"], "JSON object"),
        ([{"ids": {}}], "'features' object"),
        ([{"features": {"nope": []}, "ids": {}}], "unknown feature shard"),
        (edit(lambda r: r["features"].pop("item")),
         "missing feature shard"),
        (edit(lambda r: r["features"].__setitem__(
            "global", [[i, 1.0] for i in range(K + 1)])),
         "ell_row_capacity"),
        (edit(lambda r: r["features"].__setitem__(
            "global", [[D + 5, 1.0]])), r"in \[0, 64\)"),
        (edit(lambda r: r["features"].__setitem__("global", [["x"]])),
         "pairs"),
        (edit(lambda r: r["features"].__setitem__("user", [1.0])),
         "length-2 vector"),
        (edit(lambda r: r["ids"].pop("itemId")), "missing entity id"),
        (edit(lambda r: r["ids"].__setitem__("userId", "bob")),
         "must be an integer"),
        (edit(lambda r: r.__setitem__("offset", "much")), "offset"),
    ]


@pytest.mark.parametrize("case", range(12))
def test_bad_requests_match_jax(engines, case):
    je, te, rows, _ = engines("LOGISTIC_REGRESSION")
    bad, match = _bad_rows(rows[1])[case]
    with pytest.raises(jeng.BadRequest, match=match):
        je.parse_rows(bad)
    with pytest.raises(teng.BadRequest, match=match):
        te.parse_rows(bad)


def _projected_model(seed: int = 5) -> JGame:
    """``_jax_model`` with the per-item effect projected onto the sparse
    "global" shard: 3 subspace columns an entity, some padded with -1."""
    jm = _jax_model()
    rng = np.random.default_rng(seed)
    g = jm["per_item"].grouping
    fids, blocks = [], []
    for ne in g.n_entities:
        f = np.stack([rng.choice(D, 3, replace=False)
                      for _ in range(ne)]).astype(np.int32)
        f[rng.random(f.shape) < 0.2] = -1
        fids.append(f)
        blocks.append(jnp.asarray(rng.normal(0, 0.5, (ne, 3))
                                  .astype(np.float32)))
    jm.models["per_item"] = JRandom(
        coefficient_blocks=blocks, grouping=g, feature_shard="global",
        entity_key="itemId",
        projection=JProj(feature_ids=fids, global_dim=D))
    return jm


def _projected_requests(jm, n: int = N_ROWS) -> list[dict]:
    rows = _requests(jm, n=n)
    for r in rows:
        del r["features"]["item"]
    return rows


@pytest.mark.parametrize("bucket", [4, 8])
def test_engine_projected_random_effect_matches_jax(bucket):
    """A projected random effect folds into ``base`` on the host, as in
    the JAX engine: the port's margins within 1e-5 of the JAX engine's,
    and the per-item coordinate described as ``re_projected``."""
    jm = _projected_model()
    tm, task = _port(jm)
    rows = _projected_requests(jm)
    je = jeng.ScoringEngine(jm, JTask.LOGISTIC_REGRESSION,
                            ell_row_capacity=K)
    te = teng.ScoringEngine(tm, task, ell_row_capacity=K, device="cpu")
    assert te.describe()["coordinates"] == je.describe()["coordinates"]
    assert te.describe()["coordinates"]["per_item"] == "re_projected"
    for lo in range(0, len(rows), bucket):
        piece = rows[lo: lo + bucket - (lo // bucket) % 2]
        mj, pj, _ = je.score_batch(je.parse_rows(piece), bucket)
        mt, pt, _ = te.score_batch(te.parse_rows(piece), bucket)
        np.testing.assert_allclose(mt, mj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=ATOL)


def test_engine_defaults_to_cuda():
    tm, task = _port(_jax_model())
    if torch.cuda.is_available():
        assert teng.ScoringEngine(tm, task).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teng.ScoringEngine(tm, task)


def test_dataset_rows_matches_jax():
    from photon_ml_tpu.data.sparse_rows import SparseRows
    from photon_ml_tpu.game.dataset import GameDataset

    rng = np.random.default_rng(1)
    n = 5
    rows = SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * 2,
                                rng.integers(0, D, 2 * n),
                                rng.normal(size=2 * n).astype(np.float32))
    ds = GameDataset(labels=np.zeros(n, np.float32),
                     features={"global": rows,
                               "user": rng.normal(size=(n, 2))
                               .astype(np.float32)},
                     entity_ids={"userId": np.arange(n)},
                     offsets=rng.normal(size=n).astype(np.float32),
                     feature_dims={"global": D})
    assert teng.dataset_rows(ds, 1, 4) == jeng.dataset_rows(ds, 1, 4)


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------


class _FakeEngine:
    """Engine stand-in: echoes row payloads, records dispatch shapes."""

    version = "fake-1"

    def __init__(self, fail=False, delay_s=0.0):
        self.calls: list = []
        self.fail = fail
        self.delay_s = delay_s
        self._lock = threading.Lock()

    def score_batch(self, rows, bucket, trace=None):
        with self._lock:
            self.calls.append((len(rows), bucket))
        if self.fail:
            raise RuntimeError("device on fire")
        if self.delay_s:
            time.sleep(self.delay_s)
        vals = np.asarray(rows, np.float32)
        return vals, vals * 2.0, np.zeros(len(rows), bool)


def test_batcher_coalesces_concurrent_requests():
    eng = _FakeEngine(delay_s=0.01)
    batcher = MicroBatcher(lambda: eng, [1, 2, 4, 8], deadline_s=0.05,
                           max_queue=64)
    try:
        results: dict = {}

        def client(i):
            rows = [float(i * 10 + j) for j in range(2)]
            m, p, v, _deg = batcher.submit(rows, timeout_s=10.0)
            results[i] = (m.tolist(), p.tolist(), v)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 8
        for i, (m, p, v) in results.items():
            assert m == [i * 10.0, i * 10.0 + 1.0]
            assert p == [i * 20.0, i * 20.0 + 2.0]
            assert v == "fake-1"
        assert all(b in (1, 2, 4, 8) and n <= b for n, b in eng.calls)
        assert 2 <= len(eng.calls) < 8
        st = batcher.stats()
        assert st["rows"] == 16 and st["batches"] == len(eng.calls)
    finally:
        batcher.close()


def test_batcher_oversized_request_splits():
    eng = _FakeEngine()
    batcher = MicroBatcher(lambda: eng, [2, 4], deadline_s=0.0)
    try:
        m, _p, _v, _deg = batcher.submit([float(i) for i in range(11)],
                                         timeout_s=10.0)
        assert m.tolist() == [float(i) for i in range(11)]
        assert all(n <= 4 for n, _b in eng.calls)
        assert sum(n for n, _b in eng.calls) == 11
    finally:
        batcher.close()


def test_batcher_propagates_engine_errors_and_closes():
    eng = _FakeEngine(fail=True)
    batcher = MicroBatcher(lambda: eng, [4], deadline_s=0.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        batcher.submit([1.0], timeout_s=10.0)
    batcher.close()
    with pytest.raises(ServerClosing):
        batcher.submit([1.0], timeout_s=1.0)


def test_batcher_admission_control_sheds():
    eng = _FakeEngine(delay_s=0.05)
    batcher = MicroBatcher(lambda: eng, [2], deadline_s=0.0)
    try:
        batcher.submit([1.0], timeout_s=10.0)      # one timed batch
        with pytest.raises(ServerOverloaded) as err:
            batcher.submit([1.0] * 40, timeout_s=0.1)
        assert err.value.retry_after_s >= 1.0
        assert batcher.stats()["shed"] == 1
    finally:
        batcher.close()


def test_batcher_expires_queued_requests_past_deadline():
    now = [0.0]
    gate = threading.Event()

    class _Blocking(_FakeEngine):
        def score_batch(self, rows, bucket, trace=None):
            gate.wait(10.0)
            return super().score_batch(rows, bucket, trace)

    batcher = MicroBatcher(_Blocking, [1], deadline_s=0.0,
                           clock=lambda: now[0])
    try:
        out: dict = {}

        def client(name, timeout):
            try:
                out[name] = batcher.submit([1.0], timeout_s=timeout)
            except Exception as e:   # noqa: BLE001 - collected
                out[name] = e

        first = threading.Thread(target=client, args=("first", 10.0))
        first.start()
        time.sleep(0.1)             # the dispatcher holds "first"
        late = threading.Thread(target=client, args=("late", 1.0))
        late.start()
        time.sleep(0.1)
        now[0] = 5.0                # "late"'s deadline has passed
        gate.set()
        first.join()
        late.join()
        assert isinstance(out["late"], DeadlineExceeded)
        assert not isinstance(out["first"], Exception)
    finally:
        gate.set()
        batcher.close()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_serving_config_keys_match_jax_plus_device():
    jf = {f.name for f in dataclasses.fields(JServingConfig)}
    tf = {f.name for f in dataclasses.fields(ServingConfig)}
    assert tf == jf | {"device"}
    cfg = ServingConfig(model_dir="m")
    cfg.validate()
    assert (cfg.telemetry, cfg.monitor, cfg.trace, cfg.replicas,
            cfg.device) == ("metrics", "on", "on", 1, "cuda")
    assert cfg.buckets() == [1, 2, 4, 8, 16, 32, 64]


def test_serving_config_defaults_equal_jax():
    """Every field the packages share defaults to the same value."""
    jc, tc = JServingConfig(model_dir="m"), ServingConfig(model_dir="m")
    for f in dataclasses.fields(JServingConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name


@pytest.mark.parametrize("kw", [
    {"telemetry": "trace"}, {"telemetry": "off", "monitor": "off",
                             "trace": "off"},
    {"monitor": "on", "status_port": 0, "monitor_every_s": 0.5},
    {"trace": "on", "trace_threshold_ms": 0.0, "trace_sample_every": 0,
     "trace_buffer": 1},
    {"replicas": 2},
    {"replicas": 3, "restart_backoff_s": 0.0, "restart_backoff_max_s": 0.0,
     "breaker_threshold": 1},
])
def test_serving_config_tiers_validate(kw):
    """The tiers and the fleet validate in both packages alike."""
    ServingConfig(model_dir="m", **kw).validate()
    JServingConfig(model_dir="m", **kw).validate()


# Each fleet field at a value the reference rejects.
_FLEET_BAD = [
    ("probe_every_s", {"probe_every_s": 0}),
    ("probe_timeout_s", {"probe_timeout_s": -1.0}),
    ("unhealthy_after", {"unhealthy_after": 0}),
    ("restart_backoff_s", {"restart_backoff_s": -0.5}),
    ("restart_backoff_max_s", {"restart_backoff_s": 2.0,
                               "restart_backoff_max_s": 1.0}),
    ("breaker_threshold", {"breaker_threshold": 0}),
    ("breaker_window_s", {"breaker_window_s": 0}),
    ("breaker_reset_s", {"breaker_reset_s": -1}),
    ("replica_ready_timeout_s", {"replica_ready_timeout_s": 0}),
]


@pytest.mark.parametrize("field,kw", _FLEET_BAD,
                         ids=[f for f, _ in _FLEET_BAD])
def test_serving_config_fleet_checks_match_jax(field, kw):
    """The supervisor's knobs: both packages reject the same value with
    the same message (with replicas=2, where they drive the fleet)."""
    msgs = []
    for cls in (JServingConfig, ServingConfig):
        with pytest.raises(ValueError) as err:
            cls(model_dir="m", replicas=2, **kw).validate()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith(field)


@pytest.mark.parametrize("kw,exc,match", [
    ({"replicas": 0}, ValueError, "replicas"),
    ({"monitor": "maybe"}, ValueError, "monitor"),
    ({"monitor_every_s": 0}, ValueError, "monitor_every_s"),
    ({"status_port": 70000}, ValueError, "status_port"),
    ({"trace": "sometimes"}, ValueError, "trace"),
    ({"trace_threshold_ms": -1}, ValueError, "trace_threshold_ms"),
    ({"trace_sample_every": -1}, ValueError, "trace_sample_every"),
    ({"trace_buffer": 0}, ValueError, "trace_buffer"),
    ({"telemetry": "loud"}, ValueError, "telemetry"),
    ({"device": "tpu"}, ValueError, "device"),
    ({"batch_rows": 8, "batch_buckets": [4, 2, 8]}, ValueError,
     "ascending"),
    ({"batch_rows": 8, "batch_buckets": [2, 4]}, ValueError,
     "end at batch_rows"),
    ({"hot_swap_poll_s": -1}, ValueError, "hot_swap_poll_s"),
    ({"model_dir": ""}, ValueError, "model_dir"),
])
def test_serving_config_validation(kw, exc, match):
    kw = {"model_dir": "m", **kw}
    with pytest.raises(exc, match=match):
        ServingConfig(**kw).validate()


def test_serving_config_json_round_trip():
    cfg = ServingConfig(model_dir="m", batch_rows=32, batch_buckets=[8, 32],
                        batch_deadline_ms=1.5, spill_dir="/tmp/x",
                        hot_swap_poll_s=0.5, device="cpu",
                        compilation_cache_dir="ignored")
    assert serving_config_from_json(config_to_json(cfg)) == cfg
    with pytest.raises(ValueError, match="unknown config keys"):
        serving_config_from_json(json.dumps({"model_dir": "m", "nope": 1}))


# ---------------------------------------------------------------------------
# model server end to end (HTTP, device="cpu")
# ---------------------------------------------------------------------------


def _serve_cfg(mdir, tmp_path, **kw):
    kw.setdefault("batch_rows", 8)
    kw.setdefault("batch_deadline_ms", 1.0)
    kw.setdefault("ell_row_capacity", K)
    kw.setdefault("spill_dir", str(tmp_path / "spill"))
    kw.setdefault("entity_chunk", 4)
    kw.setdefault("hot_swap_poll_s", 0.0)
    kw.setdefault("device", "cpu")
    return ServingConfig(model_dir=mdir, port=0, **kw)


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def _post_score(port, rows):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/score",
        data=json.dumps({"rows": rows}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _jax_scores(jm, rows, task="LOGISTIC_REGRESSION"):
    je = jeng.ScoringEngine(jm, JTask(task), ell_row_capacity=K)
    m, p, _ = je.score_batch(je.parse_rows(rows), len(rows))
    return m, p


def test_server_healthz_warming_then_ready(tmp_path):
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    srv = ModelServer(_serve_cfg(mdir, tmp_path))
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.port, "/healthz")
        assert err.value.code == 503
        assert json.loads(err.value.read())["state"] == "warming"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post_score(srv.port, [{"features": {}}])
        assert err.value.code == 503
        srv.start()
        code, body = _get(srv.port, "/healthz")
        assert code == 200 and json.loads(body)["state"] == "ready"
        code, body = _get(srv.port, "/")
        assert code == 200 and json.loads(body)["ok"] is True
        code, body = _get(srv.port, "/metrics")
        assert code == 200 and "photon_serve_warm_s" in body
    finally:
        srv.stop()
    assert srv.readiness.state == "stopping"


def test_server_concurrent_clients_match_jax(tmp_path):
    """6 client threads over HTTP; every response equals the JAX
    engine's scores on the same rows (model saved by the JAX package)."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm)
    mj, pj = _jax_scores(jm, rows)
    m64, _ = _reference(jm, rows)
    srv = ModelServer(_serve_cfg(mdir, tmp_path)).start()
    try:
        errors: list = []
        results: dict = {}

        def client(c):
            try:
                for lo in range(c * 8, (c + 1) * 8, 4):
                    results[lo] = _post_score(srv.port, rows[lo:lo + 4])
            except Exception as e:   # noqa: BLE001 - collected
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        got_m = np.concatenate([results[lo]["margins"]
                                for lo in sorted(results)])
        got_p = np.concatenate([results[lo]["predictions"]
                                for lo in sorted(results)])
        np.testing.assert_allclose(got_m, mj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got_p, pj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got_m, m64, rtol=0, atol=ATOL)
        st = json.loads(_get(srv.port, "/status")[1])["serving"]
        assert st["batcher"]["rows"] == N_ROWS
        assert st["model"]["device"] == "cpu"
        assert st["state"] == "ready"
    finally:
        srv.stop()


def test_server_hot_swap_under_load_drops_nothing(tmp_path):
    jm1 = _jax_model(scale=1.0)
    jm2 = _jax_model(scale=-0.5)     # same structure, new weights
    mdir = str(tmp_path / "model")
    tio.save_game_model(*_port(jm1), mdir)
    rows = _requests(jm1, n=8)
    ref1, _ = _jax_scores(jm1, rows)
    ref2, _ = _jax_scores(jm2, rows)
    srv = ModelServer(_serve_cfg(mdir, tmp_path,
                                 hot_swap_poll_s=0.05)).start()
    try:
        stop = threading.Event()
        errors: list = []
        seen: list = []

        def hammer():
            while not stop.is_set():
                try:
                    out = _post_score(srv.port, rows)
                    m = np.asarray(out["margins"])
                    d1 = float(np.max(np.abs(m - ref1)))
                    d2 = float(np.max(np.abs(m - ref2)))
                    seen.append((out["model_version"],
                                 min(d1, d2) <= ATOL, d1 <= ATOL))
                except Exception as e:   # noqa: BLE001 - collected
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.35)
        tio.save_game_model(*_port(jm2), mdir)        # publish
        deadline = time.time() + 20.0
        while srv.swaps == 0 and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join()
        assert not errors, errors[:3]
        assert srv.swaps == 1
        assert len({v for v, _ok, _old in seen}) == 2
        assert all(ok for _v, ok, _old in seen)      # no torn response
        assert not seen[-1][2]                       # ends on model 2
    finally:
        srv.stop()


def test_server_corrupt_manifest_keeps_previous_model(tmp_path):
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=4)
    ref, _ = _jax_scores(jm, rows)
    srv = ModelServer(_serve_cfg(mdir, tmp_path,
                                 hot_swap_poll_s=0.05)).start()
    try:
        v1 = _post_score(srv.port, rows)["model_version"]
        time.sleep(0.05)
        with open(tio.model_manifest_path(mdir), "wb") as f:
            f.write(b"torn copy, not a zip")
        deadline = time.time() + 20.0
        while srv.swap_failures == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert srv.swap_failures >= 1
        out = _post_score(srv.port, rows)
        assert out["model_version"] == v1
        np.testing.assert_allclose(out["margins"], ref, rtol=0, atol=ATOL)
        st = json.loads(_get(srv.port, "/status")[1])["serving"]
        assert "last_swap_error" in st
    finally:
        srv.stop()


def test_server_bad_request_answers_400(tmp_path):
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    srv = ModelServer(_serve_cfg(mdir, tmp_path)).start()
    try:
        for body in (b"{not json", b'{"no_rows": 1}',
                     json.dumps({"rows": [{"features": {"x": []}}]})
                     .encode()):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/score", data=body)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=10)
            assert err.value.code == 400
        out = _post_score(srv.port, _requests(jm, n=2))
        assert out["n"] == 2
    finally:
        srv.stop()


def test_cli_serves_and_exits_cleanly_on_sigterm(tmp_path):
    """``python -m photon_ml_torch.serving --device cpu``: ready, one
    answered request, SIGTERM → rc 0 and a JSON last line."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    cfg_path = tmp_path / "serve.json"
    cfg_path.write_text(config_to_json(_serve_cfg(mdir, tmp_path,
                                                  device="cuda")))
    info = tmp_path / "info.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_torch.serving", "--config",
         str(cfg_path), "--device", "cpu", "--info-file", str(info)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 60.0
        port = None
        while time.time() < deadline:
            if port is None and info.exists():
                port = json.loads(info.read_text())["port"]
            if port is not None:
                try:
                    if _get(port, "/healthz")[0] == 200:
                        break
                except (urllib.error.URLError, ConnectionError):
                    pass
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.1)
        rows = _requests(jm, n=3)
        out = _post_score(port, rows)
        np.testing.assert_allclose(out["margins"], _jax_scores(jm, rows)[0],
                                   rtol=0, atol=ATOL)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    last = json.loads(stdout.strip().splitlines()[-1])
    assert last["rc"] == 0 and last["serving"]["batcher"]["rows"] == 3


# ---------------------------------------------------------------------------
# the serving tiers (telemetry, monitor, tracing) and the fault matrix,
# both packages' servers side by side
# ---------------------------------------------------------------------------


def _jserve_cfg(mdir, tmp_path, **kw):
    kw.pop("device", None)
    kw.setdefault("batch_rows", 8)
    kw.setdefault("batch_deadline_ms", 1.0)
    kw.setdefault("ell_row_capacity", K)
    kw.setdefault("spill_dir", str(tmp_path / "spill_jax"))
    kw.setdefault("entity_chunk", 4)
    kw.setdefault("hot_swap_poll_s", 0.0)
    return JServingConfig(model_dir=mdir, port=0, **kw)


def _server(pkg, mdir, tmp_path, run_logger=None, **kw):
    """A started-later ``ModelServer`` of ``pkg`` ("jax" or "port")."""
    if pkg == "port":
        return ModelServer(_serve_cfg(mdir, tmp_path, **kw),
                           run_logger=run_logger)
    from photon_ml_tpu.serving.server import ModelServer as JServer

    return JServer(_jserve_cfg(mdir, tmp_path, **kw),
                   run_logger=run_logger)


def _faults(pkg):
    if pkg == "port":
        from photon_ml_torch.reliability import faults
    else:
        from photon_ml_tpu.reliability import faults
    return faults


def _post_each(port, rows, size=4):
    """Requests of ``size`` rows, one after another → (margins, preds)."""
    outs = [_post_score(port, rows[lo: lo + size])
            for lo in range(0, len(rows), size)]
    return (np.concatenate([o["margins"] for o in outs]),
            np.concatenate([o["predictions"] for o in outs]))


def test_server_tiers_on_match_jax_and_tiers_off_bitwise(tmp_path):
    """With every tier on (the defaults), the port's served scores are
    bitwise its own with every tier off, and within 1e-5 of the JAX
    server's with every tier on."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm)
    got = {}
    for name, pkg, kw in (
            ("jax_on", "jax", {}),
            ("port_on", "port", {}),
            ("port_off", "port", {"telemetry": "off", "monitor": "off",
                                  "trace": "off"})):
        srv = _server(pkg, mdir, tmp_path, **kw).start()
        try:
            got[name] = _post_each(srv.port, rows)
            st = json.loads(_get(srv.port, "/status")[1])
        finally:
            srv.stop()
        assert ("tracing" in st["serving"]) == (name != "port_off")
        assert ("alerts" in st) == (name != "port_off")
    for i in range(2):
        np.testing.assert_array_equal(got["port_on"][i], got["port_off"][i])
        np.testing.assert_allclose(got["port_on"][i], got["jax_on"][i],
                                   rtol=0, atol=ATOL)


def test_server_projected_random_effect_matches_jax(tmp_path):
    """A model with a projected random effect, saved by the JAX package,
    is served by the port's server (every tier on) within 1e-5 of the
    JAX engine, and the projected term moves the margins."""
    jm = _projected_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _projected_requests(jm)
    mj, pj = _jax_scores(jm, rows)
    without = _jax_model()
    del without.models["per_item"]
    m_wo, _ = _jax_scores(without, [{**r, "ids": {"userId": r["ids"]
                                                  ["userId"]}}
                                    for r in rows])
    srv = ModelServer(_serve_cfg(mdir, tmp_path)).start()
    try:
        mt, pt = _post_each(srv.port, rows)
        st = json.loads(_get(srv.port, "/status")[1])["serving"]
    finally:
        srv.stop()
    assert st["model"]["coordinates"]["per_item"] == "re_projected"
    np.testing.assert_allclose(mt, mj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=ATOL)
    assert np.abs(mt - m_wo).max() > 0.05


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fault_slow_store_load_only_slows(tmp_path, pkg):
    """A slow ``serve.store_load`` is latency, not failure: the same
    scores, no row degraded."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=8)
    faults = _faults(pkg)
    srv = _server(pkg, mdir, tmp_path, monitor="off", trace="off").start()
    try:
        clean = _post_score(srv.port, rows)
        srv._current_engine().close()          # empty the chunk windows
        inj = faults.FaultInjector([faults.Fault(
            site="serve.store_load", kind="slow", at=0, count=4,
            delay_s=0.02)])
        with faults.injected(inj):
            slow = _post_score(srv.port, rows)
    finally:
        srv.stop()
    assert [f[1] for f in inj.fired] == ["slow"] * 4
    assert "degraded" not in slow
    assert slow["margins"] == clean["margins"]
    np.testing.assert_allclose(slow["margins"], _jax_scores(jm, rows)[0],
                               rtol=0, atol=ATOL)


def _failing_store_counts(pkg, tmp_path) -> dict:
    jm = _jax_model()
    mdir = str(tmp_path / pkg / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=4)
    unseen = json.loads(json.dumps(rows))
    for i, r in enumerate(unseen):
        r["ids"] = {"userId": 2 * 10 ** 9 + i, "itemId": -10 ** 9 - i}
    faults = _faults(pkg)
    srv = _server(pkg, mdir, tmp_path / pkg, monitor="off",
                  trace="off").start()
    try:
        ref = _post_score(srv.port, unseen)
        srv._current_engine().close()
        inj = faults.FaultInjector([faults.Fault(
            site="serve.store_load", kind="io_error", at=0, count=999)])
        with faults.injected(inj):
            out = _post_score(srv.port, rows)
        tel = srv._telemetry
        counts = {k: tel.counter(k) for k in (
            "serve.store_retries", "serve.store_gave_up",
            "serve.store_degraded", "serve.degraded_responses",
            "serve.requests", "serve.batches")}
    finally:
        srv.stop()
    return {"out": out, "ref": ref, "counts": counts,
            "fired": len(inj.fired)}


def test_fault_failing_store_load_degrades_after_retries(tmp_path):
    """A persistently failing ``serve.store_load`` retries, gives up and
    degrades: 200 with ``degraded``, every row scored as one of unseen
    entities (the fixed-effect-only fallback), and the same retry,
    give-up and degradation counts in both packages."""
    j = _failing_store_counts("jax", tmp_path)
    t = _failing_store_counts("port", tmp_path)
    assert t["out"]["degraded"] is True and j["out"]["degraded"] is True
    assert t["counts"] == j["counts"] and t["fired"] == j["fired"]
    assert t["counts"]["serve.store_gave_up"] >= 1
    assert t["counts"]["serve.store_retries"] == \
        2 * t["counts"]["serve.store_gave_up"]
    np.testing.assert_allclose(t["out"]["margins"], t["ref"]["margins"],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(t["out"]["margins"], j["out"]["margins"],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fault_dispatch_answers_500_then_200(tmp_path, pkg):
    """A failing ``serve.dispatch`` answers the batch 500 within a
    deadline, never a hang, with the trace headers; the next batch
    answers 200."""
    jm = _jax_model()
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm, n=2)
    faults = _faults(pkg)
    srv = _server(pkg, mdir, tmp_path).start()
    try:
        inj = faults.FaultInjector([faults.Fault(
            site="serve.dispatch", kind="error", at=0, count=1)])
        t0 = time.monotonic()
        with faults.injected(inj):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post_score(srv.port, rows)
        assert time.monotonic() - t0 < 10.0
        assert err.value.code == 500
        assert err.value.headers["X-Photon-Request-Id"]
        assert "injected fault" in json.loads(err.value.read())["error"]
        out = _post_score(srv.port, rows)
        np.testing.assert_allclose(out["margins"], _jax_scores(jm, rows)[0],
                                   rtol=0, atol=ATOL)
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fault_manifest_load_keeps_previous_model(tmp_path, pkg):
    """A ``serve.manifest_load`` fault that corrupts the published
    manifest fails the swap: the previous model keeps serving, and a
    clean publish then swaps."""
    jm1, jm2 = _jax_model(scale=1.0), _jax_model(scale=-0.5)
    mdir = str(tmp_path / "model")
    jio.save_game_model(jm1, JTask.LOGISTIC_REGRESSION, mdir)
    rows = _requests(jm1, n=4)
    faults = _faults(pkg)
    srv = _server(pkg, mdir, tmp_path, monitor="off", trace="off",
                  hot_swap_poll_s=0.05).start()
    try:
        v1 = _post_score(srv.port, rows)["model_version"]
        inj = faults.FaultInjector([faults.Fault(
            site="serve.manifest_load", kind="corrupt_file", at=0,
            count=1)])
        with faults.injected(inj):
            time.sleep(0.05)
            jio.save_game_model(jm2, JTask.LOGISTIC_REGRESSION, mdir)
            deadline = time.time() + 20.0
            while srv.swap_failures == 0 and time.time() < deadline:
                time.sleep(0.05)
        assert srv.swap_failures >= 1 and srv.swaps == 0
        assert inj.fired == [("serve.manifest_load", "corrupt_file", 0)]
        out = _post_score(srv.port, rows)
        assert out["model_version"] == v1
        np.testing.assert_allclose(out["margins"], _jax_scores(jm1, rows)[0],
                                   rtol=0, atol=ATOL)
        time.sleep(0.05)
        jio.save_game_model(jm2, JTask.LOGISTIC_REGRESSION, mdir)
        deadline = time.time() + 20.0
        while srv.swaps == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert srv.swaps == 1
        np.testing.assert_allclose(_post_score(srv.port, rows)["margins"],
                                   _jax_scores(jm2, rows)[0], rtol=0,
                                   atol=ATOL)
        # The corrupted manifest is a new signature too: one more failed
        # load may land before the clean publish.
        assert srv._telemetry.counter("serve.swap_failures") == \
            srv.swap_failures
    finally:
        srv.stop()
