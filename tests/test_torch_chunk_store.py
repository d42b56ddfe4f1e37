"""The port's out-of-core chunk store against the JAX package's.

Mirrors ``tests/test_chunk_store.py`` (less the mesh case and the GRR
store key, ROADMAP A7), the port on the CPU: chunks spill to atomic
content-keyed ``.npz`` files, an LRU host window bounds the decoded
chunks, and the prefetch thread feeds every sweep.  The contracts: a
spilled sweep equals the host-resident chunked one (value 1e-5
relative, vectors 1e-4·max|v|; the same chunk order, so the solves end
within 1e-5); the window bound and the visit order hold; corrupt or
missing files rebuild from lineage; spilled files are a warm-ETL
artifact; offsets stay out of the payload; ``invalidate`` quiesces the
prefetcher; errors from the prefetcher arrive in-band.  Two
cross-package tests: a spill dir written by either package loads warm
in the other, with zero rebuilds and equal arrays.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from photon_ml_torch.cache.plan_cache import atomic_savez
from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    TrainingConfig,
)
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.chunk_store import (
    ChunkStore,
    _open_npz_mmap,
    resolve_spill_dir,
)
from photon_ml_torch.data.chunked_batch import build_chunked_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    RegularizationType,
    SweptRegularization,
)
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.streaming import (
    ChunkedGLMObjective,
    ChunkPrefetcher,
    prefetch_stream,
    streaming_lbfgs_solve,
)

CPU = "cpu"
VALUE_RTOL = 1e-5
VECTOR_RTOL = 1e-4        # × max|v|
D = 900


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _sparse_problem(rng, n=2000, d=D, k=8):
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, n).astype(np.float32)
    offsets = rng.normal(0, 0.1, n).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * k
    rows = SparseRows.from_flat(indptr, cols.reshape(-1).astype(np.int64),
                                vals.reshape(-1))
    return rows, labels, weights, offsets


def _objective():
    return GLMObjective(loss=losses.LOGISTIC,
                        reg=RegularizationContext.l2(0.7),
                        norm=NormalizationContext.identity())


def _spilled(rng, tmp_path, n_chunks=6, window=2, depth=2, **prob_kw):
    rows, labels, weights, offsets = _sparse_problem(rng, **prob_kw)
    cb = build_chunked_batch(
        rows, D, labels, weights=weights, offsets=offsets,
        n_chunks=n_chunks, spill_dir=str(tmp_path / "spill"),
        host_max_resident=window)
    cobj = ChunkedGLMObjective(_objective(), cb, max_resident=0,
                               prefetch_depth=depth, device=CPU)
    return rows, labels, weights, offsets, cb, cobj


def _w(rng, shape=D):
    return torch.from_numpy(rng.normal(0, 0.2, shape).astype(np.float32))


def _close_vec(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VECTOR_RTOL * float(np.abs(want).max()))


def test_spilled_matches_resident(rng, tmp_path):
    """A spilled sweep equals the resident batch on every surface."""
    rows, labels, weights, offsets, cb, cobj = _spilled(rng, tmp_path)
    assert cb.store is not None and cb.store.spills == cb.n_chunks
    resident = make_sparse_batch(rows, D, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    obj = _objective()
    w, v = _w(rng), _w(rng)
    f_r, g_r = obj.value_and_gradient(w, resident)
    f_c, g_c = cobj.value_and_gradient(w)
    np.testing.assert_allclose(float(f_c), float(f_r), rtol=VALUE_RTOL)
    _close_vec(g_c, g_r)
    np.testing.assert_allclose(float(cobj.value(w)),
                               float(obj.value(w, resident)),
                               rtol=VALUE_RTOL)
    _close_vec(cobj.hessian_vector(w, v), obj.hessian_vector(w, v,
                                                             resident))
    _close_vec(cobj.hessian_diagonal(w), obj.hessian_diagonal(w, resident))
    _close_vec(cobj.predict_margins(w), obj.predict_margins(w, resident))


def test_spilled_swept_lanes_match_resident_chunked(rng, tmp_path):
    """The swept-λ surface over the disk tier equals the host-resident
    chunked one."""
    rows, labels, weights, offsets, cb, cobj = _spilled(rng, tmp_path)
    reg = SweptRegularization.from_grid(RegularizationType.L2,
                                        [3.0, 0.7, 0.05])
    co_res = ChunkedGLMObjective(
        _objective(), build_chunked_batch(rows, D, labels, weights=weights,
                                          offsets=offsets, n_chunks=6),
        max_resident=6, device=CPU)
    W = _w(rng, (3, D))
    F_r, G_r = co_res.value_and_gradient_swept(W, reg)
    F_s, G_s = cobj.value_and_gradient_swept(W, reg)
    np.testing.assert_allclose(F_s.numpy(), F_r.numpy(), rtol=VALUE_RTOL)
    _close_vec(G_s, G_r)
    np.testing.assert_allclose(cobj.value_swept(W, reg).numpy(),
                               co_res.value_swept(W, reg).numpy(),
                               rtol=VALUE_RTOL)


def test_streaming_solver_spilled_matches_ram_resident(rng, tmp_path):
    """The solve over the disk tier lands where the all-in-RAM chunked
    solve does: the same chunk order, so the same sums."""
    rows, labels, weights, offsets, cb, cobj = _spilled(rng, tmp_path)
    co_res = ChunkedGLMObjective(
        _objective(), build_chunked_batch(rows, D, labels, weights=weights,
                                          offsets=offsets, n_chunks=6),
        max_resident=6, device=CPU)
    cfg = OptimizerConfig(max_iters=40, tolerance=1e-5)
    res_r = streaming_lbfgs_solve(co_res.value_and_gradient,
                                  torch.zeros(D), cfg, value_fn=co_res.value)
    res_s = streaming_lbfgs_solve(cobj.value_and_gradient, torch.zeros(D),
                                  cfg, value_fn=cobj.value)
    np.testing.assert_allclose(float(res_s.value), float(res_r.value),
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(res_s.w.numpy(), res_r.w.numpy(), rtol=0,
                               atol=1e-3)
    assert cobj.sweeps == co_res.sweeps


def test_lru_bound_and_deterministic_order(rng, tmp_path):
    """Live decoded chunks never exceed ``host_max_resident``, and the
    store sees the chunks in sweep order, sweep after sweep."""
    *_, cb, cobj = _spilled(rng, tmp_path, n_chunks=8, window=2, depth=3)
    w = _w(rng)
    for _ in range(3):
        cobj.value_and_gradient(w)
    assert cb.store.peak_resident <= 2 and cb.store.n_resident <= 2
    assert cb.store.access_log == list(range(8)) * 3
    assert cb.store.rebuilds == 0


def test_corrupt_and_missing_chunk_fall_back_to_rebuild(rng, tmp_path):
    """A truncated or deleted chunk file is rebuilt from lineage and
    re-spilled; the sweep's value does not change."""
    rows, labels, weights, offsets, cb, cobj = _spilled(rng, tmp_path)
    resident = make_sparse_batch(rows, D, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    w = _w(rng)
    f_r = float(_objective().value(w, resident))
    with open(cb.store.path(3), "wb") as f:
        f.write(b"not a zip")
    os.remove(cb.store.path(5))
    np.testing.assert_allclose(float(cobj.value(w)), f_r, rtol=VALUE_RTOL)
    assert cb.store.rebuilds == 2
    np.testing.assert_allclose(float(cobj.value(w)), f_r, rtol=VALUE_RTOL)
    assert cb.store.rebuilds == 2


def test_spilled_store_is_warm_etl_artifact(rng, tmp_path):
    """The same dataset against the same spill dir writes nothing; other
    content keys another store."""
    rows, labels, weights, offsets, cb, cobj = _spilled(rng, tmp_path)
    w = _w(rng)
    f1 = float(cobj.value(w))
    mtimes = {i: os.path.getmtime(cb.store.path(i))
              for i in range(cb.n_chunks)}
    cb2 = build_chunked_batch(rows, D, labels, weights=weights,
                              offsets=offsets, n_chunks=6,
                              spill_dir=str(tmp_path / "spill"),
                              host_max_resident=2)
    assert cb2.store.spills == 0
    for i in range(cb2.n_chunks):
        assert os.path.getmtime(cb2.store.path(i)) == mtimes[i]
    cobj2 = ChunkedGLMObjective(_objective(), cb2, max_resident=0,
                                device=CPU)
    np.testing.assert_allclose(float(cobj2.value(w)), f1, rtol=1e-6)
    cb3 = build_chunked_batch(rows, D, labels, weights=weights * 2.0,
                              offsets=offsets, n_chunks=6,
                              spill_dir=str(tmp_path / "spill"),
                              host_max_resident=2)
    assert cb3.store.key != cb2.store.key
    assert cb3.store.spills == cb3.n_chunks


def test_set_offsets_external_to_spilled_payload(rng, tmp_path):
    """``set_offsets`` rewrites no chunk file, and the next sweep sees
    the new offsets."""
    rows, labels, weights, offsets, cb, cobj = _spilled(rng, tmp_path)
    w = _w(rng)
    cobj.value(w)
    mtimes = [os.path.getmtime(cb.store.path(i))
              for i in range(cb.n_chunks)]
    new_off = rng.normal(0, 0.3, cb.n).astype(np.float32)
    cb.set_offsets(new_off)
    cobj.invalidate()
    resident = make_sparse_batch(rows, D, labels, weights=weights,
                                 offsets=new_off, device=CPU)
    np.testing.assert_allclose(float(cobj.value(w)),
                               float(_objective().value(w, resident)),
                               rtol=VALUE_RTOL)
    assert [os.path.getmtime(cb.store.path(i))
            for i in range(cb.n_chunks)] == mtimes


def test_invalidate_interleaved_with_sweeps_stress(rng, tmp_path):
    """Sweeps, offset updates and invalidations interleaved on every
    surface: no prefetcher leaks, no reader is left behind, the values
    stay exact."""
    rows, labels, weights, offsets, cb, cobj = _spilled(
        rng, tmp_path, n_chunks=8, window=1, depth=3, n=1600)
    obj = _objective()
    w = _w(rng)
    base_threads = threading.active_count()
    for step in range(6):
        off = rng.normal(0, 0.2, cb.n).astype(np.float32)
        cb.set_offsets(off)
        cobj.invalidate()
        resident = make_sparse_batch(rows, D, labels, weights=weights,
                                     offsets=off, device=CPU)
        np.testing.assert_allclose(float(cobj.value(w)),
                                   float(obj.value(w, resident)),
                                   rtol=VALUE_RTOL)
        if step % 2:
            cobj.predict_margins(w)
        cobj.invalidate()
    assert threading.active_count() <= base_threads + 1
    cb.store.assert_quiesced()
    cb.store.drop_resident()
    assert cb.store.n_resident == 0


def test_store_asserts_on_unquiesced_free(tmp_path):
    """Freeing the window under an active reader is a loud error."""
    store = ChunkStore(str(tmp_path), "k", 1, host_max_resident=1)
    store.begin_read()
    with pytest.raises(RuntimeError, match="quiesce"):
        store.drop_resident()
    store.end_read()
    store.drop_resident()


def test_estimator_spilled_fit_matches_resident(rng, tmp_path):
    """``GameEstimator`` with ``spill_dir`` equals the host-resident
    chunked fit, through the swept λ grid and the transformer."""
    n, d, k = 800, 100, 5
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    m = np.einsum("nk,nk->n", vals, rng.normal(0, 1, d)[cols])
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    ds = GameDataset(labels=y, features={"f": [(cols[i], vals[i])
                                               for i in range(n)]},
                     entity_ids={}, feature_dims={"f": d})

    def cfg(**kw):
        return TrainingConfig(
            task_type=TaskType.LOGISTIC_REGRESSION,
            coordinates=[CoordinateConfig(
                name="global", kind=CoordinateKind.FIXED_EFFECT,
                feature_shard="f",
                optimizer=OptimizerSettings(max_iters=40, reg_weight=1.0))],
            update_sequence=["global"], n_iterations=1,
            reg_weight_grid={"global": [2.0, 0.5]},
            validation_fraction=0.0, validate_per_iteration=False,
            intercept=False, chunk_rows=192, chunk_layout="ELL",
            device=CPU, **kw)

    fits_r = GameEstimator(cfg(chunk_max_resident=8)).fit(ds)
    fits_s = GameEstimator(cfg(
        spill_dir=str(tmp_path / "est_spill"), host_max_resident=1,
        prefetch_depth=2, chunk_max_resident=0)).fit(ds)
    assert len(fits_s) == len(fits_r) == 2
    for fr, fs in zip(fits_r, fits_s):
        np.testing.assert_allclose(
            fs.model.models["global"].coefficients.means.numpy(),
            fr.model.models["global"].coefficients.means.numpy(),
            rtol=0, atol=5e-3)
    spill_root = tmp_path / "est_spill" / "chunks"
    assert spill_root.is_dir() and any(spill_root.iterdir())


def test_spill_config_validation():
    base = dict(task_type=TaskType.LOGISTIC_REGRESSION,
                coordinates=[CoordinateConfig(
                    name="g", kind=CoordinateKind.FIXED_EFFECT,
                    feature_shard="f", optimizer=OptimizerSettings())],
                update_sequence=["g"], device=CPU)
    with pytest.raises(ValueError, match="spill_dir"):
        TrainingConfig(spill_dir="/tmp/s", **base).validate()
    with pytest.raises(ValueError, match="host_max_resident"):
        TrainingConfig(chunk_rows=100, spill_dir="/tmp/s",
                       host_max_resident=0, **base).validate()
    with pytest.raises(ValueError, match="prefetch_depth"):
        TrainingConfig(chunk_rows=100, prefetch_depth=-1, **base).validate()
    TrainingConfig(chunk_rows=100, spill_dir="/tmp/s", host_max_resident=2,
                   prefetch_depth=0, **base).validate()


def test_env_spill_default_applies_at_config_layer_only(rng, tmp_path,
                                                        monkeypatch):
    """``$PHOTON_ML_TPU_SPILL_DIR`` flows through the config layer only:
    a direct ``build_chunked_batch`` call stays resident."""
    rows, labels, _, _ = _sparse_problem(rng, n=400, d=50, k=4)
    monkeypatch.setenv("PHOTON_ML_TPU_SPILL_DIR", str(tmp_path / "env"))
    cb = build_chunked_batch(rows, 50, labels, n_chunks=2)
    assert cb.store is None
    assert not (tmp_path / "env").exists()
    assert resolve_spill_dir(None) == str(tmp_path / "env")
    cb2 = build_chunked_batch(rows, 50, labels, n_chunks=2,
                              spill_dir=resolve_spill_dir(None))
    assert cb2.store is not None


def test_mmap_npz_roundtrip(tmp_path):
    """The member reader returns exactly what was saved, as file-backed
    views."""
    arrays = {"a": np.arange(1000, dtype=np.int32).reshape(50, 20),
              "b": np.linspace(0, 1, 37, dtype=np.float32),
              "c": np.zeros(0, np.float32)}
    path = str(tmp_path / "x" / "t.npz")
    atomic_savez(path, {"hello": 1}, arrays)
    out = _open_npz_mmap(path)
    for name, a in arrays.items():
        assert isinstance(out[name], np.memmap)
        np.testing.assert_array_equal(np.asarray(out[name]), a)
    assert json.loads(bytes(np.asarray(out["__meta__"])))["hello"] == 1


def test_prefetcher_error_delivered_in_band():
    """A producer failure surfaces at the consumer's ``next()`` as the
    original exception."""
    def load(i):
        if i == 2:
            raise OSError("disk went away")
        return np.full(4, i, np.float32)

    pf = ChunkPrefetcher(load, lambda h: h, depth=2)
    pf.start(range(4))
    try:
        assert pf.next(0)[0] == 0
        assert pf.next(1)[0] == 1
        with pytest.raises(OSError, match="disk went away"):
            pf.next(2)
    finally:
        pf.close()


def test_prefetch_stream_error_and_cleanup(tmp_path):
    """The same through the generator: the error raises at the failing
    chunk and the store's reader count drains to zero."""
    store = ChunkStore(str(tmp_path), "k", n_chunks=3)

    def load(i):
        if i == 1:
            raise ValueError("bad chunk")
        return i

    with pytest.raises(ValueError, match="bad chunk"):
        for _i, _c in prefetch_stream(load, lambda h: h, range(3), depth=2,
                                      store=store):
            pass
    store.assert_quiesced()


def _ref_build(rows, labels, weights, spill, **kw):
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from photon_ml_tpu.data.sparse_rows import SparseRows as JRows

    jrows = JRows.from_flat(rows.indptr, rows.cols.astype(np.int64),
                            rows.vals)
    return jbuild(jrows, D, labels, weights=weights, layout="ell",
                  spill_dir=spill, **kw)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_spill_dir_shared_between_packages(rng, tmp_path, first):
    """A spill dir written by one package loads warm in the other: the
    same content keys and file names, zero chunks built or rebuilt on
    the second side, and the decoded chunks equal leaf for leaf."""
    rows, labels, weights, _ = _sparse_problem(rng, n=1000)
    spill = str(tmp_path / "spill")
    kw = dict(n_chunks=4, host_max_resident=2)
    if first == "jax":
        writer = _ref_build(rows, labels, weights, spill, **kw)
        reader = build_chunked_batch(rows, D, labels, weights=weights,
                                     spill_dir=spill, **kw)
    else:
        writer = build_chunked_batch(rows, D, labels, weights=weights,
                                     spill_dir=spill, **kw)
        reader = _ref_build(rows, labels, weights, spill, **kw)
    assert writer.store.key == reader.store.key
    assert writer.store.spills == writer.n_chunks
    assert reader.store.spills == 0
    for i in range(reader.n_chunks):
        assert reader.store.path(i) == writer.store.path(i)
        got, want = reader.chunk(i), writer.chunk(i)
        for leaf in ("values", "col_ids", "labels", "weights", "offsets",
                     "mask"):
            np.testing.assert_array_equal(np.asarray(getattr(got, leaf)),
                                          np.asarray(getattr(want, leaf)))
    assert reader.store.rebuilds == 0
    assert len(os.listdir(os.path.join(spill, "chunks"))) == \
        reader.n_chunks


def test_staging_reads_spilled_members(tmp_path):
    """The card's staging reads a whole memory-mapped member of a spill
    file by positioned reads, in parts, exactly; a view into a member
    is not taken for one."""
    from photon_ml_torch.optim import streaming

    rng = np.random.default_rng(0)
    a = rng.normal(size=(300_000, 31)).astype(np.float32)   # 37 MB: parts
    b = np.arange(1000, dtype=np.int32)
    path = str(tmp_path / "x.npz")
    atomic_savez(path, {"k": 1}, {"a": a, "b": b})
    m = _open_npz_mmap(path)
    assert streaming._file_member(m["a"]) and streaming._file_member(m["b"])
    assert not streaming._file_member(m["a"][1:])
    assert not streaming._file_member(np.asarray(m["b"]))
    va, vb = np.empty_like(a), np.empty_like(b)
    streaming._read_members([(va, m["a"].filename, m["a"].offset),
                             (vb, m["b"].filename, m["b"].offset)])
    np.testing.assert_array_equal(va, a)
    np.testing.assert_array_equal(vb, b)
    short = np.empty(len(b) + 8, np.int32)
    with pytest.raises(OSError, match="short read"):
        streaming._read_members([(short, m["b"].filename,
                                  os.path.getsize(path) - b.nbytes)])
