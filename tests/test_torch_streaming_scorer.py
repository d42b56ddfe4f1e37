"""The port's streamed GAME scorer against the JAX package's.

The cases of ``tests/test_scoring_stream.py`` and the scorer's case of
``tests/test_reliability.py``, run through both packages on the same
seeded numpy data (every coordinate kind at once: a sparse fixed effect
with an intercept, a dense fixed effect, a random effect with unseen
entities and a projected random effect with out-of-space features, plus
offsets), the port on the CPU.  Tolerances: streamed margins within 1e-5
of the JAX package's streamed margins (float32, sums in another order)
and within 2e-4 of the resident transform's (the reference's own bound:
the resident fixed effect sums in float64); streaming evaluations within
1e-6 of the JAX package's; Avro sinks byte-identical given the same
arrays and sync marker.  A spill dir written by either package loads in
the other.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.estimators.streaming_scorer import StreamingGameScorer
from photon_ml_torch.evaluation.evaluators import EvaluatorType, evaluate
from photon_ml_torch.evaluation.streaming import (
    StreamingAUC,
    make_streaming_evaluator,
)
from photon_ml_torch.io.score_sink import AvroScoreSink, NpzScoreSink
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.reliability import faults
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

CPU = "cpu"
MARGIN_ATOL = 1e-5           # port streamed vs JAX streamed
RESIDENT_ATOL = 2e-4         # streamed vs resident (float64 host sums)
EVAL_ATOL = 1e-6             # streaming evaluations across packages


def _mixed_arrays(rng, n=1000) -> dict:
    """The draws of ``tests/test_scoring_stream.py``'s ``_mixed_workload``
    as numpy arrays."""
    from photon_ml_tpu.game.dataset import group_by_entity

    d = 50
    a = {"n": n, "d": d}
    a["indptr"] = np.arange(n + 1) * 5
    a["cols"] = rng.integers(0, d, n * 5).astype(np.int64)
    a["vals"] = rng.normal(size=n * 5)
    a["x_dense"] = rng.normal(size=(n, 7)).astype(np.float32)
    a["x_re"] = rng.normal(size=(n, 3)).astype(np.float32)
    ids = rng.integers(0, 20, n)
    ids[0] = 10**9                       # unseen entity scores 0
    a["ids"] = ids
    a["re_train_ids"] = ids[ids < 10**9][:800]
    a["blocks"] = [rng.normal(size=(ne, 3)).astype(np.float32) for ne in
                   group_by_entity(a["re_train_ids"]).n_entities]
    G = 40
    rows_p = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        c = np.sort(rng.choice(G + 3, k, replace=False)).astype(np.int64)
        rows_p.append((c, rng.normal(size=k).astype(np.float32)))
    a["rows_p"] = rows_p
    ids2 = rng.integers(0, 12, n)
    a["ids2"] = ids2
    g2 = group_by_entity(ids2[:700])
    a["G"] = G
    a["feature_ids"] = [
        np.where(rng.uniform(size=(ne, 4)) < 0.8,
                 rng.integers(0, G, (ne, 4)), -1).astype(np.int32)
        for ne in g2.n_entities]
    a["blocks2"] = [rng.normal(size=(ne, 4)).astype(np.float32)
                    for ne in g2.n_entities]
    a["w"] = rng.normal(size=d + 1).astype(np.float32)
    a["w_dense"] = rng.normal(size=8).astype(np.float32)
    a["labels"] = (rng.uniform(size=n) < 0.5).astype(np.float32)
    a["weights"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    a["offsets"] = rng.normal(size=n).astype(np.float32)
    return a


def _workload(pkg: str, a: dict):
    """(model, dataset) of ``a`` in ``pkg`` ("torch" or "jax")."""
    if pkg == "torch":
        from photon_ml_torch.data.sparse_rows import SparseRows as SR
        from photon_ml_torch.game import dataset as gd
        from photon_ml_torch.game.projector import SubspaceProjection
        from photon_ml_torch.models import game as mg
        from photon_ml_torch.models.coefficients import Coefficients

        def arr(x):
            return torch.from_numpy(np.array(x))
    else:
        import jax.numpy as jnp

        from photon_ml_tpu.data.sparse_rows import SparseRows as SR
        from photon_ml_tpu.game import dataset as gd
        from photon_ml_tpu.game.projector import SubspaceProjection
        from photon_ml_tpu.models import game as mg
        from photon_ml_tpu.models.coefficients import Coefficients

        arr = jnp.asarray
    grouping = gd.group_by_entity(a["re_train_ids"])
    g2 = gd.group_by_entity(a["ids2"][:700])
    model = mg.GameModel(models={
        "global": mg.FixedEffectModel(
            coefficients=Coefficients(means=arr(a["w"])),
            feature_shard="sparse", intercept=True),
        "ctx": mg.FixedEffectModel(
            coefficients=Coefficients(means=arr(a["w_dense"])),
            feature_shard="dense", intercept=True),
        "per_user": mg.RandomEffectModel(
            coefficient_blocks=[arr(b) for b in a["blocks"]],
            grouping=grouping, feature_shard="re", entity_key="userId"),
        "per_item": mg.RandomEffectModel(
            coefficient_blocks=[arr(b) for b in a["blocks2"]], grouping=g2,
            feature_shard="proj", entity_key="itemId",
            projection=SubspaceProjection(
                feature_ids=[f.copy() for f in a["feature_ids"]],
                global_dim=a["G"])),
    })
    dataset = gd.GameDataset(
        labels=a["labels"].copy(),
        features={"sparse": SR.from_flat(a["indptr"], a["cols"], a["vals"]),
                  "dense": a["x_dense"].copy(), "re": a["x_re"].copy(),
                  "proj": SR.from_rows(a["rows_p"])},
        entity_ids={"userId": a["ids"].copy(), "itemId": a["ids2"].copy()},
        weights=a["weights"].copy(), offsets=a["offsets"].copy())
    return model, dataset


def _both(rng, n=1000):
    a = _mixed_arrays(rng, n)
    return _workload("torch", a), _workload("jax", a)


def _jtask(task: TaskType):
    from photon_ml_tpu.models.glm import TaskType as JTask

    return JTask(task.value)


def _ref_scorer(model, task: TaskType, **kw):
    from photon_ml_tpu.estimators.streaming_scorer import (
        StreamingGameScorer as JScorer,
    )

    return JScorer(model, _jtask(task), **kw)


def _sub(model, name):
    return type(model)(models={name: model.models[name]})


# -- tests/test_scoring_stream.py:103-140: streamed against resident ---------------------


@pytest.mark.parametrize("chunk_rows", [64, 96, 128, 1000, 4096])
def test_streamed_matches_resident_all_mixes(rng, chunk_rows):
    """Every coordinate mix at once, on even and uneven chunk grids, a
    single chunk and a padded tail: the port's streamed margins equal
    its resident transform's and the JAX package's streamed margins.
    At 96 rows the JAX package's chunk program has the shapes of its own
    compile-budget test (``tests/test_scoring_stream.py``), which must
    still see it compile when it runs after this file (ROADMAP C5)."""
    (model, ds), (jmodel, jds) = _both(rng)
    task = TaskType.LOGISTIC_REGRESSION
    tr = GameTransformer(model=model, task=task, device=CPU)
    m_str = tr.transform_streamed(ds, score_chunk_rows=chunk_rows)
    np.testing.assert_allclose(m_str, tr.transform(ds), atol=RESIDENT_ATOL)
    from photon_ml_tpu.estimators.game_transformer import (
        GameTransformer as JT,
    )

    ref = JT(model=jmodel, task=_jtask(task)).transform_streamed(
        jds, score_chunk_rows=chunk_rows)
    np.testing.assert_allclose(m_str, ref, atol=MARGIN_ATOL)


@pytest.mark.parametrize("name", ["global", "ctx", "per_user", "per_item"])
def test_streamed_single_coordinate_mixes(rng, name):
    """Each coordinate kind alone."""
    (model, ds), (jmodel, jds) = _both(rng, n=500)
    task = TaskType.LINEAR_REGRESSION
    tr = GameTransformer(model=_sub(model, name), task=task, device=CPU)
    got = tr.transform_streamed(ds, score_chunk_rows=64)
    np.testing.assert_allclose(got, tr.transform(ds), atol=RESIDENT_ATOL)
    ref = _ref_scorer(_sub(jmodel, name), task, chunk_rows=64).score(
        jds, keep_margins=True)["margins"]
    np.testing.assert_allclose(got, ref, atol=MARGIN_ATOL)


def test_streamed_sparse_random_effect_features(rng):
    """A random effect over a sparse shard densifies a chunk at a time
    (``SparseRows.to_dense``), in both packages alike."""
    a = _mixed_arrays(rng, n=300)
    rows_re = [(np.sort(rng.choice(3, 2, replace=False)).astype(np.int64),
                rng.normal(size=2).astype(np.float32)) for _ in range(300)]
    out = {}
    for pkg in ("torch", "jax"):
        model, ds = _workload(pkg, a)
        ds.features["re"] = type(ds.features["sparse"]).from_rows(rows_re)
        sub = _sub(model, "per_user")
        scorer = (StreamingGameScorer(sub, TaskType.LINEAR_REGRESSION,
                                      chunk_rows=64, device=CPU)
                  if pkg == "torch" else
                  _ref_scorer(sub, TaskType.LINEAR_REGRESSION, chunk_rows=64))
        out[pkg] = scorer.score(ds, keep_margins=True)["margins"]
    np.testing.assert_allclose(out["torch"], out["jax"], atol=MARGIN_ATOL)


def test_streamed_predictions_mean_space(rng):
    """The task mean is applied a chunk at a time."""
    (model, ds), _ = _both(rng, n=300)
    scorer = StreamingGameScorer(model, TaskType.LOGISTIC_REGRESSION,
                                 chunk_rows=64, device=CPU)
    out = scorer.score(ds, keep_margins=True)
    np.testing.assert_allclose(
        out["predictions"],
        1.0 / (1.0 + np.exp(-out["margins"].astype(np.float64))),
        atol=1e-6)


# -- tests/test_scoring_stream.py:130-166: the spill store -------------------------------


def test_streamed_spill_window_bounded_and_warm(rng, tmp_path):
    """Spilled: margins as resident, the host window's bound holds, and
    a second scorer over the same content reuses the chunk files."""
    (model, ds), _ = _both(rng)
    task = TaskType.LOGISTIC_REGRESSION
    m_res = GameTransformer(model=model, task=task, device=CPU).transform(ds)
    scorer = StreamingGameScorer(
        model, task, chunk_rows=100, spill_dir=str(tmp_path),
        host_max_resident=1, prefetch_depth=2, device=CPU)
    out = scorer.score(ds, keep_margins=True)
    np.testing.assert_allclose(out["margins"], m_res, atol=RESIDENT_ATOL)
    assert out["n_chunks"] == 10
    assert out["store"]["spills"] == 10
    assert out["store"]["peak_resident"] == 1
    scorer.store.assert_quiesced()

    scorer2 = StreamingGameScorer(
        model, task, chunk_rows=100, spill_dir=str(tmp_path),
        host_max_resident=2, prefetch_depth=0, device=CPU)
    out2 = scorer2.score(ds, keep_margins=True)
    assert out2["store"]["spills"] == 0          # warm reuse
    np.testing.assert_array_equal(out2["margins"], out["margins"])


def test_streamed_corrupt_chunk_rebuilds(rng, tmp_path):
    """A corrupted spilled chunk rebuilds from lineage."""
    (model, ds), _ = _both(rng, n=400)
    task = TaskType.LOGISTIC_REGRESSION
    kw = dict(chunk_rows=100, spill_dir=str(tmp_path), host_max_resident=1,
              device=CPU)
    out = StreamingGameScorer(model, task, **kw).score(ds, keep_margins=True)
    chunk_dir = tmp_path / "chunks"
    victim = sorted(os.listdir(chunk_dir))[2]
    with open(chunk_dir / victim, "wb") as f:
        f.write(b"garbage")
    scorer2 = StreamingGameScorer(model, task, **kw)
    out2 = scorer2.score(ds, keep_margins=True)
    np.testing.assert_array_equal(out2["margins"], out["margins"])
    assert out2["store"]["loads"] > 0 and scorer2.store.rebuilds == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_dir_loads_in_either_package(rng, tmp_path, writer):
    """The store key and the chunk members are the JAX package's: a
    spill dir one package wrote is read by the other without a rebuild,
    and its margins are the other's own within 1e-5."""
    (model, ds), (jmodel, jds) = _both(rng, n=500)
    task = TaskType.LOGISTIC_REGRESSION
    kw = dict(chunk_rows=128, spill_dir=str(tmp_path), host_max_resident=2)

    def port():
        return StreamingGameScorer(model, task, device=CPU, **kw), ds

    def ref():
        return _ref_scorer(jmodel, task, **kw), jds

    first, second = (ref, port) if writer == "jax" else (port, ref)
    s1, d1 = first()
    out1 = s1.score(d1, keep_margins=True)
    files = sorted(os.listdir(tmp_path / "chunks"))
    assert out1["store"]["spills"] == 4 and len(files) == 4
    s2, d2 = second()
    out2 = s2.score(d2, keep_margins=True)
    assert out2["store"]["spills"] == 0
    assert out2["store"]["loads"] + out2["store"]["hits"] == 4
    assert sorted(os.listdir(tmp_path / "chunks")) == files
    np.testing.assert_allclose(out2["margins"], out1["margins"],
                               atol=MARGIN_ATOL)


# -- tests/test_scoring_stream.py:169-258: the streaming evaluators ----------------------


def _eval_data(rng, n):
    m = rng.normal(size=n).astype(np.float32)
    p = (1.0 / (1.0 + np.exp(-m))).astype(np.float32)
    y = (rng.uniform(size=n) < p).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return m, p, y, w


@pytest.mark.parametrize("ev", list(EvaluatorType), ids=lambda e: e.value)
def test_streaming_evaluators_match_oneshot(rng, ev):
    """Chunked updates give the port's one-shot evaluator (AUC exactly,
    the losses to float tolerance) and the JAX package's streaming
    evaluator within 1e-6."""
    from photon_ml_tpu.evaluation.evaluators import EvaluatorType as JE
    from photon_ml_tpu.evaluation.streaming import (
        make_streaming_evaluator as jmake,
    )

    n = 5000
    m, p, y, w = _eval_data(rng, n)
    acc, jacc = make_streaming_evaluator(ev), jmake(JE(ev.value))
    for lo in range(0, n, 777):
        hi = min(lo + 777, n)
        acc.update(m[lo:hi], p[lo:hi], y[lo:hi], w[lo:hi])
        jacc.update(m[lo:hi], p[lo:hi], y[lo:hi], w[lo:hi])
    scores = p if ev.value in ("RMSE", "SQUARED_LOSS") else m
    one = float(evaluate(ev, torch.from_numpy(scores), torch.from_numpy(y),
                         torch.from_numpy(w)))
    assert abs(acc.result() - one) < 5e-5
    assert abs(acc.result() - jacc.result()) < EVAL_ATOL


@pytest.mark.parametrize("exact_below", [0, 10000])
def test_streaming_auc_histogram_tolerance(rng, exact_below):
    """The histogram regime (forced, also after a mid-stream switch):
    within the documented 1e-3 of the exact AUC, and within 1e-6 of the
    JAX package's histogram."""
    from photon_ml_tpu.evaluation.streaming import StreamingAUC as JAUC

    n = 50000
    m = (rng.normal(size=n) * 3).astype(np.float32)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    from photon_ml_torch.evaluation.evaluators import auc

    ref = float(auc(torch.from_numpy(m), torch.from_numpy(y),
                    torch.from_numpy(w)))
    acc, jacc = StreamingAUC(exact_below=exact_below), JAUC(
        exact_below=exact_below)
    for lo in range(0, n, 4096):
        hi = min(lo + 4096, n)
        acc.update(m[lo:hi], y[lo:hi], w[lo:hi])
        jacc.update(m[lo:hi], y[lo:hi], w[lo:hi])
    assert not acc.exact and not jacc.exact
    assert abs(acc.result() - ref) < 1e-3
    assert abs(acc.result() - jacc.result()) < EVAL_ATOL


def test_streaming_auc_exact_below_threshold(rng):
    """Below the threshold the streaming AUC is the one-shot evaluator's
    answer, and the JAX package's within 1e-6."""
    from photon_ml_tpu.evaluation.streaming import StreamingAUC as JAUC
    from photon_ml_torch.evaluation.evaluators import auc

    n = 3000
    m = rng.normal(size=n).astype(np.float32)
    y = (rng.uniform(size=n) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    acc, jacc = StreamingAUC(), JAUC()
    for lo in range(0, n, 500):
        acc.update(m[lo:lo + 500], y[lo:lo + 500], w[lo:lo + 500])
        jacc.update(m[lo:lo + 500], y[lo:lo + 500], w[lo:lo + 500])
    assert acc.exact
    one = float(auc(torch.from_numpy(m), torch.from_numpy(y),
                    torch.from_numpy(w)))
    assert acc.result() == one
    assert abs(acc.result() - jacc.result()) < EVAL_ATOL


def test_scorer_streaming_evaluation_matches_driver_convention(rng):
    """Through the scorer: each streaming evaluation equals the one-shot
    evaluation of the resident margins under the driver's conventions
    (5e-4, the reference's bound), and the JAX package's scorer's within
    1e-6."""
    from photon_ml_tpu.evaluation.evaluators import EvaluatorType as JE
    from photon_ml_tpu.evaluation.streaming import (
        make_streaming_evaluator as jmake,
    )

    (model, ds), (jmodel, jds) = _both(rng)
    task = TaskType.LOGISTIC_REGRESSION
    kinds = ("AUC", "RMSE", "LOGISTIC_LOSS")
    margins = GameTransformer(model=model, task=task,
                              device=CPU).transform(ds)
    preds = 1.0 / (1.0 + np.exp(-margins.astype(np.float64)))
    out = StreamingGameScorer(model, task, chunk_rows=128, device=CPU).score(
        ds, evaluators=[make_streaming_evaluator(EvaluatorType(k))
                        for k in kinds])
    jout = _ref_scorer(jmodel, task, chunk_rows=128).score(
        jds, evaluators=[jmake(JE(k)) for k in kinds])
    y, w = torch.from_numpy(ds.labels), torch.from_numpy(ds.weights)
    assert set(out["evaluation"]) == set(kinds)
    for k, got in out["evaluation"].items():
        scores = preds if k in ("RMSE", "SQUARED_LOSS") else margins
        one = float(evaluate(EvaluatorType(k),
                             torch.from_numpy(scores.astype(np.float32)),
                             y, w))
        assert abs(got - one) < 5e-4, k
        assert abs(got - jout["evaluation"][k]) < EVAL_ATOL, k


# -- tests/test_scoring_stream.py:266-332: the sinks, through the scorer -----------------


def test_streamed_sinks_round_trip(rng, tmp_path, monkeypatch):
    """A pass into an ``.npz`` and an Avro sink at once: the ``.npz``
    holds the kept margins, predictions and labels, the Avro records
    the predictions in order with their entity ids, one block a chunk;
    the JAX package's pass gives the same files within 1e-6; and the
    two packages' Avro sinks, fed the same arrays and sync marker, write
    the same bytes."""
    from photon_ml_tpu.io.avro import read_container as jread
    from photon_ml_tpu.io.score_sink import AvroScoreSink as JAvro
    from photon_ml_tpu.io.score_sink import NpzScoreSink as JNpz
    from photon_ml_torch.io.avro import read_container

    (model, ds), (jmodel, jds) = _both(rng, n=700)
    task = TaskType.LOGISTIC_REGRESSION
    monkeypatch.setattr(os, "urandom", lambda k: bytes(range(k)))
    got = {}
    for pkg in ("torch", "jax"):
        npz, avro = (str(tmp_path / f"{pkg}.npz"),
                     str(tmp_path / f"{pkg}.avro"))
        if pkg == "torch":
            sinks = [NpzScoreSink(npz, ds.n),
                     AvroScoreSink(avro, ids_keys=("userId", "itemId"))]
            scorer = StreamingGameScorer(model, task, chunk_rows=256,
                                         device=CPU)
            got[pkg] = scorer.score(ds, sinks=sinks, keep_margins=True)
        else:
            sinks = [JNpz(npz, jds.n),
                     JAvro(avro, ids_keys=("userId", "itemId"))]
            _ref_scorer(jmodel, task, chunk_rows=256).score(jds, sinks=sinks)
        assert sinks[1].blocks_written == 3
    out, ref = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(out["scores"], got["torch"]["margins"])
    np.testing.assert_array_equal(out["predictions"],
                                  got["torch"]["predictions"])
    np.testing.assert_array_equal(out["labels"], ds.labels)
    for k in ("scores", "predictions"):
        np.testing.assert_allclose(out[k], ref[k], atol=EVAL_ATOL)
    _, recs = read_container(str(tmp_path / "torch.avro"))
    _, jrecs = jread(str(tmp_path / "jax.avro"))
    recs, jrecs = list(recs), list(jrecs)
    assert [r["uid"] for r in recs] == list(range(ds.n))
    assert [r["ids"] for r in recs] == [r["ids"] for r in jrecs]
    assert recs[5]["ids"]["userId"] == str(int(ds.entity_ids["userId"][5]))
    np.testing.assert_allclose([r["predictionScore"] for r in recs],
                               [r["predictionScore"] for r in jrecs],
                               atol=EVAL_ATOL)
    # The same arrays through each package's sink: the same bytes.
    p = got["torch"]["predictions"]
    for pkg, cls in (("torch_same", AvroScoreSink), ("jax_same", JAvro)):
        sink = cls(str(tmp_path / f"{pkg}.avro"), ids_keys=("userId",))
        for lo in range(0, ds.n, 256):
            hi = min(lo + 256, ds.n)
            sink.write(lo, hi, None, p[lo:hi], ds.labels[lo:hi],
                       ids={"userId": ds.entity_ids["userId"][lo:hi]})
        sink.close()
    assert (tmp_path / "torch_same.avro").read_bytes() == \
        (tmp_path / "jax_same.avro").read_bytes()


def test_npz_sink_incomplete_raises(rng, tmp_path):
    """A pass that does not cover the sink's rows cannot publish it: the
    ``.npz`` sink refuses to close short, and the scorer aborts it."""
    (model, ds), _ = _both(rng, n=300)
    sink = NpzScoreSink(str(tmp_path / "s.npz"), ds.n + 50)
    scorer = StreamingGameScorer(model, TaskType.LOGISTIC_REGRESSION,
                                 chunk_rows=64, device=CPU)
    with pytest.raises(ValueError, match=f"{ds.n} of {ds.n + 50}"):
        scorer.score(ds, sinks=[sink])
    assert os.listdir(tmp_path) == []


# -- tests/test_scoring_stream.py:406-433 and tests/test_reliability.py:700-720 ---------


def test_sink_writer_error_propagates(rng):
    """A sink failure on the writer thread surfaces to the caller and
    aborts the sinks; the writer thread has ended."""
    import threading

    (model, ds), _ = _both(rng, n=600)

    class ExplodingSink:
        def __init__(self):
            self.aborted = False

        def write(self, lo, hi, margins, preds, labels, ids=None):
            raise IOError("sink full")

        def close(self):
            raise AssertionError("close must not follow a failed write")

        def abort(self):
            self.aborted = True

    sink = ExplodingSink()
    scorer = StreamingGameScorer(model, TaskType.LOGISTIC_REGRESSION,
                                 chunk_rows=100, device=CPU)
    with pytest.raises(IOError, match="sink full"):
        scorer.score(ds, sinks=[sink])
    assert sink.aborted
    assert not [t for t in threading.enumerate()
                if t.name in ("photon-score-writer", "photon-chunk-prefetch")]


def test_sink_writer_death_leaves_no_torn_output(rng, tmp_path):
    """An injected fault at ``sink.write`` raises from the pass and
    leaves no published output and no temporary file."""
    n, d = 400, 20
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d + 1).astype(np.float32)
    from photon_ml_torch.game.dataset import GameDataset
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.models.game import FixedEffectModel, GameModel

    model = GameModel(models={"global": FixedEffectModel(
        coefficients=Coefficients(means=torch.from_numpy(w)),
        feature_shard="dense", intercept=True)})
    ds = GameDataset(labels=(rng.uniform(size=n) < 0.5).astype(np.float32),
                     features={"dense": x}, entity_ids={})
    sinks = [NpzScoreSink(str(tmp_path / "scores.npz"), n),
             AvroScoreSink(str(tmp_path / "scores.avro"), codec="null")]
    scorer = StreamingGameScorer(model, TaskType.LOGISTIC_REGRESSION,
                                 chunk_rows=64, device=CPU)
    inj = faults.FaultInjector([faults.Fault(site="sink.write",
                                             kind="error", at=1)])
    with faults.injected(inj):
        with pytest.raises(faults.InjectedFault):
            scorer.score(ds, sinks=sinks)
    assert os.listdir(tmp_path) == []


def test_unwritable_spill_dir_builds_on_the_fly(rng, tmp_path):
    """A spill dir that cannot be written degrades to chunks built on
    the fly, with the same margins."""
    (model, ds), _ = _both(rng, n=300)
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    task = TaskType.LOGISTIC_REGRESSION
    out = StreamingGameScorer(model, task, chunk_rows=64,
                              spill_dir=str(blocked / "spill"),
                              device=CPU).score(ds, keep_margins=True)
    assert "store" not in out
    ref = StreamingGameScorer(model, task, chunk_rows=64, device=CPU).score(
        ds, keep_margins=True)
    np.testing.assert_array_equal(out["margins"], ref["margins"])


def test_scorer_refuses_cuda_without_a_card():
    """The scorer runs on the card unless asked for the CPU; without
    CUDA it raises rather than move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from photon_ml_torch.models.game import GameModel

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingGameScorer(GameModel(models={}),
                            TaskType.LOGISTIC_REGRESSION)


# -- io/chunked.py: tests/test_data_io.py's chunked reads --------------------------------


@pytest.mark.parametrize("chunk_bytes", [64, 1000, 1 << 20])
def test_chunked_libsvm_matches_whole_file(tmp_path, chunk_bytes):
    """Windowed reads equal the whole-file read, and the JAX package's
    windowed read."""
    from photon_ml_tpu.io.chunked import read_libsvm_chunked as jread
    from photon_ml_torch.io.chunked import (
        iter_jsonl_chunks,
        iter_libsvm_chunks,
        read_libsvm_chunked,
    )
    from photon_ml_torch.io.libsvm import read_libsvm

    rng = np.random.default_rng(5)
    path = tmp_path / "d.libsvm"
    lines = []
    for _ in range(200):
        cols = np.sort(rng.choice(30, rng.integers(1, 6), replace=False))
        feats = " ".join(f"{c + 1}:{v:.4f}" for c, v in
                         zip(cols, rng.normal(size=len(cols))))
        lines.append(f"{rng.choice([-1, 1])} {feats}")
    path.write_text("\n".join(lines))          # no final newline
    rows, y, dim = read_libsvm_chunked(str(path), chunk_bytes=chunk_bytes)
    wrows, wy, wdim = read_libsvm(str(path))
    jrows, jy, jdim = jread(str(path), chunk_bytes=chunk_bytes)
    for a, b in ((rows.indptr, wrows.indptr), (rows.cols, wrows.cols),
                 (rows.vals, wrows.vals), (y, wy),
                 (rows.indptr, jrows.indptr), (rows.cols, jrows.cols),
                 (rows.vals, jrows.vals), (y, jy)):
        np.testing.assert_array_equal(a, b)
    assert dim == wdim == jdim and set(np.unique(y)) <= {0.0, 1.0}
    assert sum(len(r) for r, _ in iter_libsvm_chunks(
        str(path), chunk_bytes=chunk_bytes)) == 200
    jsonl = tmp_path / "r.jsonl"
    jsonl.write_text("\n".join(f'{{"i": {i}}}' for i in range(25)) + "\n\n")
    batches = list(iter_jsonl_chunks(str(jsonl), chunk_records=10))
    assert [len(b) for b in batches] == [10, 10, 5]
    assert batches[2][-1] == {"i": 24}
