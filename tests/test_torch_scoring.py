"""The port's scoring and indexing drivers, score sinks and Avro model
export against the JAX package's.

On the CPU (``--device cpu`` / ``"device": "cpu"``), from files alone,
as ``tests/test_drivers.py`` and ``tests/test_avro.py`` run the
reference: the same fixtures go through both packages' drivers.
Tolerances: scores within 1e-4 and AUC within 1e-3 between the
packages' pipelines (float32 fits in another order); a model scored by
either package's scoring driver within 1e-5 (the same coefficients,
float32 sums in another order); the scoring driver reproduces its
training driver's validation AUC within 1e-5 (the same transform); index
maps equal; Avro exports byte-identical given the same container sync
marker.  The reference's fits are L2: ``jax_c1`` (ROADMAP C1).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_torch.cli import (
    feature_indexing_driver,
    game_scoring_driver,
    game_training_driver,
)
from photon_ml_torch.config import scoring_config_from_json
from photon_ml_torch.io.avro import read_container
from photon_ml_torch.io.index_map import load_index_maps
from test_drivers import _write_jsonl_fixture
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = ["--device", "cpu"]


def _dump(tmp_path, name: str, cfg: dict) -> str:
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _drivers(pkg):
    if pkg == "torch":
        return game_training_driver, game_scoring_driver, CPU
    from photon_ml_tpu.cli import game_scoring_driver as js
    from photon_ml_tpu.cli import game_training_driver as jt
    return jt, js, []


def _game_config(train_path, out_dir, evaluators=("AUC",), **over):
    cfg = {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [
            {"name": "global", "kind": "FIXED_EFFECT",
             "feature_shard": "global",
             "optimizer": {"reg_weight": 1.0, "max_iters": 60}},
            {"name": "per_user", "kind": "RANDOM_EFFECT",
             "feature_shard": "user_re", "entity_key": "userId",
             "optimizer": {"reg_weight": 2.0, "max_iters": 30}},
        ],
        "update_sequence": ["global", "per_user"],
        "input_path": train_path,
        "dense_feature_shards": ["global", "user_re"],
        "output_dir": out_dir,
        "evaluators": list(evaluators),
    }
    cfg.update(over)
    return cfg


# -- tests/test_drivers.py:135 -------------------------------------------------------


def test_feature_indexing_driver_matches_reference(tmp_path):
    from photon_ml_tpu.cli import feature_indexing_driver as jindex

    path = str(tmp_path / "train.jsonl")
    _write_jsonl_fixture(path)
    sizes = feature_indexing_driver.main(
        ["--input", path, "--output-dir", str(tmp_path / "maps")])
    want = jindex.main(["--input", path, "--output-dir",
                        str(tmp_path / "maps_ref")])
    assert sizes == want
    assert sizes["features"]["global"] == 6
    assert sizes["entities"]["userId"] >= 10
    for mine, ref in zip(load_index_maps(str(tmp_path / "maps")),
                         load_index_maps(str(tmp_path / "maps_ref"))):
        assert {k: m.index for k, m in mine.items()} == {
            k: m.index for k, m in ref.items()}


# -- tests/test_drivers.py:147 -------------------------------------------------------


def test_training_and_scoring_drivers_libsvm(tmp_path, jax_c1):
    """Config 1 on a1a-like LIBSVM through both packages' train → score:
    each scoring driver reproduces its own training AUC within 1e-5 and
    predictions are sigmoid(margins); the two fits agree at config 1's
    tolerance (coefficients 2e-3, as ``tests/test_torch_drivers.py``
    holds the golden: the two L-BFGS runs stop an iteration apart at the
    objective's float32 floor), AUC within 1e-3; and the port's scoring
    driver gives the reference's scores of the reference's model within
    1e-5."""
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_tpu.io.libsvm import write_libsvm
    from photon_ml_tpu.utils.synthetic import make_a1a_like

    rows, labels, _ = make_a1a_like(n=1200, seed=5)
    train_path = str(tmp_path / "a1a.libsvm")
    write_libsvm(train_path, rows[:1000], np.where(labels[:1000] > 0, 1, -1))
    valid_path = str(tmp_path / "a1a.t.libsvm")
    write_libsvm(valid_path, rows[1000:], np.where(labels[1000:] > 0, 1, -1))
    out = {}
    for pkg in ("torch", "jax"):
        train_d, score_d, extra = _drivers(pkg)
        cfg = {
            "task_type": "LOGISTIC_REGRESSION",
            "coordinates": [{
                "name": "global", "kind": "FIXED_EFFECT",
                "feature_shard": "features",
                "optimizer": {"optimizer": "LBFGS", "reg_weight": 1.0,
                              "max_iters": 100}}],
            "update_sequence": ["global"],
            "input_path": train_path, "validation_path": valid_path,
            "output_dir": str(tmp_path / f"out_{pkg}"),
            "evaluators": ["AUC"],
        }
        summary = train_d.main(["--config",
                                _dump(tmp_path, f"cfg_{pkg}.json", cfg),
                                *extra])
        auc = summary["models"][0]["evaluations"]["AUC"]
        sc = {"input_path": valid_path,
              "model_dir": str(tmp_path / f"out_{pkg}" / "model"),
              "output_path": str(tmp_path / f"scores_{pkg}" / "s.npz"),
              "evaluators": ["AUC"]}
        result = score_d.main(["--config",
                               _dump(tmp_path, f"sc_{pkg}.json", sc),
                               *extra])
        assert abs(result["evaluation"]["AUC"] - auc) < 1e-5
        out[pkg] = (auc, np.load(sc["output_path"]))
    (auc, mine), (ref_auc, ref) = out["torch"], out["jax"]
    assert auc > 0.80 and abs(auc - ref_auc) < 1e-3
    assert mine["scores"].shape == (200,)
    np.testing.assert_allclose(mine["predictions"],
                               1 / (1 + np.exp(-mine["scores"])), rtol=1e-5)
    coefs = [load_game_model(str(tmp_path / f"out_{pkg}" / "model"))[0]
             .models["global"].coefficients.means.numpy()
             for pkg in ("torch", "jax")]
    np.testing.assert_allclose(coefs[0], coefs[1], rtol=2e-3, atol=2e-3)
    sc = {"input_path": valid_path,
          "model_dir": str(tmp_path / "out_jax" / "model"),
          "output_path": str(tmp_path / "cross" / "s.npz")}
    game_scoring_driver.main(["--config", _dump(tmp_path, "sc_x.json", sc),
                              *CPU])
    np.testing.assert_allclose(np.load(sc["output_path"])["scores"],
                               ref["scores"], atol=1e-5)


# -- tests/test_drivers.py:204 and :324 ----------------------------------------------


@pytest.fixture(scope="module")
def game_models(tmp_path_factory):
    """Config 4 from JSONL, trained by each package's driver (one fit
    each; the reference's needs C1's attribute, set here as the
    ``jax_c1`` fixture does and restored after)."""
    import jax
    import jax._src.core

    from photon_ml_tpu.ops import regularization

    tmp = tmp_path_factory.mktemp("game")
    train_path = str(tmp / "train.jsonl")
    data = _write_jsonl_fixture(train_path, n_users=20, n_obs=600, seed=23)
    half = str(tmp / "half.jsonl")
    _write_jsonl_fixture(half, n_users=20, n_obs=600, seed=23)
    saved = (getattr(jax.core, "trace_state_clean", None),
             regularization._HALF)
    jax.core.trace_state_clean = jax._src.core.trace_state_clean
    try:
        for pkg in ("torch", "jax"):
            train_d, _, extra = _drivers(pkg)
            cfg = _game_config(train_path, str(tmp / f"out_{pkg}"),
                               evaluators=())
            train_d.main(["--config", _dump(tmp, f"cfg_{pkg}.json", cfg),
                          *extra])
    finally:
        if saved[0] is None:
            del jax.core.trace_state_clean
        else:
            jax.core.trace_state_clean = saved[0]
        regularization._HALF = saved[1]
    return tmp, train_path, data


def _score(tmp, pkg, model_pkg, train_path, out_name, **over):
    _, score_d, extra = _drivers(pkg)
    sc = {"input_path": train_path,
          "model_dir": str(tmp / f"out_{model_pkg}" / "model"),
          "output_path": str(tmp / out_name),
          "evaluators": ["AUC", "RMSE", "LOGISTIC_LOSS"]}
    sc.update(over)
    return score_d.main(["--config",
                         _dump(tmp, f"sc_{pkg}_{out_name}.json", sc),
                         *extra])


def test_game_scoring_matches_reference(game_models):
    """Both packages train config 4 and score it with their own scoring
    drivers: scores within 1e-4, every evaluator within 1e-3."""
    tmp, train_path, _ = game_models
    mine = _score(tmp, "torch", "torch", train_path, "torch.npz")
    ref = _score(tmp, "jax", "jax", train_path, "jax.npz")
    np.testing.assert_allclose(np.load(str(tmp / "torch.npz"))["scores"],
                               np.load(str(tmp / "jax.npz"))["scores"],
                               atol=1e-4)
    for k, v in ref["evaluation"].items():
        assert abs(mine["evaluation"][k] - v) < 1e-3, k


@pytest.mark.parametrize("model_pkg,scorer", [("torch", "jax"),
                                              ("jax", "torch")])
def test_model_scores_alike_in_either_package(game_models, model_pkg,
                                              scorer):
    """A model trained by one package and scored by the other package's
    driver gives its own driver's scores within 1e-5."""
    tmp, train_path, _ = game_models
    _score(tmp, model_pkg, model_pkg, train_path, f"own_{model_pkg}.npz")
    _score(tmp, scorer, model_pkg, train_path, f"cross_{model_pkg}.npz")
    own = np.load(str(tmp / f"own_{model_pkg}.npz"))
    cross = np.load(str(tmp / f"cross_{model_pkg}.npz"))
    np.testing.assert_allclose(cross["scores"], own["scores"], atol=1e-5)
    np.testing.assert_allclose(cross["predictions"], own["predictions"],
                               atol=1e-5)
    np.testing.assert_array_equal(cross["labels"], own["labels"])


def test_scoring_unseen_entities_and_oov_features(game_models):
    """``tests/test_drivers.py:324``: an unknown entity scores the
    fixed-effect margin alone, a known one adds its random effect; both
    packages' scoring drivers agree within 1e-5 on the port's model."""
    from photon_ml_torch.io.dataset import write_game_dataset
    from photon_ml_torch.io.model_io import load_game_model

    tmp, _, data = game_models
    x = data["x"][0].astype(np.float32)
    score_path = str(tmp / "cold.jsonl")
    write_game_dataset(score_path, labels=np.zeros(2, np.float32),
                       features={"global": np.stack([x, x]),
                                 "user_re": np.ones((2, 1), np.float32)},
                       ids={"userId": np.asarray([data["user_ids"][0],
                                                  10**9])})
    _score(tmp, "torch", "torch", score_path, "cold.npz", evaluators=[])
    _score(tmp, "jax", "torch", score_path, "cold_ref.npz", evaluators=[])
    out = np.load(str(tmp / "cold.npz"))
    model, _ = load_game_model(str(tmp / "out_torch" / "model"))
    w = model.models["global"].coefficients.means.numpy()
    assert abs(out["scores"][1] - float(x @ w[:-1] + w[-1])) < 1e-4
    assert abs(out["scores"][0] - out["scores"][1]) > 1e-3
    np.testing.assert_allclose(out["scores"],
                               np.load(str(tmp / "cold_ref.npz"))["scores"],
                               atol=1e-5)


# -- tests/test_drivers.py:380 (the resident half) -------------------------------------


def test_scoring_driver_avro_round_trip(game_models):
    """``ScoringResultAvro`` output: the schema's fields, uids in order,
    mean-space scores equal to the ``.npz`` predictions, labels, and the
    entity-id map; the reference's reader reads it the same."""
    from photon_ml_tpu.io.avro import read_container as jread

    tmp, train_path, data = game_models
    _score(tmp, "torch", "torch", train_path, "resident.npz")
    ref = np.load(str(tmp / "resident.npz"))
    _score(tmp, "torch", "torch", train_path, "scores.avro")
    _, recs = read_container(str(tmp / "scores.avro"))
    recs = list(recs)
    assert len(recs) == len(ref["scores"])
    assert set(recs[0]) == {"uid", "predictionScore", "label", "ids"}
    assert [r["uid"] for r in recs[:5]] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose([r["predictionScore"] for r in recs],
                               ref["predictions"], rtol=1e-6)
    np.testing.assert_allclose([r["label"] for r in recs], ref["labels"],
                               atol=1e-9)
    uid_col = np.asarray([int(r["ids"]["userId"]) for r in recs])
    assert len(np.unique(uid_col)) == len(np.unique(data["user_ids"]))
    _, jrecs = jread(str(tmp / "scores.avro"))
    assert list(jrecs) == recs


def test_scoring_driver_streamed_matches_resident(game_models):
    """``--score-chunk-rows`` takes the streamed branch (chunks spilled
    to ``--spill-dir``, a ``stream_stats`` run-log event): its
    evaluation and its ``.npz`` and ``.avro`` scores equal the resident
    branch's within 1e-6, and the JAX package's streamed driver's on the
    same model within 1e-5."""
    from photon_ml_torch.utils.run_log import read_run_log

    tmp, train_path, _ = game_models
    res = _score(tmp, "torch", "torch", train_path, "res.npz")
    _score(tmp, "torch", "torch", train_path, "res.avro")
    extra = ["--score-chunk-rows", "128", "--spill-dir",
             str(tmp / "score_spill"), "--host-max-resident", "1",
             "--prefetch-depth", "1"]
    sc = {"input_path": train_path,
          "model_dir": str(tmp / "out_torch" / "model"),
          "evaluators": ["AUC", "RMSE", "LOGISTIC_LOSS"]}
    outs = {}
    for name, pkg in (("str_ref.npz", "jax"), ("str.npz", "torch"),
                      ("str.avro", "torch")):
        _, score_d, dev = _drivers(pkg)
        cfg = _dump(tmp, f"sc_{name}.json",
                    {**sc, "output_path": str(tmp / name)})
        outs[name] = score_d.main(["--config", cfg, *extra, *dev])
    assert len(os.listdir(tmp / "score_spill" / "chunks")) == 5
    for k, v in res["evaluation"].items():
        assert abs(outs["str.npz"]["evaluation"][k] - v) < 1e-6, k
        assert abs(outs["str_ref.npz"]["evaluation"][k] - v) < 1e-5, k
    got, want = np.load(str(tmp / "str.npz")), np.load(str(tmp / "res.npz"))
    for key in ("scores", "predictions"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
        np.testing.assert_allclose(
            got[key], np.load(str(tmp / "str_ref.npz"))[key], atol=1e-5)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    recs = list(read_container(str(tmp / "str.avro"))[1])
    rrecs = list(read_container(str(tmp / "res.avro"))[1])
    assert [r["uid"] for r in recs] == [r["uid"] for r in rrecs]
    assert [r["ids"] for r in recs] == [r["ids"] for r in rrecs]
    np.testing.assert_allclose([r["predictionScore"] for r in recs],
                               [r["predictionScore"] for r in rrecs],
                               atol=1e-6)
    stats = [e for e in read_run_log(str(tmp / "scoring_log.jsonl"))
             if e["event"] == "stream_stats"]
    assert stats and stats[-1]["n_chunks"] == 5 and "store" in stats[-1]


# -- tests/test_drivers.py:470 ---------------------------------------------------------


def test_scoring_config_validation():
    """The reference's value checks, the streamed knobs and telemetry
    accepted (telemetry validated as the reference validates it), and
    the monitor's knobs validated as the reference validates them."""
    from photon_ml_tpu.config import scoring_config_from_json as jcfg

    for parse in (scoring_config_from_json, jcfg):
        with pytest.raises(ValueError, match="score_chunk_rows"):
            parse(json.dumps({"input_path": "x", "model_dir": "m",
                              "score_chunk_rows": 0}))
        with pytest.raises(ValueError, match="spill_dir requires"):
            parse(json.dumps({"input_path": "x", "model_dir": "m",
                              "spill_dir": "/tmp/s"}))
    streamed = {"input_path": "x", "model_dir": "m",
                "score_chunk_rows": 4096, "spill_dir": "/tmp/s",
                "prefetch_depth": 0}
    assert jcfg(json.dumps(streamed)).score_chunk_rows == 4096
    assert scoring_config_from_json(json.dumps(
        {**streamed, "host_max_resident": 4})).host_max_resident == 4
    for mode in ("off", "metrics", "trace"):
        assert scoring_config_from_json(json.dumps(
            {**streamed, "telemetry": mode})).telemetry == mode
    for parse in (scoring_config_from_json, jcfg):
        with pytest.raises(ValueError, match="telemetry"):
            parse(json.dumps({**streamed, "telemetry": "verbose"}))
    for knob, value in (("monitor", "on"), ("status_port", 0)):
        for parse in (scoring_config_from_json, jcfg):
            assert getattr(parse(json.dumps(
                {"input_path": "x", "model_dir": "m", knob: value})),
                knob) == value
    for knob, value in (("monitor", "maybe"), ("status_port", 70000),
                        ("monitor_every_s", 0.0)):
        for parse in (scoring_config_from_json, jcfg):
            with pytest.raises(ValueError, match=knob):
                parse(json.dumps(
                    {"input_path": "x", "model_dir": "m", knob: value}))
    cfg = scoring_config_from_json(json.dumps(
        {"input_path": "x", "model_dir": "m", "device": "cpu",
         "evaluators": ["AUC"]}))
    assert cfg.device == "cpu" and cfg.output_path == "scores.npz"


# -- tests/test_avro.py:251 and the byte-identical export --------------------------------


def _export_models():
    """The same model in both packages: ``tests/test_avro.py``'s fixed
    effect (with the intercept) and per-user random effect."""
    import jax.numpy as jnp

    from photon_ml_torch.game.dataset import EntityGrouping
    from photon_ml_torch.io.index_map import IndexMap, feature_key
    from photon_ml_torch.models import (
        Coefficients,
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )
    from photon_ml_tpu.game.dataset import EntityGrouping as JG
    from photon_ml_tpu.io.index_map import IndexMap as JMap
    from photon_ml_tpu.models import game as jgame
    from photon_ml_tpu.models.coefficients import Coefficients as JC

    gidx = {feature_key("age"): 0, feature_key("geo", "us"): 1}
    uidx = {feature_key("clicks"): 0, feature_key("views"): 1}
    grouping = dict(
        n_examples=0, entity_ids=np.asarray([11, 42]),
        entity_counts=np.asarray([3, 2]), entity_bucket=np.asarray([0, 0]),
        entity_slot=np.asarray([0, 1]), capacities=[4], n_entities=[2],
        example_bucket=np.empty(0, np.int64),
        example_row=np.empty(0, np.int64),
        example_col=np.empty(0, np.int64))
    means = np.asarray([0.5, -1.0, 0.25], np.float32)
    variances = np.asarray([0.1, 0.2, 0.3], np.float32)
    block = np.asarray([[1.0, 0.0], [0.0, -2.0]], np.float32)
    mine = GameModel(models={
        "fixed": FixedEffectModel(
            Coefficients(means=torch.from_numpy(means),
                         variances=torch.from_numpy(variances)),
            "global", intercept=True),
        "perUser": RandomEffectModel(
            [torch.from_numpy(block)], EntityGrouping(**grouping), "user",
            entity_key="userId")})
    ref = jgame.GameModel(models={
        "fixed": jgame.FixedEffectModel(
            coefficients=JC(means=jnp.asarray(means),
                            variances=jnp.asarray(variances)),
            feature_shard="global", intercept=True),
        "perUser": jgame.RandomEffectModel(
            coefficient_blocks=[jnp.asarray(block)], grouping=JG(**grouping),
            feature_shard="user", entity_key="userId")})
    return (mine, {"global": IndexMap(index=gidx),
                   "user": IndexMap(index=uidx)},
            ref, {"global": JMap(index=gidx), "user": JMap(index=uidx)})


def test_export_model_avro_round_trip(tmp_path):
    """``tests/test_avro.py:251`` on the port: one file a coordinate,
    the fixed effect read back through its (name, term) keys with the
    intercept, the random effect one sparse record an entity."""
    from photon_ml_torch.io.avro_schemas import read_model_avro
    from photon_ml_torch.io.model_io import export_model_avro
    from photon_ml_torch.models.glm import TaskType

    model, maps, _, _ = _export_models()
    paths = export_model_avro(model, TaskType.LOGISTIC_REGRESSION, maps,
                              str(tmp_path))
    assert len(paths) == 2

    def key_to_index(n, t):
        return 2 if n == "(INTERCEPT)" else maps["global"].get_feature(n, t)

    model_id, means, variances = read_model_avro(
        str(tmp_path / "fixed.avro"), key_to_index, dim=3)
    assert model_id == "fixed"
    np.testing.assert_allclose(means, [0.5, -1.0, 0.25], rtol=1e-6)
    np.testing.assert_allclose(variances, [0.1, 0.2, 0.3], rtol=1e-6)
    _, recs = read_container(str(tmp_path / "perUser.avro"))
    by_id = {r["modelId"]: r for r in recs}
    assert set(by_id) == {"11", "42"}
    assert by_id["11"]["means"] == [
        {"name": "clicks", "term": "", "value": 1.0}]
    assert by_id["42"]["means"] == [
        {"name": "views", "term": "", "value": -2.0}]


def test_export_model_avro_byte_identical_to_reference(tmp_path,
                                                       monkeypatch):
    """Both packages export the same model to the same bytes, file for
    file (the container's random sync marker pinned in both)."""
    from photon_ml_torch.io.model_io import export_model_avro
    from photon_ml_torch.models.glm import TaskType
    from photon_ml_tpu.io.model_io import export_model_avro as jexport
    from photon_ml_tpu.models.glm import TaskType as JTask

    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    model, maps, ref, ref_maps = _export_models()
    mine = export_model_avro(model, TaskType.LOGISTIC_REGRESSION, maps,
                             str(tmp_path / "torch"))
    theirs = jexport(ref, JTask.LOGISTIC_REGRESSION, ref_maps,
                     str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in mine] == [
        os.path.basename(p) for p in theirs]
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def test_export_of_a_trained_model_byte_identical(game_models, monkeypatch):
    """A model the port's driver trained and saved, loaded by each
    package and exported by each with the training run's index maps:
    the same bytes."""
    from photon_ml_torch.io.model_io import export_model_avro, load_game_model
    from photon_ml_tpu.io.index_map import load_index_maps as jload_maps
    from photon_ml_tpu.io.model_io import export_model_avro as jexport
    from photon_ml_tpu.io.model_io import load_game_model as jload

    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    tmp, _, _ = game_models
    model_dir = str(tmp / "out_torch" / "model")
    maps_dir = str(tmp / "out_torch" / "index_maps")
    model, task = load_game_model(model_dir)
    mine = export_model_avro(model, task, load_index_maps(maps_dir)[0],
                             str(tmp / "export_torch"))
    jmodel, jtask = jload(model_dir)
    theirs = jexport(jmodel, jtask, jload_maps(maps_dir)[0],
                     str(tmp / "export_jax"))
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
