"""``photon_ml_torch.hyperparameter`` against ``photon_ml_tpu.hyperparameter``.

The same search spaces, seeds and observations go through both
packages: the random proposal streams are the reference's
``numpy.random.default_rng(seed)`` draws, so proposals are equal draw for
draw; the GP's posterior mean and std agree within 1e-5 (the port solves
in float64, the reference in float32 and float64 as ``jax_enable_x64``
promotes); and the reference's own cases of
``tests/test_hyperparameter.py`` run on the port.  The tuned training
driver runs in both packages (its reference path is L2: ``jax_c1``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_ml_torch.hyperparameter import (
    GaussianProcessSearch,
    HyperparameterTuner,
    KernelType,
    ParamRange,
    ParamScale,
    RandomSearch,
    SearchSpace,
    TunerMode,
    expected_improvement,
    fit_gp,
)
from photon_ml_torch.hyperparameter.kernels import matern52, rbf
from test_torch_training import jax_c1  # noqa: F401  (the C1 fixture)


def _ref():
    import photon_ml_tpu.hyperparameter as jh

    return jh


# -- parity with the reference ---------------------------------------------------


@pytest.mark.parametrize("scale", ["LOG", "LINEAR"])
def test_random_search_matches_reference_draw_for_draw(scale):
    jh = _ref()
    mine = RandomSearch(SearchSpace([
        ParamRange("a", 1e-3, 1e3, ParamScale(scale)),
        ParamRange("b", 0.5, 8.0, ParamScale(scale))]), seed=11)
    ref = jh.RandomSearch(jh.SearchSpace([
        jh.ParamRange("a", 1e-3, 1e3, jh.ParamScale(scale)),
        jh.ParamRange("b", 0.5, 8.0, jh.ParamScale(scale))]), seed=11)
    assert [mine.propose([]) for _ in range(20)] == [
        ref.propose([]) for _ in range(20)]
    assert mine.propose_batch([], 7) == ref.propose_batch([], 7)


@pytest.mark.parametrize("kind,atol", [(KernelType.MATERN52, 1e-5),
                                       (KernelType.RBF, 5e-5)])
def test_gp_posterior_matches_reference(kind, atol):
    """Posterior mean and std at 300 candidates, the same
    hyperparameters chosen from the grid.  Both packages evaluate the
    kernel in float32 and solve in float64, so the float32 kernel
    entries' last-bit differences (``exp``, the distance matmul) pass
    through the gram's condition number: ~6e3 for Matérn-5/2 here (the
    search's kernel: within 1e-5), ~2e5 for RBF (within 5e-5)."""
    import jax.numpy as jnp

    jh = _ref()
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(12, 2)).astype(np.float32)
    y = (np.sin(4 * x[:, 0]) + x[:, 1] ** 2).astype(np.float32)
    cands = rng.uniform(size=(300, 2)).astype(np.float32)
    gp = fit_gp(x, y, kind=kind)
    jgp = jh.fit_gp(jnp.asarray(x), jnp.asarray(y),
                    kind=jh.KernelType(kind.value))
    assert (gp.lengthscale, gp.noise) == (jgp.lengthscale, jgp.noise)
    np.testing.assert_allclose(gp.amplitude, jgp.amplitude, rtol=1e-6)
    mean, std = gp.predict(cands)
    jmean, jstd = jgp.predict(jnp.asarray(cands))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0,
                               atol=atol)


def test_gp_search_proposals_match_reference():
    """GP + EI proposals from one history: the same candidates (the
    reference's numpy streams) and the same EI argmax."""
    jh = _ref()
    history = [({"lam": lam}, -abs(np.log10(lam) - 0.3))
               for lam in (0.01, 0.1, 1.0, 5.0, 30.0)]
    mine = GaussianProcessSearch(
        SearchSpace([ParamRange("lam", 1e-3, 1e3)]), seed=4)
    ref = jh.GaussianProcessSearch(
        jh.SearchSpace([jh.ParamRange("lam", 1e-3, 1e3)]), seed=4)
    got, want = mine.propose_batch(history, 4), ref.propose_batch(history, 4)
    np.testing.assert_allclose([g["lam"] for g in got],
                               [w["lam"] for w in want], rtol=1e-6)


# -- the reference's cases (tests/test_hyperparameter.py) on the port --------------


def test_kernels_closed_form():
    x = torch.tensor([[0.0], [1.0]])
    k = rbf(x, x, amplitude=2.0, lengthscale=0.5)
    np.testing.assert_allclose(float(k[0, 0]), 4.0, rtol=1e-6)
    np.testing.assert_allclose(float(k[0, 1]), 4.0 * np.exp(-2.0), rtol=1e-5)
    m = matern52(x, x, amplitude=1.0, lengthscale=1.0)
    s5 = np.sqrt(5.0)
    expected = (1.0 + s5 + 5.0 / 3.0) * np.exp(-s5)
    np.testing.assert_allclose(float(m[0, 1]), expected, rtol=1e-4)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(20, 3)).astype(np.float32))
    gram = matern52(pts, pts, 1.0, 0.3).double().numpy()
    assert np.linalg.eigvalsh(gram).min() > -1e-5


def test_gp_interpolates_and_reverts_to_prior():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(25, 1)).astype(np.float32)
    y = np.sin(6.0 * x[:, 0]).astype(np.float32)
    gp = fit_gp(x, y, kind=KernelType.MATERN52)
    mean, std = gp.predict(x)
    np.testing.assert_allclose(mean.numpy(), y, atol=0.1)
    assert float(std.max()) < 0.5
    mean_far, std_far = gp.predict(np.asarray([[25.0]]))
    np.testing.assert_allclose(float(mean_far[0]), float(np.mean(y)),
                               atol=0.2)
    assert float(std_far[0]) > 0.8 * gp.amplitude


def test_expected_improvement_math():
    np.testing.assert_allclose(
        float(expected_improvement(2.0, 1e-9, 1.0)), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        float(expected_improvement(0.0, 1e-9, 1.0)), 0.0, atol=1e-6)
    np.testing.assert_allclose(
        float(expected_improvement(1.0, 0.5, 1.0)),
        0.5 / np.sqrt(2 * np.pi), rtol=1e-5)


def test_search_space_rescaling_roundtrip():
    space = SearchSpace([
        ParamRange("lin", 2.0, 10.0, ParamScale.LINEAR),
        ParamRange("log", 1e-3, 1e3, ParamScale.LOG)])
    u = space.to_unit({"lin": 4.0, "log": 1.0})
    np.testing.assert_allclose(u, [0.25, 0.5], rtol=1e-6)
    back = space.from_unit(u)
    np.testing.assert_allclose(back["lin"], 4.0, rtol=1e-6)
    np.testing.assert_allclose(back["log"], 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="low > 0"):
        SearchSpace([ParamRange("bad", 0.0, 1.0, ParamScale.LOG)])


def _objective(cfg: dict) -> float:
    # Max at log10(x) = 0.5.
    return float(-((np.log10(cfg["x"]) - 0.5) ** 2))


def test_gp_search_converges_to_optimum():
    """The reference's case (marked slow there for the JAX GP fits; the
    port's run alone here).  Its first three (random) trials are the
    reference tuner's draw for draw."""
    jh = _ref()
    space = SearchSpace([ParamRange("x", 1e-3, 1e3, ParamScale.LOG)])
    tuner = HyperparameterTuner(space, mode=TunerMode.BAYESIAN, seed=3)
    trials = tuner.run(lambda c: (_objective(c), None), n_trials=18)
    best = tuner.best(trials)
    assert abs(np.log10(best.config["x"]) - 0.5) < 0.35
    assert (max(t.metric for t in trials[3:])
            >= max(t.metric for t in trials[:3]))
    ref = jh.RandomSearch(jh.SearchSpace([jh.ParamRange(
        "x", 1e-3, 1e3, jh.ParamScale.LOG)]), seed=4)      # the GP's seed+1
    assert [t.config for t in trials[:3]] == [ref.propose([])
                                              for _ in range(3)]


def test_random_search_covers_space():
    rs = RandomSearch(SearchSpace([ParamRange("x", 1e-2, 1e2)]), seed=0)
    xs = [rs.propose([])["x"] for _ in range(200)]
    assert min(xs) < 0.1 and max(xs) > 10.0


def test_smaller_is_better_metric():
    space = SearchSpace([ParamRange("x", 1e-3, 1e3, ParamScale.LOG)])
    tuner = HyperparameterTuner(space, mode=TunerMode.BAYESIAN,
                                larger_is_better=False, seed=5)
    trials = tuner.run(lambda c: (-_objective(c), None), n_trials=15)
    best = tuner.best(trials)
    assert best.metric == min(t.metric for t in trials)
    assert abs(np.log10(best.config["x"]) - 0.5) < 0.35


def test_propose_batch_spreads():
    space = SearchSpace([ParamRange("lam", 1e-3, 10.0)])
    batch = RandomSearch(space, seed=0).propose_batch([], 4)
    assert len({round(b["lam"], 9) for b in batch}) == 4
    gp = GaussianProcessSearch(space, seed=0, min_observations=3)
    history = [({"lam": lam}, -abs(np.log10(lam)))
               for lam in (0.01, 0.1, 1.0, 5.0)]
    units = [space.to_unit(b)[0] for b in gp.propose_batch(history, 4)]
    assert len(units) == 4
    for i in range(4):
        for j in range(i + 1, 4):
            assert abs(units[i] - units[j]) >= 0.05 - 1e-6


def test_tuner_run_batched_contract():
    space = SearchSpace([ParamRange("lam", 0.01, 10.0)])
    tuner = HyperparameterTuner(space, mode=TunerMode.RANDOM, seed=0)
    seen = []

    def evaluate_batch(configs):
        seen.append(len(configs))
        return [(float(c["lam"]), {"lam": c["lam"]}) for c in configs]

    trials = tuner.run_batched(evaluate_batch, 7, batch_size=3)
    assert len(trials) == 7 and seen == [3, 3, 1]
    assert tuner.best(trials).metric == max(t.metric for t in trials)


def test_tuned_training_driver(tmp_path, jax_c1):
    """``tests/test_hyperparameter.py``'s tuned driver run, through both
    packages' drivers: one BEST model, 5 ``tuning_trial`` events, the
    same first (random) proposals with AUCs within 1e-3 of the
    reference's, and the saved model the best trial (the GP's later
    proposals follow the observed AUCs, so they may part)."""
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.utils.run_log import read_run_log
    from photon_ml_tpu.cli import game_training_driver as jdriver
    from photon_ml_tpu.io.dataset import write_game_dataset
    from photon_ml_tpu.utils.synthetic import make_movielens_like

    data = make_movielens_like(n_users=20, n_items=10, n_obs=900,
                               dim_global=6, seed=7)
    path = str(tmp_path / "train.jsonl")
    write_game_dataset(path, labels=data["labels"],
                       features={"global": data["x"].astype(np.float32)},
                       ids={})
    summaries, trials = {}, {}
    for pkg, driver, extra in (("torch", game_training_driver,
                                ["--device", "cpu"]), ("jax", jdriver, [])):
        config = {
            "task_type": "LOGISTIC_REGRESSION",
            "coordinates": [{
                "name": "global", "kind": "FIXED_EFFECT",
                "feature_shard": "global",
                "optimizer": {"reg_weight": 1.0, "max_iters": 60}}],
            "update_sequence": ["global"],
            "input_path": path, "validation_fraction": 0.3,
            "dense_feature_shards": ["global"],
            "tuning": {"n_trials": 5, "mode": "BAYESIAN",
                       "reg_weight_ranges": {
                           "global": {"low": 1e-3, "high": 1e3}}},
            "output_dir": str(tmp_path / f"out_{pkg}"),
            "evaluators": ["AUC"],
        }
        cfg_path = str(tmp_path / f"cfg_{pkg}.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        summaries[pkg] = driver.main(["--config", cfg_path, *extra])
        trials[pkg] = [e for e in read_run_log(
            str(tmp_path / f"out_{pkg}" / "run_log.jsonl"))
            if e["event"] == "tuning_trial"]
    mine = summaries["torch"]
    assert len(mine["models"]) == 1
    assert mine["models"][0]["evaluations"]["AUC"] > 0.7
    assert len(trials["torch"]) == len(trials["jax"]) == 5
    np.testing.assert_allclose(
        [t["config"]["global"] for t in trials["torch"][:3]],
        [t["config"]["global"] for t in trials["jax"][:3]], rtol=1e-12)
    np.testing.assert_allclose(
        [t["metric"] for t in trials["torch"][:3]],
        [t["metric"] for t in trials["jax"][:3]], rtol=0, atol=1e-3)
    assert mine["models"][0]["evaluations"]["AUC"] == max(
        t["metric"] for t in trials["torch"])
