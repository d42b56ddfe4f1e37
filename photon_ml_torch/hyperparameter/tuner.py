"""Hyperparameter tuner: iterate (propose → fit → observe).

Counterpart of ``photon_ml_tpu/hyperparameter/tuner.py``: each trial
trains a model with the proposed configuration (typically a full
``GameEstimator`` fit) and reports its validation metric back to the
search.  ``run_batched(restored=...)`` resumes a checkpointed search:
it replays the restored rounds' proposals so the strategy's random
stream continues where the interrupted run left it.  Each trial (or round) reports the live
monitor's ``tuner`` progress, and the trials land in the run log, as
there.
"""

from __future__ import annotations

import dataclasses
import enum

from photon_ml_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
    SearchSpace,
)
from photon_ml_torch.telemetry import monitor as _mon


class TunerMode(str, enum.Enum):
    RANDOM = "RANDOM"
    BAYESIAN = "BAYESIAN"


@dataclasses.dataclass
class TrialResult:
    config: dict     # parameter name → value
    metric: float
    payload: object  # whatever the evaluator returned beside the metric


class HyperparameterTuner:
    """Drive n trials of an evaluator over a search space."""

    def __init__(
        self,
        space: SearchSpace,
        mode: TunerMode = TunerMode.BAYESIAN,
        larger_is_better: bool = True,
        seed: int = 0,
    ):
        self.space = space
        self.larger_is_better = larger_is_better
        if mode == TunerMode.RANDOM:
            self.search = RandomSearch(space, seed=seed)
        else:
            self.search = GaussianProcessSearch(
                space, larger_is_better=larger_is_better, seed=seed)

    def run(self, evaluate_fn, n_trials: int,
            run_logger=None) -> list[TrialResult]:
        """``evaluate_fn(config) → (metric, payload)``, one trial at a
        time."""
        history: list = []
        trials: list[TrialResult] = []
        for t in range(n_trials):
            config = self.search.propose(history)
            metric, payload = evaluate_fn(config)
            history.append((config, metric))
            trials.append(TrialResult(config=config, metric=float(metric),
                                      payload=payload))
            if run_logger is not None:
                run_logger.event("tuning_trial", trial=t, config=config,
                                 metric=float(metric))
            _mon.progress("tuner", len(trials), n_trials, unit="trials",
                          metric=float(metric))
        return trials

    def run_batched(self, evaluate_batch_fn, n_trials: int,
                    batch_size: int | None = None,
                    run_logger=None, restored=()) -> list[TrialResult]:
        """Trials in proposal rounds: each round proposes q configs
        (``propose_batch``) and hands the list to
        ``evaluate_batch_fn(configs) → [(metric, payload), ...]``, so a
        batched evaluator (the swept-λ ``GameEstimator``) trains a round
        as one fit.  ``batch_size`` None takes the strategy's
        ``default_batch``.

        ``restored``: ``(config, metric, payload)`` triples from a
        checkpoint, seeded into the history and the returned trials.
        Their rounds' proposals are replayed against the history prefix
        each round saw (proposals are deterministic given the seed and
        the history), so the strategy's generators continue where the
        interrupted run left them and the resumed search proposes the
        rounds it would have."""
        history: list = []
        trials: list[TrialResult] = []
        for config, metric, payload in restored:
            history.append((config, metric))
            trials.append(TrialResult(config=dict(config),
                                      metric=float(metric),
                                      payload=payload))
        if trials and run_logger is not None:
            run_logger.event("tuning_restored", trials=len(trials))
        pos = 0
        while pos < len(trials) and pos < n_trials:
            q = batch_size or getattr(self.search, "default_batch",
                                      None) or (n_trials - pos)
            q = min(q, n_trials - pos)
            replayed = self.search.propose_batch(history[:pos], q)
            for cfg, t in zip(replayed, trials[pos:pos + q]):
                if cfg != t.config and run_logger is not None:
                    run_logger.event("tuning_replay_divergence",
                                     trial=pos, proposed=cfg,
                                     restored=t.config)
            pos += q
        while len(trials) < n_trials:
            q = batch_size or getattr(self.search, "default_batch",
                                      None) or (n_trials - len(trials))
            q = min(q, n_trials - len(trials))
            configs = self.search.propose_batch(history, q)
            outs = evaluate_batch_fn(configs)
            for config, (metric, payload) in zip(configs, outs):
                history.append((config, metric))
                trials.append(TrialResult(
                    config=config, metric=float(metric), payload=payload))
                if run_logger is not None:
                    run_logger.event(
                        "tuning_trial", trial=len(trials) - 1,
                        config=config, metric=float(metric))
            _mon.progress("tuner", len(trials), n_trials, unit="trials")
        return trials

    def best(self, trials: list[TrialResult]) -> TrialResult:
        key = (max if self.larger_is_better else min)
        return key(trials, key=lambda t: t.metric)
