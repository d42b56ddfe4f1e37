"""Hyperparameter search: rescaling, Expected Improvement, strategies.

Counterpart of ``photon_ml_tpu/hyperparameter/search.py``.  The search
space is a box over named parameters, each linear- or log-scaled into
[0, 1].  ``RandomSearch`` proposes uniform points; ``GaussianProcess
Search`` fits a GP to the observation history and proposes the
EI-argmax over a random candidate sweep.  Both draw from
``numpy.random.default_rng(seed)`` streams as the reference does, so
proposals match it draw for draw.  Metrics where smaller is better
(RMSE, losses) are negated internally so the acquisition maximizes.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from photon_ml_torch.hyperparameter.gp import fit_gp
from photon_ml_torch.hyperparameter.kernels import KernelType

Tensor = torch.Tensor


class ParamScale(str, enum.Enum):
    LINEAR = "LINEAR"
    LOG = "LOG"


@dataclasses.dataclass
class ParamRange:
    """One tunable dimension (a search-space JSON entry)."""

    name: str
    low: float
    high: float
    scale: ParamScale = ParamScale.LOG

    def validate(self) -> None:
        if not self.low < self.high:
            raise ValueError(f"{self.name}: low must be < high")
        if self.scale == ParamScale.LOG and self.low <= 0:
            raise ValueError(f"{self.name}: LOG scale needs low > 0")

    def to_unit(self, v: float) -> float:
        if self.scale == ParamScale.LOG:
            return (math.log(v) - math.log(self.low)) / (
                math.log(self.high) - math.log(self.low))
        return (v - self.low) / (self.high - self.low)

    def from_unit(self, u: float) -> float:
        u = min(max(u, 0.0), 1.0)
        if self.scale == ParamScale.LOG:
            return math.exp(
                math.log(self.low)
                + u * (math.log(self.high) - math.log(self.low)))
        return self.low + u * (self.high - self.low)


@dataclasses.dataclass
class SearchSpace:
    """Named box; converts between config dicts and unit vectors."""

    params: list[ParamRange]

    def __post_init__(self):
        for p in self.params:
            p.validate()

    @property
    def dim(self) -> int:
        return len(self.params)

    def to_unit(self, config: dict) -> np.ndarray:
        return np.asarray([p.to_unit(config[p.name]) for p in self.params],
                          np.float32)

    def from_unit(self, u: np.ndarray) -> dict:
        return {p.name: p.from_unit(float(u[i]))
                for i, p in enumerate(self.params)}


def expected_improvement(mean, std, best) -> Tensor:
    """EI for maximization: E[max(f − best, 0)] under N(mean, std²)."""
    mean, std, best = (torch.as_tensor(a) for a in (mean, std, best))
    z = (mean - best) / std
    cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mean - best) * cdf + std * pdf


class RandomSearch:
    """Uniform proposals in the rescaled box.

    A batched evaluator (the swept-λ ``GameEstimator``) could take the
    whole budget at once, but swept L-BFGS state grows as O(m·L·dim),
    so a round is bounded by default; ``TuningConfig.trial_batch``
    raises it."""

    default_batch: int | None = 16

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self._rng = np.random.default_rng(seed)

    def propose(self, history: list) -> dict:
        return self.space.from_unit(self._rng.uniform(size=self.space.dim))

    def propose_batch(self, history: list, q: int) -> list[dict]:
        """q independent proposals (batched trial evaluation)."""
        return [self.propose(history) for _ in range(q)]


class GaussianProcessSearch:
    """GP + EI proposals.

    ``history`` is a list of (config dict, metric); ``larger_is_better``
    flips loss-like metrics.  Random proposals until
    ``min_observations`` are available (they seed the GP)."""

    def __init__(
        self,
        space: SearchSpace,
        larger_is_better: bool = True,
        kernel: KernelType = KernelType.MATERN52,
        n_candidates: int = 2048,
        min_observations: int = 3,
        seed: int = 0,
    ):
        self.space = space
        self.larger_is_better = larger_is_better
        self.kernel = kernel
        self.n_candidates = n_candidates
        self.min_observations = min_observations
        self._rng = np.random.default_rng(seed)
        self._random = RandomSearch(space, seed=seed + 1)

    # GP proposals condition on history, so batches stay small.
    default_batch: int | None = 4

    def _ei_candidates(self, history: list):
        """One GP fit → (candidates [C, dim], EI [C]) shared by single
        and batched proposal."""
        x = np.stack([self.space.to_unit(cfg) for cfg, _ in history])
        y = np.asarray([m for _, m in history], np.float32)
        if not self.larger_is_better:
            y = -y
        gp = fit_gp(x, y, kind=self.kernel)
        cands = self._rng.uniform(
            size=(self.n_candidates, self.space.dim)).astype(np.float32)
        # Half as many again perturb the best point so far.
        best_x = x[int(np.argmax(y))]
        local = np.clip(
            best_x + 0.1 * self._rng.normal(
                size=(self.n_candidates // 2, self.space.dim)),
            0.0, 1.0).astype(np.float32)
        cands = np.vstack([cands, local])
        mean, std = gp.predict(cands)
        ei = expected_improvement(mean, std, float(np.max(y)))
        return cands, ei.numpy()

    def propose(self, history: list) -> dict:
        if len(history) < self.min_observations:
            return self._random.propose(history)
        cands, ei = self._ei_candidates(history)
        return self.space.from_unit(cands[int(np.argmax(ei))])

    def propose_batch(self, history: list, q: int,
                      min_dist: float = 0.05) -> list[dict]:
        """q proposals from ONE GP fit: EI-ranked candidates with a
        greedy min-distance filter, so the batch spreads over the
        acquisition surface; random before ``min_observations``."""
        if len(history) < self.min_observations:
            return [self._random.propose(history) for _ in range(q)]
        cands, ei = self._ei_candidates(history)
        order = np.argsort(-ei)
        picked: list[np.ndarray] = []
        for i in order:
            if len(picked) == q:
                break
            c = cands[i]
            if any(np.linalg.norm(c - p) < min_dist for p in picked):
                continue
            picked.append(c)
        # A degenerate surface (every candidate near a pick): the next
        # best regardless of spacing.
        for i in order:
            if len(picked) == q:
                break
            c = cands[i]
            if not any(np.array_equal(c, p) for p in picked):
                picked.append(c)
        return [self.space.from_unit(c) for c in picked]
