"""What the entries judged by their final coefficients share."""

from __future__ import annotations

import torch

from gpubench import compare
from gpubench.reference.fits import objective_values


class FinalAnswer:
    """``keep`` copies a fit's coefficients on the device; ``host`` reads
    them back as float64 arrays by leaf."""

    def keep(self, leaves: dict) -> dict:
        return {k: [b.detach().clone() for b in v] for k, v in leaves.items()}

    def host(self, kept: dict) -> dict:
        return {k: v[0].detach().cpu().double().numpy()
                for k, v in kept.items()}


def numbers(reference_answer, leaf_lambdas, answers: list, data: dict,
            config: dict, traffic: dict, device: str, reference=None):
    """``obj_gap``, ``coef_gap`` and ``coef_max_gap`` of each answer
    ({leaf: array}) against the float64 reference (worked out here
    unless given) → ([{number: reading}], reference)."""
    if reference is None:
        reference = reference_answer(data, config, traffic, torch.float64,
                                     device)
    values = objective_values(data, config, leaf_lambdas(traffic),
                              [reference] + list(answers), device)
    return [{"obj_gap": compare.obj_gap(v, values[0]),
             "coef_gap": compare.coef_gap(a, reference),
             "coef_max_gap": compare.coef_max_gap(a, reference)}
            for a, v in zip(answers, values[1:])], reference


def judge(reference_answer, leaf_lambdas, kept: dict, data: dict,
          config: dict, traffic: dict, device: str) -> dict:
    """{window index: {number: reading}} of the kept fits (the first, and
    the one drawn from the seed; ``kept``: window index → answer)."""
    order = sorted(kept)
    got, _ = numbers(reference_answer, leaf_lambdas,
                     [kept[i] for i in order], data, config, traffic, device)
    return dict(zip(order, got))


def weighted(data: dict, weights) -> dict:
    """The inputs with row weights set (a planted fault), or as they are."""
    return data if weights is None else {**data, "weights": weights}
