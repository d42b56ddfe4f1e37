"""The fixed-effect coordinate's L-BFGS solve, repeated from zero.

Set-up prepares the batch through the estimator (``_prepare``,
``_build_coordinates``); each fit is ``problem.run(batch, w0)`` at the
traffic's λ.  Judged by its final coefficients (``obj_gap``,
``coef_max_gap``) against the reference's independent fit.
"""

from __future__ import annotations

import functools
import time

import torch

from gpubench.entries import final
from gpubench.reference.fits import glm_fit


class Entry(final.FinalAnswer):
    def __init__(self, port, data: dict, config: dict, traffic: dict,
                 device: str):
        self.port = port
        train = port.game_dataset(data)
        t = time.perf_counter()
        est = port.estimator(config, traffic, device)
        prep = port.prepare(est, train)
        coords = port.build_coordinates(
            est, train, prep, {"global": float(traffic["lambda"])})
        self.coord = coords["global"]
        self.w0 = torch.zeros(port.fixed_batch(self.coord).dim,
                              dtype=torch.float32, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        self.prepare_s = time.perf_counter() - t

    def fit(self, record=False) -> dict:
        return {"global": [self.port.fixed_effect_solve(self.coord, self.w0)]}

    def release(self) -> None:
        self.coord = self.w0 = None


def reference_answer(data, config, traffic, dtype, device, weights=None):
    """The reference's own fit (it needs nothing of the program's)."""
    return glm_fit(final.weighted(data, weights), config, traffic, dtype,
                   device)


def leaf_lambdas(traffic):
    return {"global": float(traffic["lambda"])}


numbers = functools.partial(final.numbers, reference_answer, leaf_lambdas)
judge = functools.partial(final.judge, reference_answer, leaf_lambdas)
