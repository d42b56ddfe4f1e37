"""The plain reference of each fit the benchmark times.

Each function takes the inputs the benchmark generated (numpy arrays),
the configuration and the traffic, and returns the coefficients the
configuration says the fit ends at, as float64 numpy arrays by leaf
name.  ``dtype`` is the precision the arithmetic runs in: float64 for
the reference, a lower one for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.glm import SparseLogistic
from gpubench.reference.lbfgs import minimize


def _fixed_problem(data: dict, config: dict, dtype, device) -> SparseLogistic:
    return SparseLogistic(data["indptr"], data["cols"], data["vals"],
                          data["labels"], int(data["dim"]),
                          bool(config["intercept"]), dtype, device,
                          weights=data.get("weights"))


def _coordinate(config: dict, name: str) -> dict:
    return next(c for c in config["coordinates"] if c["name"] == name)


def _host(w: torch.Tensor) -> np.ndarray:
    return w.detach().to(device="cpu", dtype=torch.float64).numpy()


def glm_fit(data: dict, config: dict, traffic: dict, dtype, device) -> dict:
    """One fixed-effect L-BFGS fit from zero at the traffic's λ."""
    prob = _fixed_problem(data, config, dtype, device)
    coord = _coordinate(config, "global")
    lams = torch.tensor([float(traffic["lambda"])], dtype=dtype,
                        device=device)
    w0 = torch.zeros((1, prob.dim), dtype=dtype, device=device)
    w = minimize(lambda W: prob.value_and_grad(W, lams),
                 lambda W: prob.value(W, lams), w0, config["solver"],
                 int(coord["max_iters"]), float(coord["tolerance"]))
    return {"global": _host(w[0])}


def objective_values(data: dict, config: dict, lambdas: dict,
                     answers: list, device) -> list:
    """The configuration's objective in float64 at each answer's leaves
    ({leaf: [dim] coefficients}), each leaf at its own λ (``lambdas``)
    → one {leaf: value} an answer."""
    prob = _fixed_problem(data, config, torch.float64, device)
    out = []
    for answer in answers:
        values = {}
        for leaf, lam in lambdas.items():
            w = torch.as_tensor(np.asarray(answer[leaf], np.float64)).to(
                device)[None]
            lams = torch.tensor([float(lam)], dtype=torch.float64,
                                device=device)
            values[leaf] = float(prob.value(w, lams)[0])
        out.append(values)
    return out
