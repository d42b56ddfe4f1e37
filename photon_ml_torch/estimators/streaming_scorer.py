"""The fused per-chunk scoring program.

Counterpart of ``_CoordSpec`` and ``_run_chunk`` in
``photon_ml_tpu/estimators/streaming_scorer.py``: one call sums every
coordinate's contribution into margins and applies the task mean.

- ``fixed_sparse``: the ELL gather-contract ``gather_rowsum`` (the
  hand-written CUDA kernel on the GPU) plus the intercept ``.base``;
- ``fixed_dense``: ``x @ w`` plus ``.base`` (a plain product, left to
  ``torch.matmul`` as the JAX package left it to XLA);
- ``re``: the coefficient-row gather-dot ``(x * table[idx]).sum(-1)``,
  plain torch for the same reason.

``StreamingGameScorer`` (the batch scoring pass over a dataset) comes
later; the serving engine calls ``run_chunk`` directly.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.ops.kernels import gather_rowsum


@dataclasses.dataclass(frozen=True)
class _CoordSpec:
    """Static description of one coordinate's scoring."""

    name: str
    kind: str          # "fixed_sparse" | "fixed_dense" | "re"


def run_chunk(specs, mean_fn, tables: dict, chunk: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(margins, predictions) for one chunk: ``chunk["base"]`` plus
    every coordinate of ``specs``; ``tables`` and ``chunk`` are dicts of
    tensors on one device."""
    m = chunk["base"]
    for s in specs:
        if s.kind == "fixed_sparse":
            m = m + gather_rowsum(tables[s.name], chunk[s.name + ".vals"],
                                  chunk[s.name + ".cols"]) \
                + tables[s.name + ".base"]
        elif s.kind == "fixed_dense":
            m = m + chunk[s.name + ".x"] @ tables[s.name] \
                + tables[s.name + ".base"]
        else:
            m = m + (chunk[s.name + ".x"]
                     * tables[s.name][chunk[s.name + ".idx"]]).sum(-1)
    return m, mean_fn(m)
