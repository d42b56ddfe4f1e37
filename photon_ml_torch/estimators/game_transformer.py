"""GameTransformer: batch scoring of a GameDataset with a GameModel.

Counterpart of ``photon_ml_tpu/estimators/game_transformer.py``.  Scores
are summed per coordinate (Photon-ML's ``CoordinateDataScores``):

- fixed effect: on the card, ``gather_rowsum`` (B1, ``csrc/gather_rowsum
  .cu``) over equal-shape ELL chunks of up to 2²⁰ rows; on the CPU the
  host float64 pass ``SparseRows.dot_dense``;
- random effect: entity ids joined to trained entities on the host
  (unseen entities score 0), then the coefficient-row gather-dot, on the
  card in the same chunks or on the host; a projected random effect
  always takes the host merge-join.

The margins are raw (``transform``); ``transform_mean`` applies the
task's mean function.  The one-pass streamed scorer
(``transform_streamed``) is ROADMAP D8.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.device import resolve_device
from photon_ml_torch.game.dataset import GameDataset, sorted_key_join
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops.kernels import gather_rowsum

Tensor = torch.Tensor

# Rows a device scoring chunk: the grid is min(n, this) rounded up to a
# 8,192-row tile, so one chunk shape serves every chunk of an input.
_DEVICE_SCORE_CHUNK = 1 << 20


def _np(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def _grid(n: int) -> int:
    return -(-min(max(n, 1), _DEVICE_SCORE_CHUNK) // 8192) * 8192


def _device_score_sparse(rows: SparseRows, w: np.ndarray,
                         device: torch.device) -> np.ndarray:
    """Chunked X·w on ``device`` through B1: equal-shape ELL chunks (the
    tail padded), each read back before the next but one is placed, so
    at most two chunks are on the card."""
    n = len(rows)
    k = max(rows.max_nnz, 1)
    grid = _grid(n)
    w_dev = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device)
    outs, pending = [], []
    for lo in range(0, n, grid):
        hi = min(lo + grid, n)
        cols, vals = rows[lo:hi].to_ell(row_capacity=k, pad_to=grid)
        out = gather_rowsum(
            w_dev, torch.from_numpy(np.ascontiguousarray(vals)).to(device),
            torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(device))
        pending.append((out, hi - lo))
        if len(pending) >= 2:
            o, m = pending.pop(0)
            outs.append(o[:m].cpu().numpy())
    outs += [o[:m].cpu().numpy() for o, m in pending]
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


def _re_gather_dot(w_pad: Tensor, x: Tensor, idx: Tensor) -> Tensor:
    """``out[i] = x[i] · w_pad[idx[i]]``: the coefficient-row gather-dot
    (``idx`` points unseen entities at the zero padding row)."""
    return (x * w_pad[idx]).sum(-1)


def _device_score_re(feats, w_pad: np.ndarray, idx: np.ndarray,
                     device: torch.device) -> np.ndarray:
    """Chunked device gather-dot of an unprojected random effect."""
    n = len(idx)
    d_re = w_pad.shape[1]
    grid = _grid(n)
    W = torch.from_numpy(np.ascontiguousarray(w_pad, np.float32)).to(device)
    pad_row = w_pad.shape[0] - 1
    outs = []
    for lo in range(0, n, grid):
        hi = min(lo + grid, n)
        x = (feats[lo:hi].to_dense(d_re) if isinstance(feats, SparseRows)
             else np.asarray(feats[lo:hi], np.float32))
        ix = np.where(idx[lo:hi] < 0, pad_row, idx[lo:hi]).astype(np.int64)
        outs.append(_re_gather_dot(W, torch.from_numpy(x).to(device),
                                   torch.from_numpy(ix).to(device))
                    .cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


def _score_fixed(model: FixedEffectModel, dataset: GameDataset,
                 device: torch.device) -> np.ndarray:
    feats = dataset.features[model.feature_shard]
    w = _np(model.coefficients.means)
    if isinstance(feats, np.ndarray):
        x = np.asarray(feats, np.float32)
        if model.intercept:
            x = np.concatenate([x, np.ones((len(x), 1), np.float32)], 1)
        return (torch.from_numpy(x).to(device)
                @ torch.from_numpy(w.astype(np.float32)).to(device)
                ).cpu().numpy()
    # Sparse rows: the intercept is the last coefficient.
    base = w[-1] if model.intercept else 0.0
    rows = SparseRows.from_rows(feats)
    if device.type == "cuda":
        return (_device_score_sparse(rows, w, device).astype(np.float64)
                + np.float32(base))
    return rows.dot_dense(w.astype(np.float64)) + np.float32(base)


def _projected_score_table(model: RandomEffectModel
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Projected model → sorted ``(entity_row·G + global_col) → value``
    map, the model side of the scoring merge-join."""
    G = np.int64(model.projection.global_dim)
    keys_parts, vals_parts = [], []
    ent_row_of = model.grouping.entity_row_map()
    for b, blk in enumerate(model.coefficient_blocks):
        fids = model.projection.feature_ids[b]
        blk = _np(blk)
        rr, cc = np.nonzero(fids >= 0)
        if not len(rr):
            continue
        keys_parts.append(ent_row_of[b, rr] * G + fids[rr, cc])
        vals_parts.append(blk[rr, cc].astype(np.float64))
    if not keys_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    keys = np.concatenate(keys_parts)
    vals = np.concatenate(vals_parts)
    order = np.argsort(keys)
    return keys[order], vals[order]


def _score_projected_rows(model: RandomEffectModel, table, idx,
                          rows: SparseRows) -> np.ndarray:
    """Projected-model scores: the rows' (entity row, global col) keys
    merge-joined against the sorted model table, all vectorized."""
    ks, vs = table
    n = len(rows)
    if ks.size == 0:
        return np.zeros(n, np.float32)
    G = np.int64(model.projection.global_dim)
    row_of = rows.row_of()
    erow_nnz = idx[row_of]
    # Columns past the trained space would alias into the next entity.
    dsel = (erow_nnz >= 0) & (rows.cols.astype(np.int64) < G)
    key_d = erow_nnz[dsel] * G + rows.cols[dsel].astype(np.int64)
    w_at, hit = sorted_key_join(ks, vs, key_d, presorted=True)
    contrib = np.zeros(rows.nnz, np.float64)
    contrib[dsel] = np.where(hit, w_at, 0.0) * rows.vals[dsel]
    cs = np.zeros(rows.nnz + 1, np.float64)
    np.cumsum(contrib, out=cs[1:])
    return (cs[rows.indptr[1:]] - cs[rows.indptr[:-1]]).astype(np.float32)


def _score_random(model: RandomEffectModel, entity_ids: np.ndarray,
                  dataset: GameDataset, device: torch.device) -> np.ndarray:
    idx = model.grouping.join_ids(entity_ids)
    feats = dataset.features[model.feature_shard]
    if model.projection is None:
        w_all = _np(model.all_coefficients())             # [E, d_re]
        w_pad = np.vstack([w_all, np.zeros((1, w_all.shape[1]),
                                           w_all.dtype)])
        if device.type == "cuda":
            return _device_score_re(feats, w_pad, idx, device)
        x = (feats.to_dense(w_all.shape[1]) if isinstance(feats, SparseRows)
             else np.asarray(feats, np.float32))
        return np.einsum("nd,nd->n", x, w_pad[idx]).astype(np.float32)
    rows = SparseRows.from_rows(feats)
    return _score_projected_rows(model, _projected_score_table(model), idx,
                                 rows)


@dataclasses.dataclass
class GameTransformer:
    """Score a GameDataset with a GameModel (margins per example) on
    ``device`` (default CUDA; ``"cpu"`` takes the host passes)."""

    model: GameModel
    task: TaskType
    device: str | None = None

    def transform(self, dataset: GameDataset) -> np.ndarray:
        """Summed raw scores [n] plus the dataset's offsets."""
        dev = resolve_device(self.device)
        total = dataset.offset_array().astype(np.float64).copy()
        for name, comp in self.model.models.items():
            if isinstance(comp, FixedEffectModel):
                total += _score_fixed(comp, dataset, dev)
            elif isinstance(comp, RandomEffectModel):
                ids = dataset.entity_ids[comp.entity_key or name]
                total += _score_random(comp, ids, dataset, dev)
            else:
                raise TypeError(f"unknown component model {type(comp)}")
        return total.astype(np.float32)

    def transform_mean(self, dataset: GameDataset) -> np.ndarray:
        """Mean-space predictions (sigmoid / identity / soft exp)."""
        return self.task.loss.mean(
            torch.from_numpy(self.transform(dataset))).numpy()
