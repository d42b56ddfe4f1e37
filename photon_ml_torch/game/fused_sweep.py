"""The fused coordinate-descent cycle: one streamed store pass a cycle.

Counterpart of ``photon_ml_tpu/game/fused_sweep.py``.  The
per-coordinate loop pays a full data stream for every objective
evaluation of every coordinate; here a cycle is one pass:

- **Cycle-aligned chunks.** The fixed effect's chunk grid
  (``data.chunked_batch``) is the master grid.  A sidecar chunk beside
  each example chunk holds every random effect's per-row entity index
  and (projected) feature plane (``data.chunk_store``
  ``FUSED_CHUNK_CODEC``, content-keyed and spilled when a spill dir is
  given), so one prefetched chunk pair feeds every coordinate.
- **One per-chunk program** (``_fused_chunk``).  The margins are
  composed from the current coefficients: the fixed effect's ``X·w`` on
  B1 (``gather_rowsum``) plus each random effect's coefficient-row
  gather-dot.  From the shared loss derivatives it accumulates the fixed
  effect's value, gradient and Hessian diagonal, and each random
  effect's per-entity gradient [E, p] and Gauss–Newton Gram [E, p, p]
  by ``index_add_``.  Every statistic accumulates in float64 (CUDA's
  ``index_add_`` is atomic and has no fixed order; float64 keeps the
  float32 result it is cast to at the step independent of that order in
  practice).  Retired entities' statistics are gated off.
- **A Jacobi update a cycle.** The fixed effect takes one diagonally
  preconditioned Newton step (``_fe_step``) and every active entity one
  regularized Newton solve of its p×p system (``_re_step``), all against
  the cycle-start offsets.
- **A safeguard.** The joint objective comes out of the same pass; a
  cycle whose value rose halves the global step scale, progress grows it
  back by 1.25 (up to 1).  Where the JAX package then steps on from the
  worse point, the port rejects it: it keeps the last accepted point's
  statistics and steps from them again with the shorter scale, so a
  rejection costs no extra pass.  Jacobi steps of all coordinates at
  once overshoot by up to the number of coordinates a row touches (the
  fixed effect's non-zeros and one a random effect); on config 5's
  31-slot rows the JAX package's first cycles multiply the joint
  objective by ~10⁹ and never recover, while the port's accepted value
  falls monotonically, and the fit returns the last accepted point when
  its final step rose.  Until the first rise the two trajectories are
  the same.

Per-coordinate score planes come out of each pass (validation,
retirement bookkeeping and the coordinate-descent result), at the
cycle-start coefficients.

In a training fleet (``parallel.fleet``) a host streams only its chunk
shard and builds and spills only its sidecars (under its per-host spill
dir).  Each schedule step's statistics are summed across the hosts
before they are added (a sentinel step contributes zeros) and the score
planes once at the end of the pass, so every host takes the same steps
from the same totals, and the safeguard's decisions agree.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging

import numpy as np
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.data.batch import SparseBatch
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.parallel import fleet as _fleet
from photon_ml_torch.telemetry import convergence as _conv
from photon_ml_torch.telemetry import device as _device
from photon_ml_torch.telemetry import monitor as _mon

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

# Ridge on every Newton system: the fixed effect's diagonal and the
# per-entity Grams stay solvable at zero curvature (retired entities,
# projected padding columns) without moving a real solution.
_RIDGE = 1e-6
_MIN_ALPHA = 1.0 / 64.0


# ---------------------------------------------------------------------------
# The per-chunk program and the steps
# ---------------------------------------------------------------------------


def _zero_stats(dim: int, shapes: list[tuple[int, int]], device) -> tuple:
    """float64 accumulators: (value, fixed-effect gradient [d] and
    Hessian diagonal [d], per random effect g [E + 1, p] and G
    [E + 1, p, p])."""
    z = dict(dtype=torch.float64, device=device)
    return (torch.zeros((), **z), torch.zeros(dim, **z),
            torch.zeros(dim, **z),
            tuple(torch.zeros((e1, p), **z) for e1, p in shapes),
            tuple(torch.zeros((e1, p, p), **z) for e1, p in shapes))


def _acc_add(acc: tuple, x: tuple) -> None:
    """``acc += x`` in place over the ``_zero_stats`` structure."""
    for a, b in zip(acc[:3], x[:3]):
        a += b
    for part in (3, 4):
        for a, b in zip(acc[part], x[part]):
            a += b


def _fused_chunk(loss, w_fe: Tensor, re_tabs, re_actives,
                 batch: SparseBatch, re_xs, re_idxs, acc: tuple):
    """One chunk's statistics, added into ``acc`` (``_zero_stats``).

    Args:
      loss: the ``PointwiseLoss``.
      w_fe: [d] fixed-effect coefficients.
      re_tabs: [E_r + 1, p_r] flattened coefficient tables, a random
        effect each (the last row is the all-zero dump row).
      re_actives: [E_r + 1] float gates: 1 accumulates an entity's
        statistics, 0 (retired, the dump row) skips them.
      batch: the fixed-effect chunk (ELL; its offsets are ignored, the
        margins are composed from the coefficients).
      re_xs: [R, p_r] per-row (projected) feature planes.
      re_idxs: [R] int32 flat entity indices (padding rows: the dump
        row).

    Returns (fixed-effect scores [R], random-effect scores, a [R] each).
    """
    fe_scores = batch.x_dot(w_fe)
    m = fe_scores
    re_scores = []
    idxs = [idx.long() for idx in re_idxs]
    for x, tab, idx in zip(re_xs, re_tabs, idxs):
        s = (x * tab[idx]).sum(-1)
        re_scores.append(s)
        m = m + s
    f, fe_g, fe_h, re_gs, re_Gs = acc
    wl = batch.weights * batch.mask
    f += (wl * loss.loss(m, batch.labels)).double().sum()
    dl = wl * loss.d1(m, batch.labels)
    d2 = wl * loss.d2(m, batch.labels)
    ids = batch.col_ids.reshape(-1)
    fe_g.index_add_(0, ids, (batch.values * dl[:, None]).reshape(-1)
                    .double())
    fe_h.index_add_(0, ids, (batch.values * batch.values * d2[:, None])
                    .reshape(-1).double())
    for x, idx, act, g, G in zip(re_xs, idxs, re_actives, re_gs, re_Gs):
        gate = act[idx]
        gd1 = dl * gate
        gd2 = d2 * gate
        g.index_add_(0, idx, (gd1[:, None] * x).double())
        G.index_add_(0, idx, (gd2[:, None, None] * x[:, :, None]
                              * x[:, None, :]).double())
    return fe_scores, re_scores


def _fused_chunk_cost(dev: dict, coefs: list, acc: tuple, names: list,
                      rows: int, device) -> dict:
    """Analytic cost of ``_fused_chunk`` on one chunk: its placed arrays
    and the coefficient tables read once, the statistics and score rows
    written once; flops: the fixed effect's three sparse products
    (``X·w``, ``Xᵀd₁``, ``(X∘X)ᵀd₂``) and each random effect's dot,
    gradient and Gram over its feature plane."""
    stats = [acc[0], acc[1], acc[2], *acc[3], *acc[4]]
    out_bytes = (_device.tensor_bytes(stats)
                 + 4 * rows * (1 + len(names)))
    flops = 2.0 * 3 * dev["fe.values"].numel()
    for n in names:
        x = dev[n + ".x"]
        flops += 2.0 * x.numel() * (2 + x.shape[-1])
    return _device.program_cost(list(dev.values()) + list(coefs),
                                out_bytes, flops, device)


def _fe_step(obj: GLMObjective, w: Tensor, g: Tensor, h: Tensor,
             alpha: float):
    """The fixed effect's diagonally preconditioned Newton step from the
    pass's float64 (gradient, Hessian diagonal), cast here; the
    regularization and the prior are added once, after the pass.
    Returns (w_new, max |applied step|, ‖g‖)."""
    g = g.to(w.dtype) + obj.reg.l2_gradient(w)
    h = h.to(w.dtype) + obj.reg.l2_hessian_diagonal(w)
    if obj.prior is not None:
        g = g + obj.prior.gradient(w)
        h = h + obj.prior.hessian_diagonal()
    step = alpha * (g / torch.clamp(h, min=_RIDGE))
    return w - step, step.abs().max(), torch.linalg.vector_norm(g)


def _re_step(tab: Tensor, g: Tensor, G: Tensor, active: Tensor, lam: float,
             alpha: float):
    """Each entity's regularized Newton solve from its accumulated
    statistics, Δ_e = (G_e + (λ + δ)I)⁻¹ (g_e + λ w_e), applied (scaled
    by ``alpha``) to active entities only.  Padding columns of a
    projected bucket have zero x, w and g, so Δ = 0 there.

    Returns (the new table [E + 1, p], each entity's undamped |Δ|_∞
    [E + 1]): retirement compares the full Newton step with the
    tolerance; the damped step would loosen it to tolerance / α."""
    p = tab.shape[1]
    eye = torch.eye(p, dtype=tab.dtype, device=tab.device)
    g_tot = g.to(tab.dtype) + lam * tab
    A = G.to(tab.dtype) + (lam + _RIDGE) * eye
    delta = torch.linalg.solve(A, g_tot[..., None])[..., 0]
    on = active > 0.0
    tab_new = torch.where(on[:, None], tab - alpha * delta, tab)
    tab_new[-1] = 0.0            # the dump row stays pinned at zero
    move = torch.where(on, delta.abs().amax(-1),
                       torch.zeros_like(active))
    return tab_new, move


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FusedRE:
    """One random effect's fused-cycle bookkeeping."""

    name: str
    coord: "object"                # the estimator's coordinate
    lam: float                     # the smooth L2 weight (float32 value)
    tolerance: float               # retirement threshold
    widths: list[int]              # p_b a bucket
    p_max: int
    n_entities: list[int]
    boff: np.ndarray               # [buckets] flat entity-index bases
    E_total: int
    # Examples sorted by (flat entity, position) and the [E + 1] run
    # starts: the per-entity reductions of the retirement bookkeeping.
    ex_sorted: np.ndarray
    ent_starts: np.ndarray
    active: np.ndarray = None      # [E] bool
    solved_off: np.ndarray = None  # [n] offsets at each entity's last solve
    prev_off: np.ndarray = None    # [n] the previous cycle's offsets

    def entity_max(self, per_example: np.ndarray) -> np.ndarray:
        """[E] per-entity max of a per-example plane (0 for an entity
        with no examples)."""
        out = np.zeros(self.E_total, np.float32)
        nz = np.diff(self.ent_starts) > 0
        if self.ex_sorted.size:
            out[nz] = np.maximum.reduceat(per_example[self.ex_sorted],
                                          self.ent_starts[:-1][nz])
        return out


class FusedCycleEngine:
    """One-pass-a-cycle coordinate descent over a chunked fixed effect
    and any number of random effects.

    Coefficients cross its boundary in the coordinates' formats, [d] for
    the fixed effect and per-bucket [E_b, p_b] blocks for a random
    effect, and are flattened to device tables inside, so model export,
    validation and checkpoints are unchanged.
    """

    def __init__(self, fe_name: str, fe_coord, res: list[_FusedRE],
                 n_examples: int, prefetch_depth: int = 2,
                 retirement: bool = True, sidecar_store=None,
                 sidecar_resident: list | None = None):
        from photon_ml_torch.optim.streaming import ArrayPlacer

        self.fe_name = fe_name
        self.fe_coord = fe_coord
        self.chunked = fe_coord.chunked
        self.objective = fe_coord.objective
        self.loss = fe_coord.objective.loss
        self.device = fe_coord.device
        self.res = res
        self.n = int(n_examples)
        self.prefetch_depth = int(prefetch_depth)
        self.retirement = bool(retirement)
        self.sidecar_store = sidecar_store
        self._sidecar_resident = sidecar_resident
        self._placer = ArrayPlacer(self.device,
                                   max(self.prefetch_depth, 0) + 2)
        self.alpha = 1.0
        self.prev_value: float | None = None
        self.cycles = 0
        # The last accepted cycle's point (the point a rejected step
        # returns to): its coefficients, tables, gates and the pass's
        # float64 statistics; and the steps rejected so far.
        self._accepted: dict | None = None
        self.rejections = 0
        # Device tables keyed by the identity of the block lists this
        # engine returned last cycle: an unchanged table is not rebuilt;
        # foreign blocks (a warm start, a resume) miss and are rebuilt.
        self._tab_cache: dict = {}

    # -- coefficient formats --------------------------------------------------

    def _flatten(self, r: _FusedRE, blocks) -> Tensor:
        tab = torch.zeros((r.E_total + 1, r.p_max), dtype=torch.float32,
                          device=self.device)
        for b, blk in enumerate(blocks):
            lo = int(r.boff[b])
            tab[lo:lo + r.n_entities[b], : r.widths[b]] = torch.as_tensor(
                blk).to(device=self.device, dtype=torch.float32)
        return tab

    def _tab_for(self, r: _FusedRE, blocks) -> Tensor:
        cached = self._tab_cache.get(r.name)
        if cached is not None and cached[0] is blocks:
            return cached[1]
        return self._flatten(r, blocks)

    def _unflatten(self, r: _FusedRE, tab: Tensor) -> list[Tensor]:
        return [tab[int(r.boff[b]):int(r.boff[b]) + r.n_entities[b],
                    : r.widths[b]].clone()
                for b in range(len(r.n_entities))]

    # -- the chunk feed -----------------------------------------------------

    def _sidecar(self, i: int) -> dict:
        if self.sidecar_store is not None:
            return self.sidecar_store.get(i)
        if self._sidecar_resident is None:     # a fixed-effect-only fit
            return {}
        return self._sidecar_resident[i]

    def _load(self, i: int) -> dict:
        """The prefetch thread's load: fixed-effect chunk i's leaves and
        its sidecar, one dict to place with one event."""
        host = self.chunked.chunk(i)
        leaves = {"fe." + leaf: getattr(host, leaf)
                  for leaf in ("values", "col_ids", "labels", "weights",
                               "mask")}
        leaves.update(self._sidecar(i))
        return leaves

    def _stream(self):
        """``(i, placed tensors)`` in this host's schedule order through
        the prefetch pipeline, with chunk i-1's work fenced before chunk
        i dispatches on a spilled store (the queued work holds one
        chunk's buffers).  A fleet sentinel step yields ``(EMPTY_CHUNK,
        None)``: nothing is placed or fenced for it."""
        from photon_ml_torch.optim.streaming import (
            ArrayPlacer,
            prefetch_stream,
        )

        sched = self.chunked.chunk_schedule
        real = [i for i in sched if i >= 0]
        inner = prefetch_stream(self._load, self._placer.place, real,
                                self.prefetch_depth,
                                store=self.chunked.store,
                                device=self.device)
        fenced = (self.chunked.store is not None
                  and self.device.type == "cuda")
        fence = None
        try:
            for i in sched:
                if i < 0:
                    yield i, None
                    continue
                _, placed = next(inner)
                if fence is not None:
                    fence.synchronize()
                yield i, ArrayPlacer.handover(placed)
                if fenced:
                    fence = torch.cuda.Event()
                    fence.record()
        finally:
            inner.close()

    # -- the pass -------------------------------------------------------------

    def _pass(self, w_fe: Tensor, tabs: list[Tensor],
              actives: list[Tensor]):
        """One streamed pass: the accumulated statistics and the host
        score planes of every coordinate, at the given coefficients.  In
        a fleet each step's statistics are summed across the hosts
        before they join the accumulators, and the planes once at the
        end (examples are disjoint across hosts: the sum is the
        concatenation)."""
        K, R = self.chunked.n_chunks, self.chunked.chunk_rows
        names = [r.name for r in self.res]
        fred = _fleet.reducer()
        shapes = [(r.E_total + 1, r.p_max) for r in self.res]
        acc = _zero_stats(self.chunked.dim, shapes, self.device)
        planes = (torch.empty if fred is None else torch.zeros)(
            (1 + len(self.res), K * R), dtype=torch.float32,
            device=self.device)
        steps = len(self.chunked.chunk_schedule)
        store = self.sidecar_store
        if store is not None:
            store.begin_read()
        telemetry.count("solver.sweeps")
        try:
            with telemetry.span("fused_cycle_pass", cat="solver",
                                chunks=K):
                for si, (i, dev) in enumerate(self._stream()):
                    if i < 0:     # a sentinel: zeros to the barrier
                        _acc_add(acc, fred.reduce(_zero_stats(
                            self.chunked.dim, shapes, self.device)))
                        _mon.progress("train.cd_fused", si + 1, steps,
                                      unit="chunks", cycle=self.cycles + 1)
                        continue
                    into = (acc if fred is None else
                            _zero_stats(self.chunked.dim, shapes,
                                        self.device))
                    labels = dev["fe.labels"]
                    batch = SparseBatch(
                        values=dev["fe.values"],
                        col_ids=dev["fe.col_ids"], labels=labels,
                        weights=dev["fe.weights"],
                        offsets=torch.zeros_like(labels),
                        mask=dev["fe.mask"], dim=self.chunked.dim)
                    with telemetry.span("chunk_compute", cat="device"):
                        with telemetry.device_timed("fused_chunk",
                                                    self.device):
                            fe_s, re_s = _fused_chunk(
                                self.loss, w_fe, tabs, actives, batch,
                                [dev[n + ".x"] for n in names],
                                [dev[n + ".idx"] for n in names], into)
                            planes[0, i * R:(i + 1) * R] = fe_s
                            for j, s in enumerate(re_s):
                                planes[1 + j, i * R:(i + 1) * R] = s
                    _device.maybe_capture(
                        "fused_chunk",
                        lambda: _fused_chunk_cost(dev, [w_fe, *tabs,
                                                        *actives],
                                                  acc, names, R,
                                                  self.device),
                        span="chunk_compute")
                    if fred is not None:
                        _acc_add(acc, fred.reduce(into))
                        telemetry.count("fleet.chunks_streamed")
                    _mon.progress("train.cd_fused", si + 1, steps,
                                  unit="chunks", cycle=self.cycles + 1)
                host = planes[:, : self.n].cpu().numpy()
                fe_scores, re_scores = host[0], list(host[1:])
                if fred is not None:
                    fe_scores, re_scores = fred.reduce((fe_scores,
                                                        re_scores))
        finally:
            if store is not None:
                store.end_read()
        return acc, fe_scores, list(re_scores)

    def _total_value(self, data_value: Tensor, w_fe: Tensor,
                     tabs: list[Tensor]) -> float:
        """The joint objective (data, smooth regularization, prior) at the
        coefficients the pass evaluated: the safeguard's scalar."""
        obj = self.objective
        v = float(data_value) + float(obj.reg.l2_value(w_fe.double()))
        if obj.prior is not None:
            v += float(obj.prior.value(w_fe))
        for r, tab in zip(self.res, tabs):
            v += 0.5 * r.lam * float((tab.double() ** 2).sum())
        return v

    # -- one cycle ----------------------------------------------------------

    def _actives(self) -> list[Tensor]:
        """Each random effect's cycle-start gates, the dump row off."""
        return [torch.from_numpy(np.concatenate(
            [r.active.astype(np.float32), np.zeros(1, np.float32)])
        ).to(self.device) for r in self.res]

    def _rose(self, value: float) -> bool:
        return (self.prev_value is not None
                and value > self.prev_value
                + 1e-12 * (1.0 + abs(self.prev_value)))

    def _step(self, point: dict):
        """The Jacobi step from an accepted point's statistics at the
        current step scale: (new coefficients, max |fixed-effect step|,
        each random effect's undamped |Δ|_∞ [E] on the host)."""
        _, fe_g, fe_h, re_gs, re_Gs = point["acc"]
        new_coefs = dict(point["coefs"])
        w_new, fe_step, _ = _fe_step(self.objective, point["w"], fe_g,
                                     fe_h, self.alpha)
        new_coefs[self.fe_name] = w_new
        moves = []
        for j, r in enumerate(self.res):
            tab_new, move = _re_step(point["tabs"][j], re_gs[j], re_Gs[j],
                                     point["actives"][j], r.lam, self.alpha)
            blocks = self._unflatten(r, tab_new)
            new_coefs[r.name] = blocks
            self._tab_cache[r.name] = (blocks, tab_new)
            moves.append(move[:-1].cpu().numpy())
        return new_coefs, fe_step, moves

    def run_cycle(self, coefs: dict):
        """One pass at the given coefficients, then the Jacobi solves.
        Returns (new coefficients, the scores at the input coefficients,
        their total, diagnostics a coordinate)."""
        w_fe = torch.as_tensor(coefs[self.fe_name]).to(
            device=self.device, dtype=torch.float32)
        tabs = [self._tab_for(r, coefs[r.name]) for r in self.res]
        actives = self._actives()
        telemetry.count("solver.fused_cycle_sweeps")
        acc, fe_scores, re_scores = self._pass(w_fe, tabs, actives)
        value = self._total_value(acc[0], w_fe, tabs)
        _, _, fe_gnorm = _fe_step(self.objective, w_fe, acc[1], acc[2], 0.0)
        fe_gnorm = float(fe_gnorm)
        total = fe_scores.copy()
        for s in re_scores:
            total += s
        scores = {self.fe_name: self._plane(fe_scores)}
        for j, r in enumerate(self.res):
            scores[r.name] = self._plane(re_scores[j])
        self.cycles += 1
        telemetry.count("solver.iterations")
        _conv.iteration("fused_cd", self.fe_name, self.cycles, value,
                        fe_gnorm)
        rose = self._rose(value)
        if rose and self.alpha > _MIN_ALPHA and self._accepted is not None:
            # Back to the accepted point with half the step scale; no
            # step and no retirement bookkeeping come of this one.
            self.alpha = max(self.alpha * 0.5, _MIN_ALPHA)
            self.rejections += 1
            new_coefs, fe_step, _ = self._step(self._accepted)
            diag: dict = {self.fe_name: {
                "value": round(value, 8),
                "grad_norm": round(float(fe_gnorm), 8),
                "step_inf_norm": round(float(fe_step), 8),
                "alpha": round(self.alpha, 6),
                "rejected": True,
                "fused": True}}
            for r in self.res:
                diag[r.name] = {
                    "entities": r.E_total, "entities_solved": 0,
                    "entities_retired": int((~r.active).sum()),
                    "entities_newly_retired": 0, "entities_woken": 0,
                    "fused": True}
            return new_coefs, scores, self._plane(total), diag
        # A rise here has no shorter step left (or no point to return
        # to): halve and step on, as the JAX package does.
        if rose:
            self.alpha = max(self.alpha * 0.5, _MIN_ALPHA)
        elif self.prev_value is not None:
            self.alpha = min(1.0, self.alpha * 1.25)
        self.prev_value = value
        self._accepted = {"coefs": dict(coefs), "w": w_fe, "tabs": tabs,
                          "actives": actives, "acc": acc}
        new_coefs, fe_step, moves = self._step(self._accepted)
        diag = {self.fe_name: {
            "value": round(value, 8),
            "grad_norm": round(float(fe_gnorm), 8),
            "step_inf_norm": round(float(fe_step), 8),
            "alpha": round(self.alpha, 6),
            "fused": True}}
        for j, r in enumerate(self.res):
            off_r = total - re_scores[j]
            # Only entities whose statistics this pass accumulated (the
            # cycle-start mask) solved; a woken one enters next cycle.
            solved_mask = r.active.copy()
            woken = 0
            if self.retirement and r.solved_off is not None:
                retired = ~r.active
                if retired.any():
                    drift = r.entity_max(np.abs(off_r - r.solved_off))
                    woke = retired & (drift >= r.tolerance)
                    woken = int(woke.sum())
                    r.active |= woke
            if r.solved_off is None:
                r.solved_off = off_r.copy()
            # Solved entities' baselines move to this cycle's offsets.
            if solved_mask.any() and r.ex_sorted.size:
                per_ex = solved_mask[np.repeat(np.arange(r.E_total),
                                               np.diff(r.ent_starts))]
                ex = r.ex_sorted[per_ex]
                r.solved_off[ex] = off_r[ex]
            newly = 0
            if self.retirement:
                # Solved, step under the tolerance, offsets quiet since
                # the previous cycle.
                quiet = np.ones(r.E_total, bool)
                if r.prev_off is not None:
                    quiet = (r.entity_max(np.abs(off_r - r.prev_off))
                             < r.tolerance)
                retire = solved_mask & (moves[j] < r.tolerance) & quiet
                newly = int(retire.sum())
                r.active &= ~retire
                if newly:
                    _conv.re_retirement(r.name, newly,
                                        int((~r.active).sum()))
            r.prev_off = off_r.copy()
            diag[r.name] = {
                "entities": r.E_total,
                "entities_solved": int(solved_mask.sum()),
                "entities_retired": int((~r.active).sum()),
                "entities_newly_retired": newly,
                "entities_woken": woken,
                "fused": True}
        return new_coefs, scores, self._plane(total), diag

    def _plane(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def score_pass(self, coefs: dict):
        """The final model and its scores from one more pass: the given
        coefficients, or the last accepted point when their joint value
        rose above it (then one pass more).  Both passes are auxiliary
        sweeps of the odometer (the second, the port's return to the
        accepted point, is the pass the JAX package never makes).
        Returns (coefficients, scores a coordinate, total)."""
        zeros = [torch.zeros(r.E_total + 1, device=self.device)
                 for r in self.res]
        w_fe = torch.as_tensor(coefs[self.fe_name]).to(
            device=self.device, dtype=torch.float32)
        tabs = [self._tab_for(r, coefs[r.name]) for r in self.res]
        telemetry.count("solver.aux_sweeps")
        acc, fe_scores, re_scores = self._pass(w_fe, tabs, zeros)
        if (self._accepted is not None
                and self._rose(self._total_value(acc[0], w_fe, tabs))):
            point = self._accepted
            coefs = dict(point["coefs"])
            telemetry.count("solver.aux_sweeps")
            _, fe_scores, re_scores = self._pass(point["w"], point["tabs"],
                                                 zeros)
        scores = {self.fe_name: self._plane(fe_scores)}
        total = fe_scores.copy()
        for j, r in enumerate(self.res):
            scores[r.name] = self._plane(re_scores[j])
            total += re_scores[j]
        return coefs, scores, self._plane(total)

    # -- checkpoint state ---------------------------------------------------

    def _identity_fingerprint(self) -> str:
        """A hash of everything the snapshot's meaning depends on: the
        regularization weights (as float32, the JAX package's values),
        tolerances, the entity and chunk geometry and the retirement
        mode.  A resume after an edit refuses the stale masks and step
        scale.  The same string in either package."""
        ident = (
            self.fe_name,
            float(np.float32(self.objective.reg.l2_weight)),
            [(r.name, float(r.lam), float(r.tolerance), int(r.E_total),
              int(r.p_max)) for r in self.res],
            int(self.chunked.n_chunks), int(self.chunked.chunk_rows),
            int(self.chunked.dim),
            bool(self.retirement),
        )
        return hashlib.blake2b(repr(ident).encode(),
                               digest_size=16).hexdigest()

    def runtime_state(self) -> dict:
        """What the loop carries between cycles beyond the coefficients:
        the step scale, the last value, the retirement masks and offset
        baselines (the JAX package's tree), and the port's own keys: the
        last accepted point (its fixed effect, flattened tables, gates
        and float64 statistics) and the rejections so far (the JAX
        package ignores them; without them a resume starts with no point
        to return to)."""
        accepted = None
        pt = self._accepted
        if pt is not None:
            _, fe_g, fe_h, re_gs, re_Gs = pt["acc"]
            accepted = {
                "fe": pt["w"], "fe_g": fe_g, "fe_h": fe_h,
                "re": {r.name: {"tab": pt["tabs"][j],
                                "gate": pt["actives"][j],
                                "g": re_gs[j], "G": re_Gs[j]}
                       for j, r in enumerate(self.res)}}
        return {
            "fingerprint": self._identity_fingerprint(),
            "alpha": float(self.alpha),
            "prev_value": (None if self.prev_value is None
                           else float(self.prev_value)),
            "cycles": int(self.cycles),
            # A killed fleet host restores it and replays its reduce
            # sequence through the coordinator's cache.
            "fleet_seq": _fleet.seq(),
            "accepted": accepted,
            "rejections": int(self.rejections),
            "re": {r.name: {
                "active": np.asarray(r.active),
                "solved_off": (None if r.solved_off is None
                               else np.asarray(r.solved_off)),
                "prev_off": (None if r.prev_off is None
                             else np.asarray(r.prev_off)),
            } for r in self.res},
        }

    def restore_runtime_state(self, state: dict | None) -> None:
        if not state:
            return
        snap = state.get("fingerprint")
        if snap is not None:
            if not isinstance(snap, str):
                snap = str(np.asarray(snap).item())
            if snap != self._identity_fingerprint():
                raise ValueError(
                    "fused checkpoint was written under a different "
                    "configuration (regularization / tolerance / chunk "
                    "geometry changed); start a fresh checkpoint_dir")
        self.alpha = float(state.get("alpha", 1.0))
        pv = state.get("prev_value")
        self.prev_value = None if pv is None else float(pv)
        self.cycles = int(state.get("cycles", 0))
        self.rejections = int(state.get("rejections", 0))
        _fleet.restore_seq(state.get("fleet_seq"))
        acc = state.get("accepted")
        self._accepted = None
        if acc is not None:
            def dev(a, dtype):
                return torch.as_tensor(np.asarray(a, dtype)).to(self.device)

            re = [acc["re"][r.name] for r in self.res]
            tabs = [dev(x["tab"], np.float32) for x in re]
            coefs = {self.fe_name: dev(acc["fe"], np.float32)}
            for r, tab in zip(self.res, tabs):
                coefs[r.name] = self._unflatten(r, tab)
            self._accepted = {
                "coefs": coefs, "w": coefs[self.fe_name], "tabs": tabs,
                "actives": [dev(x["gate"], np.float32) for x in re],
                "acc": (None, dev(acc["fe_g"], np.float64),
                        dev(acc["fe_h"], np.float64),
                        tuple(dev(x["g"], np.float64) for x in re),
                        tuple(dev(x["G"], np.float64) for x in re))}
        for r in self.res:
            st = (state.get("re") or {}).get(r.name)
            if st is None:
                continue
            r.active = np.asarray(st["active"], bool).copy()
            so, po = st.get("solved_off"), st.get("prev_off")
            r.solved_off = (None if so is None
                            else np.asarray(so, np.float32).copy())
            r.prev_off = (None if po is None
                          else np.asarray(po, np.float32).copy())


# ---------------------------------------------------------------------------
# Construction: built coordinates → sidecar chunks on the fixed effect's
# chunk grid and each random effect's bookkeeping.
# ---------------------------------------------------------------------------


def _flat_entity_runs(grouping, boff: np.ndarray):
    """(ex_sorted, ent_starts) over the flat entity order (bucket base +
    slot)."""
    E = grouping.n_total_entities
    flat = boff[grouping.example_bucket] + grouping.example_row
    order = np.lexsort((grouping.example_col, flat))
    counts = np.bincount(flat[order], minlength=E)
    starts = np.zeros(E + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return order.astype(np.int64), starts


def _per_example_features(train, coord):
    """One random effect's per-example (x [n, p_max] float32, flat
    entity index [n] int32, widths, bucket bases, entities a bucket):
    dense shards directly, sparse ones through the subspace projection,
    each bucket's width padded to the widest."""
    grouping = coord.grouping
    n = grouping.n_examples
    n_ents = list(grouping.n_entities)
    boff = np.zeros(len(n_ents), np.int64)
    if len(n_ents) > 1:
        boff[1:] = np.cumsum(n_ents)[:-1]
    flat_idx = (boff[grouping.example_bucket]
                + grouping.example_row).astype(np.int32)
    shard = getattr(coord, "feature_shard", None)
    if shard is None or shard not in train.features:
        shard = _find_shard(train, coord,
                            sparse=coord.projection is not None)
    if coord.projection is None:
        x_ex = np.asarray(train.features[shard], np.float32)
        widths = [x_ex.shape[1]] * len(n_ents)
    else:
        from photon_ml_torch.data.sparse_rows import SparseRows
        from photon_ml_torch.game.projector import build_subspace_projection

        rows = SparseRows.from_rows(train.features[shard])
        _, x_blocks = build_subspace_projection(
            grouping, rows, coord.projection.global_dim)
        widths = [xb.shape[-1] for xb in x_blocks]
        x_ex = np.zeros((n, max(widths) if widths else 1), np.float32)
        for b in range(len(n_ents)):
            sel = np.flatnonzero(grouping.example_bucket == b)
            x_ex[sel, : widths[b]] = np.asarray(x_blocks[b])[
                grouping.example_row[sel], grouping.example_col[sel]]
    p_max = max(widths) if widths else 1
    if x_ex.shape[1] < p_max:
        x_ex = np.pad(x_ex, ((0, 0), (0, p_max - x_ex.shape[1])))
    return (np.ascontiguousarray(x_ex, dtype=np.float32), flat_idx,
            widths, boff, n_ents)


def _find_shard(train, coord, sparse: bool = False) -> str:
    """The feature shard a random effect was built from, matched by the
    grouping's example count and the shard's kind.  Ambiguity is an
    error: with a sparse fixed-effect shard and a sparse random-effect
    shard of one length, the first match could be the fixed effect's."""
    n = coord.grouping.n_examples
    candidates = []
    for name, feats in train.features.items():
        if isinstance(feats, np.ndarray) == sparse:
            continue
        if not hasattr(feats, "__len__") or len(feats) != n:
            continue
        candidates.append(name)
    if len(candidates) == 1:
        return candidates[0]
    if not candidates:
        raise ValueError("could not resolve the random effect's feature "
                         "shard from the dataset")
    raise ValueError(
        f"ambiguous feature shard for random effect "
        f"'{getattr(coord, 'name', '?')}': {sorted(candidates)} all "
        f"match; pass re_shards= to build_fused_cycle_engine")


def build_fused_cycle_engine(
    train,
    coords: dict,
    update_sequence: list[str],
    re_shards: dict[str, str] | None = None,
    spill_dir: str | None = None,
    host_max_resident: int = 2,
    prefetch_depth: int = 2,
    retirement: bool = True,
    window_group=None,
) -> FusedCycleEngine:
    """The fused engine over built coordinates: exactly one
    ``ChunkedFixedEffectCoordinate`` in the update sequence (its chunk
    grid is the master grid) and any number of random effects.
    ``re_shards`` maps a random effect's name to its feature shard
    (probed when absent).  With ``spill_dir`` the sidecars spill through
    the chunk store (content-keyed, warm across runs and packages, in
    ``window_group`` when given); otherwise they stay in host RAM."""
    from photon_ml_torch.game.coordinates import ChunkedFixedEffectCoordinate

    fe_name = None
    re_names = []
    for name in dict.fromkeys(update_sequence):
        coord = coords[name]
        if isinstance(coord, ChunkedFixedEffectCoordinate):
            if fe_name is not None:
                raise ValueError(
                    "cd_fused supports exactly one chunked fixed-effect "
                    "coordinate")
            fe_name = name
        elif hasattr(coord, "grouping"):
            re_names.append(name)
        else:
            raise ValueError(
                f"cd_fused: coordinate '{name}' is neither a chunked "
                "fixed effect nor a random effect")
    if fe_name is None:
        raise ValueError("cd_fused requires a chunked fixed-effect "
                         "coordinate (chunk_rows)")
    fe_coord = coords[fe_name]
    chunked = fe_coord.chunked
    K, R, n = chunked.n_chunks, chunked.chunk_rows, chunked.n

    res: list[_FusedRE] = []
    side_planes: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for name in re_names:
        coord = coords[name]
        if coord.grouping.n_examples != n:
            raise ValueError(
                f"cd_fused: random effect '{name}' covers "
                f"{coord.grouping.n_examples} examples, the fixed "
                f"effect {n}: one chunk grid must fit both")
        if (re_shards or {}).get(name):
            coord.feature_shard = re_shards[name]
        x_ex, flat_idx, widths, boff, n_ents = _per_example_features(
            train, coord)
        E_total = int(sum(n_ents))
        ex_sorted, ent_starts = _flat_entity_runs(coord.grouping, boff)
        res.append(_FusedRE(
            name=name, coord=coord,
            lam=float(np.float32(coord.problem.objective.reg.l2_weight)),
            tolerance=float(coord.problem.config.tolerance),
            widths=[int(w) for w in widths],
            p_max=max(widths) if widths else 1,
            n_entities=[int(e) for e in n_ents], boff=boff,
            E_total=E_total, ex_sorted=ex_sorted, ent_starts=ent_starts,
            active=np.ones(E_total, bool)))
        side_planes[name] = (x_ex, flat_idx)
    e_totals = {r.name: r.E_total for r in res}

    def planes() -> dict:
        """The per-example planes, re-made from the dataset when they
        were dropped after the spill (a lineage rebuild pays one
        deterministic re-projection; keeping them would void the
        window's bound)."""
        if not side_planes:
            for r in res:
                x_ex, flat_idx, *_ = _per_example_features(train, r.coord)
                side_planes[r.name] = (x_ex, flat_idx)
        return side_planes

    def build_sidecar(i: int) -> dict:
        lo, hi = i * R, min(i * R + R, n)
        out: dict = {}
        for name, (x_ex, flat_idx) in planes().items():
            x = x_ex[lo:hi]
            if hi - lo < R:
                x = np.pad(x, ((0, R - (hi - lo)), (0, 0)))
            idx = np.full(R, e_totals[name], np.int32)
            idx[: hi - lo] = flat_idx[lo:hi]
            out[name + ".x"] = np.ascontiguousarray(x)
            out[name + ".idx"] = idx
        return out

    # A fleet host builds and spills the sidecars of its shard only,
    # under its per-host spill dir.
    owned = chunked.owned_chunk_ids
    sidecar_store = None
    sidecar_resident = None
    if res and spill_dir is not None:
        from photon_ml_torch.data.chunk_store import (
            FUSED_CHUNK_CODEC,
            ChunkStore,
            array_content_key,
            probe_spill_dir,
            release_free_heap,
        )

        spill_dir = _fleet.host_dir(spill_dir, _fleet.active())
        if probe_spill_dir(spill_dir) is not None:
            key_arrays = []
            for name in sorted(side_planes):
                key_arrays.extend(side_planes[name])
            key = array_content_key(key_arrays, {
                "kind": "fused-sidecar", "chunk_rows": int(R),
                "n_chunks": int(K), "res": sorted(side_planes)})
            sidecar_store = ChunkStore(
                spill_dir, key, K, host_max_resident=host_max_resident,
                rebuild=build_sidecar, codec=FUSED_CHUNK_CODEC,
                window_group=window_group)
            missing = [i for i in owned if not sidecar_store.has(i)]
            for i in missing:
                sidecar_store.put(i, build_sidecar(i))
            side_planes.clear()    # the window is the only residency now
            if missing:
                release_free_heap()
            logger.info("fused sidecar: %d chunks (%d built, %d reused) "
                        "spilled to %s", len(owned), len(missing),
                        len(owned) - len(missing), spill_dir)
    if res and sidecar_store is None:
        owned_set = set(owned)
        sidecar_resident = [build_sidecar(i) if i in owned_set else None
                            for i in range(K)]

    engine = FusedCycleEngine(
        fe_name=fe_name, fe_coord=fe_coord, res=res, n_examples=n,
        prefetch_depth=prefetch_depth, retirement=retirement,
        sidecar_store=sidecar_store, sidecar_resident=sidecar_resident)
    logger.info(
        "fused CD engine: fixed effect '%s' (%d chunks × %d rows) + %d "
        "random effect(s) %s, one store pass a cycle", fe_name, K, R,
        len(res), [r.name for r in res])
    return engine
