"""GRR (gather-route-reduce) layout: a static plan for both sparse
contractions of the GLM hot loop.

Counterpart of ``photon_ml_tpu/data/grr.py``.  Both directions are
instances of ``out[s] = Σ_e val_e·table[idx_e]`` (margins: s = example,
table = w; gradient: s = feature, table = residual).  The plan, built
once on the host, blocks the non-zeros into supertiles of 128 × 128
slots, one per (segment window × table window) pair; within a supertile
each element starts in the row of its table index's window sub-tile and
is routed to its segment's reduction slot by a three-stage Clos route
(``ops.crossbar``).  Each segment owns ``cap`` slots per table window;
what overflows goes to an overflow plan with its own cap, and what is
left to a small COO spill list.  Hot columns go to a dense side matrix,
mid-hot ones (gradient direction) to a compact plan of their own.

The builder is the JAX package's numpy host code, copied, with the same
C++ library behind it (``native``), so both packages compile the same
input to the same arrays and share plan-cache files.  The plan types
hold torch tensors on an explicit device (``to``); ``contract`` runs
the hand-written CUDA kernels of ``ops.grr_kernel`` on a CUDA device
(B2 for dense-grid plans, B3 for the others) and their plain versions on
the CPU.  There is no switch that turns the kernels off.

A direction whose COO residual (the spill that stays on the scatter
path) exceeds 5 % of its entries is flagged; the flags of one
``build_grr_pair`` are one warning and one ``grr.spill_flagged_builds``
telemetry count (``_SpillWarnings``).

``build_sharded_grr_pairs`` compiles one congruent plan a row shard
(the mesh's shards and the GRR chunk layouts): one hot and mid set, one
cap a direction, overflow decided on the pooled spill, and every shard
padded to the same leaf shapes with zero-valued supertiles and COO
entries.  Its host plans are the JAX package's, array for array, and
its plan-cache entries load in either package.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.grr_kernel import (
    DENSE_B,
    grr_contract,
    grr_contract_dense,
)

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

WIN = 16384          # table entries per gather window ([128,128] tile)
TILE = 128
SLOTS = TILE * TILE  # nonzero slots per supertile

# Planner semantics version: part of every plan-cache key; kept equal to
# the JAX package's so both read each other's cached plans.
PLANNER_VERSION = 1

DENSE_GRID_MIN_FILL = 0.7


class _SpillWarnings:
    """Aggregates the per-direction spill-fraction warnings: inside a
    collecting scope (``build_grr_pair``; re-entrant, thread-safe, the
    direction builds run on a pool) the flagged builds are one summary
    at scope exit; outside any scope the first flagged build reports at
    once and later ones within ``_UNSCOPED_WINDOW_S`` join the next
    summary.  Every summary counts ``grr.spill_flagged_builds``."""

    _THRESHOLD = 0.05          # COO fraction below which no one acts
    _UNSCOPED_WINDOW_S = 30.0

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._builds = 0
        self._flagged: list = []
        self._last_emit: float | None = None

    def __enter__(self):
        with self._lock:
            builds = flagged = None
            if self._depth == 0:
                builds, flagged = self._drain()
            self._depth += 1
        if flagged:
            self._emit(builds, flagged)
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth:
                return False
            builds, flagged = self._drain()
        if flagged:
            self._emit(builds, flagged)
        return False

    def _drain(self) -> tuple[int, list]:
        builds, flagged = self._builds, self._flagged
        self._builds, self._flagged = 0, []
        return builds, flagged

    def _emit(self, builds: int, flagged: list) -> None:
        telemetry.count("grr.spill_flagged_builds", len(flagged))
        logger.warning(
            "GRR spill fraction >%.0f%% on the scatter path in %d of %d "
            "direction builds (min %.1f%%, max %.1f%%, mean %.1f%%): "
            "consider a larger cap or a lower hot-column threshold",
            100 * self._THRESHOLD, len(flagged), builds,
            100 * min(flagged), 100 * max(flagged),
            100 * sum(flagged) / len(flagged))

    def note(self, m_coo: int, total: int) -> None:
        if not total:
            return
        frac = m_coo / total
        with self._lock:
            self._builds += 1
            if frac > self._THRESHOLD:
                self._flagged.append(frac)
            if self._depth or not self._flagged:
                return
            now = time.monotonic()
            if (self._last_emit is not None
                    and now - self._last_emit < self._UNSCOPED_WINDOW_S):
                return               # buffer the burst
            self._last_emit = now
            builds, flagged = self._drain()
        self._emit(builds, flagged)


_spill_warnings = _SpillWarnings()


def _collect_spill_warnings(fn):
    """One spill summary over a plan build."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _spill_warnings:
            return fn(*args, **kwargs)

    return wrapped


def collect_spill_warnings():
    """The public aggregation scope for builds that compile several plan
    families (``build_chunked_batch``, ``shard_sparse_batch``): every
    nested ``build_grr_pair``/``build_sharded_grr_pairs`` scope folds
    into one summary at the outermost exit (the scope is re-entrant)."""
    return _spill_warnings


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _group_ranks(keys: np.ndarray) -> np.ndarray:
    """Rank of each entry within its key group (0-based).  Sorted keys
    rank in one run-length pass; others through a stable argsort."""
    n = keys.size
    if n == 0:
        return np.zeros(0, np.int64)
    if bool((keys[1:] >= keys[:-1]).all()):
        newgrp = np.r_[True, keys[1:] != keys[:-1]]
        gstart = np.maximum.accumulate(np.where(newgrp, np.arange(n), 0))
        return np.arange(n) - gstart
    sort_keys = keys
    if keys.dtype.itemsize > 4 and 0 <= int(keys.min()) \
            and int(keys.max()) < np.iinfo(np.int32).max:
        sort_keys = keys.astype(np.int32)
    order = np.argsort(sort_keys, kind="stable")
    sk = keys[order]
    newgrp = np.r_[True, sk[1:] != sk[:-1]]
    gstart = np.maximum.accumulate(np.where(newgrp, np.arange(n), 0))
    ranks = np.empty(n, np.int64)
    ranks[order] = np.arange(n) - gstart
    return ranks


def _nnz(a) -> int:
    if isinstance(a, Tensor):
        return int(torch.count_nonzero(a))
    return int(np.count_nonzero(a))


def _place(a, device: torch.device) -> Tensor:
    """A leaf on ``device``.  A read-only array (a plan loaded from a
    memory-mapped spill file) is copied: up to the card by the transfer,
    on the CPU explicitly, so no tensor aliases the mapping."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        if device.type == "cpu":
            return torch.from_numpy(a.copy())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # read once by the copy
            return torch.from_numpy(a).to(device)
    return torch.as_tensor(a).to(device)


# -- plan types -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GrrDirection:
    """One direction's compiled plan.  Leaves are numpy arrays on a host
    plan (as built or loaded) and torch tensors after ``to(device)``."""

    g1: Tensor            # [n_st,128,128] i8 — gather ∘ route stage 1
    g2: Tensor            # [n_st,128,128] i8 — route stage 2 (transposed)
    g3: Tensor            # [n_st,128,128] i8 — route stage 3
    vals: Tensor          # [n_st,128,128] f32 — values in final slot order
    gw_of_st: Tensor      # [n_st] i32 (dense grid: [n_st/4] per 4 tiles)
    ow_of_st: Tensor      # [n_st] i32 (dense grid: empty)
    first_of_ow: Tensor   # [n_st] i32 (dense grid: empty)
    spill_idx: Tensor     # [m] i32 — COO residual
    spill_seg: Tensor     # [m] i32
    spill_val: Tensor     # [m] f32
    table_len: int
    n_segments: int
    cap: int
    n_gw: int
    n_ow: int
    # Dense grid: tiles gw-major over the full (gw × ow_p) grid, missing
    # blocks as zero dummy tiles; a tile's position IS its (gw, ow).
    dense_grid: bool = False
    # Overflow plan over the heavy tail (its own, larger cap).
    overflow: "GrrDirection | None" = None

    @property
    def n_supertiles(self) -> int:
        return self.vals.shape[0]

    @property
    def n_spill(self) -> int:
        return int(self.spill_idx.shape[0])

    @property
    def n_ow_padded(self) -> int:
        """Dense grid: padded ow count (n_supertiles / n_gw)."""
        return self.n_supertiles // self.n_gw

    def to(self, device) -> "GrrDirection":
        """The plan with tensor leaves on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(
            self,
            **{f: _place(getattr(self, f), device) for f in _ARRAY_FIELDS},
            overflow=(None if self.overflow is None
                      else self.overflow.to(device)))

    def contract(self, table: Tensor) -> Tensor:
        """``out[s] = Σ val_e · table[idx_e]`` — [n_segments]."""
        table = table.to(torch.float32)
        pad = self.n_gw * WIN - self.table_len
        # Window rows ARE table sub-tiles: no transpose.
        table_t = torch.nn.functional.pad(table, (0, pad)).view(
            self.n_gw, TILE, TILE)
        if self.dense_grid:
            out2d = grr_contract_dense(
                table_t, self.g1, self.g2, self.g3, self.vals,
                self.gw_of_st, n_ow_p=self.n_ow_padded, cap=self.cap)
        else:
            out2d = grr_contract(
                table_t, self.g1, self.g2, self.g3, self.vals,
                self.gw_of_st, self.ow_of_st, self.first_of_ow,
                n_ow=self.n_ow, cap=self.cap)
        out = out2d.reshape(-1)[: self.n_segments]
        if self.overflow is not None:
            out = out + self.overflow.contract(table)
        if self.n_spill:
            # The COO residual adds a segment's terms (float32 products)
            # in the atomics' order on the card.  Their float64 sum's
            # rounding is far below the float32 result's, so the order
            # shows only where that sum lies within float64 rounding of
            # a float32 rounding boundary: rare, but a run is not
            # bitwise by construction.
            spill = torch.zeros(self.n_segments, dtype=torch.float64,
                                device=out.device).index_add_(
                0, self.spill_seg,
                (self.spill_val * table[self.spill_idx]).double())
            out = out + spill.to(out.dtype)
        return out

    def squared(self) -> "GrrDirection":
        """Same plan with values squared (Hessian-diagonal aggregation)."""
        return dataclasses.replace(
            self,
            vals=self.vals * self.vals,
            spill_val=self.spill_val * self.spill_val,
            overflow=(None if self.overflow is None
                      else self.overflow.squared()))

    def plan_stats(self) -> dict:
        """Placement accounting: entries on the level-1 kernel, per
        overflow level, and the COO residual."""
        lvl1 = _nnz(self.vals)
        levels = []
        coo = 0
        d = self
        while d is not None:
            if d is not self:
                levels.append(_nnz(d.vals))
            coo += _nnz(d.spill_val)
            d = d.overflow
        total = lvl1 + sum(levels) + coo
        return {
            "entries": total,
            "level1": lvl1,
            "overflow_levels": levels,
            "coo": coo,
            "coo_frac": coo / total if total else 0.0,
            "spill_frac": ((sum(levels) + coo) / total) if total else 0.0,
            "supertiles": self.n_supertiles,
            "cap": self.cap,
            "fill": (lvl1 / (self.n_supertiles * SLOTS)
                     if self.n_supertiles else 0.0),
        }


_ARRAY_FIELDS = ("g1", "g2", "g3", "vals", "gw_of_st", "ow_of_st",
                 "first_of_ow", "spill_idx", "spill_seg", "spill_val")


@dataclasses.dataclass(frozen=True)
class GrrRangeSplit:
    """Column-range split of one direction (the row direction under
    power-law column popularity): one sub-plan per contiguous,
    window-aligned table range with its own cap,
    ``out[s] = Σ_r plan_r.contract(table[lo_r:hi_r])``."""

    parts: tuple          # tuple[GrrDirection, ...]
    bounds: tuple         # len(parts) + 1 column ids
    table_len: int
    n_segments: int

    @property
    def n_spill(self) -> int:
        return sum(p.n_spill for p in self.parts)

    def to(self, device) -> "GrrRangeSplit":
        return dataclasses.replace(
            self, parts=tuple(p.to(device) for p in self.parts))

    def contract(self, table: Tensor) -> Tensor:
        out = None
        for p, lo, hi in zip(self.parts, self.bounds[:-1], self.bounds[1:]):
            part = p.contract(table[lo:hi])
            out = part if out is None else out + part
        return out

    def squared(self) -> "GrrRangeSplit":
        return dataclasses.replace(
            self, parts=tuple(p.squared() for p in self.parts))

    def plan_stats(self) -> dict:
        ps = [p.plan_stats() for p in self.parts]
        total = sum(s["entries"] for s in ps)
        coo = sum(s["coo"] for s in ps)
        spill = sum(s["coo"] + sum(s["overflow_levels"]) for s in ps)
        st = sum(s["supertiles"] for s in ps)
        return {
            "entries": total,
            "level1": sum(s["level1"] for s in ps),
            "overflow_levels": [sum(s["overflow_levels"]) for s in ps],
            "coo": coo,
            "coo_frac": coo / total if total else 0.0,
            "spill_frac": spill / total if total else 0.0,
            "supertiles": st,
            "cap": [s["cap"] for s in ps],
            "fill": (sum(s["level1"] for s in ps) / (st * SLOTS)
                     if st else 0.0),
            "bounds": list(self.bounds),
        }


@dataclasses.dataclass(frozen=True)
class GrrPair:
    """Both contraction directions plus the dense hot-column side: a
    sparse design matrix whose ``dot``/``t_dot`` are X·v and Xᵀ·r.

    Mega-hot columns live in the dense [n, H] ``x_hot``; mid-hot columns
    (gradient direction) get the compact plan ``col_mid`` over remapped
    ids ``mid_ids``; the tail runs the main plans and their overflow."""

    row_dir: "GrrDirection | GrrRangeSplit"   # segments = rows, table = w
    col_dir: GrrDirection   # segments = tail cols, table = residual
    hot_ids: Tensor         # [H] i32
    x_hot: Tensor           # [n_rows, H] f32
    mid_ids: "Tensor | None" = None           # [M] i32
    col_mid: "GrrDirection | None" = None     # segments = mid cols

    @property
    def n_rows(self) -> int:
        return self.row_dir.n_segments

    @property
    def dim(self) -> int:
        return self.col_dir.n_segments

    def to(self, device) -> "GrrPair":
        device = torch.device(device)
        return GrrPair(
            row_dir=self.row_dir.to(device), col_dir=self.col_dir.to(device),
            hot_ids=_place(self.hot_ids, device),
            x_hot=_place(self.x_hot, device),
            mid_ids=(None if self.mid_ids is None
                     else _place(self.mid_ids, device)),
            col_mid=None if self.col_mid is None else self.col_mid.to(device))

    def dot(self, w: Tensor) -> Tensor:
        """X·w — [n_rows] (margins, HVP forward side)."""
        return _GrrDot.apply(w, self)

    def t_dot(self, r: Tensor) -> Tensor:
        """Xᵀ·r — [dim] (gradient side)."""
        return _GrrTDot.apply(r, self)

    def squared(self) -> "GrrPair":
        return GrrPair(
            row_dir=self.row_dir.squared(), col_dir=self.col_dir.squared(),
            hot_ids=self.hot_ids, x_hot=self.x_hot * self.x_hot,
            mid_ids=self.mid_ids,
            col_mid=None if self.col_mid is None else self.col_mid.squared())

    def plan_stats(self) -> dict:
        return {
            "row": self.row_dir.plan_stats(),
            "col": self.col_dir.plan_stats(),
            "mid": None if self.col_mid is None else self.col_mid.plan_stats(),
            "hot_columns": int(self.hot_ids.shape[0]),
        }


def _dot_impl(pair: GrrPair, w: Tensor) -> Tensor:
    out = pair.row_dir.contract(w)
    if pair.hot_ids.shape[0]:
        out = out + torch.matmul(pair.x_hot, w[pair.hot_ids])
    return out


def _tdot_impl(pair: GrrPair, r: Tensor) -> Tensor:
    out = pair.col_dir.contract(r)
    if pair.col_mid is not None:
        out = out.index_add(0, pair.mid_ids, pair.col_mid.contract(r))
    if pair.hot_ids.shape[0]:
        out = out.index_add(0, pair.hot_ids, torch.matmul(pair.x_hot.T, r))
    return out


class _GrrDot(torch.autograd.Function):
    """X·w; its backward is Xᵀ·g through the other direction's plan, so
    autograd never differentiates through a kernel."""

    @staticmethod
    def forward(ctx, w, pair):
        ctx.pair = pair
        return _dot_impl(pair, w)

    @staticmethod
    def backward(ctx, g):
        return _tdot_impl(ctx.pair, g), None


class _GrrTDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, pair):
        ctx.pair = pair
        return _tdot_impl(pair, r)

    @staticmethod
    def backward(ctx, g):
        return _dot_impl(ctx.pair, g), None


# -- the host builder (numpy; the JAX package's, copied) -------------------------


def _maybe_dense_grid(G1, G2, G3, VALS, gw_of_st, ow_of_st, n_gw, n_ow,
                      force=None):
    """Reorder a built plan's tiles into the gw-major full (gw × ow_p)
    grid when the block grid is dense enough (≥ DENSE_GRID_MIN_FILL) or
    ``force`` says so.  Returns (G1, G2, G3, VALS, gwg) or None."""
    n_ow_p = -(-n_ow // DENSE_B) * DENSE_B
    n_st_p = n_gw * n_ow_p
    n_st = VALS.shape[0]
    dense = (force if force is not None
             else n_st >= DENSE_GRID_MIN_FILL * n_st_p)
    if not dense:
        return None
    pos = (np.asarray(gw_of_st, np.int64) * n_ow_p
           + np.asarray(ow_of_st, np.int64))

    def scatter(a):
        out = np.zeros((n_st_p,) + a.shape[1:], a.dtype)
        out[pos] = a
        return out

    gwg = np.repeat(np.arange(n_gw, dtype=np.int32), n_ow_p // DENSE_B)
    return (scatter(np.asarray(G1)), scatter(np.asarray(G2)),
            scatter(np.asarray(G3)), scatter(np.asarray(VALS)), gwg)


def _spill_overflow(s_idx, s_seg, s_val, m_real, table_len, n_segments,
                    validate, threshold, depth=4):
    """Compile the COO spill into an overflow plan when it is big enough
    to matter (up to ``depth`` levels) and each level keeps under 96
    streamed slots per absorbed entry.  Returns (overflow, s_idx, s_seg,
    s_val), the spill arrays emptied when absorbed."""
    if depth <= 0 or threshold is None or m_real <= threshold:
        return None, s_idx, s_seg, s_val
    # Every plan carries at least ceil(n_segments / segwin) supertiles;
    # a tail that cannot clear the bar even at that floor is not built.
    st_floor = -(-n_segments // (WIN // 4))
    if st_floor * SLOTS > 96 * m_real:
        return None, s_idx, s_seg, s_val
    lvl2 = _build_host_direction(
        idx=np.asarray(s_idx[:m_real], np.int64),
        seg=np.asarray(s_seg[:m_real], np.int64),
        val=np.asarray(s_val[:m_real]),
        table_len=table_len, n_segments=n_segments,
        cap=None, validate=validate,
        overflow_threshold=(threshold if depth > 1 else None),
        overflow_depth=depth - 1,
    )
    if lvl2.n_supertiles * SLOTS > 96 * m_real:
        return None, s_idx, s_seg, s_val
    z = np.zeros(0, np.int32)
    return lvl2, z, z, np.zeros(0, np.float32)


def _native_direction(cols, vals_masked, direction, table_len, n_segments,
                      cap, validate, overflow_threshold, dense_grid=None,
                      idx_range=None) -> "GrrDirection | None":
    """One direction's host plan via the C++ builder (``pml_grr_plan``),
    or None when the native library is unavailable.  ``idx_range=(lo,
    hi)`` builds a column-range sub-plan over the table slice [lo, hi)."""
    from photon_ml_torch.native import grr_plan_native, grr_routes_native

    plan = grr_plan_native(cols, vals_masked, direction, table_len,
                           n_segments, cap, idx_range=idx_range)
    if plan is None:
        return None
    if idx_range is not None:
        table_len = int(idx_range[1] - idx_range[0])
    routes = grr_routes_native(plan["dst"], plan["hi"])
    if routes is None:
        return None
    G1, G2, G3 = routes
    if validate and plan["vals"].shape[0]:
        _validate_routes(G2, G3)
    m = int(np.count_nonzero(plan["spill_val"]))
    total = m + int(np.count_nonzero(plan["vals"]))
    overflow, s_idx, s_seg, s_val = _spill_overflow(
        plan["spill_idx"], plan["spill_seg"], plan["spill_val"], m,
        table_len, n_segments, validate, overflow_threshold)
    # Only the spill left on the scatter path is flagged (what the
    # overflow plan absorbed runs on the kernel).
    _spill_warnings.note(int(np.count_nonzero(s_val)), total)
    VALS, gw_arr = plan["vals"], plan["gw_of_st"]
    ow_arr, first_arr = plan["ow_of_st"], plan["first_of_ow"]
    dg = _maybe_dense_grid(G1, G2, G3, VALS, gw_arr, ow_arr,
                           plan["n_gw"], plan["n_ow"], force=dense_grid)
    if dg is not None:
        G1, G2, G3, VALS, gw_arr = dg
        ow_arr = first_arr = np.zeros(0, np.int32)
    return GrrDirection(
        g1=G1, g2=G2, g3=G3, vals=VALS, gw_of_st=gw_arr, ow_of_st=ow_arr,
        first_of_ow=first_arr, spill_idx=s_idx, spill_seg=s_seg,
        spill_val=s_val, table_len=table_len, n_segments=n_segments,
        cap=plan["cap"], n_gw=plan["n_gw"], n_ow=plan["n_ow"],
        overflow=overflow, dense_grid=dg is not None)


def build_grr_direction(
    idx: np.ndarray,
    seg: np.ndarray,
    val: np.ndarray,
    table_len: int,
    n_segments: int,
    cap: int | None = None,
    validate: bool = True,
    overflow_threshold: int | None = None,
    device=None,
    dense_grid: bool | None = None,
) -> GrrDirection:
    """Compile one direction's plan from COO (idx, seg, val) and place
    it on ``device`` (default CUDA; ``"cpu"`` when asked).

    Entries with val == 0 are dropped.  ``cap`` (slots per segment per
    table window) defaults to a heuristic from the occupancy; overflow
    spills to an overflow plan or the COO residual."""
    return _build_host_direction(
        idx, seg, val, table_len, n_segments, cap=cap, validate=validate,
        overflow_threshold=overflow_threshold,
        dense_grid=dense_grid).to(resolve_device(device))


def _build_host_direction(idx, seg, val, table_len, n_segments, cap=None,
                          validate=True, overflow_threshold=None,
                          dense_grid=None, overflow_depth=4) -> GrrDirection:
    """``build_grr_direction`` without the placement: numpy leaves."""
    from photon_ml_torch.native import grr_routes_native
    from photon_ml_torch.ops.crossbar import route_tile

    idx = np.asarray(idx, np.int64)
    seg = np.asarray(seg, np.int64)
    val = np.asarray(val, np.float32)
    keep0 = val != 0
    if not bool(keep0.all()):
        idx, seg, val = idx[keep0], seg[keep0], val[keep0]
    if idx.size and (idx.min() < 0 or idx.max() >= table_len):
        raise ValueError("idx out of range")
    if seg.size and (seg.min() < 0 or seg.max() >= n_segments):
        raise ValueError("seg out of range")

    n_gw = max(1, -(-table_len // WIN))
    gw = idx // WIN

    # Capacity heuristic: cover ~1.5× the mean nonempty (seg, window)
    # occupancy; a power of two in [4, 64].  Estimated from a seeded
    # sample of whole segments above 8192 segments.
    group_key = seg * n_gw + gw
    if cap is None:
        if idx.size:
            if n_segments > 8192:
                segs = np.random.default_rng(0).choice(
                    n_segments, 4096, replace=False)
                lut = np.zeros(n_segments, bool)
                lut[segs] = True
                samp = group_key[lut[seg]]
            else:
                samp = group_key
            _, counts = np.unique(samp, return_counts=True)
            mean = counts.mean() if counts.size else 1.0
            cap = int(np.clip(_next_pow2(int(np.ceil(1.5 * mean))), 4, 64))
        else:
            cap = 4
    if cap not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ValueError(f"cap must be a power of two ≤ 128, got {cap}")
    segwin = WIN // cap
    group = TILE // cap
    n_ow = max(1, -(-n_segments // segwin))

    # Slot rank within (seg, window); beyond cap → spill.
    q = _group_ranks(group_key)
    spill1 = q >= cap

    ow = seg // segwin
    bk = ow * n_gw + gw                    # block key, sorted = (ow, gw)
    # Start row = the entry's window sub-tile; the gather plane carries
    # the lane residue idx % 128.
    hrow = (idx % WIN) // TILE

    # Start-lane rank within (block, start row) among cap-kept entries;
    # beyond 128 starts a row → spill.
    k1 = ~spill1
    rank2 = np.full(idx.size, TILE, np.int64)
    rank2[k1] = _group_ranks(bk[k1] * TILE + hrow[k1])
    spill2 = k1 & (rank2 >= TILE)
    kept = k1 & ~spill2
    spilled = ~kept

    # Supertiles: one per non-empty block, plus a dummy per empty
    # segment window (every ow needs ≥ 1 supertile).
    bkk = bk[kept]
    if bkk.size and bool((bkk[1:] >= bkk[:-1]).all()):
        blocks = bkk[np.r_[True, bkk[1:] != bkk[:-1]]]
    else:
        blocks = np.unique(bkk)
    present_ow = (np.unique(blocks // n_gw) if blocks.size
                  else np.empty(0, np.int64))
    missing_ow = np.setdiff1d(np.arange(n_ow, dtype=np.int64), present_ow)
    blocks = np.sort(np.r_[blocks, missing_ow * n_gw])
    n_st = blocks.size
    st_of = np.searchsorted(blocks, bkk)

    gw_of_st = (blocks % n_gw).astype(np.int32)
    ow_of_st = (blocks // n_gw).astype(np.int32)
    first_of_ow = np.r_[1, (np.diff(ow_of_st) != 0).astype(np.int32)].astype(
        np.int32)

    # Start and final positions within each supertile.
    r_s = hrow[kept]
    l_s = rank2[kept]
    b = seg[kept] % segwin
    r_f = q[kept] * group + b // TILE
    l_f = b % TILE
    start_flat = st_of * SLOTS + r_s * TILE + l_s
    final_flat = st_of * SLOTS + r_f * TILE + l_f

    hi = (idx[kept] % TILE).astype(np.int8)
    HI = np.zeros(n_st * SLOTS, np.int8)
    HI[start_flat] = hi
    VALS = np.zeros(n_st * SLOTS, np.float32)
    VALS[final_flat] = val[kept]

    # Destination-slot map: real elements start → final; padding starts
    # pair off with padding finals (both sorted, equal per-tile counts).
    dst = np.empty(n_st * SLOTS, np.int32)
    occ_s = np.zeros(n_st * SLOTS, bool)
    occ_s[start_flat] = True
    occ_f = np.zeros(n_st * SLOTS, bool)
    occ_f[final_flat] = True
    dst[start_flat] = (r_f * TILE + l_f).astype(np.int32)
    free_s = np.flatnonzero(~occ_s)
    free_f = np.flatnonzero(~occ_f)
    dst[free_s] = (free_f % SLOTS).astype(np.int32)
    dst = dst.reshape(n_st, TILE, TILE)
    HI = HI.reshape(n_st, TILE, TILE)
    VALS = VALS.reshape(n_st, TILE, TILE)

    # Route every supertile, route stage 1 fused into the gather index:
    # the C++ batch router, else the Python colorer tile by tile.
    native = grr_routes_native(dst, HI)
    if native is not None:
        G1, G2, G3 = native
    else:
        if n_st > 64:
            logger.warning(
                "GRR: routing %d supertiles with the pure-Python colorer "
                "(native library unavailable); orders of magnitude "
                "slower than the C++ path", n_st)
        G1 = np.empty((n_st, TILE, TILE), np.int8)
        G2 = np.empty((n_st, TILE, TILE), np.int8)
        G3 = np.empty((n_st, TILE, TILE), np.int8)
        for t in range(n_st):
            rg1, rg2, rg3 = route_tile(dst[t])
            G1[t] = np.take_along_axis(HI[t], rg1, axis=1).astype(np.int8)
            G2[t] = rg2.astype(np.int8)
            G3[t] = rg3.astype(np.int8)

    if validate and n_st:
        _validate_routes(G2, G3)

    # Spill COO, padded to a multiple of 8.
    s_idx = idx[spilled].astype(np.int32)
    s_seg = seg[spilled].astype(np.int32)
    s_val = val[spilled]
    m = s_idx.size
    if m:
        m_pad = -(-m // 8) * 8
        s_idx = np.pad(s_idx, (0, m_pad - m))
        s_seg = np.pad(s_seg, (0, m_pad - m))
        s_val = np.pad(s_val, (0, m_pad - m))

    overflow, s_idx, s_seg, s_val = _spill_overflow(
        s_idx, s_seg, s_val, m, table_len, n_segments, validate,
        overflow_threshold, depth=overflow_depth)
    _spill_warnings.note(int(np.count_nonzero(s_val)), max(idx.size, 1))
    dg = _maybe_dense_grid(G1, G2, G3, VALS, gw_of_st, ow_of_st,
                           n_gw, n_ow, force=dense_grid)
    if dg is not None:
        G1, G2, G3, VALS, gw_of_st = dg
        ow_of_st = first_of_ow = np.zeros(0, np.int32)
    return GrrDirection(
        g1=G1, g2=G2, g3=G3, vals=VALS, gw_of_st=gw_of_st,
        ow_of_st=ow_of_st, first_of_ow=first_of_ow, spill_idx=s_idx,
        spill_seg=s_seg, spill_val=s_val, table_len=table_len,
        n_segments=n_segments, cap=cap, n_gw=n_gw, n_ow=n_ow,
        overflow=overflow, dense_grid=dg is not None)


def _validate_routes(G2, G3) -> None:
    """Every row of route stages 2 and 3 must be a lane permutation (a
    proper coloring); large plans are checked on 256 sampled tiles."""
    if G2.shape[0] > 256:
        sel = np.linspace(0, G2.shape[0] - 1, 256).astype(np.int64)
        G2, G3 = G2[sel], G3[sel]
    for name, G in (("g2", G2), ("g3", G3)):
        sorted_rows = np.sort(G.astype(np.int32), axis=2)
        if not np.array_equal(
                sorted_rows,
                np.broadcast_to(np.arange(TILE, dtype=np.int32), G.shape)):
            raise AssertionError(
                f"GRR route stage {name} is not a lane permutation — "
                "improper edge coloring")


def _select_hot(counts: np.ndarray, threshold: int,
                max_hot: int) -> np.ndarray:
    """Hot-column ids: the top ``max_hot`` above ``threshold``."""
    hot = np.flatnonzero(counts > threshold)
    if hot.size > max_hot:
        order = np.argsort(counts[hot])[::-1]
        hot = np.sort(hot[order[:max_hot]])
    return hot


def _apply_hot_split(cols, vals, dim, n_rows, hot):
    """Densify a hot id set out of an ELL batch → (x_hot [n_rows, H],
    keep_mask [n, k])."""
    nz = vals != 0
    pos = np.full(dim, -1, np.int64)
    pos[hot] = np.arange(hot.size)
    is_hot = nz & (pos[cols] >= 0)
    x_hot = np.zeros((n_rows, hot.size), np.float32)
    r_idx, k_idx = np.nonzero(is_hot)
    np.add.at(x_hot, (r_idx, pos[cols[r_idx, k_idx]]), vals[r_idx, k_idx])
    return x_hot, nz & ~is_hot


def dense_hot_split(cols: np.ndarray, vals: np.ndarray, dim: int,
                    n_rows: int, threshold: int | None = None,
                    max_hot: int = 128):
    """Split hot columns out of an ELL batch for the dense side →
    (hot_ids [H] i32, x_hot [n_rows, H] f32, keep_mask [n, k])."""
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    counts = np.bincount(cols[vals != 0].reshape(-1), minlength=dim)
    if threshold is None:
        threshold = max(64, n_rows // 16)
    hot = _select_hot(counts, threshold, max_hot)
    x_hot, keep = _apply_hot_split(cols, vals, dim, n_rows, hot)
    return hot.astype(np.int32), x_hot, keep


def _range_overflow_threshold(overflow_threshold: int, frac: float) -> int:
    """Per-range overflow threshold, scaled by the range's mass."""
    return max(4096, int(overflow_threshold * frac))


def _plan_col_ranges(cols, vals_masked, dim, max_parts=4,
                     sample_rows=65536):
    """Window-aligned contiguous column ranges of roughly homogeneous
    per-(row, window) occupancy for the row direction's range split,
    estimated on a strided row sample.  Returns [(lo, hi, mass_frac)]
    with ≥ 2 entries, or None when one capacity class covers every
    window."""
    n_gw = -(-dim // WIN)
    n = cols.shape[0]
    if n_gw < 2 or n == 0:
        return None
    if n > sample_rows:
        stride = n // sample_rows
        c = cols[::stride][:sample_rows]
        v = vals_masked[::stride][:sample_rows]
    else:
        c, v = cols, vals_masked
    rows, ks = np.nonzero(v != 0)
    if rows.size == 0:
        return None
    gw = c[rows, ks].astype(np.int64) // WIN
    cnt = np.bincount(gw, minlength=n_gw).astype(np.float64)
    key = rows.astype(np.int64) * n_gw + gw
    grp = np.bincount(np.unique(key) % n_gw,
                      minlength=n_gw).astype(np.float64)

    def cap_of(cnt_s, grp_s):
        occ = cnt_s / max(grp_s, 1.0)
        return int(np.clip(_next_pow2(int(np.ceil(1.5 * max(occ, 1.0)))),
                           4, 64))

    caps = [cap_of(cnt[w], grp[w]) for w in range(n_gw)]
    # A partial trailing window joins its neighbour's capacity class.
    if dim % WIN != 0 and n_gw >= 2:
        caps[-1] = caps[-2]
    runs = []
    for w in range(n_gw):
        if runs and caps[w] == cap_of(runs[-1][2], runs[-1][3]):
            runs[-1][1] = w + 1
            runs[-1][2] += cnt[w]
            runs[-1][3] += grp[w]
        else:
            runs.append([w, w + 1, cnt[w], grp[w]])
    total = cnt.sum()

    def merge_pass(min_mass):
        best, best_cost = None, None
        for i in range(len(runs) - 1):
            a, b = runs[i], runs[i + 1]
            la = np.log2(cap_of(a[2], a[3]))
            lb = np.log2(cap_of(b[2], b[3]))
            cost = min(a[2], b[2]) * abs(la - lb)
            if min(a[2], b[2]) < min_mass:
                cost = -1.0 / (1 + cost)  # tiny runs merge first
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
        a, b = runs[best], runs[best + 1]
        runs[best] = [a[0], b[1], a[2] + b[2], a[3] + b[3]]
        del runs[best + 1]

    min_mass = total / 64.0
    while len(runs) > 1 and (
            len(runs) > max_parts or min(r[2] for r in runs) < min_mass):
        merge_pass(min_mass)
    i = 0
    while i < len(runs) - 1:
        if cap_of(runs[i][2], runs[i][3]) == cap_of(runs[i + 1][2],
                                                    runs[i + 1][3]):
            runs[i] = [runs[i][0], runs[i + 1][1],
                       runs[i][2] + runs[i + 1][2],
                       runs[i][3] + runs[i + 1][3]]
            del runs[i + 1]
        else:
            i += 1
    if len(runs) < 2:
        return None
    final_caps = [cap_of(r[2], r[3]) for r in runs]
    if max(final_caps) < 4 * min(final_caps):
        return None
    return [(r[0] * WIN, min(r[1] * WIN, dim), r[2] / total) for r in runs]


def _mid_hot_split(cols, vals_masked, dim, n, mid_threshold, validate,
                   overflow_threshold, mid=None, cap=None, dense_grid=None):
    """Mid-hot column split for the gradient direction: columns that
    would overflow the tail plan's capacities get a compact host plan
    over remapped ids.  ``mid``/``cap``/``dense_grid`` may be forced
    (the sharded build's one global mid set and common plan structure).
    Returns (mid_ids | None, col_mid | None, vals_masked_tail)."""
    nz = vals_masked != 0
    if mid is None:
        counts = np.bincount(cols[nz].reshape(-1), minlength=dim)
        mid = np.flatnonzero(counts > mid_threshold)
    if not mid.size:
        return None, None, vals_masked
    pos = np.full(dim, -1, np.int64)
    pos[mid] = np.arange(mid.size)
    is_mid = nz & (pos[cols] >= 0)
    r_idx, k_idx = np.nonzero(is_mid)
    col_mid = _build_host_direction(
        idx=r_idx.astype(np.int64), seg=pos[cols[r_idx, k_idx]],
        val=vals_masked[r_idx, k_idx], table_len=n,
        n_segments=int(mid.size), cap=cap, validate=validate,
        overflow_threshold=overflow_threshold, dense_grid=dense_grid)
    tail = np.where(is_mid, np.float32(0.0), vals_masked)
    return mid.astype(np.int32), col_mid, tail


def _build_direction_ell(cols, vals_masked, direction, table_len,
                         n_segments, cap, validate, overflow_threshold,
                         dense_grid=None, idx_range=None) -> GrrDirection:
    """One direction's host plan from (hot-masked) ELL arrays: the C++
    builder first, the numpy COO path as the fallback.  ``idx_range``
    restricts to a table sub-range."""
    d = _native_direction(cols, vals_masked, direction, table_len,
                          n_segments, cap, validate, overflow_threshold,
                          dense_grid=dense_grid, idx_range=idx_range)
    if d is not None:
        return d
    r_idx, k_idx = np.nonzero(vals_masked != 0)
    c = cols[r_idx, k_idx].astype(np.int64)
    v = vals_masked[r_idx, k_idx]
    idx, seg = ((c, r_idx.astype(np.int64)) if direction == 0
                else (r_idx.astype(np.int64), c))
    if idx_range is not None:
        lo, hi = idx_range
        if idx.size and (idx.min() < 0 or idx.max() >= table_len):
            raise ValueError("idx out of range")
        keep = (idx >= lo) & (idx < hi)
        idx, seg, v = idx[keep] - lo, seg[keep], v[keep]
        table_len = int(hi - lo)
    return _build_host_direction(
        idx=idx, seg=seg, val=v, table_len=table_len,
        n_segments=n_segments, cap=cap, validate=validate,
        overflow_threshold=overflow_threshold, dense_grid=dense_grid)


# Phase timings of the most recent ``build_grr_pair`` call (seconds).
last_build_phases: dict = {}

# The build_grr_pair options that are part of plan semantics (and so of
# the cache key); ``validate`` never changes the plan.
_PLAN_OPTION_NAMES = ("cap", "hot_threshold", "max_hot", "max_hot_bytes",
                      "mid_threshold", "overflow_threshold",
                      "col_range_split")


# The environment default of the plan cache (``build_grr_pair``'s
# ``cache_dir=None``), shared with the JAX package.
PLAN_CACHE_ENV = "PHOTON_ML_TPU_PLAN_CACHE"


def _resolve_cache_dir(cache_dir: str | None) -> str | None:
    from photon_ml_torch.config import read_env

    return cache_dir or read_env(PLAN_CACHE_ENV) or None


def _pair_cache_path(cols, vals, dim, cache_dir, config: dict,
                     extra: tuple = ()) -> str:
    from photon_ml_torch.cache import plan_cache

    fp = plan_cache.dataset_fingerprint(
        np.asarray(cols), np.asarray(vals, np.float32), dim, extra=extra)
    return plan_cache.plan_cache_path(
        cache_dir, fp, plan_cache.plan_config_key(**config))


def pair_cache_path_for(cols, vals, dim, cache_dir: str,
                        **overrides) -> str:
    """The cache-file path ``build_grr_pair(cols, vals, dim,
    **overrides)`` would read and write; the option defaults come from
    ``build_grr_pair``'s own signature."""
    import inspect

    sig = inspect.signature(build_grr_pair)
    config = {n: sig.parameters[n].default for n in _PLAN_OPTION_NAMES}
    unknown = set(overrides) - set(config)
    if unknown:
        raise TypeError(f"unknown plan options: {sorted(unknown)}")
    config.update(overrides)
    return _pair_cache_path(cols, vals, dim, cache_dir, config)


@_collect_spill_warnings
def build_grr_pair(
    cols: np.ndarray,
    vals: np.ndarray,
    dim: int,
    cap: int | None = None,
    hot_threshold: int | None = None,
    max_hot: int = 128,
    max_hot_bytes: int = 2 << 30,
    mid_threshold: int | None = None,
    validate: bool = True,
    overflow_threshold: int | None = None,
    col_range_split: bool | None = None,
    cache_dir: str | None = None,
    device=None,
) -> GrrPair:
    """Compile an ELL batch ([n, k] cols/vals) into the full GRR plan and
    place it on ``device`` (default CUDA; ``"cpu"`` when asked).

    The options are the JAX package's, with the same defaults:
    ``overflow_threshold`` defaults to 16384 + nnz/256; ``hot_threshold``
    to min(max(64, n/16), 48 per row window); ``max_hot_bytes`` bounds the
    dense side; ``mid_threshold`` (default 16 per row window) routes
    mid-hot columns to ``col_mid``; ``col_range_split`` (default: on from
    one row window) splits the row direction into per-capacity column
    ranges.  ``cache_dir`` (default ``$PHOTON_ML_TPU_PLAN_CACHE``)
    enables the on-disk plan cache shared with the JAX package (a hit
    replaces the host build with one load).  Phase
    timings land in ``last_build_phases``."""
    global last_build_phases
    dev = resolve_device(device)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    n, k = cols.shape
    phases: dict = {}
    t_all = time.perf_counter()

    cache_dir = _resolve_cache_dir(cache_dir)
    cache_path = None
    if cache_dir is not None:
        from photon_ml_torch.cache import plan_cache

        passed = locals()
        cache_path = _pair_cache_path(
            cols, vals, dim, cache_dir,
            {name: passed[name] for name in _PLAN_OPTION_NAMES})
        t0 = time.perf_counter()
        cached = plan_cache.load_plan(cache_path)
        if cached is not None:
            phases["cache_hit"] = 1.0
            phases["cache_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            pair = cached.to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            phases["h2d_s"] = time.perf_counter() - t0
            phases["total_s"] = time.perf_counter() - t_all
            last_build_phases = phases
            logger.info("GRR plan cache hit: %s", cache_path)
            return pair
        phases["cache_hit"] = 0.0

    if overflow_threshold is None:
        overflow_threshold = 16384 + int(np.count_nonzero(vals)) // 256
    n_row_windows = max(1, -(-n // WIN))
    if hot_threshold is None:
        # A column denser than ~48 entries per row window overflows even
        # the largest capacity: it goes to the dense side.
        hot_threshold = min(max(64, n // 16), 48 * n_row_windows)
    max_hot = min(max_hot, max(1, max_hot_bytes // (4 * n)))
    hot_ids, x_hot, keep = dense_hot_split(
        cols, vals, dim, n, threshold=hot_threshold, max_hot=max_hot)
    vals_masked = np.where(keep, vals, np.float32(0.0))
    phases["hot_split_s"] = time.perf_counter() - t_all
    auto_mid = mid_threshold is None
    if auto_mid:
        mid_threshold = 16 * n_row_windows
    split = col_range_split if col_range_split is not None else n >= WIN
    ranges = _plan_col_ranges(cols, vals_masked, dim) if split else None

    # One thread pool for every independent host build: one task per
    # row range (or the single row plan) plus the (mid split → tail col)
    # chain.  The C++ builder and numpy release the GIL.
    def row_part(rng_):
        lo, hi, frac = rng_
        thr = _range_overflow_threshold(overflow_threshold, frac)
        return _build_direction_ell(cols, vals_masked, 0, dim, n, cap,
                                    validate, thr, idx_range=(lo, hi))

    def row_single():
        return _build_direction_ell(cols, vals_masked, 0, dim, n, cap,
                                    validate, overflow_threshold)

    def col_chain():
        # Below one full row window the auto heuristic skips the mid
        # split; an explicit mid_threshold always applies.
        t0 = time.perf_counter()
        if not auto_mid or n >= WIN:
            mid_ids, col_mid, vals_tail = _mid_hot_split(
                cols, vals_masked, dim, n, mid_threshold, validate,
                overflow_threshold)
        else:
            mid_ids, col_mid, vals_tail = None, None, vals_masked
        phases["mid_split_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        col = _build_direction_ell(cols, vals_tail, 1, n, dim, cap,
                                   validate, overflow_threshold)
        phases["col_build_s"] = time.perf_counter() - t0
        return mid_ids, col_mid, col

    t0 = time.perf_counter()
    n_row_tasks = len(ranges) if ranges else 1
    with ThreadPoolExecutor(max_workers=n_row_tasks + 1) as ex:
        f_col = ex.submit(col_chain)
        row_futs = ([ex.submit(row_part, r) for r in ranges] if ranges
                    else [ex.submit(row_single)])
        rows = [f.result() for f in row_futs]
        phases["row_build_s"] = time.perf_counter() - t0
        mid_ids, col_mid, col_dir = f_col.result()

    if ranges:
        bounds = tuple(lo for lo, _, _ in ranges) + (ranges[-1][1],)
        row_dir = GrrRangeSplit(parts=tuple(rows), bounds=bounds,
                                table_len=dim, n_segments=n)
        logger.info("GRR row direction: column-range split into %d parts "
                    "(bounds %s, caps %s)", len(ranges), bounds,
                    [p.cap for p in rows])
    else:
        row_dir = rows[0]
    host = GrrPair(row_dir=row_dir, col_dir=col_dir, hot_ids=hot_ids,
                   x_hot=x_hot, mid_ids=mid_ids, col_mid=col_mid)
    phases["host_build_s"] = time.perf_counter() - t_all
    if cache_path is not None:
        # A failed save costs the next run its warm path, never this run.
        t0 = time.perf_counter()
        try:
            plan_cache.save_plan(cache_path, host)
        except Exception as e:  # noqa: BLE001 - logged, run continues
            logger.warning("plan cache: save failed (%r)", e)
        phases["cache_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair = host.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases["h2d_s"] = time.perf_counter() - t0
    phases["total_s"] = time.perf_counter() - t_all
    last_build_phases = phases
    return pair


# -- mesh-sharded plans: congruent per-shard GrrPairs ----------------------------
#
# Each shard owns a contiguous block of rows: its row direction contracts
# the replicated w over its rows, its col direction gives its [dim]
# gradient partial, and the distributed objective sums the partials.
# The shards are built congruent (equal leaf shapes, the same hot and mid
# sets, one cap a direction, overflow for all or none), as the JAX
# package's builder must for its global arrays; the port keeps the
# congruence so both packages compile the same plans and share cache
# files.  Shape differences that remain are closed by zero-valued dummy
# supertiles and COO entries, which add exactly zero.


def _pad_grr_direction(d: GrrDirection, n_st: int, n_spill: int,
                       ovf_pad=None) -> GrrDirection:
    """Pad a host plan to (n_st supertiles, n_spill COO entries).

    Dummy supertiles carry vals 0, gw 0 and ow n_ow − 1 with
    first_of_ow 0: appended after the real tiles, they extend the last
    output-window run, so the revisiting order stays valid."""
    rep = {}
    add = n_st - d.n_supertiles
    if d.dense_grid and add:
        raise AssertionError(
            "dense-grid shard plans must have equal tile counts (full "
            "grid); got a mismatch")
    if add:
        def z3(a, dt):
            a = np.asarray(a)
            return np.concatenate([a, np.zeros((add,) + a.shape[1:], dt)])
        rep.update(
            g1=z3(d.g1, np.int8), g2=z3(d.g2, np.int8), g3=z3(d.g3, np.int8),
            vals=z3(d.vals, np.float32),
            gw_of_st=np.concatenate(
                [np.asarray(d.gw_of_st), np.zeros(add, np.int32)]),
            ow_of_st=np.concatenate(
                [np.asarray(d.ow_of_st),
                 np.full(add, d.n_ow - 1, np.int32)]),
            first_of_ow=np.concatenate(
                [np.asarray(d.first_of_ow), np.zeros(add, np.int32)]))
    madd = n_spill - d.n_spill
    if madd:
        rep.update(
            spill_idx=np.pad(np.asarray(d.spill_idx), (0, madd)),
            spill_seg=np.pad(np.asarray(d.spill_seg), (0, madd)),
            spill_val=np.pad(np.asarray(d.spill_val), (0, madd)))
    if ovf_pad is not None and d.overflow is not None:
        rep["overflow"] = _pad_grr_direction(d.overflow, *ovf_pad)
    return dataclasses.replace(d, **rep) if rep else d


def _pool_overflow(dirs: list, table_len: int, n_segments: int,
                   validate: bool, threshold: int | None) -> list:
    """The sharded build's two-level overflow, decided once on the pooled
    spill (all shards or none, so they stay congruent), with the
    economics of ``_spill_overflow``."""
    ms = [int(np.count_nonzero(np.asarray(d.spill_val))) for d in dirs]
    total = sum(ms)
    if threshold is None or total <= threshold:
        return dirs
    st_floor = -(-n_segments // (WIN // 4))
    if st_floor * SLOTS * len(dirs) > 96 * total:
        return dirs
    seed = {"cap": None, "dense": None}
    lvl2: list = [None] * len(dirs)

    def build(i):
        d = dirs[i]
        lvl2[i] = _build_host_direction(
            np.asarray(d.spill_idx, np.int64),
            np.asarray(d.spill_seg, np.int64), np.asarray(d.spill_val),
            table_len, n_segments, cap=seed["cap"], validate=validate,
            overflow_threshold=None, dense_grid=seed["dense"])
        if seed["cap"] is None:
            seed["cap"] = lvl2[i].cap
            seed["dense"] = lvl2[i].dense_grid

    _seeded_map(build, sorted(range(len(dirs)), key=lambda j: -ms[j]))
    if sum(x.n_supertiles for x in lvl2) * SLOTS > 96 * total:
        return dirs
    z = np.zeros(0, np.int32)
    return [dataclasses.replace(d, overflow=l2, spill_idx=z, spill_seg=z,
                                spill_val=np.zeros(0, np.float32))
            for d, l2 in zip(dirs, lvl2)]


def _pad_dirs_common(dirs: list) -> list:
    """Pad every shard's plan (and level-2 plan) to the largest shapes."""
    n_st = max(d.n_supertiles for d in dirs)
    n_sp = max(d.n_spill for d in dirs)
    ovf_pad = None
    if dirs[0].overflow is not None:  # all or none by construction
        ovf_pad = (max(d.overflow.n_supertiles for d in dirs),
                   max(d.overflow.n_spill for d in dirs))
    return [_pad_grr_direction(d, n_st, n_sp, ovf_pad) for d in dirs]


def _seeded_map(fn, order: list) -> None:
    """``fn(i)`` for every shard in ``order``: the first alone (it seeds
    the choices the others share), the rest on a thread pool (the C++
    builder releases the GIL).  Each call writes only its own shard's
    results, so the outcome is the sequential one."""
    if not order:
        return
    fn(order[0])
    if len(order) > 1:
        with ThreadPoolExecutor(
                max_workers=min(len(order) - 1, os.cpu_count() or 1)) as ex:
            list(ex.map(fn, order[1:]))


@_collect_spill_warnings
def build_sharded_grr_pairs(
    shard_cols: list,
    shard_vals: list,
    dim: int,
    cap: int | None = None,
    hot_threshold: int | None = None,
    max_hot: int = 128,
    max_hot_bytes: int = 2 << 30,
    mid_threshold: int | None = None,
    validate: bool = True,
    overflow_threshold: int | None = None,
    col_range_split: bool | None = None,
    cache_dir: str | None = None,
) -> list:
    """Compile congruent GRR plans over equal-size row shards.

    ``shard_cols``/``shard_vals``: one [per, k] ELL pair a shard, padded
    to equal row counts.  Returns one ``GrrPair`` a shard with host
    (numpy) leaves, equal in structure and leaf shapes; place each with
    ``GrrPair.to``.  The options are ``build_grr_pair``'s, with
    thresholds scaled to the shard grid; ``col_range_split`` (default:
    on for shards of at least one row window) splits every shard's row
    direction into the same column ranges, decided on a pooled sample.
    ``cache_dir`` (default ``$PHOTON_ML_TPU_PLAN_CACHE``): the plan cache
    over the whole shard list, one entry (``"sharded": True`` in its
    key) shared with the JAX package.
    """
    n_shards = len(shard_cols)
    cache_dir = _resolve_cache_dir(cache_dir)
    cache_path = None
    if cache_dir is not None:
        from photon_ml_torch.cache import plan_cache

        passed = locals()
        config = {name: passed[name] for name in _PLAN_OPTION_NAMES}
        config.update({"n_shards": n_shards, "sharded": True})
        cache_path = _pair_cache_path(
            shard_cols[0], shard_vals[0], dim, cache_dir, config,
            extra=tuple(shard_cols[1:]) + tuple(shard_vals[1:]))
        cached = plan_cache.load_plan(cache_path)
        if cached is not None:
            logger.info("sharded GRR plan cache hit: %s", cache_path)
            return cached
    per = shard_cols[0].shape[0]
    n_total = per * n_shards
    if overflow_threshold is None:   # nnz-scaled, as in build_grr_pair
        nnz = sum(int(np.count_nonzero(np.asarray(v))) for v in shard_vals)
        overflow_threshold = 16384 + nnz // 256

    # One hot id set for every shard, from the global column counts.
    counts = np.zeros(dim, np.int64)
    for c, v in zip(shard_cols, shard_vals):
        nz = np.asarray(v) != 0
        counts += np.bincount(np.asarray(c)[nz].reshape(-1), minlength=dim)
    n_row_windows = max(1, -(-per // WIN)) * n_shards
    if hot_threshold is None:
        hot_threshold = min(max(64, n_total // 16), 48 * n_row_windows)
    # The byte budget applies to each shard's x_hot [per, H].
    max_hot = min(max_hot, max(1, max_hot_bytes // (4 * per)))
    hot = _select_hot(counts, hot_threshold, max_hot)
    hot_ids = hot.astype(np.int32)

    # One mid-hot set for every shard.
    auto_mid = mid_threshold is None
    if auto_mid:
        mid_threshold = 16 * n_row_windows
    counts_nonhot = counts.copy()
    counts_nonhot[hot] = 0
    mid = (np.flatnonzero(counts_nonhot > mid_threshold)
           if (not auto_mid or per >= WIN) else np.zeros(0, np.int64))
    mid_ids = mid.astype(np.int32) if mid.size else None
    mid_pos = None
    if mid.size:
        mid_pos = np.full(dim, -1, np.int64)
        mid_pos[mid] = np.arange(mid.size)

    # Pass 1: hot masking a shard, and each shard's mid mass (the mid cap
    # is seeded by a shard that carries mid entries).
    prepped, mid_counts = [], []
    for c, v in zip(shard_cols, shard_vals):
        c = np.asarray(c)
        v = np.asarray(v, np.float32)
        x_hot, keep = _apply_hot_split(c, v, dim, per, hot)
        vm = np.where(keep, v, np.float32(0.0))
        prepped.append((c, x_hot, vm))
        mid_counts.append(
            0 if mid_pos is None
            else int(((vm != 0) & (mid_pos[c] >= 0)).sum()))

    # Pass 2: mid plans, heaviest shard first (it seeds cap and grid).
    mid_dirs: list = [None] * n_shards
    tails: list = [None] * n_shards
    mseed = {"cap": None, "dense": None}

    def mid_plan(i):
        c, _, vm = prepped[i]
        _, md, tail = _mid_hot_split(
            c, vm, dim, per, mid_threshold, validate, None, mid=mid,
            cap=mseed["cap"], dense_grid=mseed["dense"])
        if mseed["cap"] is None:
            mseed["cap"], mseed["dense"] = md.cap, md.dense_grid
        mid_dirs[i] = md
        tails[i] = tail

    if mid_pos is not None:
        _seeded_map(mid_plan, sorted(range(n_shards),
                                     key=lambda j: -mid_counts[j]))

    # The row direction's column-range split, decided once on a pooled
    # sample so every shard splits into the same ranges.
    row_ranges = None
    if col_range_split or (col_range_split is None and per >= WIN):
        samp_per = max(1, 65536 // n_shards)
        stride = max(1, per // samp_per)
        samp_c = np.concatenate(
            [c[::stride][:samp_per] for (c, _, _) in prepped])
        samp_v = np.concatenate(
            [vm[::stride][:samp_per] for (_, _, vm) in prepped])
        row_ranges = _plan_col_ranges(samp_c, samp_v, dim,
                                      sample_rows=samp_c.shape[0])
        if row_ranges:
            logger.info(
                "sharded GRR row direction: column-range split into %d "
                "parts (bounds %s)", len(row_ranges),
                [lo for lo, _, _ in row_ranges] + [dim])

    # Pass 3: the main directions, heaviest shard first (it seeds the
    # shared caps and grid choices).
    row_dirs: list = [None] * n_shards
    col_dirs: list = [None] * n_shards
    x_hots = [x_hot for (_, x_hot, _) in prepped]
    nnzs = [int(np.count_nonzero(vm)) for (_, _, vm) in prepped]
    n_parts = len(row_ranges) if row_ranges else 0
    row_parts: list = [[None] * n_parts for _ in range(n_shards)]
    part_caps = [cap] * n_parts
    part_dense: list = [None] * n_parts
    caps = {"row": cap, "col": cap}
    dense: dict = {"row": None, "col": None}

    def main_plans(i):
        c, _, vm = prepped[i]
        vm_tail = tails[i] if tails[i] is not None else vm
        if row_ranges:
            for r, (lo, hi, _) in enumerate(row_ranges):
                p = _build_direction_ell(
                    c, vm, 0, dim, per, part_caps[r], validate, None,
                    dense_grid=part_dense[r], idx_range=(lo, hi))
                part_caps[r] = part_caps[r] or p.cap
                part_dense[r] = (p.dense_grid if part_dense[r] is None
                                 else part_dense[r])
                row_parts[i][r] = p
        else:
            rd = _build_direction_ell(c, vm, 0, dim, per, caps["row"],
                                      validate, None,
                                      dense_grid=dense["row"])
            caps["row"] = caps["row"] or rd.cap
            if dense["row"] is None:
                dense["row"] = rd.dense_grid
            row_dirs[i] = rd
        cd_ = _build_direction_ell(c, vm_tail, 1, per, dim, caps["col"],
                                   validate, None, dense_grid=dense["col"])
        caps["col"] = caps["col"] or cd_.cap
        if dense["col"] is None:
            dense["col"] = cd_.dense_grid
        col_dirs[i] = cd_

    _seeded_map(main_plans, sorted(range(n_shards), key=lambda j: -nnzs[j]))

    if row_ranges:
        # Overflow pooling and padding a range across the shards.
        bounds = tuple(lo for lo, _, _ in row_ranges) + (dim,)
        for r, (lo, hi, frac) in enumerate(row_ranges):
            fam = [row_parts[i][r] for i in range(n_shards)]
            thr = _range_overflow_threshold(overflow_threshold, frac)
            fam = _pad_dirs_common(
                _pool_overflow(fam, hi - lo, per, validate, thr))
            for i in range(n_shards):
                row_parts[i][r] = fam[i]
        row_dirs = [GrrRangeSplit(parts=tuple(row_parts[i]), bounds=bounds,
                                  table_len=dim, n_segments=per)
                    for i in range(n_shards)]
    else:
        row_dirs = _pad_dirs_common(_pool_overflow(
            row_dirs, dim, per, validate, overflow_threshold))
    col_dirs = _pad_dirs_common(_pool_overflow(
        col_dirs, per, dim, validate, overflow_threshold))
    if mid_pos is not None:
        mid_dirs = _pad_dirs_common(_pool_overflow(
            mid_dirs, per, int(mid.size), validate, overflow_threshold))
    pairs = [
        GrrPair(row_dir=rd, col_dir=cd_, hot_ids=hot_ids.copy(), x_hot=xh,
                mid_ids=None if mid_ids is None else mid_ids.copy(),
                col_mid=md)
        for rd, cd_, xh, md in zip(row_dirs, col_dirs, x_hots, mid_dirs)]
    if cache_path is not None:
        try:
            plan_cache.save_plan(cache_path, pairs)
        except Exception as e:  # noqa: BLE001 - logged, run continues
            logger.warning("plan cache: save failed (%r)", e)
    return pairs
