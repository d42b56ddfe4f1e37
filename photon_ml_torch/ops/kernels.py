"""The sparse hot-op ``out[i] = Σ_k vals[i,k] · table[ids[i,k]]``.

Counterpart of ``photon_ml_tpu/ops/kernels.py``.  There the function had
an XLA formulation (the live path) and a Pallas kernel,
``_pallas_gather_rowsum``, that ran only in interpret mode.  Here:

- ``gather_rowsum`` is the dispatcher.  On CUDA tensors it launches the
  hand-written kernel ``csrc/gather_rowsum.cu`` (built with nvcc for
  ``sm_90a``, loaded with ctypes — see ``kernels/_build.py``) in the
  shape ``_launch_shape`` picks, and counts the launch in
  ``gather_rowsum.launches``.  On CPU tensors it runs the plain version.
  A CUDA tensor never falls back to the plain version: the kernel runs
  or the call raises.
- ``gather_rowsum_reference`` is the plain PyTorch version.  The CPU
  tests use it, and ``chip_smoke.py`` holds the kernel against it on
  the card.
- ``gather_rowsum_lanes`` is the same contraction over L coefficient
  lanes at once, ``out[i, l] = Σ_k vals[i,k] · table[ids[i,k], l]``
  with a lane-minor table [T, L]: the counterpart of ``jax.vmap`` of the
  Pallas kernel over a λ grid (the swept fit).  On CUDA tensors it
  launches ``csrc/gather_rowsum_lanes.cu`` in the shape
  ``_lane_launch_shape`` picks (counted in
  ``gather_rowsum_lanes.launches``); on CPU tensors it runs
  ``gather_rowsum_lanes_reference``.

Padding slots (id 0, val 0) are multiplied like any other slot in both
versions, as in the JAX package.

``sorted_colsum`` is Xᵀr over a column-sorted copy of a plain-ELL
batch's slots (``data.colsorted``): ``out[j] = Σ vals[s] · r[rows[s]]``
over column j's slots, summed in float64 and rounded once to float32.
On CUDA tensors it launches ``csrc/sorted_colsum.cu`` (a merge-path
segmented sum and its fix-up: no atomics, bitwise repeatable; counted
in ``sorted_colsum.launches``), on CPU tensors it runs
``sorted_colsum_reference``.  It replaces no TPU kernel (the JAX
package's plain-ELL Xᵀr is ``jax.ops.segment_sum``); it takes the place
of a float64 ``index_add_`` scatter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

Tensor = torch.Tensor

# Threads (and warps) a block of csrc/gather_rowsum.cu; the most table
# entries a block copies into its shared memory (the source's kHeadMax);
# and the fewest slots (n·k) at which that copy pays for itself (it costs
# ~3 µs at the serving bucket on an H100; PERF.md).
_THREADS = 512
_WARPS = _THREADS // 32
_HEAD_MAX = 56 * 1024
_HEAD_MIN_SLOTS = 1 << 21
# The lane kernel, csrc/gather_rowsum_lanes.cu: the lane widths it is
# built for (other L pad to the next with zero lanes); its launch, as the
# source fixes it (PERF.md, the lane kernel on an H100): one block of 512
# threads that gather and sum (and a producer warp) an SM, a ring of 2
# stages, the most shared memory a block may ask (227 KB, the source's
# kSmemMax) and the ring's barriers at its start (kBarrierBytes).  Its
# choices here: tiles of about ``_LANE_STAGE_BYTES`` of streams (vals and
# ids), runs of at most ``_LANE_RUN`` slots a thread, and the table's
# head in the shared memory the ring leaves, from
# ``_LANE_HEAD_MIN_SLOTS`` slots on, at up to ``_LANE_HEAD_MAX_LANES``
# lanes (64-byte rows read from shared memory conflict more than they
# save), where it holds at least ``_LANE_HEAD_MIN_SHARE`` of the table's
# rows (a head of a few thousand of the transposed ELL's 900,000 rows
# was slower than none).
LANE_WIDTHS = (2, 4, 8, 16)
MAX_LANES = LANE_WIDTHS[-1]
_LANE_CONSUMERS = 512
_LANE_STAGES = 2
_LANE_SMEM_BLOCK = 232_448
_LANE_BARRIER_BYTES = 2 * _LANE_STAGES * 8
_LANE_STAGE_BYTES = 16 << 10
_LANE_RUN = 8
_LANE_HEAD_MIN_SLOTS = 1 << 21
_LANE_HEAD_MIN_SHARE = 1 / 32
_LANE_HEAD_MAX_LANES = 8
# csrc/sorted_colsum.cu: merged items (column ends and slots) a block
# takes, its kTile (512 threads x 4 items).  The partition of a copy into
# such tiles (``sorted_colsum_tiles``) is built with the copy.
SORTED_COLSUM_TILE = 2048


def gather_rowsum_reference(table: Tensor, vals: Tensor, ids: Tensor
                            ) -> Tensor:
    """Plain PyTorch version: ``(vals * table[ids]).sum(-1)``."""
    return (vals * table[ids]).sum(-1)


def gather_rowsum_lanes_reference(table: Tensor, vals: Tensor, ids: Tensor
                                  ) -> Tensor:
    """Plain PyTorch version of the lane kernel,
    ``(vals[..., None] * table[ids]).sum(-2)``, written so that every
    lane sums its slots as ``gather_rowsum_reference`` does ([n, L, k],
    k innermost): on the CPU lane l is bit for bit
    ``gather_rowsum_reference(table[:, l], vals, ids)``, so a swept fit's
    lanes repeat their single-λ fits' arithmetic."""
    gathered = table[ids].transpose(-1, -2).contiguous()        # [n, L, k]
    return (vals[..., None, :] * gathered).sum(-1)


def _check(table: Tensor, vals: Tensor, ids: Tensor,
           fn: str = "gather_rowsum") -> None:
    """Types, stream shapes and devices, common to both wrappers (each
    checks its table's shape)."""
    if table.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(
            f"{fn} takes float32 table and vals, got "
            f"{table.dtype} and {vals.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"{fn} takes int32 ids, got {ids.dtype}")
    if vals.dim() != 2 or ids.shape != vals.shape:
        raise ValueError(
            f"vals and ids must be [n, k] of one shape, got "
            f"{tuple(vals.shape)} and {tuple(ids.shape)}")
    dev = vals.device
    if table.device != dev or ids.device != dev:
        raise ValueError(
            f"{fn} inputs must share one device, got "
            f"{table.device}, {dev}, {ids.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


class LaunchShape(NamedTuple):
    """How ``csrc/gather_rowsum.cu`` runs over [n, k]: ``vec`` slots a
    thread loads at once (4: one 16-byte load of ids and one of vals; 1:
    the scalar path), ``threads_a_row`` threads share a row, a warp takes
    ``rows_a_warp`` rows at a time, each block first copies the table's
    first ``head`` entries into shared memory (0: none), and ``blocks``
    persistent blocks walk the row groups."""

    vec: int
    threads_a_row: int
    rows_a_warp: int
    head: int
    blocks: int

    @property
    def path(self) -> str:
        return "vec4" if self.vec == 4 else "scalar"


def _row_split(k: int, aligned: bool) -> tuple[int, int]:
    """(slots a thread loads at once, threads a row) over rows of ``k``
    slots: 4 (16-byte loads) where ``k % 4 == 0`` and the streams are
    ``aligned``, else 1; the fewest threads (a power of two, at most a
    warp) that cover a row in one step."""
    vec = 4 if aligned and k % 4 == 0 and k > 0 else 1
    tpr = 1
    while tpr < 32 and tpr * vec < k:
        tpr *= 2
    return vec, tpr


@functools.lru_cache(maxsize=256)
def _launch_shape(n: int, k: int, aligned: bool, resident: int,
                  table_len: int) -> LaunchShape:
    """The launch over [n, k] rows and a table of ``table_len``: the
    16-byte path where ``k % 4 == 0`` and the streams are ``aligned`` (16
    bytes), else the scalar one; the fewest threads a row (a power of
    two, at most a warp) that cover it in one step of ``vec`` slots each;
    the table's head in shared memory from ``_HEAD_MIN_SLOTS`` slots on;
    one row group a warp, in at most ``resident`` blocks (as many as the
    card holds at once)."""
    vec, tpr = _row_split(k, aligned)
    rpw = 32 // tpr
    head = min(table_len, _HEAD_MAX) if n * k >= _HEAD_MIN_SLOTS else 0
    groups = -(-n // rpw)
    blocks = min(-(-groups // _WARPS), max(1, resident))
    return LaunchShape(vec, tpr, rpw, head, blocks)


def _aligned(vals: Tensor, ids: Tensor) -> bool:
    """Whether both streams start on a 16-byte boundary."""
    return (vals.data_ptr() | ids.data_ptr()) % 16 == 0


# Per CUDA device index: the library's launch function (the library is
# loaded once a process), the blocks the device's SMs hold at once, and
# PyTorch's getter of the current raw cudaStream_t (the one its own
# compiled kernels use; cheaper than building a ``torch.cuda.Stream``).
_LAUNCHERS: dict[int, "_Launcher"] = {}


class _Launcher(NamedTuple):
    launch: object
    resident: int
    raw_stream: object


def _launcher(device: torch.device) -> _Launcher:
    """The launch function and the card's figures for ``device``; the
    card is asked once a device."""
    got = _LAUNCHERS.get(device.index)
    if got is None:
        from photon_ml_torch.kernels import _build

        lib = _build.load("gather_rowsum")
        with torch.cuda.device(device):
            per_sm = lib.gather_rowsum_prepare()
        if per_sm <= 0:
            raise RuntimeError(f"gather_rowsum: no block fits an SM (CUDA "
                               f"error {-per_sm})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = _Launcher(lib.gather_rowsum_launch, per_sm * sms,
                        torch._C._cuda_getCurrentRawStream)
        _LAUNCHERS[device.index] = got
    return got


def gather_rowsum(table: Tensor, vals: Tensor, ids: Tensor) -> Tensor:
    """``out[i] = Σ_k vals[i,k] · table[ids[i,k]]``.

    Args:
      table: [L] float32 — the gather table (w for margins).
      vals:  [n, k] float32 — ELL values (padding slots are 0).
      ids:   [n, k] int32 — ELL indices into ``table`` (padding → 0).
    """
    _check(table, vals, ids)
    if table.dim() != 1:
        raise ValueError(f"table must be 1-D, got shape {tuple(table.shape)}")
    dev = vals.device
    if dev.type == "cpu":
        return gather_rowsum_reference(table, vals, ids)
    if not (table.is_contiguous() and vals.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError("gather_rowsum's CUDA kernel takes contiguous "
                         "tensors")
    n, k = vals.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _launcher(dev)
    shape = _launch_shape(n, k, _aligned(vals, ids), lib.resident,
                          table.numel())
    err = lib.launch(table.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                     out.data_ptr(), n, k,
                     shape.vec, shape.threads_a_row, shape.head, shape.blocks,
                     dev.index, lib.raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"gather_rowsum kernel launch failed: CUDA "
                           f"error {err}")
    gather_rowsum.launches += 1
    return out


gather_rowsum.launches = 0


class LaneLaunchShape(NamedTuple):
    """How ``csrc/gather_rowsum_lanes.cu`` runs over [n, k] rows at a
    lane width L: ``threads_a_slot`` threads share a slot's lanes (16
    bytes of the table row each; one at 2 lanes), ``slot_threads``
    threads split a row's slots into runs of at most ``run`` consecutive
    slots, a block takes tiles of ``tile_rows`` rows; the staged path
    copies each tile's vals and ids into the shared-memory ring (read
    ``vec`` slots at a time) and keeps the table's first ``head`` rows in
    shared memory; the direct path reads the slots from device memory.
    ``blocks`` persistent blocks walk the tiles, one an SM."""

    staged: bool
    vec: int
    threads_a_slot: int
    slot_threads: int
    run: int
    tile_rows: int
    head: int
    blocks: int

    @property
    def path(self) -> str:
        return "staged" if self.staged else "direct"

    @property
    def threads_a_row(self) -> int:
        return self.threads_a_slot * self.slot_threads

    @property
    def stages(self) -> int:
        return _LANE_STAGES if self.staged else 0


def _lane_smem(lanes: int, k: int, tile_rows: int, head: int) -> int:
    """Shared memory a staged launch takes (the source's layout): the
    barriers, the table's first ``head`` rows (16-byte rounded) and the
    ring's stages of ``tile_rows`` rows."""
    return (_LANE_BARRIER_BYTES + -(-head * lanes * 4 // 16) * 16
            + _LANE_STAGES * tile_rows * k * 8)


@functools.lru_cache(maxsize=256)
def _lane_launch_shape(n: int, k: int, lanes: int, aligned: bool,
                       table_rows: int, sms: int) -> LaneLaunchShape:
    """The lane kernel's launch over [n, k] rows, ``lanes`` (a built
    width) and a table of ``table_rows`` rows on a card of ``sms`` SMs:
    the fewest slot threads (a power of two) that keep a run within
    ``_LANE_RUN`` slots; tiles of whole passes of the block's threads,
    about ``_LANE_STAGE_BYTES`` of streams each (a multiple of 4 rows:
    every tile starts 16-byte aligned); the staged path wherever the
    streams are ``aligned`` and two stages fit a block, else the direct
    path; the table's head in the room the ring leaves (see
    ``_LANE_HEAD_MIN_SLOTS``); one block an SM, at most a tile each."""
    floats = 2 if lanes == 2 else 4
    per_slot = lanes // floats
    slot_threads = 1
    while per_slot * slot_threads < 32 and -(-k // slot_threads) > _LANE_RUN:
        slot_threads *= 2
    run = -(-k // slot_threads)
    rows_a_pass = _LANE_CONSUMERS // (per_slot * slot_threads)
    row_bytes = 8 * k
    passes = (max(1, _LANE_STAGE_BYTES // (row_bytes * rows_a_pass))
              if k else 1)
    tile_rows = passes * rows_a_pass
    blocks = min(-(-n // tile_rows), sms)
    if not (aligned and _lane_smem(lanes, k, tile_rows, 0)
            <= _LANE_SMEM_BLOCK):
        return LaneLaunchShape(False, 1, per_slot, slot_threads, run,
                               tile_rows, 0, blocks)
    vec = 4 if k % 4 == 0 and run % 4 == 0 and k > 0 else 1
    room = _LANE_SMEM_BLOCK - _lane_smem(lanes, k, tile_rows, 0)
    most = min(table_rows, room // 16 * 16 // (4 * lanes))
    head = most if (n * k >= _LANE_HEAD_MIN_SLOTS
                    and lanes <= _LANE_HEAD_MAX_LANES
                    and most >= table_rows * _LANE_HEAD_MIN_SHARE) else 0
    return LaneLaunchShape(True, vec, per_slot, slot_threads, run,
                           tile_rows, head, blocks)


# Per CUDA device index: the lane library's launch function, PyTorch's
# getter of the current raw cudaStream_t, and the device's SM count.
_LANE_LAUNCHERS: dict[int, "_LaneLauncher"] = {}


class _LaneLauncher(NamedTuple):
    launch: object
    raw_stream: object
    sms: int


def _lane_launcher(device: torch.device) -> _LaneLauncher:
    """The lane library's launch function and the card's SM count for
    ``device``; every variant is prepared, and one block an SM checked to
    fit, once a device."""
    got = _LANE_LAUNCHERS.get(device.index)
    if got is None:
        from photon_ml_torch.kernels import _build

        lib = _build.load("gather_rowsum_lanes")
        with torch.cuda.device(device):
            per_sm = lib.gather_rowsum_lanes_prepare()
        if per_sm <= 0:
            raise RuntimeError(f"gather_rowsum_lanes: no block fits an SM "
                               f"(CUDA error {-per_sm})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = _LaneLauncher(lib.gather_rowsum_lanes_launch,
                            torch._C._cuda_getCurrentRawStream, sms)
        _LANE_LAUNCHERS[device.index] = got
    return got


def gather_rowsum_lanes(table: Tensor, vals: Tensor, ids: Tensor) -> Tensor:
    """``out[i, l] = Σ_k vals[i,k] · table[ids[i,k], l]`` over L lanes.

    Args:
      table: [T, L] float32, lane-minor (row t holds every lane's entry
        t), 1 ≤ L ≤ ``MAX_LANES``.
      vals:  [n, k] float32 — ELL values (padding slots are 0).
      ids:   [n, k] int32 — ELL indices into ``table``'s rows.

    Returns [n, L].  On the card L is padded to the next of
    ``LANE_WIDTHS`` with zero lanes (the output drops them); callers
    route one lane to ``gather_rowsum``.
    """
    _check(table, vals, ids, "gather_rowsum_lanes")
    if table.dim() != 2 or not 1 <= table.shape[1] <= MAX_LANES:
        raise ValueError(
            f"table must be [T, L] with 1 <= L <= {MAX_LANES}, got shape "
            f"{tuple(table.shape)}")
    dev = vals.device
    if dev.type == "cpu":
        return gather_rowsum_lanes_reference(table, vals, ids)
    if not (table.is_contiguous() and vals.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError("gather_rowsum_lanes' CUDA kernel takes "
                         "contiguous tensors")
    n, k = vals.shape
    lanes = table.shape[1]
    width = next(w for w in LANE_WIDTHS if w >= lanes)
    if width != lanes or table.data_ptr() % 16:
        # A fresh allocation: zero lanes appended, 16-byte aligned.
        table = torch.nn.functional.pad(table, (0, width - lanes))
    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    if n == 0:
        return out[:, :lanes]
    lib = _lane_launcher(dev)
    shape = _lane_launch_shape(n, k, width, _aligned(vals, ids),
                               table.shape[0], lib.sms)
    err = lib.launch(table.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                     out.data_ptr(), n, k, width, int(shape.staged),
                     shape.vec, shape.slot_threads, shape.run,
                     shape.tile_rows, shape.head, shape.blocks, dev.index,
                     lib.raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"gather_rowsum_lanes kernel launch failed: "
                           f"CUDA error {err}")
    gather_rowsum_lanes.launches += 1
    return out if width == lanes else out[:, :lanes]


gather_rowsum_lanes.launches = 0


def sorted_colsum_reference(r: Tensor, rows: Tensor, vals: Tensor,
                            col_ptr: Tensor) -> Tensor:
    """Plain PyTorch version of ``sorted_colsum``: the float32 products
    ``vals · r[rows]`` added in float64 by ``index_add_`` into their
    columns (slot order: rows ascending within a column), then rounded to
    float32.  On the CPU that is the plain-ELL scatter's arithmetic term
    for term, so the two agree bit for bit where no slot's value is 0."""
    dim = col_ptr.numel() - 1
    cols = torch.repeat_interleave(
        torch.arange(dim, device=col_ptr.device), col_ptr.diff())
    out = torch.zeros(dim, dtype=torch.float64, device=r.device)
    out.index_add_(0, cols, (vals * r[rows]).double())
    return out.to(r.dtype)


def sorted_colsum_tiles(col_ptr: Tensor, nnz: int) -> Tensor:
    """The merge-path partition of ``nnz`` slots over ``col_ptr``'s
    columns into tiles of ``SORTED_COLSUM_TILE`` merged items: entry b
    (int64, one more than the tiles) is the number of columns that end
    before tile b's first item.  Column j's end is item col_ptr[j+1] + j
    of the merged list (after its slots), so that number is a
    ``searchsorted`` of the tiles' first items in those ends."""
    dim = col_ptr.numel() - 1
    n_tiles = -(-(dim + nnz) // SORTED_COLSUM_TILE)
    starts = torch.arange(n_tiles + 1, device=col_ptr.device,
                          dtype=torch.int64) * SORTED_COLSUM_TILE
    ends = col_ptr[1:] + torch.arange(dim, device=col_ptr.device)
    return torch.searchsorted(ends, starts)


_SORTED_LAUNCHERS: dict[int, object] = {}


def sorted_colsum(r: Tensor, rows: Tensor, vals: Tensor, col_ptr: Tensor,
                  tiles: Tensor) -> Tensor:
    """``out[j] = Σ_{s ∈ [col_ptr[j], col_ptr[j+1])} vals[s] · r[rows[s]]``.

    Args:
      r:       [n] float32 — the residual, gathered by row.
      rows:    [nnz] int32 — each slot's row, sorted by column (rows
        ascending within a column).
      vals:    [nnz] float32 — each slot's value.
      col_ptr: [dim + 1] int64 — column j's slots are
        ``[col_ptr[j], col_ptr[j+1])``; ``col_ptr[dim] == nnz``.
      tiles:   ``sorted_colsum_tiles(col_ptr, nnz)`` (read by the kernel
        only).

    Returns [dim] float32.
    """
    if r.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"sorted_colsum takes float32 r and vals, got "
                        f"{r.dtype} and {vals.dtype}")
    if (rows.dtype != torch.int32 or col_ptr.dtype != torch.int64
            or tiles.dtype != torch.int64):
        raise TypeError(
            f"sorted_colsum takes int32 rows and int64 col_ptr and tiles, "
            f"got {rows.dtype}, {col_ptr.dtype} and {tiles.dtype}")
    if (r.dim() != 1 or rows.dim() != 1 or rows.shape != vals.shape
            or col_ptr.dim() != 1 or col_ptr.numel() < 1
            or tiles.dim() != 1):
        raise ValueError(
            f"sorted_colsum takes 1-D r, rows, vals, col_ptr and tiles, "
            f"rows and vals of one shape; got {tuple(r.shape)}, "
            f"{tuple(rows.shape)}, {tuple(vals.shape)}, "
            f"{tuple(col_ptr.shape)} and {tuple(tiles.shape)}")
    dim, nnz = col_ptr.numel() - 1, rows.numel()
    n_tiles = tiles.numel() - 1
    if n_tiles != -(-(dim + nnz) // SORTED_COLSUM_TILE):
        raise ValueError(f"tiles holds {n_tiles} tiles, not the "
                         f"partition of {dim} columns and {nnz} slots")
    dev = vals.device
    if any(t.device != dev for t in (r, rows, col_ptr, tiles)):
        raise ValueError("sorted_colsum inputs must share one device")
    if dev.type == "cpu":
        return sorted_colsum_reference(r, rows, vals, col_ptr)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in (r, rows, vals, col_ptr, tiles)):
        raise ValueError("sorted_colsum's CUDA kernel takes contiguous "
                         "tensors")
    if not _aligned(vals, rows):
        raise ValueError("sorted_colsum's CUDA kernel takes rows and vals "
                         "that start on a 16-byte boundary")
    out = torch.empty(dim, dtype=torch.float32, device=dev)
    if dim == 0:
        return out
    launch = _SORTED_LAUNCHERS.get(dev.index)
    if launch is None:
        from photon_ml_torch.kernels import _build

        launch = _build.load("sorted_colsum").sorted_colsum_launch
        _SORTED_LAUNCHERS[dev.index] = launch
    carry = torch.empty(2, n_tiles, dtype=torch.float64, device=dev)
    err = launch(r.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                 col_ptr.data_ptr(), tiles.data_ptr(), out.data_ptr(),
                 carry[0].data_ptr(), carry[1].data_ptr(), dim, nnz, n_tiles,
                 SORTED_COLSUM_TILE, dev.index,
                 torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"sorted_colsum kernel launch failed: CUDA "
                           f"error {err}")
    sorted_colsum.launches += 1
    return out


sorted_colsum.launches = 0


def lane_gather_rowsum(v: Tensor, vals: Tensor, ids: Tensor) -> Tensor:
    """``gather_rowsum`` of ``v`` [T], or of every lane of ``v`` [L, T] →
    [L, n]: one lane on ``gather_rowsum`` (bit for bit the single-λ
    path), more in one ``gather_rowsum_lanes`` over the lane-minor
    table ``vᵀ`` [T, L], its [n, L] output transposed back (contiguous,
    so the objective's reductions run over contiguous rows)."""
    if v.dim() == 1:
        return gather_rowsum(v, vals, ids)
    if v.shape[0] == 1:
        return gather_rowsum(v[0].contiguous(), vals, ids)[None]
    return gather_rowsum_lanes(v.T.contiguous(), vals, ids).T.contiguous()


def vrow_pad(v: int, multiple: int | None = None) -> int:
    """Padded virtual-row count for the transposed-ELL build (multiple
    of 8 unless an explicit multiple is given) — kept identical to the
    JAX package's so shared layouts stay byte-identical."""
    v = max(int(v), 1)
    if multiple is None:
        multiple = 8
    return max(-(-v // multiple) * multiple, 8)
