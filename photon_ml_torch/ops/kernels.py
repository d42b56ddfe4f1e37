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
  Pallas kernel over a λ grid (the swept fit).  It launches the second
  kernel of ``csrc/gather_rowsum.cu`` (counted in
  ``gather_rowsum_lanes.launches``) on CUDA tensors and runs
  ``gather_rowsum_lanes_reference`` on CPU tensors.

Padding slots (id 0, val 0) are multiplied like any other slot in both
versions, as in the JAX package.
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
# The lane kernel: threads a block (the source's kLaneThreads), the lane
# widths it is built for (other L pad to the next with zero lanes), and
# blocks an SM the grid-stride launch asks for at most.
_LANE_THREADS = 256
LANE_WIDTHS = (2, 4, 8, 16)
MAX_LANES = LANE_WIDTHS[-1]
_LANE_BLOCKS_AN_SM = 8


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
    warp) that cover a row in one step.  Both kernels split rows so."""
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


# Per CUDA device index: the library's launch functions (the library is
# loaded once a process), the blocks the device's SMs hold at once, the
# device's SM count, and PyTorch's getter of the current raw
# cudaStream_t (the one its own compiled kernels use; cheaper than
# building a ``torch.cuda.Stream``).
_LAUNCHERS: dict[int, "_Launcher"] = {}


class _Launcher(NamedTuple):
    launch: object
    resident: int
    raw_stream: object
    launch_lanes: object
    sms: int


def _launcher(device: torch.device) -> _Launcher:
    """The launch functions and the card's figures for ``device``; the
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
                        torch._C._cuda_getCurrentRawStream,
                        lib.gather_rowsum_lanes_launch, sms)
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
    lib = _launcher(dev)
    vec, tpr = _row_split(k, _aligned(vals, ids))
    groups = -(-n // (32 // tpr))
    blocks = min(-(-groups // (_LANE_THREADS // 32)),
                 _LANE_BLOCKS_AN_SM * lib.sms)
    err = lib.launch_lanes(table.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                           out.data_ptr(), n, k, width, vec, tpr, blocks,
                           dev.index, lib.raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"gather_rowsum_lanes kernel launch failed: "
                           f"CUDA error {err}")
    gather_rowsum_lanes.launches += 1
    return out if width == lanes else out[:, :lanes]


gather_rowsum_lanes.launches = 0


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
