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


def gather_rowsum_reference(table: Tensor, vals: Tensor, ids: Tensor
                            ) -> Tensor:
    """Plain PyTorch version: ``(vals * table[ids]).sum(-1)``."""
    return (vals * table[ids]).sum(-1)


def _check(table: Tensor, vals: Tensor, ids: Tensor) -> None:
    if table.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(
            f"gather_rowsum takes float32 table and vals, got "
            f"{table.dtype} and {vals.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"gather_rowsum takes int32 ids, got {ids.dtype}")
    if table.dim() != 1:
        raise ValueError(f"table must be 1-D, got shape {tuple(table.shape)}")
    if vals.dim() != 2 or ids.shape != vals.shape:
        raise ValueError(
            f"vals and ids must be [n, k] of one shape, got "
            f"{tuple(vals.shape)} and {tuple(ids.shape)}")
    dev = vals.device
    if table.device != dev or ids.device != dev:
        raise ValueError(
            f"gather_rowsum inputs must share one device, got "
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
    vec = 4 if aligned and k % 4 == 0 and k > 0 else 1
    tpr = 1
    while tpr < 32 and tpr * vec < k:
        tpr *= 2
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
_LAUNCHERS: dict[int, tuple] = {}


def _launcher(device: torch.device) -> tuple:
    """(launch function, resident blocks, stream getter) for ``device``;
    the card is asked once a device."""
    got = _LAUNCHERS.get(device.index)
    if got is None:
        from photon_ml_torch.kernels import _build

        lib = _build.load("gather_rowsum")
        with torch.cuda.device(device):
            per_sm = lib.gather_rowsum_prepare()
        if per_sm <= 0:
            raise RuntimeError(f"gather_rowsum: no block fits an SM (CUDA "
                               f"error {-per_sm})")
        resident = per_sm * torch.cuda.get_device_properties(
            device).multi_processor_count
        got = (lib.gather_rowsum_launch, resident,
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
    launch, resident, raw_stream = _launcher(dev)
    shape = _launch_shape(n, k, _aligned(vals, ids), resident, table.numel())
    err = launch(table.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                 out.data_ptr(), n, k,
                 shape.vec, shape.threads_a_row, shape.head, shape.blocks,
                 dev.index, raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"gather_rowsum kernel launch failed: CUDA "
                           f"error {err}")
    gather_rowsum.launches += 1
    return out


gather_rowsum.launches = 0


def vrow_pad(v: int, multiple: int | None = None) -> int:
    """Padded virtual-row count for the transposed-ELL build (multiple
    of 8 unless an explicit multiple is given) — kept identical to the
    JAX package's so shared layouts stay byte-identical."""
    v = max(int(v), 1)
    if multiple is None:
        multiple = 8
    return max(-(-v // multiple) * multiple, 8)
