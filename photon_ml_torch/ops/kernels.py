"""The sparse hot-op ``out[i] = Σ_k vals[i,k] · table[ids[i,k]]``.

Counterpart of ``photon_ml_tpu/ops/kernels.py``.  There the function had
an XLA formulation (the live path) and a Pallas kernel,
``_pallas_gather_rowsum``, that ran only in interpret mode.  Here:

- ``gather_rowsum`` is the dispatcher.  On CUDA tensors it launches the
  hand-written kernel ``csrc/gather_rowsum.cu`` (built with nvcc for
  ``sm_90a``, loaded with ctypes — see ``kernels/_build.py``) and counts
  the launch in ``gather_rowsum.launches``.  On CPU tensors it runs the
  plain version.  A CUDA tensor never falls back to the plain version:
  the kernel runs or the call raises.
- ``gather_rowsum_reference`` is the plain PyTorch version.  The CPU
  tests use it, and ``chip_smoke.py`` holds the kernel against it on
  the card.

Padding slots (id 0, val 0) are multiplied like any other slot in both
versions, as in the JAX package.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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
    if not (table.device == vals.device == ids.device):
        raise ValueError(
            f"gather_rowsum inputs must share one device, got "
            f"{table.device}, {vals.device}, {ids.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


def gather_rowsum(table: Tensor, vals: Tensor, ids: Tensor) -> Tensor:
    """``out[i] = Σ_k vals[i,k] · table[ids[i,k]]``.

    Args:
      table: [L] float32 — the gather table (w for margins).
      vals:  [n, k] float32 — ELL values (padding slots are 0).
      ids:   [n, k] int32 — ELL indices into ``table`` (padding → 0).
    """
    _check(table, vals, ids)
    if table.device.type == "cpu":
        return gather_rowsum_reference(table, vals, ids)
    if not (table.is_contiguous() and vals.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError("gather_rowsum's CUDA kernel takes contiguous "
                         "tensors")
    n, k = vals.shape
    out = torch.empty(n, dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    from photon_ml_torch.kernels import _build

    lib = _build.load("gather_rowsum")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.gather_rowsum_launch(
            table.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n, k, stream)
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
