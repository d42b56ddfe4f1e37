"""Peaks of the card and the least time of the work the benchmark reads.

The byte bounds are frozen copies of ``chip_smoke.py``'s
``gather_rowsum_bound_ms`` and ``sorted_colsum_bound_ms``: every input
byte read once (the values and ids of each slot, each table entry or
row the ids touch), every output byte written once, against the card's
memory rate.  The peaks are copied from
``photon_ml_torch/telemetry/device.py`` (``CARD_PEAK_GBPS``) and the
H100 SXM data sheet.
"""

from __future__ import annotations

# Bytes a second of the card's memory, by the name the driver reports.
# A run on a card not listed here is refused: its shares would be read
# against another card's peak.
CARD_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,     # H100 SXM5 data sheet
}
FP32_OPS_PER_S = 67e12                    # H100 SXM, outside tensor cores


def gather_rowsum_bound_s(n: int, k: int, touched: int,
                          bytes_per_s: float) -> float:
    """B1 (``out[i] = Σ_k vals[i,k]·table[ids[i,k]]``) over [n, k] slots
    whose ids touch ``touched`` table entries: vals and ids read once,
    those entries read once, out written once; 2 float32 operations a
    slot."""
    nbytes = n * k * (4 + 4) + touched * 4 + n * 4
    return max(nbytes / bytes_per_s, 2 * n * k / FP32_OPS_PER_S)


def sorted_colsum_bound_s(nnz: int, dim: int, touched: int,
                          bytes_per_s: float) -> float:
    """Xᵀr over a column-sorted copy (``out[j] = Σ vals[s]·r[rows[s]]``
    over column j's slots) of ``nnz`` slots and ``dim`` columns whose
    rows touch ``touched`` entries of r: rows (int32) and vals read once,
    col_ptr (int64, dim + 1) read once, out (float32) written once, those
    entries of r read once; a float32 product and a float64 add a
    slot."""
    nbytes = nnz * (4 + 4) + (dim + 1) * 8 + dim * 4 + touched * 4
    return max(nbytes / bytes_per_s, 2 * nnz / FP32_OPS_PER_S)
