"""``chip_smoke.py`` rehearsed on the CPU at a small size.

The script runs on the GPU only (``main()`` refuses without CUDA).  Its
training-phase functions take a device, so the plan build, the per-level
kernel checks (here the plain versions against themselves) and the fit's
gates run here on CPU tensors at 60,000 rows.  At that size the held-out
AUC is below the script's 0.70 gate (a property of the generator: it
grows with the row count), so that one gate is expected to report.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from photon_ml_torch.ops import grr_kernel as tk

ROWS = 60_000


@pytest.fixture(scope="module")
def train():
    from photon_ml_torch import native

    if not native.native_available():
        pytest.skip("the native plan builder needs g++")
    return cs.phase_train_build(seed=3, n=ROWS, device="cpu")


def test_main_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cs.main() != 0
    assert capsys.readouterr().out == ""


def test_training_data_shape_and_seed():
    rows, y = cs.make_training_data(seed=3, n=500, d=2000)
    assert len(rows) == 500 and rows.max_nnz == cs.NNZ + 1
    assert rows.max_col == 2000                      # the intercept column
    assert set(np.unique(y)) <= {0.0, 1.0}
    rows2, y2 = cs.make_training_data(seed=3, n=500, d=2000)
    np.testing.assert_array_equal(rows.cols, rows2.cols)
    np.testing.assert_array_equal(y, y2)


def test_train_build_on_cpu(train):
    info = train["info"]
    assert info["train_rows"] == ROWS - ROWS // 10
    assert info["slots_a_row"] == cs.NNZ + 1
    assert info["builder"].startswith("native C++")
    assert train["grr"].grr is not None and train["ell"].grr is None
    levels = cs.plan_levels(train["grr"].grr)
    assert {d.dense_grid for _, d in levels} == {True, False}


def test_grr_kernel_checks_on_cpu(train):
    before = (tk.grr_contract_dense.launches, tk.grr_contract.launches)
    entries = cs.phase_kernels_grr(train["grr"].grr, seed=5, time_it=False)
    assert [e["name"] for e in entries] == ["grr_contract_dense",
                                            "grr_contract"]
    for e in entries:
        assert e["levels"] >= 1 and e["max_abs_err"] == 0.0
        assert e["bound_ms"] > 0 and e["bound_by"] == "bytes"
        for level in e["shapes"]:
            assert level["library_max_abs_err"] < 1e-3
    assert (tk.grr_contract_dense.launches,
            tk.grr_contract.launches) == before


def test_training_phase_gates_on_cpu(train):
    out = cs.phase_training(train, time_it=False)
    assert [f for f in out["failures"] if "AUC" not in f] == []
    assert out["loss_final"] < out["loss_first"]
    assert out["early_loss_gap_rel"] <= cs.TRAJECTORY_RTOL
    assert max(out["f64_errors"]["grr"].values()) <= cs.F64_VECTOR_RTOL
    assert out["launches"] == {"grr_contract_dense": 0, "grr_contract": 0,
                               "gather_rowsum": 0}
