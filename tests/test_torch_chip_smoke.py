"""``chip_smoke.py`` rehearsed on the CPU at a small size.

The script runs on the GPU only (``main()`` refuses without CUDA).  Its
training-phase functions take a device, so the plan build, the per-level
kernel checks (here the plain versions against themselves) and the fit's
gates run here on CPU tensors at 60,000 rows.  At that size the held-out
AUC is below the script's 0.70 gate (a property of the generator: it
grows with the row count), so that one gate is expected to report.
Phase 7 (GAME training) runs at 8,000 rows over 2,000 columns and 300
entities a random effect, with every gate; phase 8 runs the training,
indexing and scoring drivers in subprocesses with ``--device cpu``;
phase 9 (the swept λ grid, single-λ fits and the tuned fit) runs on the
60,000 rows, every gate but the card-only launch counts.  Phase 10 runs
at phase 7's small size with 2,048-row chunks (10a–10c, the driver in a
subprocess with ``--device cpu``) and on 20,000 of the 60,000 rows with
8,192-row chunks (10d).  Phase 11 runs at phase 10's small size with
64-entity and 2,048-row chunks; there the fused fit's held-out AUC ends
above the per-coordinate fit's by more than the 1e-3 gate (a property of
the size, as phase 6's AUC gate is), so that gate is expected to report.
Phase 16 (the training fleet) runs at phase 10's small size with
1,500-row chunks (5 chunks: host 1 owns two and a sentinel), its host
processes and drivers on the CPU, every gate but the card-only B1
counts.
"""

from __future__ import annotations

import json

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


@pytest.fixture(scope="module")
def training(train):
    """Phase 6 on the CPU, once for the tests that read it."""
    return cs.phase_training(train, time_it=False)


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "WORK", str(tmp_path))
    return tmp_path


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


def test_gather_rowsum_checks_on_cpu(train):
    """Phase 3's B1 check rehearsed: the plain version against itself at
    every shape (the ELL training arrays included), no launch counted."""
    from photon_ml_torch.ops import kernels as kk

    table = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, cs.D + 1).astype(np.float32))
    before = kk.gather_rowsum.launches
    entry = cs.phase_kernels(table, seed=1, ell=train["ell"], time_it=False)
    assert kk.gather_rowsum.launches == before
    assert entry["name"] == "gather_rowsum" and entry["max_abs_err"] == 0.0
    names = [s["shape"] for s in entry["shapes"]]
    assert names[0] == f"{cs.BATCH_ROWS}x{cs.ELL_CAP}"
    assert "ell_train" in names
    assert {(s["n"], s["k"]) for s in entry["shapes"]} >= set(
        cs.KERNEL_SHAPES) | set(cs.WIDTH_SHAPES)
    ell = entry["shapes"][names.index("ell_train")]
    assert (ell["n"], ell["k"]) == (ROWS - ROWS // 10, cs.ELL_CAP)
    assert ell["bound_by"] == "bytes" and ell["bound_ms"] > 0
    assert entry["ms"] is None and entry["launches_ell_fit"] is None


def test_ell_split_by_kernel():
    split = cs.split_ell_evaluation({
        "void gather_rowsum_kernel<4, 8>(float const*)": 0.25,
        "void at::native::indexFuncLargeIndex<double, long>": 1.5,
        "void at::native::vectorized_elementwise_kernel<4>": 0.5,
        "Memcpy DtoH (Device -> Pinned)": 0.01})
    assert split["gather_rowsum"] == 0.25 and split["index_add"] == 1.5
    assert split["rest"] == pytest.approx(0.51)
    assert split["sorted_colsum"] == 0.0
    assert len(split["largest"]) == 4
    # Xᵀr over the column-sorted copy: its kernel and its fix-up.
    split = cs.split_ell_evaluation({
        "void gather_rowsum_kernel<4, 8>(float const*)": 0.25,
        "(anonymous namespace)::sorted_colsum_kernel(float const*)": 0.04,
        "(anonymous namespace)::sorted_colsum_fixup_kernel(long const*)":
            0.002})
    assert split["sorted_colsum"] == pytest.approx(0.042)
    assert split["index_add"] == 0.0


def test_training_phase_gates_on_cpu(training):
    out = training
    assert [f for f in out["failures"] if "AUC" not in f] == []
    assert out["loss_final"] < out["loss_first"]
    assert out["early_loss_gap_rel"] <= cs.TRAJECTORY_RTOL
    assert max(out["f64_errors"]["grr"].values()) <= cs.F64_VECTOR_RTOL
    assert out["launches"] == {"grr_contract_dense": 0, "grr_contract": 0,
                               "gather_rowsum": 0}
    # Launches are counted on the card only; the ELL fit's gradients run
    # over its column-sorted copy there.
    assert out["ell_sorted_colsum_launches"] == 0
    assert out["ell_gradients"] == len(out["trajectories"]["ell"]["loss"])


def test_transposed_ell_kernel_check_on_cpu(train):
    """Phase 3's B1 check at the transposed-ELL arrays: the residual over
    the training rows as the table, auto capacity."""
    table = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, cs.D + 1).astype(np.float32))
    cm = train["colmajor"].colmajor
    entry = cs.phase_kernels(table, seed=1, ell=train["ell"], colmajor=cm,
                             time_it=False)
    shape = next(s for s in entry["shapes"] if s["shape"] == "colmajor_train")
    assert (shape["n"], shape["k"]) == (cm.n_virtual_rows, cm.capacity)
    assert entry["transposed_shape"] == [cm.n_virtual_rows, cm.capacity]
    assert shape["table"] == ROWS - ROWS // 10
    assert shape["atol"] == cs.COLMAJOR_ATOL and shape["max_abs_err"] == 0.0
    assert shape["bound_by"] == "bytes" and shape["bound_ms"] > 0
    assert cm.capacity % 8 == 0 and 8 <= cm.capacity <= 512
    assert entry["launches_game_fit"] is None


def test_training_phase_colmajor_and_config2_on_cpu(training):
    out = training
    assert out["colmajor_loss_gap_rel"] <= cs.LAYOUT_LOSS_RTOL
    assert out["colmajor_gather_rowsum_launches"] == 0       # plain on CPU
    assert max(out["f64_errors"]["colmajor"].values()) <= cs.F64_VECTOR_RTOL
    c2 = out["config2"]
    assert c2["failures"] == []
    for layout in ("ell", "colmajor"):
        assert c2[f"tron_{layout}"]["loss_final"] < \
            c2[f"tron_{layout}"]["loss_first"]
    assert c2["tron_ell"]["grad_norm"] < c2["lbfgs_ell"]["grad_norm"]


def test_colmajor_split_by_kernel():
    split = cs.split_colmajor_evaluation({
        "void gather_rowsum_kernel<4>": 0.4,
        "void at::native::vectorized_elementwise_kernel": 0.05,
        "void at::native::indexFuncSmallIndex<double>": 0.02}, 0.1)
    assert split == pytest.approx({"gather_rowsum_xw": 0.1,
                                   "gather_rowsum_xtr": 0.3, "fold": 0.02,
                                   "rest": 0.05})


def test_game_data_shape_and_seed():
    ds = cs.make_game_data(seed=7, n=400, d=2000, n_entities=50)
    assert ds.n == 400 and ds.features["global"].max_nnz == cs.NNZ
    assert ds.feature_dim("global") == 2000
    assert ds.features["user_re"].shape == (400, cs.P_USER)
    assert ds.features["item_re"].shape == (400, cs.P_ITEM)
    assert ds.entity_ids["userId"].max() < 50
    again = cs.make_game_data(seed=7, n=400, d=2000, n_entities=50)
    np.testing.assert_array_equal(ds.labels, again.labels)
    # Power-law entities: the most frequent user holds many rows.
    assert np.bincount(ds.entity_ids["userId"]).max() > 400 / 50


def test_game_phase_on_cpu(work):
    """Phase 7 at a small size, every gate on: GAME beats fixed-only, the
    layouts agree, the per-entity float64 check and the served margins;
    B1 checked at the fixed effect's own arrays; the fit probe and the
    scoring recorder leave no patch behind."""
    from photon_ml_torch.data.batch import SparseBatch
    from photon_ml_torch.estimators import game_transformer
    from photon_ml_torch.game import coordinates

    solve, margins = coordinates.solve_batched, SparseBatch.margins
    xt_dot, score_b1 = SparseBatch.xt_dot, game_transformer.gather_rowsum
    out = cs.phase_game(seed=7, n=8000, device="cpu", d=2000,
                        n_entities=300, time_it=False)
    assert out["failures"] == []
    assert coordinates.solve_batched is solve
    assert SparseBatch.margins is margins and SparseBatch.xt_dot is xt_dot
    assert game_transformer.gather_rowsum is score_b1
    assert out["entity_check"]["checked"] == cs.GAME_ENTITY_CHECKS
    assert out["serve_max_abs_err"] <= cs.GAME_SERVE_ATOL
    shapes = {sh["shape"]: sh for sh in out["kernel_shapes"]}
    assert sorted(shapes) == ["game_fe_colmajor", "game_fe_ell"]  # no chunk
    n_train = 8000 - int(8000 * cs.TRAIN_HOLDOUT)
    assert (shapes["game_fe_ell"]["n"], shapes["game_fe_ell"]["k"]) == (
        n_train, cs.NNZ + 1)
    assert shapes["game_fe_colmajor"]["table"] == n_train
    sorted_shape = out["sorted_shape"]
    assert sorted_shape["shape"] == "game_fe_ell"
    assert (sorted_shape["rows"], sorted_shape["columns"]) == (n_train, 2001)
    assert sorted_shape["max_ulps"] == 0.0
    for layout in ("ell", "colmajor"):
        f = out[layout]
        assert f["fe_evaluations"] > 0 and f["launches"] == 0
        assert f["fe_evaluation_launches"] == f["fe_gradient_launches"] == 0
        assert f["fe_gradients"] > 0 and f["fe_gradient_sorted_colsum"] == 0
        assert len(f["auc_by_sweep"]) == cs.GAME_SWEEPS
        assert sorted(f["sweep_coordinate_s"]) == [1, 2]
        assert {b["width"] for b in f["buckets"]} == {cs.P_USER, cs.P_ITEM}
    assert out["ell"]["auc"] > out["fixed_only"]["auc"]


def test_driver_phase_on_cpu(work):
    """Phase 8: the training driver's golden, then the indexing driver's
    maps, the scoring driver's AUC and outputs, and the Avro export;
    then phase 12b on them: the scoring driver's streamed branch against
    its resident outputs."""
    out = cs.phase_driver(["--device", "cpu"])
    assert out["rc"] == 0
    assert abs(out["auc"] - out["golden_auc"]) < cs.DRIVER_AUC_ATOL
    assert out["index_sizes"]["entities"]["userId"] > 0
    assert out["scoring_auc_gap"] <= cs.SCORING_ATOL
    assert out["scoring_outputs_max_abs_diff"] <= cs.SCORING_ATOL
    assert out["scoring_rows"] > 0
    assert out["scoring_gather_rowsum_launches"] == 0       # plain on CPU
    assert out["export_files"] == ["global.avro", "per_user.avro"]
    assert out["export_max_abs_diff"] == 0.0
    failures: list = []
    b = cs.phase_stream_score_driver(out, ["--device", "cpu"], failures)
    assert failures == []
    assert b["n_chunks"] == -(-out["scoring_rows"] // 128) >= 2
    assert b["chunk_files"] == b["n_chunks"]
    assert b["auc_gap"] <= cs.SCORING_ATOL
    assert b["npz_max_abs_diff"] <= cs.SCORING_ATOL
    assert b["avro_max_abs_diff"] <= cs.SCORING_ATOL
    assert b["launches"] == 0                               # plain on CPU


KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_lane_kernel_checks_on_cpu(train):
    """Phase 3's lane-kernel check rehearsed: the plain version against
    itself at 2, 8 and 16 lanes on the ELL arrays, at 4 and 8 on those
    arrays cut to the estimator's 31 slots (the line's main shape) and 8
    on their transposed ELL, no launch counted; the ``kernels`` entry
    carries every key of the line."""
    from photon_ml_torch.ops import kernels as kk

    cm = train["colmajor"].colmajor
    before = kk.gather_rowsum_lanes.launches
    entry = cs.phase_kernels_lanes(train["ell"], cm, seed=9, time_it=False)
    assert kk.gather_rowsum_lanes.launches == before
    assert KERNEL_KEYS <= set(entry)
    assert entry["name"] == "gather_rowsum_lanes" and entry["route"] == "cuda"
    assert entry["replaces"] == ("photon_ml_tpu/ops/kernels.py:65 "
                                 "(under jax.vmap)")
    assert entry["max_abs_err"] == 0.0 and entry["bound_by"] == "bytes"
    assert entry["lanes"] == cs.LANES_MAIN
    assert entry["shape"] == [ROWS - ROWS // 10, cs.NNZ + 1]
    shapes = {sh["shape"]: sh for sh in entry["shapes"]}
    assert sorted(shapes) == sorted(
        [f"ell_train_L{n}" for n in cs.LANE_COUNTS]
        + [f"ell{cs.NNZ + 1}_train_L{n}" for n in cs.LANE_COUNTS_31]
        + [f"colmajor_train_L{cs.LANES_MAIN}"])
    for n in cs.LANE_COUNTS_31:
        sh = shapes[f"ell{cs.NNZ + 1}_train_L{n}"]
        assert (sh["n"], sh["k"], sh["lanes"]) == (ROWS - ROWS // 10,
                                                   cs.NNZ + 1, n)
    t = shapes[f"colmajor_train_L{cs.LANES_MAIN}"]
    assert (t["n"], t["k"], t["table"]) == (cm.n_virtual_rows, cm.capacity,
                                            ROWS - ROWS // 10)
    assert t["atol"] == cs.COLMAJOR_ATOL
    # More lanes move more table and output bytes.
    bounds = [shapes[f"ell_train_L{n}"]["bound_ms"] for n in cs.LANE_COUNTS]
    assert bounds == sorted(bounds)


def test_lane_bound_gate():
    """A lane-kernel shape read faster than 105 % of its HBM bound is
    named (phase 3 raises on it, phase 9 fails on it); untimed shapes
    and shapes at or below the slack pass."""
    shapes = [{"shape": "a", "share_of_bound": 0.3},
              {"shape": "b", "share_of_bound": 1.05},
              {"shape": "c", "share_of_bound": 1.06},
              {"shape": "d"}]
    assert cs.lanes_past_bound(shapes) == ["c"]
    assert cs.lanes_past_bound(shapes[:2] + shapes[3:]) == []


def test_kernel_entries_carry_every_key(train):
    """Every entry of the ``kernels`` line has the keys the line needs."""
    table = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, cs.D + 1).astype(np.float32))
    entries = [cs.phase_kernels(table, seed=1, time_it=False)]
    entries += cs.phase_kernels_grr(train["grr"].grr, seed=5, time_it=False)
    entries.append(cs.phase_kernels_sorted(10, time_it=False, device="cpu",
                                           n=20_000, d=50_000))
    for e in entries:
        assert KERNEL_KEYS <= set(e), e["name"]


def test_sweep_phase_on_cpu(train):
    """Phase 9 at 60,000 rows: both layouts' grids take the swept path
    (one swept solve, no ``_fit_point``), one validation entry a lane,
    lanes 0, 3 and 7 within the gates of their single-λ fits, the tuned
    fit swept and in range; the lane kernel's plain version checked at
    every shape the fits ran it at (the estimator's ELL, intercept
    included, at 8 and 4 lanes; its transposed ELL at 8); no launch
    counted on the CPU and no patch left behind."""
    from photon_ml_torch.data.batch import SparseBatch
    from photon_ml_torch.data import batch, colmajor
    from photon_ml_torch.estimators.game_estimator import GameEstimator
    from photon_ml_torch.game import coordinates

    saved = (SparseBatch.margins, SparseBatch.xt_dot,
             GameEstimator._fit_point,
             coordinates.FixedEffectCoordinate.train_swept,
             coordinates.FixedEffectCoordinate.train,
             batch.lane_gather_rowsum, colmajor.lane_gather_rowsum)
    out = cs.phase_sweep(train, "cpu", time_it=False)
    assert out["failures"] == []
    assert saved == (SparseBatch.margins, SparseBatch.xt_dot,
                     GameEstimator._fit_point,
                     coordinates.FixedEffectCoordinate.train_swept,
                     coordinates.FixedEffectCoordinate.train,
                     batch.lane_gather_rowsum, colmajor.lane_gather_rowsum)
    n_train = ROWS - ROWS // 10
    assert out["train_rows"] == n_train
    for layout in ("ell", "colmajor", "tuned"):
        f = out[layout]
        assert f["launches"] == 0 and f["evaluations"] > 0
        assert f["gradients"] > 0
        assert f["evaluation_single_launches"] == 0
        assert f["gradient_single_launches"] == 0
    xw8 = f"sweep_xw_{n_train}x{cs.NNZ + 1}_L{cs.LANES_MAIN}"
    xw4 = f"sweep_xw_{n_train}x{cs.NNZ + 1}_L{cs.TUNE_BATCH}"
    assert set(out["ell"]["lane_launches_by_shape"]) == {xw8}
    assert set(out["tuned"]["lane_launches_by_shape"]) == {xw4}
    xtr = [s for s in out["colmajor"]["lane_launches_by_shape"] if s != xw8]
    assert len(xtr) == 1 and xtr[0].startswith("sweep_xtr_")
    shapes = {sh["shape"]: sh for sh in out["lane_shapes"]}
    assert sorted(shapes) == sorted([xw8, xw4, xtr[0]])
    for sh in shapes.values():
        assert sh["max_abs_err"] == 0.0 and sh["launches"] == 0
        assert KERNEL_KEYS - {"ms", "plain_ms", "library_ms", "name",
                              "route", "source", "replaces"} <= set(sh)
    assert shapes[xtr[0]]["atol"] == cs.COLMAJOR_ATOL
    assert shapes[xtr[0]]["table"] == n_train
    assert shapes[xw4]["lanes"] == cs.TUNE_BATCH
    for layout in ("ell", "colmajor"):
        f = out[layout]
        assert f["swept_solves"] == 1 and f["fit_point_calls"] == 0
        assert len(f["loss"]) == len(f["auc"]) == len(cs.SWEEP_LAMS)
        # λ-ascending lanes: the regularized loss grows with λ.
        assert f["loss"] == sorted(f["loss"])
    assert [s["lane"] for s in out["singles"]] == list(cs.SWEEP_CHECK_LANES)
    for single in out["singles"]:
        assert single["ell_loss_gap_rel"] <= cs.SWEEP_LOSS_RTOL
        assert single["colmajor_auc_gap"] <= cs.SWEEP_AUC_ATOL
    tuned = out["tuned"]
    assert tuned["fit_point_calls"] == 0
    assert tuned["swept_solves"] == cs.TUNE_TRIALS // cs.TUNE_BATCH
    assert len(tuned["lams"]) == cs.TUNE_TRIALS


def test_sweep_evaluation_splits_on_cpu():
    """The batches the swept evaluation is timed on: the estimator's ELL
    (30 columns + the intercept column of phase 6's rows, no estimator
    intercept) and its transposed ELL."""
    rows, y = cs.make_training_data(seed=3, n=2000, d=500)
    data = {"rows": rows[:1800], "labels": y[:1800],
            "test_rows": rows[1800:], "test_labels": y[1800:]}
    train, valid = cs.sweep_data(data)
    assert valid.n == 200
    out = cs.sweep_evaluation_splits(train, "cpu", time_it=False)
    assert out["ell"]["shape"] == [1800, cs.NNZ + 1]
    assert out["ell"]["lanes"] == cs.LANES_MAIN
    v, c = out["colmajor"]["transposed_shape"]
    assert c % 8 == 0 and v * c >= 1800 * (cs.NNZ + 1)


def test_profile_sweep_on_cpu():
    """The profiled sweep runs here with no device events to sum."""
    ds = cs.make_game_data(seed=7, n=2000, d=500, n_entities=40)
    out = cs.profile_sweep(ds, "cpu")
    assert out["wall_s"] > 0
    assert out["device_busy_ms"] is None and out["idle_share"] is None


def test_fe_evaluation_splits_on_cpu():
    """The phase-7 fixed-effect batches the split times: the estimator's
    ELL batch (30 columns + the intercept) and its transposed ELL."""
    ds = cs.make_game_data(seed=7, n=2000, d=500, n_entities=40)
    out = cs.fe_evaluation_splits(
        {layout: cs.fe_problem(ds, "cpu", layout)
         for layout in ("ELL", "COLMAJOR")}, time_it=False)
    assert out["ell"]["shape"] == [2000, cs.NNZ + 1]
    assert "transposed_shape" not in out["ell"]
    v, c = out["colmajor"]["transposed_shape"]
    assert c % 8 == 0 and v * c >= 2000 * (cs.NNZ + 1)


def test_stream_phase_on_cpu(work):
    """Phases 10a-10c at a small size: the streamed fit within the gates
    of the resident one, the fault inside sweep 2's fixed-effect solve
    raised in-band and resumed from a solver snapshot (bitwise on the
    CPU), the corrupted chunk rebuilt, the driver SIGKILLed and resumed;
    the probe leaves no patch behind."""
    from photon_ml_torch.game import coordinates
    from photon_ml_torch.optim import streaming

    n, d, n_entities = 8000, 2000, 300
    data = cs.make_game_data(7, n, d=d, n_entities=n_entities)
    n_train = n - int(n * cs.TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    ref = cs._fit_summary(cs._stream_fit(cs.game_config("ELL", "cpu"),
                                         train, valid))
    saved = (streaming.ChunkedGLMObjective.value_and_gradient,
             streaming.ChunkedGLMObjective._place,
             coordinates.ChunkedFixedEffectCoordinate.train)
    out = cs.phase_stream(ref, "cpu", n=n, d=d, n_entities=n_entities,
                          chunk_rows=2048, time_it=False)
    assert out["failures"] == []
    assert saved == (streaming.ChunkedGLMObjective.value_and_gradient,
                     streaming.ChunkedGLMObjective._place,
                     coordinates.ChunkedFixedEffectCoordinate.train)
    a = out["10a"]
    assert a["chunks"] == 4 and a["chunk_files"] == 4
    assert a["placed_devices"] == ["cpu"] and a["rebuilds"] == 0
    assert a["evaluation"]["placed_chunks"] == 4
    assert out["10a_resident"]["evaluation"]["placed_chunks"] == 0
    assert out["kernel_shape"]["shape"] == "stream_chunk_2048x31"
    b = out["10b"]
    assert "InjectedFault" in b["raised"] and b["fired"]
    assert max(b["solver_resume_iterations"]) > 0 and b["bitwise"]
    assert out["10b_corrupt"]["rebuilds"] >= 1
    c = out["10c"]
    assert c["victim_rc"] == -9 and c["run_headers"] == 2
    assert c["max_abs_dw"] <= cs.DRIVER_COEF_TOL


def test_stream_sweep_phase_on_cpu(train, work):
    """Phase 10d on 20,000 rows: one streamed swept solve whose lanes 0,
    3 and 7 end within phase 9's gates of the resident swept fit's; the
    lane kernel's plain version checked at a chunk."""
    rows = 20_000
    sweep = {"rows": train["rows"][:rows], "labels": train["labels"][:rows],
             "test_rows": train["test_rows"],
             "test_labels": train["test_labels"]}
    tr, va = cs.sweep_data(sweep)
    ref, _ = cs._swept_fit("ELL", tr, va, "cpu")
    out = cs.phase_stream_sweep(sweep, ref, "cpu", chunk_rows=8192,
                                time_it=False)
    assert out["failures"] == []
    assert out["swept_solves"] == 1 and out["chunks"] == 3
    assert out["evaluations"] > 0 and out["lane_launches"] == 0
    assert out["kernel_shape"]["lanes"] == len(cs.SWEEP_LAMS)
    assert out["kernel_shape"]["max_abs_err"] == 0.0


def test_fused_phase_on_cpu(work):
    """Phase 11 at phase 10's small size: the streamed random effects (2
    entity chunks and more a bucket, retirement on) within the AUC gate
    of the resident fit over 8 sweeps with non-increasing solves; the
    fused cycle over 2,048-row chunks against the per-coordinate
    streamed fit, one pass a cycle reading every chunk and sidecar once,
    and the fused fit over two chunks on the phase's device against the
    CPU engine (both on the CPU here, so equal to the bit); a sweep at
    still offsets retires entities and the next solves only the rest;
    a fault in each fit resumed from its CD snapshot (bitwise on the
    CPU); the probe leaves no patch behind."""
    from photon_ml_torch.estimators.game_estimator import GameEstimator
    from photon_ml_torch.game import fused_sweep

    n, d, n_entities = 8000, 2000, 300
    data = cs.make_game_data(7, n, d=d, n_entities=n_entities)
    n_train = n - int(n * cs.TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    ref = cs._ooc_summary(cs._ooc_fit(cs.stream_config(
        "cpu", str(work / "ref_spill"), 2048), train, valid))
    saved = (GameEstimator._build_coordinates, GameEstimator._fused_engine,
             fused_sweep.FusedCycleEngine._pass)
    out = cs.phase_out_of_core(ref, "cpu", n=n, d=d, n_entities=n_entities,
                               chunk_rows=2048, re_chunk=64, time_it=False)
    # At 7,200 training rows 60 fused cycles end 1e-2 above the 2-sweep
    # per-coordinate fit's held-out AUC (at 900,000 within 1e-3): only
    # that gate reports, for the fit and for its resume.
    assert [(f.split(":")[0], "AUC" in f) for f in out["failures"]] == [
        ("11b", True), ("11c fused", True)]
    assert saved == (GameEstimator._build_coordinates,
                     GameEstimator._fused_engine,
                     fused_sweep.FusedCycleEngine._pass)
    a = out["11a"]
    assert a["stores"] == 2 and a["chunk_files"] > 2
    assert len(a["re"]["per_user"]["solved"]) == cs.RE_STREAM_SWEEPS
    b = out["11b"]
    # One pass a cycle, one for the final scores and one more when the
    # last step rose (the fit then returns the last accepted point).
    assert b["chunks"] == 4 and b["passes"] in (cs.FUSED_CYCLES + 1,
                                                 cs.FUSED_CYCLES + 2)
    chk = b["against_cpu"]
    assert chk["rows"] == 2 * 2048 and chk["cycles"] == cs.FUSED_CYCLES
    assert chk["value_rel"] == 0.0 and chk["max_abs_dw"] == 0.0
    still = a["still_offsets"]
    assert still["retired"] > 0
    assert still["solved_next"] == still["solved"] - still["retired"]
    assert b["rejections"] > 0 and b["joint_value"] > 0
    assert b["pass_reads"] == [(4, 4)]
    assert len(b["alpha"]) == cs.FUSED_CYCLES
    assert b["bytes_a_pass"]["sidecar"] > 0
    assert out["kernel_shape"]["shape"] == "fused_chunk_2048x31"
    for name in ("fused", "re_stream"):
        c = out["11c"][name]
        assert "InjectedFault" in c["raised"] and c["fired"]
        assert c["resumed_at"][0] > 0 and c["bitwise"]


def test_stream_score_phase_on_cpu(work):
    """Phase 12a at phase 10's small size: a 2-sweep fit's model scores
    its training rows in 2,048-row chunks from a spill dir, within the
    margin gate of the resident transform, the streaming AUC equal to
    the one-shot AUC, every chunk spilled once and the warm pass equal
    to the bit; B1's plain version checked at the scorer's chunk."""
    n, d, n_entities = 8000, 2000, 300
    data = cs.make_game_data(7, n, d=d, n_entities=n_entities)
    n_train = n - int(n * cs.TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    model = cs._stream_fit(cs.game_config("ELL", "cpu"), train,
                           valid)["results"][0].model
    out = cs.phase_stream_score(model, train, "cpu", chunk_rows=2048,
                                time_it=False)
    assert out["failures"] == []
    assert out["n_chunks"] == 4 and out["chunk_files"] == 4
    assert out["store"]["spills"] == 4 and out["warm_store"]["spills"] == 0
    assert out["warm_bitwise"] and out["auc_gap_one_shot"] == 0.0
    assert out["margin_gap"] <= cs.SCORE_MARGIN_ATOL
    assert abs(out["auc"] - out["resident_auc"]) < 1e-6
    assert out["launches"] == out["warm_launches"] == 0     # plain on CPU
    assert out["kernel_shape"]["shape"] == "score_chunk_2048x30"
    assert out["kernel_shape"]["max_abs_err"] == 0.0


def test_telemetry_phase_on_cpu(train, work):
    """Phase 13 at phase 10's small size: 10a's streamed fit off, in a
    metrics and in a trace session, bitwise equal to 10a's with the
    reports ok and the chunk program's cost the analytic count; 12a's
    scoring pass off and in a metrics session to the bit; 10d's grid on
    20,000 rows in a metrics session equal to 10d's lanes; the training
    driver with ``--telemetry trace`` and ``profile_dir`` in a
    subprocess, its report exiting 0.  The CPU has no sync guard and no
    CUDA events: their numbers are None here."""
    n, d, n_entities = 8000, 2000, 300
    data = cs.make_game_data(7, n, d=d, n_entities=n_entities)
    n_train = n - int(n * cs.TRAIN_HOLDOUT)
    tr, va = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    fit = cs._stream_fit(cs.stream_config(
        "cpu", str(work / "stream_spill"), 2048), tr, va)
    fit_10a = cs._fit_summary(fit)
    stream = {"10a": {"launches": fit["launches"]}}
    model = fit["results"][0].model
    del fit
    a = cs.phase_telemetry(stream, fit_10a, "cpu", n=n, d=d,
                           n_entities=n_entities, chunk_rows=2048)
    assert a["failures"] == []
    assert a["gates"] == "bitwise"
    assert all(a["bitwise_10a"].values())
    assert a["metrics_report"]["ok"] and a["trace_report"]["ok"]
    assert a["trace_report"]["reconciliation"] >= 0.9
    assert a["metrics_report"]["odometer_ok"]
    assert a["split"]["chunks"] > 0 and a["split"]["load_s"] > 0
    assert a["program"]["stream_ms"] is None       # no CUDA events
    assert a["program"]["kernel_ms"] is None       # no profiler kernels
    assert a["cost_bytes"] == a["cost_bytes_analytic"]
    assert a["trace"]["prefetch_load"] == ["photon-chunk-prefetch"]
    assert a["syncs"] == dict.fromkeys(("off", "metrics", "trace",
                                        "off_again"))

    b = cs.phase_telemetry_score(model, tr, "cpu", chunk_rows=2048)
    assert b["failures"] == [] and b["bitwise"]
    assert b["n_chunks"] == 4 and b["split"]["chunks"] == 4

    rows = 20_000
    sweep = {"rows": train["rows"][:rows], "labels": train["labels"][:rows],
             "test_rows": train["test_rows"],
             "test_labels": train["test_labels"]}
    s_tr, s_va = cs.sweep_data(sweep)
    ref, _ = cs._swept_fit("ELL", s_tr, s_va, "cpu")
    ref_10d = cs.phase_stream_sweep(sweep, ref, "cpu", chunk_rows=8192,
                                    time_it=False)
    c = cs.phase_telemetry_sweep(sweep, ref_10d, "cpu", chunk_rows=8192)
    assert c["failures"] == [] and c["bitwise_10d"]
    assert c["report"]["odometer_ok"] and c["report"]["sweeps"] > 0

    dd = cs.phase_telemetry_driver(["--device", "cpu"])
    assert dd["failures"] == [], dd
    assert dd["report_rc"] == 0 and dd["profile_bytes"] > 0


def test_tiers_phase_on_cpu(work):
    """Phase 14 at a small size (2,000 columns, 500 entities a random
    effect): every gate but the card-only launch count and sync counts
    (None here) holds, the projected model's answers within 1e-4 of
    float64, and the dispatch fault latches one tail-latency alert."""
    model, host = cs.make_model(seed=0, d=2000, n_entities=500)
    model_dir = str(work / "model")
    cs.save_game_model(model, cs.TaskType.LOGISTIC_REGRESSION, model_dir)
    rows = cs.make_rows(np.random.default_rng(2), host,
                        cs.CLIENTS * cs.REQUESTS * cs.ROWS, d=2000)
    ref_m, ref_p = cs.reference(host, rows)
    # This model's requests take milliseconds on the CPU, so queue wait
    # and throughput swing with the host's load: the fault's monitor
    # keeps only the rule under test (the card runs the defaults).
    out = cs.phase_tiers(model_dir, str(work / "spill"), rows, ref_m, ref_p,
                         "cpu", proj={"d": 2000, "n_entities": 500,
                                      "n_rows": 32},
                         fault_thresholds={"queue_wait_fraction": 1e9,
                                           "collapse_fraction": 0.0})
    assert out["failures"] == [], out["failures"]
    assert out["launches"] == 0 and out["builds"] == 0
    assert out["sync"]["on"] is None and out["sync"]["bitwise"]
    assert out["metrics"]["photon_serve_requests_total"] == \
        cs.CLIENTS * cs.REQUESTS
    assert out["serve_report"]["rc"] == 0
    assert out["serve_report"]["tail_requests"] >= 0
    assert set(out["split"]["p99"]["stages_ms"]) >= {
        "admission", "queue_wait", "assemble", "store_lookup", "dispatch",
        "d2h", "serialize", "write", "other"}
    assert out["projected"]["max_abs_err"] <= cs.SERVE_ATOL
    assert out["projected"]["projected_term_max"] > 0.01
    assert out["fault"]["fired"][0][:2] == ["serve.dispatch", "error"]
    # The cost run: with the tiers off only the request context is
    # minted, at their defaults every hook runs.
    cost = out["cost"]
    for off, on in zip(cost["runs"]["off"], cost["runs"]["defaults"],
                       strict=True):
        assert on["hook_calls"] > off["hook_calls"] > 0
        for clock in ("wall", "cpu"):
            assert on["hooks_us"][clock]["trace"] > 0
            assert on["hooks_us"][clock]["monitor"] > 0
    assert len(cost["runs"]["off"]) == cs.TIER_COST_ROUNDS
    for clock in ("wall", "cpu"):
        assert cost["median"]["defaults"][f"hooks_{clock}_us"] > \
            cost["median"]["off"][f"hooks_{clock}_us"]


def test_fleet_phase_on_cpu(work):
    """Phase 15 at a small size (2,000 columns, 500 entities a random
    effect): the fleet CLI with two replicas on the CPU, every gate but
    the card-only nvidia-smi one, and a result that is one JSON object."""
    model, host = cs.make_model(seed=0, d=2000, n_entities=500)
    model_dir = str(work / "model")
    cs.save_game_model(model, cs.TaskType.LOGISTIC_REGRESSION, model_dir)
    rows = cs.make_rows(np.random.default_rng(2), host,
                        cs.CLIENTS * cs.REQUESTS * cs.ROWS, d=2000)
    ref_m, ref_p = cs.reference(host, rows)
    model2, host2 = cs.make_model(seed=1, d=2000, n_entities=500)
    out = cs.phase_fleet(model_dir, str(work / "spill"), rows, ref_m, ref_p,
                         "cpu", model2, cs.reference(host2, rows))
    assert out["failures"] == [], out["failures"]
    json.loads(json.dumps(out))
    assert len(out["cold_start_s"]) == cs.FLEET_REPLICAS
    assert out["serving"]["requests"] == cs.CLIENTS * cs.REQUESTS
    assert out["serving"]["max_abs_err"] <= cs.SERVE_ATOL
    assert len(out["fleet_batches"]) == cs.FLEET_REPLICAS
    assert all(b > 0 for b in out["fleet_batches"])
    assert out["frontend_pid"] not in [r["pid"] for r in out["replicas"]]
    assert [r["device"] for r in out["replicas"]] == ["cpu"] * 2
    assert "card_apps" not in out                  # nvidia-smi: card only
    assert out["kill"]["failed"] == 0 and out["kill"]["requests"] > 0
    assert out["kill"]["replica_restarts"] >= 1
    assert "replica_restarts" in out["kill"]["alerts"]
    assert out["swap"]["min_ready"] >= 1 and out["swap"]["swap_aborts"] == 0
    assert out["after_swap"]["matched"] == [cs.CLIENTS * cs.REQUESTS]
    assert out["corrupt"]["failed"] == 0
    assert "failed to come up" in out["corrupt"]["last_swap_error"]
    assert out["after_abort"]["matched"] == [cs.CLIENTS * cs.REQUESTS]
    assert out["fleet"]["swaps"] == 1 and out["fleet"]["swap_aborts"] == 1
    assert out["frontend"]["failed"] == 0
    assert out["stop"]["rc"] == 0
    assert out["serve_report"]["rc"] == 0
    assert len(out["serve_report"]["logs"]) == 1 + cs.FLEET_REPLICAS
    assert set(out["serve_report"]["stages"]) >= {"route", "forward"}


def test_training_fleet_phase_on_cpu(work):
    """Phase 16 at phase 10's small size: the streamed fit, its
    killed-host replay, the fused fit (10 cycles) and the training
    driver as two-host fleets, with their single-process references;
    every gate holds, host 1 owns a sentinel step, the resumed host
    restored its reduce sequence, and the result is one JSON object."""
    kw = dict(n=8000, d=2000, n_entities=300, chunk_rows=1500)
    refs = cs.fleet_references("cpu", cycles=10, **kw)
    out = cs.phase_fleet_training(*refs, "cpu", cycles=10, time_it=False,
                                  **kw)
    assert out["failures"] == [], out["failures"]
    json.loads(json.dumps(out, default=str))
    a = out["16a"]
    assert a["owned"] == [[0, 1, 2], [3, 4]] and a["bitwise"]
    assert a["seq"][0] == a["seq"][1] == a["reduces"] > 0
    assert a["fleet_report"]["rc"] == 0
    assert a["reduce"]["ms"] > 0 and not a["reduce"]["errors"]
    b = out["16b"]
    assert b["victim_rc"] == -9 and b["replays"] > 0
    assert b["bitwise_to_16a"] == [True, True]
    assert b["fleet_report"]["restarted_hosts"] == [1]
    assert b["fleet_report"]["rows"][1]["seq_restored"] > 0
    assert b["rejoin_s"] is not None and b["rejoin_s"] > 0
    c = out["16c"]
    assert c["bitwise"] and c["auc_gap"] <= cs.STREAM_AUC_ATOL
    assert c["stats_bytes_a_step"] > 0
    assert all(r["passes"] == 11 for r in c["b1"].values())
    d = out["16d"]
    assert d["bitwise"] and d["fleet_report"]["rc"] == 0
    assert d["max_abs_dw_vs_10c"] <= cs.DRIVER_COEF_TOL



def test_mesh_phase_on_cpu(train, training, work):
    """Phase 17a on the 60,000 rows: config 1 on 8 shards (ELL,
    transposed ELL, GRR) through the estimator within phase 6's float64
    and layout gates, config 2's TRON on the mesh, every shard's kernel
    shapes checked (the plain versions against themselves here)."""
    out = cs.phase_mesh(train, training, "cpu", time_it=False)
    assert out["failures"] == []
    assert out["ell"]["rows_per_shard"] * cs.MESH_DEVICES >= \
        ROWS - ROWS // 10
    assert len(out["shapes"]["ELL"]) == cs.MESH_DEVICES
    assert {s["max_abs_err"] for s in out["shapes"]["COLMAJOR"]} == {0.0}
    assert all(0.0 <= s["padding_share"] < 1.0
               for s in out["shapes"]["COLMAJOR"])
    assert out["grr"]["padded_levels"] == len(out["shapes"]["GRR"])
    assert out["config2_tron_colmajor"]["loss_gap_rel"] <= \
        cs.LAYOUT_LOSS_RTOL


def test_mesh_game_stream_and_driver_phases_on_cpu(work):
    """Phases 17b-17d at phase 10's small size: config 5 on 8 shards
    against its single-device fit, phase 10a's fit on GRR chunks and on
    GRR chunks × 2 shards against the ELL-chunk fit, and the driver with
    ``distributed_init`` (a world of one gloo process) and 8 shards
    against its single-device run; 17c also spilled to disk."""
    from photon_ml_torch.cli import game_training_driver

    n, d, n_entities = 8000, 2000, 300
    data = cs.make_game_data(7, n, d=d, n_entities=n_entities)
    n_train = n - int(n * cs.TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    fit = cs._fit_game(cs.game_config("ELL", "cpu"), train, valid)
    game = cs.phase_mesh_game(7, n, "cpu", {"auc": fit["auc"],
                                            "wall_s": fit["wall_s"]},
                              d=d, n_entities=n_entities)
    assert game["failures"] == []
    assert game["shard_entities"] and game["bucket_solves"] % \
        cs.MESH_DEVICES == 0
    assert game["fe_evaluations"] % cs.MESH_DEVICES == 0
    stream_fit = cs._stream_fit(cs.stream_config(
        "cpu", str(work / "ref_spill"), 2048), train, valid)
    ref = dict(cs._fit_summary(stream_fit), wall_s=stream_fit["wall_s"])
    for spill in (False, True):
        stream = cs.phase_mesh_stream(ref, "cpu", n=n, d=d,
                                      n_entities=n_entities,
                                      chunk_rows=2048, time_it=False,
                                      spill=spill)
        assert stream["failures"] == []
        for name in ("grr", "grr_mesh"):
            assert stream[name]["evaluation_padded_levels"] >= \
                stream[name]["pieces_a_chunk"]
    assert stream["grr"]["evaluations"] >= 1
    assert stream["grr_mesh"]["pieces_a_chunk"] == cs.MESH_CHUNK_DEVICES
    assert {s["max_abs_err"] for s in stream["shapes"]} == {0.0}
    out_dir = str(work / "ref_driver")
    cfg_path = str(work / "ref_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(cs.stream_driver_config(out_dir), f)
    game_training_driver.main(["--config", cfg_path, "--spill-dir",
                               str(work / "ref_driver_spill"), "--device",
                               "cpu"])
    failures: list = []
    drv = cs.phase_mesh_driver(out_dir, failures, ["--device", "cpu"])
    assert failures == [] and not drv["group_left"]
    assert drv["distributed"] == {"backend": "gloo", "world": 1, "rank": 0}
