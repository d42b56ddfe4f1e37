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
    assert len(split["largest"]) == 4


def test_training_phase_gates_on_cpu(training):
    out = training
    assert [f for f in out["failures"] if "AUC" not in f] == []
    assert out["loss_final"] < out["loss_first"]
    assert out["early_loss_gap_rel"] <= cs.TRAJECTORY_RTOL
    assert max(out["f64_errors"]["grr"].values()) <= cs.F64_VECTOR_RTOL
    assert out["launches"] == {"grr_contract_dense": 0, "grr_contract": 0,
                               "gather_rowsum": 0}


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
    for layout in ("ell", "colmajor"):
        f = out[layout]
        assert f["fe_evaluations"] > 0 and f["launches"] == 0
        assert f["fe_evaluation_launches"] == f["fe_gradient_launches"] == 0
        assert f["fe_gradients"] > 0
        assert len(f["auc_by_sweep"]) == cs.GAME_SWEEPS
        assert sorted(f["sweep_coordinate_s"]) == [1, 2]
        assert {b["width"] for b in f["buckets"]} == {cs.P_USER, cs.P_ITEM}
    assert out["ell"]["auc"] > out["fixed_only"]["auc"]


def test_driver_phase_on_cpu(work):
    """Phase 8: the training driver's golden, then the indexing driver's
    maps, the scoring driver's AUC and outputs, and the Avro export."""
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
