#!/usr/bin/env python3
"""Smoke run of ``photon_ml_torch`` on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card (an H100: the kernels are built for ``sm_90a``),
``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``) and
``g++`` (the host plan builder).  Without a card, or outside a checkout
of the repository, it exits nonzero and prints no result.  Each phase
raises on failure:

1. card: the card's name and power limit, as nvidia-smi prints them;
2. build: every hand-written kernel from ``photon_ml_torch/csrc``, one
   nvcc per source, all started together;
3. kernel check: each kernel against its plain PyTorch version on the
   card, with CUDA-event times beside the bound and a library call:
   ``gather_rowsum`` at the serving path's shapes, at phase 6's ELL
   training arrays and at their transposed ELL (``build_colmajor``,
   auto capacity; the table a residual over the 900,000 rows, as in
   ``ColMajorSlice.xt_dot``) (median of 20 samples of back-to-back
   calls, after 3 warm-ups, with the profiler's device ms, the bound and
   ``embedding_bag`` beside), and checked at the widths 8, 128 and 512,
   every shape launched twice and required bitwise equal;
   ``grr_contract_dense`` and ``grr_contract`` at every level of the full-width GRR plan that phase
   6 trains on (each direction, column range and overflow level), each
   level launched twice and required bitwise equal, and timed L2-cold
   (median of 20 single calls, each after a 128 MB write; a level read
   faster than 105 % of its HBM bound fails) with the back-to-back
   figure and the profiler's device ms beside it as ``*_warm``;
   ``gather_rowsum_lanes`` at phase 6's ELL arrays with a [100,001, L]
   table at L = 2, 8 and 16, at those arrays cut to their 31 real slots
   (the estimator's ELL, intercept included, as phase 9 fits it) at L =
   4 and 8, and at their transposed ELL with L = 8 (the table a residual
   over the rows, [900,000, 8]), each launched twice and required
   bitwise equal and within B1's tolerances, timed as B1 is with
   ``embedding_bag`` over the [T, L] table and L single-lane
   ``gather_rowsum`` launches beside (a shape read faster than 105 % of
   its HBM bound fails), the 31-slot and transposed shapes also timed
   with every id 0 (the streams and sums alone) and the 31-slot ones
   with no table head kept (the table grown with zero rows) and with
   their ids mirrored (the popular rows past the head);
4. serving: the config-5 GAME model (KDD Cup 2012 track 2 widths: a
   sparse fixed effect over 100,000 features plus an intercept, 30
   non-zeros a row; a per-user random effect of 100,000 entities x 2
   features; a per-item one of 100,000 x 1) made from seed 0, saved,
   and served by an in-process ``ModelServer`` on the card to
   concurrent HTTP clients.  Every margin and prediction is held
   against a float64 numpy reference computed from the coefficients.
   The kernels' launch counts are set to 0 just before this phase and
   read just after it.  Then the time of a batch is split by stage of
   ``ScoringEngine.score_batch``, as served and with every entity-store
   chunk held in the host window;
5. CLI: ``python -m photon_ml_torch.serving`` in a subprocess answers
   one request and exits 0 on SIGTERM with a JSON last line;
6. training: config 1 (logistic, L2, L-BFGS) at the config-5
   fixed-effect widths: 10^6 rows made from seed 3 with power-law column
   popularity, 30 non-zeros plus an intercept a row (ELL capacity 32),
   labels from a planted sparse model, 10% held out.  The GRR plan is
   built on the host by the C++ builder (asserted) and moved to the
   card; the launch counts are set to 0, a 20-iteration fit runs through
   the plan, and the counts are read.  The loss must fall, the held-out
   AUC reach 0.70, the objective's value, gradient, Hessian-vector
   product and Hessian diagonal agree with a float64 scipy reference,
   and the same fit on the plain-ELL layout end at the same loss, having
   launched ``gather_rowsum`` at least once an evaluation; the same fit
   on the transposed-ELL layout must end within 1e-3 of the ELL one and
   launch ``gather_rowsum`` twice a value-and-gradient.  Config 2
   (squared loss, L2, TRON, 20 iterations) runs on the ELL and the
   transposed-ELL layout of the same arrays: the loss must fall, the two
   end within 1e-3, and TRON's final gradient norm must be below that of
   L-BFGS on the same problem.  Then one ``value_and_gradient`` is timed
   on the three layouts beside one cuSPARSE product per direction, the
   plain-ELL one's device ms split by kernel and the transposed-ELL
   one's into B1 X·w, B1 Xᵀr, the fold and the rest;
7. GAME training: config 5 at the phase-4 widths (the fixed effect over
   100,000 power-law columns, 30 a row, plus an intercept; a per-user
   random effect over 100,000 power-law entities x [1, x]; a per-item
   one x [1]), 10^6 rows made from seed 7, 10% held out;
   ``GameEstimator(TrainingConfig(...)).fit`` for 2 coordinate-descent
   sweeps with L-BFGS on every coordinate, once on the ELL and once on
   the transposed-ELL layout, beside a fixed-only fit.  The held-out AUC
   must beat the fixed-only one, the two layouts' AUCs agree within
   1e-3, ``gather_rowsum`` launch at least once inside every fixed-effect
   evaluation (``SparseBatch.margins``) and, on the transposed ELL, once
   inside every gradient (``SparseBatch.xt_dot``), 64 converged entity
   lanes drawn across every bucket of
   both random effects each reach, within 1e-4 relative, the objective
   of a float64 scipy solve of that entity's problem (with the offsets
   its last solve saw), and the saved model, served by
   ``ScoringEngine``, give the transformer's margins to 1e-4.  Then
   ``gather_rowsum`` is checked and timed as in phase 3 on phase 7's
   own arrays: the fixed effect's ELL as the estimator builds it
   (900,000 x 31 with the intercept), its transposed ELL, and the
   transformer's first scoring chunk of the held-out rows.  Printed:
   the wall a sweep and a coordinate, each bucket's entities, capacity,
   iterations and solve wall, one profiled sweep's device busy ms and
   idle share, and the fixed effect's evaluation on the ELL and the
   transposed-ELL layout split by part;
8. drivers: ``python -m photon_ml_torch.cli.game_training_driver`` in a
   subprocess, on the card, on the committed config-4 Avro fixture: it
   exits 0 and reproduces ``tests/resources/golden.json``'s config-4 AUC
   and fixed-effect coefficients within 2e-3.  Then, in subprocesses,
   ``feature_indexing_driver`` writes index maps equal to the training
   driver's, and ``game_scoring_driver`` scores the validation file from
   the saved model to ``.npz`` and to ``.avro``: its AUC equals the
   training driver's within 1e-6, the two outputs' scores agree within
   1e-6 and the Avro file reads back with the port's reader.  The
   ``.npz`` scoring runs once more in this process with the B1 count set
   to 0 (it must launch), and ``export_model_avro`` writes the model,
   which reads back to the same coefficients;
9. swept λ: config 1 on phase 6's arrays (the intercept one of their
   columns) over 8 λ log-spaced on [0.01, 100], ``GameEstimator.fit`` of
   the grid with L-BFGS for 20 iterations, on the ELL and the
   transposed-ELL layout.  Each grid must take the swept path (one
   swept solve, ``_fit_point`` never called), ``gather_rowsum_lanes``
   must launch inside every swept evaluation (``SparseBatch.margins``
   with W [L, d]) and, on the transposed ELL, every swept gradient,
   and single-lane ``gather_rowsum`` never inside either; lanes 0, 3
   and 7 must end within 1e-3 (relative loss) and 1e-3 (held-out AUC)
   of single-λ fits of their λ.  A RANDOM ``fit_tuned`` of 8 trials, 4 a
   round, must take the swept path (the same kernel gates) with every λ
   in range and its best AUC at least the grid's worst.  The lane
   kernel is then checked and timed as in phase 3 at every shape these
   fits launched it at, on the last inputs each had (the estimator's
   900,000 x 31 ELL at 8 and 4 lanes, and its transposed ELL at 8),
   each shape carrying its launches (none read faster than 105 % of its
   bound).  Printed: each grid fit's wall by stage (data preparation,
   swept setup, swept solve, validations, the rest), the swept solves'
   walls against the single-λ ones, and one swept ``value_and_gradient`` at
   L = 8 on each layout, its device ms split by part, and the idle share;
10. streamed training: (a) phase 7's ELL config 5 (its data remade
   from seed 7) with the fixed effect chunk-streamed from disk
   (``chunk_rows`` 131,072: 7 ELL chunks of the 900,000 training rows,
   spilled to a temporary dir, one chunk kept on the card, two decoded
   in host RAM, two prefetched, so every evaluation streams every chunk
   from disk) for 2 sweeps: its held-out AUC within 1e-3 of phase 7's
   resident ELL fit and its fixed effect's final loss within 1e-3
   relative (max |Δw| printed), ``gather_rowsum`` launched at least
   once a chunk in every fixed-effect evaluation, every chunk file in
   the spill dir, the store quiesced after the fit and every placed
   chunk leaf on the card.  Printed: the fit's wall by stage, one
   streamed ``value_and_gradient`` (CUDA-event ms, wall, the profiler's
   device ms split into kernels and host-to-device copies, the idle
   share, the bytes placed, the copy rate, the prefetch consumer's
   wait), and the same fit and evaluation with every chunk kept on the
   card (the transfer paid once); B1 checked and timed at a placed
   chunk (131,072 x 31).  (b) The same fit with solver snapshots every
   5 iterations and an ``error`` fault at a ``prefetch.load``
   occurrence three quarters into sweep 2's fixed-effect solve: the
   fault raises in-band, a new estimator with ``resume=True`` finishes
   from a solver snapshot at an iteration > 0, within (a)'s gates of
   (a)'s fit (bitwise equality printed); the same resume again from a
   copy of the interrupted checkpoints, with a ``corrupt_file`` fault
   at the first chunk load: the chunk rebuilds from lineage and the fit
   ends within the gates.  (c) ``python -m
   photon_ml_torch.cli.game_training_driver`` in a subprocess on phase
   8's config-4 fixture, chunked (64 rows), spilled and snapshotted
   every solver iteration (``--spill-dir``, ``--checkpoint-dir``,
   ``--checkpoint-every-solver-iters 1``), SIGKILLed once a
   ``solver_*.npz`` appears, then rerun with ``--resume``: its model
   within phase 8's coefficient tolerance of an uninterrupted run's, its
   run log holding both runs.  (d) Phase 9's ELL grid with the fixed
   effect chunk-streamed from disk (131,072 rows a chunk):
   ``gather_rowsum_lanes`` launched at least once a chunk in every swept
   evaluation and single-lane ``gather_rowsum`` never, lanes 0, 3 and 7
   within phase 9's gates of its resident swept lanes; the lane kernel
   checked and timed at a placed chunk with L = 8.
11. out-of-core GAME training on phase 10's data: (a) both random
   effects streamed from a spill dir in entity chunks (16,384 entities a
   chunk a size bucket, two decoded in host RAM, two prefetched),
   converged entities retired, for 8 sweeps beside a resident 8-sweep
   fit: held-out AUC within 1e-3 of it, each random effect's entities
   solved a sweep non-increasing, every entity-chunk file present and the
   stores quiesced; then one more per-user sweep at the last offsets (no
   drift) must retire entities, and the sweep after it must solve exactly
   the rest; printed: the per-sweep entities solved and retired, each
   random effect's wall a sweep beside the resident fit's, one streamed
   per-user sweep's wall, device ms by part and idle share.
   (b) The fused cycle (``cd_fused``) over phase 10a's 131,072-row
   chunks, spilled with their sidecars, 60 cycles: held-out AUC within
   1e-3 of phase 10a's per-coordinate fit; every pass launches B1 at
   least once a chunk and reads every chunk and every sidecar once, one
   pass a cycle and one or two more for the final model; the sidecar
   files present.  The engine on the card is held against the port's
   CPU engine (which the tests hold against the JAX package): the same
   fused fit over the first two chunks' rows, 60 cycles on each, every
   cycle's (value, step scale) within 1e-5 relative and every
   coefficient within 5e-3.  Phase 10a's 2-sweep fit is not converged,
   so the fused fit's coefficients are recorded beside it, not gated.
   Printed: each cycle's ms, value and step scale, the bytes a pass, one
   cycle's device ms by part (B1, the float64 ``index_add_``, the Newton
   solves, copies) and idle share; B1 checked and timed at a pass's chunk
   with the fitted coefficients.  (c) An ``error`` fault at a
   ``prefetch.load`` halfway through each of (a)'s and (b)'s fits (with
   CD snapshots), then the resume from the snapshot: each ends within its
   fit's gates, its bitwise equality with the uninterrupted fit printed.

The line before the card's and the result's is one JSON object with a
``kernels`` list: per kernel its launches on its path (``gather_rowsum``:
phase 4; phase 6's ELL and transposed-ELL fits as ``launches_ell_fit``
and ``launches_colmajor_fit``; phase 7's ELL GAME fit as
``launches_game_fit``; phase 8's in-process scoring as
``launches_scoring_driver``; phase 10a's streamed fit as
``launches_stream_fit``; phase 11's streamed random-effect and fused
fits as ``launches_re_stream_fit`` and ``launches_fused_fit``, the fused
pass's chunk as ``fused_chunk_shape``; the GRR kernels: phase 6's GRR fit;
``gather_rowsum_lanes``: phase 9's ELL, transposed-ELL and tuned fits and
phase 10d's streamed grid, and by shape in ``shapes``),
the largest kernel-vs-plain difference over all checked shapes
(``gather_rowsum``: phases 3, 7, 10 and 11), and its times and bound
(``gather_rowsum``: at the serving bucket, 64 rows x 32 slots; the GRR
kernels: L2-cold, summed over the plan levels they run, i.e. one X·w
plus one Xᵀr, with the warm sums beside; ``gather_rowsum_lanes``: at
phase 6's ELL arrays cut to the estimator's 900,000 x 31 with 8 lanes);
``shapes`` holds every checked shape.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import dataclasses

import numpy as np
import torch

from photon_ml_torch import native
from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    ServingConfig,
    TrainingConfig,
    TuningConfig,
    config_to_json,
)
from photon_ml_torch.data import batch as batch_mod
from photon_ml_torch.data import colmajor as colmajor_mod
from photon_ml_torch.data import grr as grr_mod
from photon_ml_torch.data.batch import SparseBatch, make_sparse_batch
from photon_ml_torch.data.colmajor import build_colmajor
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators import game_transformer
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.evaluation.evaluators import EvaluatorType, auc
from photon_ml_torch.game import coordinates as game_coordinates
from photon_ml_torch.game import fused_sweep as fused_mod
from photon_ml_torch.game.dataset import EntityGrouping, GameDataset
from photon_ml_torch.io.model_io import load_game_model, save_game_model
from photon_ml_torch.kernels import _build
from photon_ml_torch.models import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    TaskType,
)
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.grr_kernel import (
    grr_contract,
    grr_contract_dense,
    grr_contract_dense_reference,
    grr_contract_reference,
    tile_partials,
)
from photon_ml_torch.ops.kernels import (
    gather_rowsum,
    gather_rowsum_lanes,
    gather_rowsum_lanes_reference,
    gather_rowsum_reference,
)
from photon_ml_torch.ops.objective import GLMObjective, sweep_value_and_gradient
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim import streaming as streaming_mod
from photon_ml_torch.optim.problem import OptimizationProblem
from photon_ml_torch.reliability import faults
from photon_ml_torch.serving.engine import ScoringEngine, dataset_rows
from photon_ml_torch.serving.server import ModelServer
from photon_ml_torch.utils.run_log import RunLogger, read_run_log

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")

# Config 5 at the repository's own widths (examples/kdd_scale.py, bench.py).
D = 100_000                 # sparse fixed-effect features (+ intercept)
NNZ = 30                    # non-zeros a row
ELL_CAP = 32                # ell_row_capacity of the server
N_ENTITIES = 100_000        # per random effect
P_USER, P_ITEM = 2, 1       # user: [1, x]; item: per-entity intercept
BATCH_ROWS = 64             # largest micro-batch bucket
CLIENTS, REQUESTS, ROWS = 4, 8, 8   # client threads x requests x rows

# Kernel vs plain version: float32 sums taken in another order.
RTOL, ATOL = 1e-5, 1e-6
# Served answers vs the float64 reference: float32 arithmetic throughout.
SERVE_ATOL = 1e-4

# One H100 SXM (NVIDIA data sheet): HBM rate and the float32 rate outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# gather_rowsum's timed shapes (n, k): the serving bucket, an odd tail
# with padding slots and ids at both ends of the table, a scoring chunk
# (phase 6's ELL training arrays are timed beside them); and the widths
# of the transposed-ELL virtual rows (capacities 8-512), checked only.
KERNEL_SHAPES = ((BATCH_ROWS, ELL_CAP), (67, 5), (1 << 20, ELL_CAP))
WIDTH_SHAPES = ((1 << 16, 8), (1 << 16, 128), (1 << 16, 512))

# Phase 6: config 1 at the config-5 fixed-effect widths (bench.py:83).
TRAIN_ROWS = 1_000_000      # 10% of them held out
TRAIN_HOLDOUT = 0.1
TRAIN_ITERS = 20
TRAIN_L2 = 1.0
TRAIN_AUC_MIN = 0.70
# Objective surfaces vs the float64 reference: value relative error;
# vectors max|Δ| / max|reference|.
F64_VALUE_RTOL, F64_VECTOR_RTOL = 1e-5, 1e-4
# The GRR and the plain-ELL fits: their losses at each of the first
# TRAJECTORY_ITERS iterations, and at the end.  The end is looser: at
# this conditioning (a head column in nearly every row beside columns
# seen a few times; no normalization) L-BFGS amplifies float32 rounding
# differences of the objective over the later iterations.  The phase
# measures that amplification on one layout (the same fit from a start
# perturbed at rounding level) and reports it beside the layouts' gap.
TRAJECTORY_ITERS, TRAJECTORY_RTOL = 10, 1e-4
LAYOUT_LOSS_RTOL = 1e-3
PERTURBATION = 1e-7
# GRR kernels vs their plain versions: rtol, and atol as a multiple of
# the largest |partial| a supertile adds to an output window.  Both
# versions sum each tile's cap terms, then the tiles; float32 rounding
# in those sums scales with these terms (an output window sums up to
# n_gw of them, and near-zero outputs come from their cancellation).
GRR_RTOL, GRR_ATOL_SCALE = 1e-5, 1e-5
# L2-cold timing of the GRR levels: bytes written between two samples
# (the H100's L2 holds 50 MB), and a spin of about 1 ms that covers the
# host's enqueue time.  A level read faster than its HBM bound by more
# than GRR_BOUND_SLACK is a measurement fault, not a gain; so is a shape
# of the lane kernel (a kernel that skips work, or a timing that does not
# measure it).
FLUSH_BYTES = 128 << 20
SPIN_CYCLES = 2_000_000
GRR_BOUND_SLACK = 1.05
# B1 at the transposed-ELL arrays (virtual rows of up to 512 slots, the
# residual as the table): sums of up to 512 terms of |r| < 1, so float32
# rounding in two summation orders reaches ~1e-5 on near-zero sums.
COLMAJOR_ATOL = 1e-5
# Phase 6, config 2 (squared loss, L2, TRON) beside L-BFGS on the same
# problem, both 20 iterations.
TRON_ITERS = 20

# Phase 7: config 5 GAME training at the phase-4 widths, 10^6 rows made
# from seed 7 (10% held out), two coordinate-descent sweeps of L-BFGS on
# every coordinate, once a fixed-effect layout.
GAME_ROWS = 1_000_000
GAME_SWEEPS = 2
GAME_FE_ITERS, GAME_RE_ITERS = 20, 30
GAME_L2 = 1.0
GAME_LAYOUT_AUC_ATOL = 1e-3
# Per-entity check: converged lanes drawn across every bucket of both
# random effects, their objective against a float64 scipy solve of the
# entity's own problem (the offsets its last solve saw).
GAME_ENTITY_CHECKS = 64
GAME_ENTITY_RTOL = 1e-4
# The saved model served by ScoringEngine against the transformer.
GAME_SERVE_ROWS, GAME_SERVE_ATOL = 256, 1e-4

# Phase 8: the training driver on the committed config-4 fixture, at
# the tolerances of tests/test_fixtures.py; then the indexing and scoring
# drivers and the Avro export on the same fixture.  The scoring driver
# runs the training driver's validation transform again, so its AUC and
# its two outputs' scores agree to float32 rounding.
FIXTURES = os.path.join(REPO, "tests", "resources")
DRIVER_AUC_ATOL, DRIVER_COEF_TOL = 2e-3, 2e-3
SCORING_ATOL = 1e-6

# gather_rowsum_lanes in phase 3: the λ-lane counts checked and timed at
# phase 6's ELL arrays, the ones checked and timed at those arrays cut to
# the estimator's 31 slots (the tuned fit's rounds of 4 and the grid's
# 8), and the one at their transposed ELL (the main path's: phase 9
# sweeps 8 λ).
LANE_COUNTS = (2, 8, 16)
LANE_COUNTS_31 = (4, 8)
LANES_MAIN = 8

# Phase 9: config 1 at the config-5 fixed-effect widths (phase 6's
# arrays) fitted over a λ grid of 8 log-spaced points as ONE swept
# solve, L-BFGS 20 iterations, on the ELL and the transposed-ELL layout.
# Lanes SWEEP_CHECK_LANES are held against single-λ fits at the layout
# gates of phase 6 (final loss 1e-3 relative; held-out AUC 1e-3).  Then
# a RANDOM tuned fit of TUNE_TRIALS trials, TUNE_BATCH a swept round.
SWEEP_LAMS = tuple(float(x) for x in np.logspace(-2, 2, 8))
SWEEP_ITERS = 20
SWEEP_CHECK_LANES = (0, 3, 7)
SWEEP_LOSS_RTOL, SWEEP_AUC_ATOL = 1e-3, 1e-3
TUNE_TRIALS, TUNE_BATCH = 8, 4
# Phase 10: the fixed effect chunk-streamed from disk.
STREAM_CHUNK_ROWS = 131_072       # 7 chunks of phase 7's 900,000 rows
STREAM_AUC_ATOL, STREAM_LOSS_RTOL = 1e-3, 1e-3   # phase 7's layout gates
STREAM_CKPT_EVERY = 5             # solver iterations between snapshots
STREAM_DRIVER_CHUNK_ROWS = 64     # the config-4 fixture's 750 rows: 12
STREAM_DRIVER_ITERS = 100
# Phase 11: out-of-core GAME training on phase 10's data.  (a) Both random
# effects streamed from a spill dir in entity chunks, converged entities
# retired, against a resident fit of as many sweeps; (b) the fused cycle
# over phase 10a's chunks against phase 10a's per-coordinate fit; (c) a
# prefetch fault in each and the resume from its CD snapshot.
RE_CHUNK_ENTITIES = 16_384
RE_STREAM_SWEEPS = 8
FUSED_CYCLES = 60
FUSED_CKPT_EVERY = 10             # cycles between fused snapshots
FUSED_CHECK_CHUNKS = 2            # chunks of the card-against-CPU fused fit
FUSED_TRAJ_RTOL = 1e-5            # its per-cycle (value, alpha)
FUSED_PARITY_ATOL = 5e-3          # its coefficients (the reference's)


# -- the model and its float64 reference -------------------------------------


def _random_effect(rng, n_entities: int, p: int):
    """A grouping of ``n_entities`` ids with power-law example counts in
    two size buckets, and its coefficient blocks."""
    ids = np.sort(rng.choice(3 * n_entities, n_entities, replace=False))
    counts = np.minimum(rng.zipf(1.8, n_entities), 4096).astype(np.int64)
    bucket = (counts > 4).astype(np.int64)
    slot = np.zeros(n_entities, np.int64)
    n_per = []
    for b in (0, 1):
        sel = bucket == b
        slot[sel] = np.arange(int(sel.sum()))
        n_per.append(int(sel.sum()))
    grouping = EntityGrouping(
        n_examples=int(counts.sum()), entity_ids=ids.astype(np.int64),
        entity_counts=counts, entity_bucket=bucket, entity_slot=slot,
        capacities=[4, int(counts.max())], n_entities=n_per,
        example_bucket=np.empty(0, np.int64),
        example_row=np.empty(0, np.int64),
        example_col=np.empty(0, np.int64))
    blocks = [rng.normal(0, 0.3, (n, p)).astype(np.float32) for n in n_per]
    return grouping, blocks


def make_model(seed: int, d: int = D, n_entities: int = N_ENTITIES):
    """(GameModel, host numpy view for the reference) from ``seed``."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, d + 1).astype(np.float32)
    models = {"global": FixedEffectModel(
        Coefficients(torch.from_numpy(w)), "global", intercept=True)}
    host = {"w": w, "re": {}}
    for name, shard, key, p in (("per_user", "user", "userId", P_USER),
                                ("per_item", "item", "itemId", P_ITEM)):
        grouping, blocks = _random_effect(rng, n_entities, p)
        models[name] = RandomEffectModel(
            [torch.from_numpy(b) for b in blocks], grouping, shard,
            entity_key=key)
        host["re"][name] = (shard, key, grouping, blocks)
    return GameModel(models), host


def make_rows(rng, host, n: int, d: int = D) -> list[dict]:
    """``n`` request rows: ``NNZ`` non-zeros each; one user in 5 and one
    item in 7 never seen in training."""
    users = host["re"]["per_user"][2].entity_ids
    items = host["re"]["per_item"][2].entity_ids
    rows = []
    for i in range(n):
        cols = rng.choice(d, NNZ, replace=False)
        vals = rng.random(NNZ)
        uid = int(users[rng.integers(len(users))]) if i % 5 else -1 - i
        iid = int(items[rng.integers(len(items))]) if i % 7 else -1 - i
        rows.append({
            "features": {
                "global": [[int(c), float(v)] for c, v in zip(cols, vals)],
                "user": [1.0, float(rng.normal())],
                "item": [1.0],
            },
            "ids": {"userId": uid, "itemId": iid},
            "offset": float(rng.normal(0, 0.3)),
        })
    return rows


def reference(host, rows) -> tuple[np.ndarray, np.ndarray]:
    """float64 margins and logistic predictions straight from the
    coefficients; unseen entities contribute nothing."""
    w = host["w"].astype(np.float64)
    margins = np.empty(len(rows))
    for i, r in enumerate(rows):
        cv = np.asarray(r["features"]["global"], np.float64)
        m = r["offset"] + w[-1] + float(cv[:, 1] @ w[cv[:, 0].astype(int)])
        for shard, key, g, blocks in host["re"].values():
            j = int(np.searchsorted(g.entity_ids, r["ids"][key]))
            if j < len(g.entity_ids) and g.entity_ids[j] == r["ids"][key]:
                coef = blocks[g.entity_bucket[j]][g.entity_slot[j]]
                m += float(coef.astype(np.float64)
                           @ np.asarray(r["features"][shard], np.float64))
        margins[i] = m
    return margins, 1.0 / (1.0 + np.exp(-margins))


# -- phase 3: kernels against their plain versions ----------------------------


def kernel_inputs(rng, table: torch.Tensor, n: int, k: int):
    """(vals [n,k] f32, ids [n,k] i32) on ``table``'s device, at the
    served model's scales (feature values U(0, 1)).  Serving-width rows
    hold ``NNZ`` values and pad the rest (id 0, val 0); the odd tail pads
    a random 30% and pins ids 0 and L-1 on real slots."""
    L = table.numel()
    vals = rng.random((n, k), dtype=np.float32)
    ids = rng.integers(0, L, (n, k), dtype=np.int32)
    if k == ELL_CAP:
        pad = np.zeros((n, k), bool)
        pad[:, NNZ:] = True
    else:
        pad = rng.random((n, k)) < 0.3
    ids[pad] = 0
    vals[pad] = 0.0
    ids[1, 0], vals[1, 0] = 0, 0.5
    ids[-1, -1], vals[-1, -1] = L - 1, 0.25
    dev = table.device
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev))


def check_gather_rowsum(table: torch.Tensor, vals, ids,
                        atol: float = ATOL) -> float:
    """Max |kernel − plain| on these inputs; raises past the tolerance or
    if two launches differ."""
    got = gather_rowsum(table, vals, ids)
    again = gather_rowsum(table, vals, ids)
    if got.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"gather_rowsum at {tuple(vals.shape)}: two "
                             f"launches differ")
    want = gather_rowsum_reference(table, vals, ids)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("gather_rowsum returned non-finite values")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def time_ms(fn, reps: int) -> float:
    """Median over 20 samples of CUDA-event time per call, each sample
    ``reps`` back-to-back calls, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return float(np.median(samples))


def cold_ms(fn, n: int = 20) -> float:
    """Median over ``n`` samples of one call between its own pair of CUDA
    events, each after writing ``FLUSH_BYTES`` (which evicts the 50 MB
    L2, as a whole evaluation between two launches of a plan level does)
    and a spin kernel that keeps the card busy while the call is
    enqueued, so that no host time falls between the events."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    samples = []
    for i in range(n):
        flush.fill_(i & 0xFF)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    del flush
    return float(np.median(samples))


def gather_rowsum_bound_ms(table, vals, ids) -> tuple[float, str]:
    """Least time on one H100 for these inputs: vals and ids read once,
    the table entries these ids touch read once, out written once; 2
    float32 operations a slot."""
    n, k = vals.shape
    touched = int(torch.unique(ids).numel())
    nbytes = n * k * (4 + 4) + touched * 4 + n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n * k / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_b1_case(name: str, tab, vals, ids, atol: float,
                  time_it: bool = True) -> dict:
    """One B1 shape: launched twice (bitwise equal) and held against its
    plain version; ``embedding_bag`` of the same inputs and the bound
    beside; with ``time_it``, CUDA-event ms (back to back) and profiler
    device ms of the kernel, the plain version and the library call."""
    n, k = vals.shape
    column = tab[:, None]
    err = check_gather_rowsum(tab, vals, ids, atol)
    library = torch.nn.functional.embedding_bag(
        ids, column, per_sample_weights=vals, mode="sum")[:, 0]
    lib_err = float((library - gather_rowsum_reference(
        tab, vals, ids)).abs().max())
    bound, bound_by = gather_rowsum_bound_ms(tab, vals, ids)
    entry = {"shape": name, "n": n, "k": k, "table": tab.numel(),
             "max_abs_err": err, "atol": atol,
             "library_max_abs_err": lib_err,
             "bound_ms": bound, "bound_by": bound_by}
    if time_it:
        reps = 100 if n * k < 1 << 20 else 5

        def run():
            return gather_rowsum(tab, vals, ids)

        entry["ms"] = time_ms(run, reps)
        entry["device_ms"] = device_ms(run, 20)
        entry["plain_ms"] = time_ms(
            lambda: gather_rowsum_reference(tab, vals, ids), reps)
        entry["library_ms"] = time_ms(
            lambda: torch.nn.functional.embedding_bag(
                ids, column, per_sample_weights=vals, mode="sum"), reps)
        entry["share_of_bound"] = bound / entry["ms"]
    print(f"  gather_rowsum {name}: " + json.dumps(entry))
    return entry


def phase_kernels(table: torch.Tensor, seed: int, ell=None,
                  colmajor=None, time_it: bool = True) -> dict:
    """B1 against its plain version at ``KERNEL_SHAPES``, at phase 6's
    ELL training arrays ``ell`` (a ``SparseBatch``; ``table`` as its w),
    at their transposed ELL ``colmajor`` (a ``ColMajorSlice``; the table
    a residual over the rows: the Xᵀr of a ``value_and_gradient``) and at
    ``WIDTH_SHAPES``; every shape launched twice and required bitwise
    equal.  ``time_it``: the timed shapes get CUDA-event ms (back to
    back) and profiler device ms beside the plain version's, the library
    call's and the bound."""
    rng = np.random.default_rng(seed)
    cases = [(f"{n}x{k}", table, *kernel_inputs(rng, table, n, k), ATOL)
             for n, k in KERNEL_SHAPES]
    if ell is not None:
        cases.append(("ell_train", table, ell.values, ell.col_ids, ATOL))
    if colmajor is not None:
        # The residual of a logistic fit at a point near zero.
        w = torch.from_numpy(rng.normal(0, 0.05, ell.dim).astype(
            np.float32)).to(table.device)
        r = (torch.sigmoid(ell.margins(w)) - ell.labels).contiguous()
        cases.append(("colmajor_train", r, colmajor.tvals, colmajor.trows,
                      COLMAJOR_ATOL))
    shapes = [check_b1_case(*case, time_it=time_it) for case in cases]
    for n, k in WIDTH_SHAPES:
        vals, ids = kernel_inputs(rng, table, n, k)
        shapes.append({"shape": f"{n}x{k}", "n": n, "k": k,
                       "max_abs_err": check_gather_rowsum(table, vals, ids)})
        print(f"  gather_rowsum {n}x{k} (checked): " + json.dumps(shapes[-1]))
    main = shapes[0]
    return {
        "name": "gather_rowsum", "route": "cuda",
        "source": "photon_ml_torch/csrc/gather_rowsum.cu",
        "replaces": "photon_ml_tpu/ops/kernels.py:65",
        "launches": None, "launches_ell_fit": None,
        "launches_colmajor_fit": None, "launches_game_fit": None,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main.get("ms"), "device_ms": main.get("device_ms"),
        "plain_ms": main.get("plain_ms"),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main.get("library_ms"),
        "library_call": "torch.nn.functional.embedding_bag(mode='sum')",
        "shape": [main["n"], main["k"]],
        "transposed_shape": next(([s["n"], s["k"]] for s in shapes
                                  if s["shape"] == "colmajor_train"), None),
        "shapes": shapes,
    }


def check_gather_rowsum_lanes(table: torch.Tensor, vals, ids,
                              atol: float = ATOL) -> float:
    """Max |lane kernel − plain| on these inputs; raises past the
    tolerance or if two launches differ."""
    got = gather_rowsum_lanes(table, vals, ids)
    again = gather_rowsum_lanes(table, vals, ids)
    if got.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"gather_rowsum_lanes at {tuple(vals.shape)} x "
                             f"{table.shape[1]} lanes: two launches differ")
    want = gather_rowsum_lanes_reference(table, vals, ids)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("gather_rowsum_lanes returned non-finite "
                             "values")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def gather_rowsum_lanes_bound_ms(table, vals, ids) -> tuple[float, str]:
    """Least time on one H100 for these inputs: vals and ids read once
    for every lane, the table rows these ids touch read once (L floats
    each), out [n, L] written once; 2 float32 operations a slot and a
    lane."""
    n, k = vals.shape
    lanes = table.shape[1]
    touched = int(torch.unique(ids).numel())
    nbytes = n * k * (4 + 4) + touched * lanes * 4 + n * lanes * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n * k * lanes / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_lanes_case(name: str, tab, vals, ids, atol: float,
                     time_it: bool = True) -> dict:
    """One lane-kernel shape: launched twice (bitwise equal) and held
    against its plain version; ``embedding_bag`` over the [T, L] table
    and the bound beside; with ``time_it``, CUDA-event ms (back to back)
    and profiler device ms of the kernel, of the plain version, of the
    library call and of L single-lane ``gather_rowsum`` launches (one a
    lane: what the sweep would cost without the lane kernel)."""
    n, k = vals.shape
    lanes = tab.shape[1]
    err = check_gather_rowsum_lanes(tab, vals, ids, atol)
    library = torch.nn.functional.embedding_bag(
        ids, tab, per_sample_weights=vals, mode="sum")
    lib_err = float((library - gather_rowsum_lanes_reference(
        tab, vals, ids)).abs().max())
    bound, bound_by = gather_rowsum_lanes_bound_ms(tab, vals, ids)
    entry = {"shape": name, "n": n, "k": k, "lanes": lanes,
             "table": tab.shape[0], "max_abs_err": err, "atol": atol,
             "library_max_abs_err": lib_err,
             "bound_ms": bound, "bound_by": bound_by}
    if time_it:
        columns = [tab[:, j].contiguous() for j in range(lanes)]

        def run():
            return gather_rowsum_lanes(tab, vals, ids)

        def singles():
            return [gather_rowsum(c, vals, ids) for c in columns]

        entry["ms"] = time_ms(run, 5)
        entry["device_ms"] = device_ms(run, 20)
        entry["single_lanes_ms"] = time_ms(singles, 2)
        entry["plain_ms"] = time_ms(
            lambda: gather_rowsum_lanes_reference(tab, vals, ids), 2)
        entry["library_ms"] = time_ms(
            lambda: torch.nn.functional.embedding_bag(
                ids, tab, per_sample_weights=vals, mode="sum"), 2)
        entry["share_of_bound"] = bound / entry["ms"]
    print(f"  gather_rowsum_lanes {name}: " + json.dumps(entry))
    return entry


def lane_limits(tab, vals, ids, head: bool) -> dict:
    """Limiter runs of the lane kernel on these inputs (CUDA-event ms,
    back to back, as ``check_lanes_case`` times it): every id 0 (the
    streams and sums alone; each gather the same table row); and where
    the launch keeps a table ``head``, the table grown to 8 times its
    rows with zero rows (the same gathers, no head kept: it would hold
    under 1/32 of the table) and the ids mirrored, t → T − 1 − t (the
    same gathers, the popular rows past the head that is kept)."""
    zero = torch.zeros_like(ids)
    out = {"ids_zero_ms": time_ms(
        lambda: gather_rowsum_lanes(tab, vals, zero), 5)}
    if head:
        grown = torch.cat([tab, tab.new_zeros(7 * tab.shape[0],
                                              tab.shape[1])])
        flipped = (tab.shape[0] - 1 - ids).to(torch.int32)
        out["no_head_ms"] = time_ms(
            lambda: gather_rowsum_lanes(grown, vals, ids), 5)
        out["ids_mirrored_ms"] = time_ms(
            lambda: gather_rowsum_lanes(tab, vals, flipped), 5)
    return out


def lanes_past_bound(shapes: list) -> list:
    """The lane-kernel shapes timed faster than ``GRR_BOUND_SLACK`` times
    their bound."""
    return [sh["shape"] for sh in shapes
            if sh.get("share_of_bound", 0.0) > GRR_BOUND_SLACK]


def phase_kernels_lanes(ell, colmajor, seed: int,
                        time_it: bool = True) -> dict:
    """The lane kernel against its plain version at phase 6's ELL arrays
    ``ell`` (a ``SparseBatch``; a [T, L] table of small coefficients) at
    every lane count of ``LANE_COUNTS``, at those arrays cut to their
    ``NNZ + 1`` real slots (the estimator's ELL, intercept included: the
    main path's width) at ``LANE_COUNTS_31``, and at their transposed ELL
    ``colmajor`` with ``LANES_MAIN`` lanes (the table a residual over the
    rows, [n, L]: the swept Xᵀr); every shape launched twice and required
    bitwise equal, and none timed faster than its bound allows; the
    main-path shapes also timed on their limiter inputs
    (``lane_limits``)."""
    rng = np.random.default_rng(seed)
    dev = ell.values.device
    if bool((ell.values[:, NNZ + 1:] != 0).any()):
        raise AssertionError(f"phase 6's ELL holds more than {NNZ + 1} "
                             f"slots a row")
    vals31 = ell.values[:, :NNZ + 1].contiguous()
    ids31 = ell.col_ids[:, :NNZ + 1].contiguous()
    shapes = []
    for name, counts, vals, ids in (
            ("ell_train", LANE_COUNTS, ell.values, ell.col_ids),
            (f"ell{NNZ + 1}_train", LANE_COUNTS_31, vals31, ids31)):
        for lanes in counts:
            tab = torch.from_numpy(rng.normal(
                0, 0.05, (ell.dim, lanes)).astype(np.float32)).to(dev)
            shapes.append(check_lanes_case(f"{name}_L{lanes}", tab, vals,
                                           ids, ATOL, time_it=time_it))
            if time_it and counts is LANE_COUNTS_31:
                shapes[-1]["limits"] = lane_limits(tab, vals, ids, True)
    if colmajor is not None:
        W = torch.from_numpy(rng.normal(0, 0.05, (LANES_MAIN, ell.dim))
                             .astype(np.float32)).to(dev)
        R = (torch.sigmoid(ell.margins(W)) - ell.labels).T.contiguous()
        shapes.append(check_lanes_case(
            f"colmajor_train_L{LANES_MAIN}", R, colmajor.tvals,
            colmajor.trows, COLMAJOR_ATOL, time_it=time_it))
        if time_it:
            shapes[-1]["limits"] = lane_limits(R, colmajor.tvals,
                                               colmajor.trows, False)
    fast = lanes_past_bound(shapes)
    if fast:
        raise AssertionError(f"gather_rowsum_lanes read faster than its HBM "
                             f"bound by more than {GRR_BOUND_SLACK - 1:.0%} "
                             f"at {fast}")
    main = next(sh for sh in shapes
                if sh["shape"] == f"ell{NNZ + 1}_train_L{LANES_MAIN}")
    return {
        "name": "gather_rowsum_lanes", "route": "cuda",
        "source": "photon_ml_torch/csrc/gather_rowsum_lanes.cu",
        "replaces": "photon_ml_tpu/ops/kernels.py:65 (under jax.vmap)",
        "launches": None, "launches_ell_fit": None,
        "launches_colmajor_fit": None, "launches_tuned_fit": None,
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
        "ms": main.get("ms"), "device_ms": main.get("device_ms"),
        "plain_ms": main.get("plain_ms"),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main.get("library_ms"),
        "library_call": "torch.nn.functional.embedding_bag(table [T, L], "
                        "mode='sum')",
        "single_lanes_ms": main.get("single_lanes_ms"),
        "shape": [main["n"], main["k"]], "lanes": LANES_MAIN,
        "shapes": shapes,
    }


# -- phases 4 and 5: serving ------------------------------------------------


def _post(port: int, rows: list, timeout: float = 60.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/score",
        data=json.dumps({"rows": rows}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _check_answer(out: dict, ref_m, ref_p) -> float:
    m = np.asarray(out["margins"], np.float64)
    p = np.asarray(out["predictions"], np.float64)
    if m.shape != ref_m.shape or p.shape != ref_p.shape:
        raise AssertionError(f"answer shape {m.shape} != {ref_m.shape}")
    if not (np.isfinite(m).all() and np.isfinite(p).all()):
        raise AssertionError("non-finite scores")
    err = float(max(np.abs(m - ref_m).max(), np.abs(p - ref_p).max()))
    if err > SERVE_ATOL:
        raise AssertionError(f"served scores differ from the float64 "
                             f"reference by {err:g} > {SERVE_ATOL:g}")
    return err


def serving_config(model_dir: str, spill_dir: str, device: str
                   ) -> ServingConfig:
    return ServingConfig(model_dir=model_dir, port=0, batch_rows=BATCH_ROWS,
                         ell_row_capacity=ELL_CAP, spill_dir=spill_dir,
                         hot_swap_poll_s=0.0, device=device)


def phase_serving(cfg: ServingConfig, rows: list, ref_m, ref_p) -> dict:
    """In-process server; ``CLIENTS`` threads each send ``REQUESTS``
    requests of ``ROWS`` rows over HTTP."""
    t0 = time.perf_counter()
    srv = ModelServer(cfg)
    try:
        srv.start()
        ready_s = time.perf_counter() - t0
        results: dict = {}
        latencies: list = []
        errors: list = []
        lock = threading.Lock()

        def client(c: int) -> None:
            try:
                for r in range(REQUESTS):
                    lo = (c * REQUESTS + r) * ROWS
                    t = time.perf_counter()
                    out = _post(srv.port, rows[lo: lo + ROWS])
                    with lock:
                        latencies.append(time.perf_counter() - t)
                        results[lo] = out
            except Exception as e:   # noqa: BLE001 - re-raised below
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t1
        if any(t.is_alive() for t in threads):
            raise TimeoutError("serving clients did not finish in 300 s")
        if errors:
            raise errors[0]
        status = srv.serving_status()
    finally:
        srv.stop()
    if len(results) != CLIENTS * REQUESTS:
        raise AssertionError(f"{len(results)} answers for "
                             f"{CLIENTS * REQUESTS} requests")
    err = 0.0
    for lo, out in results.items():
        err = max(err, _check_answer(out, ref_m[lo: lo + ROWS],
                                     ref_p[lo: lo + ROWS]))
    if status["model"]["device"] != cfg.device:
        raise AssertionError(f"served on {status['model']['device']}, "
                             f"not {cfg.device}")
    lat_ms = np.asarray(latencies) * 1e3
    return {
        "requests": len(results), "rows": len(results) * ROWS,
        "max_abs_err": err,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "rows_per_s": len(results) * ROWS / wall,
        "ready_s": ready_s,
        "batches": status["batcher"]["batches"],
        "batch_fill": status["batcher"]["batch_fill"],
        "warmed_buckets": len(status["model"]["buckets"]),
        "device": status["model"]["device"],
    }


def stage_breakdown(engine: ScoringEngine, rows: list,
                    bucket: int = 2 * ROWS) -> dict:
    """Median ms a batch of ``bucket`` rows spends in each stage of
    ``ScoringEngine.score_batch`` (host clock; the score stage ends in
    the copy back, so it waits for the card): parse, the random-effect
    lookups alone, host staging (ELL + mini-tables, lookups included),
    and the whole call."""
    times: dict = {"parse": [], "lookup": [], "stage": [], "score": []}
    for lo in range(0, len(rows) - bucket + 1, bucket):
        t0 = time.perf_counter()
        parsed = engine.parse_rows(rows[lo: lo + bucket])
        t1 = time.perf_counter()
        for _name, _shard, key, store in engine._re:
            store.lookup(np.array([r.ids[key] for r in parsed]))
        t2 = time.perf_counter()
        engine._build_chunk(parsed, bucket)
        t3 = time.perf_counter()
        engine.score_batch(parsed, bucket)
        t4 = time.perf_counter()
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[k].append(dt * 1e3)
    return {f"{k}_ms": float(np.median(v)) for k, v in times.items()}


def phase_breakdown(cfg: ServingConfig, rows: list) -> dict:
    """``stage_breakdown`` on the served configuration, and on the same
    model with every entity-store chunk held in the host window."""
    model, task = load_game_model(cfg.model_dir)
    all_chunks = max(-(-len(m.grouping.entity_ids) // cfg.entity_chunk)
                     for m in model.models.values()
                     if isinstance(m, RandomEffectModel))
    out = {}
    for label, resident in (("served", cfg.host_max_resident),
                            ("window_all_chunks", all_chunks)):
        engine = ScoringEngine(
            model, task, ell_row_capacity=cfg.ell_row_capacity,
            spill_dir=cfg.spill_dir, entity_chunk=cfg.entity_chunk,
            host_max_resident=resident, device=cfg.device)
        engine.warm(cfg.buckets())
        out[label] = {"host_max_resident": resident,
                      **stage_breakdown(engine, rows)}
        engine.close()
    return out


def phase_cli(cfg: ServingConfig, rows: list, ref_m, ref_p) -> dict:
    """``python -m photon_ml_torch.serving`` in a subprocess: ready,
    one answered request, SIGTERM, rc 0 and a JSON last line."""
    cfg_path = os.path.join(WORK, "serve.json")
    info = os.path.join(WORK, "info.json")
    with open(cfg_path, "w") as f:
        f.write(config_to_json(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    with open(os.path.join(WORK, "cli.out"), "w+") as out, \
            open(os.path.join(WORK, "cli.err"), "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_torch.serving", "--config",
             cfg_path, "--info-file", info],
            cwd=REPO, env=env, stdout=out, stderr=err, text=True)
        try:
            port = None
            deadline = time.monotonic() + 300
            while True:
                if proc.poll() is not None:
                    err.seek(0)
                    raise RuntimeError(f"server exited rc {proc.returncode}"
                                       f" before ready:\n{err.read()}")
                if time.monotonic() > deadline:
                    raise TimeoutError("CLI server not ready in 300 s")
                if port is None and os.path.exists(info):
                    with open(info) as f:
                        port = json.load(f)["port"]
                if port is not None:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as r:
                            if r.status == 200:
                                break
                    except OSError:
                        pass
                time.sleep(0.2)
            ready_s = time.perf_counter() - t0
            answer = _post(port, rows)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        lines = out.read().strip().splitlines()
        err.seek(0)
        stderr = err.read()
    if rc != 0:
        raise RuntimeError(f"CLI server exited rc {rc}:\n{stderr}")
    last = json.loads(lines[-1])
    if last.get("rc") != 0:
        raise AssertionError(f"CLI last line reports rc {last.get('rc')}")
    return {"ready_s": ready_s, "rc": rc,
            "max_abs_err": _check_answer(answer, ref_m, ref_p),
            "rows": last["serving"]["batcher"]["rows"]}


# -- phase 6 (built before phase 3): data, the GRR plan, its levels ----------


def make_training_data(seed: int, n: int, d: int = D, k: int = NNZ):
    """Config-5 fixed-effect rows (the generator of examples/kdd_scale.py):
    power-law column popularity, ``k`` distinct columns a row, values 1.0,
    labels from a planted sparse ``w_true``; then an intercept column
    ``d``.  Returns (SparseRows [n, d + 1], labels)."""
    rng = np.random.default_rng(seed)
    rows, w_true = _power_law_rows(rng, n, d, k)
    margins = rows.dot_dense(w_true).astype(np.float64) - 1.0
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float32)
    return rows.with_constant_col(d), y


def _power_law_rows(rng, n: int, d: int, k: int):
    """(SparseRows [n, d] of ``k`` distinct power-law columns a row,
    values 1.0; a planted sparse w_true [d])."""
    cols = np.sort(((d - k) * rng.random((n, k)) ** 2.2).astype(np.int64),
                   axis=1)
    for j in range(1, k):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    rows = SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * k,
                                cols.reshape(-1), np.ones(n * k, np.float32))
    w_true = np.zeros(d)
    n_active = max(d // 20, 200)
    active = rng.choice(d, size=n_active, replace=False)
    w_true[active] = rng.normal(0, 1.2, n_active)
    return rows, w_true


def phase_train_build(seed: int, n: int, device: str) -> dict:
    """Training data; the GRR plan built on the host (the C++ builder
    must be loaded) and placed on ``device``; the plain-ELL view of the
    same batch and its transposed-ELL view (``build_colmajor``, auto
    capacity); the held-out batch."""
    if not native.native_available():
        raise RuntimeError("the native GRR plan builder did not load "
                           "(g++ missing?); the numpy fallback would take "
                           "hours at these widths")
    t = time.perf_counter()
    rows, y = make_training_data(seed, n)
    data_s = time.perf_counter() - t
    n_train = n - int(n * TRAIN_HOLDOUT)
    dim = D + 1
    t = time.perf_counter()
    batch = make_sparse_batch(rows[:n_train], dim, y[:n_train],
                              row_capacity=ELL_CAP, grr=True, device=device)
    build_s = time.perf_counter() - t
    phases = dict(grr_mod.last_build_phases)
    test = make_sparse_batch(rows[n_train:], dim, y[n_train:],
                             row_capacity=ELL_CAP, device=device)
    ell = dataclasses.replace(batch, grr=None)
    t = time.perf_counter()
    cm = build_colmajor(ell.col_ids.cpu().numpy(), ell.values.cpu().numpy(),
                        dim, device=device)
    colmajor_s = time.perf_counter() - t
    return {
        "grr": batch, "ell": ell,
        "colmajor": dataclasses.replace(ell, colmajor=cm),
        "test": test, "rows": rows[:n_train], "labels": y[:n_train],
        "test_rows": rows[n_train:], "test_labels": y[n_train:],
        "info": {
            "colmajor_build_s": colmajor_s,
            "colmajor_virtual_rows": cm.n_virtual_rows,
            "colmajor_capacity": cm.capacity,
            "rows": n, "train_rows": n_train, "dim": dim,
            "slots_a_row": int(rows.max_nnz), "ell_capacity": ELL_CAP,
            "positives": float(y.mean()), "data_s": data_s,
            "builder": f"native C++ ({os.path.relpath(native.library_path(), REPO)})",
            "make_batch_s": build_s, "plan_build_phases": phases,
        },
    }


def plan_levels(pair) -> list:
    """(name, GrrDirection) for every level the pair runs: each
    direction, column range and overflow level."""
    out = []

    def walk(name, node):
        if isinstance(node, grr_mod.GrrRangeSplit):
            for i, p in enumerate(node.parts):
                walk(f"{name}.part{i}", p)
            return
        level = 0
        while node is not None:
            out.append((f"{name}.level{level}", node))
            node, level = node.overflow, level + 1

    walk("row", pair.row_dir)
    walk("col", pair.col_dir)
    if pair.col_mid is not None:
        walk("mid", pair.col_mid)
    return out


def _windows(d, table: torch.Tensor) -> torch.Tensor:
    pad = d.n_gw * grr_mod.WIN - d.table_len
    return torch.nn.functional.pad(table, (0, pad)).view(d.n_gw, 128, 128)


def level_csr(d) -> torch.Tensor:
    """The level's entries as a CSR matrix [n_segments, table_len], read
    off the plan: routing a table of float indices gives each slot's
    index, its final position gives its segment."""
    dev = d.vals.device
    n_st, group = d.n_supertiles, 128 // d.cap
    if d.dense_grid:
        t = torch.arange(n_st, device=dev)
        gw, ow = t // d.n_ow_padded, t % d.n_ow_padded
    else:
        gw, ow = d.gw_of_st.long(), d.ow_of_st.long()
    index_t = torch.arange(d.n_gw * grr_mod.WIN, dtype=torch.float32,
                           device=dev).view(d.n_gw, 128, 128)
    x1 = torch.gather(index_t[gw], 2, d.g1.long())
    x2t = torch.gather(x1.transpose(1, 2), 2, d.g2.long())
    idx = torch.gather(x2t.transpose(1, 2), 2, d.g3.long()).long()
    r = torch.arange(128, device=dev)
    seg = (ow[:, None, None] * (grr_mod.WIN // d.cap)
           + (r % group)[None, :, None] * 128 + r[None, None, :])
    real = d.vals != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([seg.expand_as(idx)[real], idx[real]]), d.vals[real],
        (d.n_segments, d.table_len))
    return coo.coalesce().to_sparse_csr()


def grr_level_bound_ms(d) -> tuple[float, str]:
    """Least time on one H100 for one level: the planes (vals f32 +
    g1/g2/g3 i8 a slot) and tile maps read once, each table window read
    once, the output written once; 2 float32 operations a real entry."""
    slots = d.n_supertiles * grr_mod.SLOTS
    n_out = (d.n_ow_padded if d.dense_grid else d.n_ow) * grr_mod.SLOTS // d.cap
    maps = d.gw_of_st.numel() + d.ow_of_st.numel()
    nbytes = slots * 7 + maps * 4 + d.n_gw * grr_mod.WIN * 4 + n_out * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * int(torch.count_nonzero(d.vals)) / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_grr_level(name: str, d, rng, time_it: bool = True) -> dict:
    """One plan level: its kernel against its plain version and a
    cuSPARSE product of the same entries; times and bound."""
    table = torch.from_numpy(
        rng.uniform(-1, 1, d.table_len).astype(np.float32)).to(d.vals.device)
    tt = _windows(d, table)
    if d.dense_grid:
        kernel = "grr_contract_dense"

        def run():
            return grr_contract_dense(tt, d.g1, d.g2, d.g3, d.vals,
                                      d.gw_of_st, d.n_ow_padded, d.cap)

        def plain():
            return grr_contract_dense_reference(tt, d.g1, d.g2, d.g3, d.vals,
                                                d.n_ow_padded, d.cap)
    else:
        kernel = "grr_contract"

        def run():
            return grr_contract(tt, d.g1, d.g2, d.g3, d.vals, d.gw_of_st,
                                d.ow_of_st, d.first_of_ow, d.n_ow, d.cap)

        def plain():
            return grr_contract_reference(tt, d.g1, d.g2, d.g3, d.vals,
                                          d.gw_of_st, d.ow_of_st, d.n_ow,
                                          d.cap)
    got = run()
    again = run()
    if got.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{kernel} at {name}: two launches differ")
    want = plain()
    got_h, want_h = got.cpu().numpy(), want.cpu().numpy()
    if not np.isfinite(got_h).all():
        raise AssertionError(f"{kernel} returned non-finite values at {name}")
    gw_of_tile = (torch.arange(d.n_gw, device=tt.device)
                  .repeat_interleave(d.n_ow_padded) if d.dense_grid
                  else d.gw_of_st)
    max_partial = float(tile_partials(tt, gw_of_tile, d.g1, d.g2, d.g3,
                                      d.vals, d.cap).abs().max())
    max_term = float(table.abs().max()) * float(d.vals.abs().max())
    atol = GRR_ATOL_SCALE * max_partial
    np.testing.assert_allclose(got_h, want_h, rtol=GRR_RTOL, atol=atol,
                               err_msg=f"{kernel} at {name}")
    csr = level_csr(d)
    library = torch.sparse.mm(csr, table[:, None])[:, 0]
    flat = got.reshape(-1)[: d.n_segments]
    bound, bound_by = grr_level_bound_ms(d)
    out = {
        "level": name, "kernel": kernel, "cap": d.cap,
        "supertiles": d.n_supertiles, "entries": int(csr.values().numel()),
        "n_segments": d.n_segments, "table_len": d.table_len,
        "max_abs_err": float(np.abs(got_h - want_h).max()),
        "atol": atol, "max_tile_partial": max_partial,
        "max_abs_err_over_max_term": float(
            np.abs(got_h - want_h).max()) / max_term,
        "library_max_abs_err": float((library - flat).abs().max()),
        "bound_ms": bound, "bound_by": bound_by,
    }
    if time_it:
        def library():
            return torch.sparse.mm(csr, table[:, None])

        for key, fn, reps in (("ms", run, 10), ("plain_ms", plain, 2),
                              ("library_ms", library, 10)):
            out[key] = cold_ms(fn)
            out[key + "_warm"] = time_ms(fn, reps)
        out["device_ms_warm"] = device_ms(run, 10)
        out["share_of_bound"] = bound / out["ms"]
    del csr
    return out


def phase_kernels_grr(pair, seed: int, time_it: bool = True) -> list:
    """B2 and B3 at every level of the training plan → their kernel
    entries, times and bounds summed over the levels each runs."""
    rng = np.random.default_rng(seed)
    levels = []
    for name, d in plan_levels(pair):
        levels.append(check_grr_level(name, d, rng, time_it))
        print(f"  {levels[-1]['kernel']} {name}: " + json.dumps(levels[-1]))
    fast = [lv["level"] for lv in levels
            if lv.get("share_of_bound", 0.0) > GRR_BOUND_SLACK]
    if fast:
        raise AssertionError(f"L2-cold times beat the HBM bound by more "
                             f"than {GRR_BOUND_SLACK - 1:.0%} at {fast}: "
                             f"the timing does not measure HBM reads")
    entries = []
    for kernel, replaces in (
            ("grr_contract_dense", "photon_ml_tpu/ops/grr_kernel.py:121"),
            ("grr_contract", "photon_ml_tpu/ops/grr_kernel.py:52")):
        mine = [lv for lv in levels if lv["kernel"] == kernel]
        if not mine:
            raise AssertionError(f"no level of the training plan runs "
                                 f"{kernel}")
        entry = {
            "name": kernel, "route": "cuda",
            "source": "photon_ml_torch/csrc/grr_contract.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(lv["max_abs_err"] for lv in mine),
            "bound_by": ("bytes" if all(lv["bound_by"] == "bytes"
                                        for lv in mine) else "operations"),
            "library_call": "torch.sparse.mm(CSR of the level, table)",
            "levels": len(mine), "shapes": mine,
        }
        for key in ("ms", "ms_warm", "device_ms_warm", "plain_ms",
                    "plain_ms_warm", "library_ms", "library_ms_warm",
                    "bound_ms"):
            got = [lv.get(key) for lv in mine]
            entry[key] = (None if None in got else sum(got))
        entries.append(entry)
    return entries


# -- phase 6: training -----------------------------------------------------------


def f64_surfaces(X, y, w, v, l2: float) -> dict:
    """Logistic + L2 value, gradient, HVP and Hessian diagonal in float64
    with scipy.sparse (X is CSR)."""
    m = X @ w
    s = 1.0 / (1.0 + np.exp(-m))
    d2 = s * (1.0 - s)
    X2 = X.copy()
    X2.data = X2.data ** 2
    return {
        "value": float(np.sum(np.logaddexp(0.0, m) - y * m)
                       + 0.5 * l2 * w @ w),
        "gradient": X.T @ (s - y) + l2 * w,
        "hessian_vector": X.T @ (d2 * (X @ v)) + l2 * v,
        "hessian_diagonal": X2.T @ d2 + l2,
    }


def _fit(problem, batch, w0) -> tuple:
    t = time.perf_counter()
    res = problem.run(batch, w0)
    if w0.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t


def phase_training(data: dict, time_it: bool = True) -> dict:
    """The GRR fit (its launch counts) and the plain-ELL fit; the loss,
    AUC, float64 and layout gates; the per-evaluation times.  Every
    result is printed before a failed gate raises."""
    import scipy.sparse as sp

    batch, ell, test = data["grr"], data["ell"], data["test"]
    cmb = data["colmajor"]
    dev, dim = batch.labels.device, batch.dim
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(TRAIN_L2),
                       NormalizationContext.identity())
    problem = OptimizationProblem(obj,
                                  config=OptimizerConfig(max_iters=TRAIN_ITERS))
    w0 = torch.zeros(dim, device=dev)
    for b in (batch, ell, cmb):   # first-call costs (cuBLAS handles) not timed
        obj.value_and_gradient(w0, b)

    grr_contract_dense.launches = grr_contract.launches = 0
    gather_rowsum.launches = 0
    res, fit_s = _fit(problem, batch, w0)
    launches = {"grr_contract_dense": grr_contract_dense.launches,
                "grr_contract": grr_contract.launches,
                "gather_rowsum": gather_rowsum.launches}
    gather_rowsum.launches = 0
    res_ell, fit_ell_s = _fit(problem, ell, w0)
    ell_launches = gather_rowsum.launches
    gather_rowsum.launches = 0
    res_cm, fit_cm_s = _fit(problem, cmb, w0)
    cm_launches = gather_rowsum.launches
    w0_perturbed = PERTURBATION * torch.from_numpy(
        np.random.default_rng(6).normal(size=dim).astype(np.float32)).to(dev)
    res_perturbed, _ = _fit(problem, batch, w0_perturbed)

    def trajectory(r):
        t = r.tracker
        return {"loss": t.values[: t.count].tolist(),
                "ls_trials": t.ls_trials[1: t.count].tolist()}

    traj = {"grr": trajectory(res), "ell": trajectory(res_ell),
            "colmajor": trajectory(res_cm)}
    # Every value_and_gradient of the transposed-ELL fit launches B1
    # twice (X·w and Xᵀr): one at the start and one an iteration.
    cm_vg = res_cm.iterations + 1
    # Every evaluation computes X·w once: one per iteration plus the
    # start (value and gradient), one per line-search trial (value).
    ell_evaluations = res_ell.iterations + 1 + int(
        sum(traj["ell"]["ls_trials"]))
    test_auc = float(auc(test.margins(res.w), test.labels, mask=test.mask))

    def gap(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    loss_gap = gap(res_ell.value, res.value)
    cm_loss_gap = gap(res_cm.value, res_ell.value)
    self_gap = gap(res_perturbed.value, res.value)
    early_gap = max(gap(a, b) for a, b in zip(
        traj["ell"]["loss"][: TRAJECTORY_ITERS + 1],
        traj["grr"]["loss"][: TRAJECTORY_ITERS + 1]))

    rows, y = data["rows"], data["labels"].astype(np.float64)
    X = sp.csr_matrix((rows.vals.astype(np.float64), rows.cols, rows.indptr),
                      shape=(len(rows), dim))
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.05, dim)
    v = rng.normal(0, 1.0, dim)
    ref = f64_surfaces(X, y, w, v, TRAIN_L2)
    w_t = torch.from_numpy(w.astype(np.float32)).to(dev)
    v_t = torch.from_numpy(v.astype(np.float32)).to(dev)
    errors = {}
    for layout, b in (("grr", batch), ("ell", ell), ("colmajor", cmb)):
        val, grad = obj.value_and_gradient(w_t, b)
        got = {"gradient": grad,
               "hessian_vector": obj.hessian_vector(w_t, v_t, b),
               "hessian_diagonal": obj.hessian_diagonal(w_t, b)}
        errors[layout] = {"value": abs(float(val) - ref["value"])
                          / abs(ref["value"])}
        for key, g in got.items():
            g = g.double().cpu().numpy()
            errors[layout][key] = float(np.abs(g - ref[key]).max()
                                        / np.abs(ref[key]).max())
    out = {
        "iterations": res.iterations, "converged": res.converged,
        "loss_first": traj["grr"]["loss"][0], "loss_final": float(res.value),
        "loss_final_ell": float(res_ell.value), "loss_gap_rel": loss_gap,
        "early_loss_gap_rel": early_gap,
        "loss_final_perturbed_start": float(res_perturbed.value),
        "perturbed_start_gap_rel": self_gap,
        "test_auc": test_auc, "f64_errors": errors,
        "launches": launches, "ell_gather_rowsum_launches": ell_launches,
        "ell_evaluations": ell_evaluations,
        "loss_final_colmajor": float(res_cm.value),
        "colmajor_loss_gap_rel": cm_loss_gap,
        "colmajor_gather_rowsum_launches": cm_launches,
        "colmajor_value_and_gradients": cm_vg, "fit_colmajor_s": fit_cm_s,
        "value_evaluations": int(sum(traj["grr"]["ls_trials"])),
        "gradient_evaluations": res.iterations + 1,
        "fit_s": fit_s, "fit_ell_s": fit_ell_s, "trajectories": traj,
    }
    config2 = phase_config2(ell, cmb)
    out["config2"] = config2
    if time_it:
        out.update(time_evaluations(obj, batch, ell, X, w_t, cmb))

    failures = list(config2["failures"])
    if dev.type == "cuda" and cm_launches < 2 * cm_vg:
        failures.append(f"the transposed-ELL fit launched gather_rowsum "
                        f"{cm_launches} time(s) for {cm_vg} value and "
                        "gradient evaluations (2 each)")
    if not cm_loss_gap <= LAYOUT_LOSS_RTOL:
        failures.append(f"transposed-ELL and ELL fits end {cm_loss_gap:g} "
                        f"apart (relative) > {LAYOUT_LOSS_RTOL:g}")
    if dev.type == "cuda" and ell_launches < ell_evaluations:
        failures.append(f"the ELL fit launched gather_rowsum {ell_launches} "
                        f"time(s) for {ell_evaluations} evaluations")
    if not traj["grr"]["loss"][-1] < traj["grr"]["loss"][0]:
        failures.append("the GRR fit's loss did not fall")
    if test_auc < TRAIN_AUC_MIN:
        failures.append(f"held-out AUC {test_auc:.4f} < {TRAIN_AUC_MIN}")
    for layout, errs in errors.items():
        for key, err in errs.items():
            limit = F64_VALUE_RTOL if key == "value" else F64_VECTOR_RTOL
            if not err <= limit:
                failures.append(f"{layout} {key} differs from the float64 "
                                f"reference by {err:g} > {limit:g}")
    if not early_gap <= TRAJECTORY_RTOL:
        failures.append(f"GRR and ELL losses over the first "
                        f"{TRAJECTORY_ITERS} iterations differ by "
                        f"{early_gap:g} (relative) > {TRAJECTORY_RTOL:g}")
    if not loss_gap <= LAYOUT_LOSS_RTOL:
        failures.append(f"GRR and ELL fits end {loss_gap:g} apart "
                        f"(relative) > {LAYOUT_LOSS_RTOL:g}")
    out["failures"] = failures
    return out


def phase_config2(ell, cmb) -> dict:
    """Config 2 (squared loss, L2, TRON) on the ELL and transposed-ELL
    layouts of the same arrays, and L-BFGS on the ELL one: the loss must
    fall, the layouts end within ``LAYOUT_LOSS_RTOL`` and TRON's final
    gradient norm must be below L-BFGS's."""
    obj = GLMObjective(losses.SQUARED, RegularizationContext.l2(TRAIN_L2),
                       NormalizationContext.identity())
    cfg = OptimizerConfig(max_iters=TRON_ITERS)
    w0 = torch.zeros(ell.dim, device=ell.labels.device)
    tron = OptimizationProblem(obj, OptimizerType.TRON, cfg)
    out, fits = {"failures": []}, {}
    for layout, b in (("ell", ell), ("colmajor", cmb)):
        res, fit_s = _fit(tron, b, w0)
        fits[layout] = res
        t = res.tracker
        out[f"tron_{layout}"] = {
            "iterations": res.iterations, "converged": res.converged,
            "loss_first": float(t.values[0]),
            "loss_final": float(res.value),
            "grad_norm": float(res.grad_norm),
            "cg_iterations": t.ls_trials[1: t.count].tolist(),
            "fit_s": fit_s}
        if not float(res.value) < float(t.values[0]):
            out["failures"].append(f"config-2 TRON loss did not fall on "
                                   f"{layout}")
    lb, lb_s = _fit(OptimizationProblem(obj, config=cfg), ell, w0)
    out["lbfgs_ell"] = {"iterations": lb.iterations,
                        "loss_final": float(lb.value),
                        "grad_norm": float(lb.grad_norm), "fit_s": lb_s}
    gap = abs(float(fits["colmajor"].value) - float(fits["ell"].value)) \
        / abs(float(fits["ell"].value))
    out["layout_loss_gap_rel"] = gap
    if not gap <= LAYOUT_LOSS_RTOL:
        out["failures"].append(f"config-2 TRON fits end {gap:g} apart "
                               f"(relative) > {LAYOUT_LOSS_RTOL:g}")
    if not float(fits["ell"].grad_norm) < float(lb.grad_norm):
        out["failures"].append(
            f"config-2 TRON ends at gradient norm "
            f"{float(fits['ell'].grad_norm):g}, not below L-BFGS's "
            f"{float(lb.grad_norm):g} after {TRON_ITERS} iterations each")
    return out


def split_colmajor_evaluation(by_name: dict, xw_ms: float) -> dict:
    """A transposed-ELL evaluation's device ms by part: B1's X·w
    (``xw_ms``: B1's time in a plain-ELL evaluation of the same row
    arrays), B1's Xᵀr (the rest of B1's time), the float64 fold
    (PyTorch's ``indexFunc*`` kernels), and the rest."""
    parts = {"gather_rowsum_xw": xw_ms, "gather_rowsum_xtr": -xw_ms,
             "fold": 0.0, "rest": 0.0}
    for name, ms in by_name.items():
        key = ("gather_rowsum_xtr" if "gather_rowsum" in name
               else "fold" if "indexFunc" in name else "rest")
        parts[key] += ms
    return parts


def device_kernels_ms(fn, n: int = 5, tries: int = 3) -> dict:
    """Device ms per call by kernel (or copy) name: the name's mean event
    time in a ``torch.profiler`` trace of ``n`` calls, times its events
    a call (its event count over ``n``, rounded, at least 1).  Late in a
    long run a trace may miss some device events (up to ~40 % of one
    kernel's seen here) or hold a late one, which a sum over ``n`` turns
    into a wrong time and the mean does not.  A trace that comes back
    without device events is taken again, up to ``tries`` traces; empty
    if none holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total: dict = {}
        count: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                total[e.name] = (total.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3)
                count[e.name] = count.get(e.name, 0) + 1
        if total:
            return {name: total[name] / count[name]
                    * max(1, round(count[name] / n)) for name in total}
    return {}


def device_ms(fn, n: int = 5):
    """Device busy ms per call (``device_kernels_ms`` summed); None where
    the trace holds no device event."""
    return sum(device_kernels_ms(fn, n).values()) or None


def split_ell_evaluation(by_name: dict) -> dict:
    """A plain-ELL evaluation's device ms by part: B1 (X·w), the float64
    ``index_add_`` of Xᵀr (PyTorch's ``indexFunc*`` kernels), the rest,
    and the five largest kernels by name."""
    parts = {"gather_rowsum": 0.0, "index_add": 0.0, "rest": 0.0}
    for name, ms in by_name.items():
        key = ("gather_rowsum" if "gather_rowsum" in name
               else "index_add" if "indexFunc" in name else "rest")
        parts[key] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    parts["largest"] = {name[:96]: ms for name, ms in top}
    return parts


def time_evaluations(obj, batch, ell, X, w_t, cmb=None) -> dict:
    """CUDA-event ms of one ``value_and_gradient`` on each layout (back to
    back: the host's launch rate sets it where the host is slower), of one
    cuSPARSE CSR product per direction, and of the GRR evaluation's
    parts: the row and column contractions (B2/B3 levels, overflow and
    spill), the hot-side matmuls and the spill ``index_add_`` alone.
    Then each layout's device busy ms per evaluation (profiler) and the
    card's idle share of the back-to-back time."""
    dev = w_t.device
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(X.indptr.astype(np.int64)),
        torch.from_numpy(X.indices.astype(np.int64)),
        torch.from_numpy(X.data.astype(np.float32)), X.shape).to(dev)
    Xt = X.T.tocsr()
    csr_t = torch.sparse_csr_tensor(
        torch.from_numpy(Xt.indptr.astype(np.int64)),
        torch.from_numpy(Xt.indices.astype(np.int64)),
        torch.from_numpy(Xt.data.astype(np.float32)), Xt.shape).to(dev)
    r = torch.rand(X.shape[0], device=dev) - 0.5
    pair = batch.grr
    hot = pair.hot_ids
    spills = [(d, torch.rand(d.table_len, device=dev))
              for _, d in plan_levels(pair) if d.n_spill]
    out = {
        "vg_grr_ms": time_ms(lambda: obj.value_and_gradient(w_t, batch), 5),
        "vg_ell_ms": time_ms(lambda: obj.value_and_gradient(w_t, ell), 5),
        "library_xw_ms": time_ms(lambda: torch.sparse.mm(csr, w_t[:, None]),
                                 5),
        "library_xtr_ms": time_ms(
            lambda: torch.sparse.mm(csr_t, r[:, None]), 5),
        "row_contract_ms": time_ms(lambda: pair.row_dir.contract(w_t), 5),
        "col_contract_ms": time_ms(lambda: pair.col_dir.contract(r), 5),
        "mid_contract_ms": (time_ms(lambda: pair.col_mid.contract(r), 5)
                            if pair.col_mid is not None else 0.0),
        "hot_matmul_ms": time_ms(
            lambda: (torch.matmul(pair.x_hot, w_t[hot]),
                     torch.matmul(pair.x_hot.T, r)), 5),
        "spill_index_add_ms": sum(
            time_ms(lambda d=d, t=t: torch.zeros(d.n_segments, device=dev)
                    .index_add_(0, d.spill_seg, d.spill_val * t[d.spill_idx]),
                    5) for d, t in spills),
    }
    out["library_ms"] = out["library_xw_ms"] + out["library_xtr_ms"]
    for layout, b in (("grr", batch), ("ell", ell)):
        by_name = device_kernels_ms(lambda b=b: obj.value_and_gradient(w_t, b))
        busy = sum(by_name.values()) or None
        if layout == "ell":
            out["vg_ell_device_split_ms"] = split_ell_evaluation(by_name)
        out[f"vg_{layout}_device_ms"] = busy
        out[f"vg_{layout}_idle_share"] = (
            None if busy is None else max(0.0, 1.0 - busy
                                          / out[f"vg_{layout}_ms"]))
    if cmb is not None:
        # B1's X·w runs on the same row-ELL arrays in both layouts: the
        # plain-ELL evaluation's B1 time is the transposed one's X·w.
        out["vg_colmajor_ms"] = time_ms(
            lambda: obj.value_and_gradient(w_t, cmb), 5)
        split = split_colmajor_evaluation(
            device_kernels_ms(lambda: obj.value_and_gradient(w_t, cmb)),
            out["vg_ell_device_split_ms"]["gather_rowsum"])
        busy = sum(split.values()) or None
        out["vg_colmajor_device_split_ms"] = split
        out["vg_colmajor_device_ms"] = busy
        out["vg_colmajor_idle_share"] = (
            None if busy is None else max(0.0, 1.0 - busy
                                          / out["vg_colmajor_ms"]))
    return out


# -- phase 7: config 5 GAME training ------------------------------------------


def make_game_data(seed: int, n: int, d: int = D, k: int = NNZ,
                   n_entities: int = N_ENTITIES) -> GameDataset:
    """Config-5 rows (the generator of examples/kdd_scale.py at the
    phase-4 widths): ``k`` power-law columns of ``d`` a row (the
    estimator adds the intercept), power-law user and item ids over
    ``n_entities`` each, a user shard [1, x] and an item shard [1];
    labels from planted global, per-user (2) and per-item (1) effects."""
    rng = np.random.default_rng(seed)
    rows, w_true = _power_law_rows(rng, n, d, k)
    user = (n_entities * rng.random(n) ** 1.8).astype(np.int64)
    item = (n_entities * rng.random(n) ** 1.8).astype(np.int64)
    u_eff = rng.normal(0, 1.0, (n_entities, P_USER)) * [1.2, 0.5]
    i_eff = rng.normal(0, 0.8, n_entities)
    x_user = np.stack([np.ones(n), rng.normal(size=n)], 1).astype(np.float32)
    margins = (rows.dot_dense(w_true).astype(np.float64)
               + (u_eff[user] * x_user).sum(1) + i_eff[item] - 1.0)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margins))).astype(np.float32)
    return GameDataset(
        labels=y, features={"global": rows, "user_re": x_user,
                            "item_re": np.ones((n, P_ITEM), np.float32)},
        entity_ids={"userId": user, "itemId": item},
        feature_dims={"global": d})


def game_config(layout: str, device: str, fixed_only: bool = False,
                sweeps: int = GAME_SWEEPS) -> TrainingConfig:
    """Config 5: logistic, L2, L-BFGS on the fixed effect and on the
    per-user and per-item random effects (or the fixed effect alone)."""
    coords = [CoordinateConfig(
        "global", CoordinateKind.FIXED_EFFECT, "global",
        optimizer=OptimizerSettings(max_iters=GAME_FE_ITERS,
                                    reg_weight=GAME_L2))]
    if not fixed_only:
        coords += [CoordinateConfig(
            name, CoordinateKind.RANDOM_EFFECT, shard, entity_key=key,
            optimizer=OptimizerSettings(max_iters=GAME_RE_ITERS,
                                        reg_weight=GAME_L2))
            for name, shard, key in (("per_user", "user_re", "userId"),
                                     ("per_item", "item_re", "itemId"))]
    return TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION, coordinates=coords,
        update_sequence=[c.name for c in coords], n_iterations=sweeps,
        evaluators=[EvaluatorType.AUC], sparse_layout=layout, device=device)


class _FitProbe:
    """Counts, during a fit, the fixed-effect evaluations (each calls
    ``SparseBatch.margins`` once; scoring calls ``x_dot``) and the
    gradients (``SparseBatch.xt_dot``), with the B1 launches made inside
    each, and times each bucket's lane-batched solve."""

    def __enter__(self):
        self.margins_calls = self.margins_launches = 0
        self.xt_dot_calls = self.xt_dot_launches = 0
        self.buckets: list = []
        self._margins = SparseBatch.margins
        self._xt_dot = SparseBatch.xt_dot
        self._solve = game_coordinates.solve_batched
        probe = self

        def margins(batch, w):
            before = gather_rowsum.launches
            out = probe._margins(batch, w)
            probe.margins_calls += 1
            probe.margins_launches += gather_rowsum.launches - before
            return out

        def xt_dot(batch, r):
            before = gather_rowsum.launches
            out = probe._xt_dot(batch, r)
            probe.xt_dot_calls += 1
            probe.xt_dot_launches += gather_rowsum.launches - before
            return out

        def solve(problem, batches, w0s):
            t = time.perf_counter()
            res = probe._solve(problem, batches, w0s)
            iters = int(res.iterations.max())      # waits for the card
            probe.buckets.append({
                "entities": int(batches.x.shape[0]),
                "capacity": int(batches.x.shape[1]),
                "width": int(batches.x.shape[2]),
                "max_iterations": iters,
                "solve_s": time.perf_counter() - t})
            return res

        SparseBatch.margins = margins
        SparseBatch.xt_dot = xt_dot
        game_coordinates.solve_batched = solve
        return self

    def __exit__(self, *exc):
        SparseBatch.margins = self._margins
        SparseBatch.xt_dot = self._xt_dot
        game_coordinates.solve_batched = self._solve
        return False


def _fit_game(config: TrainingConfig, train, valid) -> dict:
    """One ``GameEstimator.fit`` with its B1 launches, fixed-effect
    evaluations, bucket solves and the run log's sweep and coordinate
    walls."""
    log_path = os.path.join(WORK, f"game_{time.monotonic_ns()}.jsonl")
    gather_rowsum.launches = 0
    with RunLogger(log_path) as log, _FitProbe() as probe:
        t = time.perf_counter()
        result = GameEstimator(config).fit(train, valid, run_logger=log)[0]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = read_run_log(log_path)
    coord_s: dict = {}
    for e in events:
        if e["event"] == "cd_coordinate":
            coord_s.setdefault(e["iteration"], {})[e["coordinate"]] = \
                e["duration_s"]
    return {"result": result, "wall_s": wall,
            "launches": gather_rowsum.launches,
            "fe_evaluations": probe.margins_calls,
            "fe_evaluation_launches": probe.margins_launches,
            "fe_gradients": probe.xt_dot_calls,
            "fe_gradient_launches": probe.xt_dot_launches,
            "buckets": probe.buckets,
            "sweep_coordinate_s": coord_s,
            "auc": float(result.evaluations[EvaluatorType.AUC]),
            "auc_by_sweep": [float(v[EvaluatorType.AUC])
                             for v in result.validation_history]}


def _entity_problem_check(result, train: GameDataset, n_checks: int,
                          seed: int) -> dict:
    """For ``n_checks`` converged lanes drawn across every bucket of both
    random effects: the lane's float64 objective (with the offsets its
    last solve saw) against a float64 scipy L-BFGS-B solve of the
    entity's own problem."""
    import scipy.optimize

    rng = np.random.default_rng(seed)
    cd = result.descent
    res_names = [n for n, m in result.model.models.items()
                 if isinstance(m, RandomEffectModel)]
    # One converged lane from every bucket first, then the rest at random.
    pools, skipped = [], 0
    for name in res_names:
        for b, r in enumerate(cd.last_results[name]):
            conv = r.converged.cpu().numpy()
            skipped += int((~conv).sum())
            slots = rng.permutation(np.flatnonzero(conv))
            pools += [[(name, b, int(s)) for s in slots]]
    picks = [p[0] for p in pools if p]
    rest = [t for p in pools for t in p[1:]]
    extra = max(0, n_checks - len(picks))
    picks += [rest[i] for i in rng.choice(len(rest), min(extra, len(rest)),
                                          replace=False)]
    worst, checked = 0.0, []
    y_all = train.labels.astype(np.float64)
    for name, b, s in picks:
        model = result.model.models[name]
        g = model.grouping
        e = int(np.flatnonzero((g.entity_bucket == b)
                               & (g.entity_slot == s))[0])
        ex = np.flatnonzero(g.example_entity == e)
        x = train.features[model.feature_shard][ex].astype(np.float64)
        y = y_all[ex]
        off = cd.last_offsets[name][torch.from_numpy(ex).to(
            cd.last_offsets[name].device)].double().cpu().numpy()

        def f(w, x=x, y=y, off=off):
            z = x @ w + off
            return np.sum(np.logaddexp(0.0, z) - y * z) + 0.5 * GAME_L2 * w @ w

        def grad(w, x=x, y=y, off=off):
            z = x @ w + off
            return x.T @ (1.0 / (1.0 + np.exp(-z)) - y) + GAME_L2 * w

        opt = scipy.optimize.minimize(
            f, np.zeros(x.shape[1]), jac=grad, method="L-BFGS-B",
            options={"gtol": 1e-12, "ftol": 1e-15, "maxiter": 1000})
        w_port = model.coefficient_blocks[b][s].double().numpy()
        rel = (f(w_port) - opt.fun) / abs(opt.fun)
        worst = max(worst, rel)
        checked.append({"coordinate": name, "bucket": b,
                        "examples": len(ex), "rel": rel})
    checked.sort(key=lambda c: -c["rel"])
    return {"checked": len(checked), "worst_rel": worst,
            "unconverged_lanes": skipped, "worst_five": checked[:5]}


def _serve_check(result, valid: GameDataset, device: str) -> float:
    """The fit's model saved, loaded by ``ScoringEngine`` and served
    ``GAME_SERVE_ROWS`` held-out rows; max |engine − transformer|."""
    model_dir = os.path.join(WORK, "game_model")
    save_game_model(result.model, TaskType.LOGISTIC_REGRESSION, model_dir)
    model, task = load_game_model(model_dir)
    engine = ScoringEngine(model, task, ell_row_capacity=ELL_CAP,
                           spill_dir=os.path.join(WORK, "game_spill"),
                           device=device)
    n = min(GAME_SERVE_ROWS, valid.n)
    sub = valid.take(np.arange(n))
    want = GameTransformer(model=result.model, task=task,
                           device=device).transform(sub)
    got = []
    for lo in range(0, n, BATCH_ROWS):
        parsed = engine.parse_rows(dataset_rows(sub, lo, min(lo + BATCH_ROWS,
                                                             n)))
        got.append(engine.score_batch(parsed, BATCH_ROWS)[0])
    engine.close()
    return float(np.abs(np.concatenate(got) - want).max())


def profile_sweep(train: GameDataset, device: str) -> dict:
    """One coordinate-descent sweep of the ELL config (its coordinates
    built first, outside the window) under ``torch.profiler``: the wall,
    the device busy ms (the trace's device events summed) and the idle
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_torch.game.coordinate_descent import (
        run_coordinate_descent,
    )

    est = GameEstimator(game_config("ELL", device, sweeps=1))
    coords = est._build_coordinates(train, est._prepare(train), {})
    seq = est.config.update_sequence
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run_coordinate_descent(coords, seq, 1)         # first-call costs
    sync()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        run_coordinate_descent(coords, seq, 1)
        sync()
        wall = time.perf_counter() - t
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    return {"wall_s": wall, "device_busy_ms": busy or None,
            "idle_share": (max(0.0, 1.0 - busy / 1e3 / wall) if busy
                           else None)}


def fe_problem(train: GameDataset, device: str, layout: str) -> tuple:
    """The phase-7 fixed effect's objective and the batch the estimator
    builds for it (intercept included) on ``layout``."""
    est = GameEstimator(game_config(layout, device, fixed_only=True,
                                    sweeps=1))
    prep = est._prepare(train)
    coord = est._build_coordinates(train, prep, {})["global"]
    return coord.problem.objective, prep["global"]["batch"]


def game_kernel_cases(batch, model, valid: GameDataset, device: str,
                      seed: int) -> list:
    """B1's inputs on phase 7's own arrays, as ``check_b1_case`` takes
    them: the fixed effect's ELL (the estimator's transposed-ELL batch,
    intercept included, ``w`` near zero as the table), its transposed
    ELL (the residual over the rows as the table) and, on the card, the
    transformer's first scoring chunk of the held-out rows (the fitted
    coefficients as the table), caught at its call."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.05, batch.dim).astype(
        np.float32)).to(batch.labels.device)
    r = (torch.sigmoid(batch.margins(w)) - batch.labels).contiguous()
    cm = batch.colmajor
    cases = [("game_fe_ell", w, batch.values, batch.col_ids, ATOL),
             ("game_fe_colmajor", r, cm.tvals, cm.trows, COLMAJOR_ATOL)]
    seen = []
    real = game_transformer.gather_rowsum

    def record(table, vals, ids):
        seen.append((table, vals, ids))
        return real(table, vals, ids)

    game_transformer.gather_rowsum = record
    try:
        GameTransformer(model=model, task=TaskType.LOGISTIC_REGRESSION,
                        device=device).transform(valid)
    finally:
        game_transformer.gather_rowsum = real
    if device != "cpu":
        if not seen:
            raise AssertionError("phase 7: the transformer's scoring did "
                                 "not call gather_rowsum")
        table, vals, ids = seen[0]
        # Phase 3's tolerance holds at terms |w·x| ≤ 1; the fitted
        # coefficients' terms may be larger, and rounding scales with them.
        scale = max(1.0, float(table.abs().max()) * float(vals.abs().max()))
        cases.append(("game_score_chunk", table, vals, ids, ATOL * scale))
    return cases


def fe_evaluation_splits(problems: dict, time_it: bool = True) -> dict:
    """The phase-7 fixed effect's ``value_and_gradient`` on the batch the
    estimator builds for it (``fe_problem``), on the ELL and the
    transposed-ELL layout: its shapes; with ``time_it``, the ms back to
    back and the device ms by part (``split_ell_evaluation``,
    ``split_colmajor_evaluation``)."""
    out = {}
    for layout in ("ELL", "COLMAJOR"):
        obj, batch = problems[layout]
        w = torch.from_numpy(np.random.default_rng(8).normal(
            0, 0.05, batch.dim).astype(np.float32)).to(batch.labels.device)
        entry = {"shape": list(batch.values.shape)}
        if batch.colmajor is not None:
            entry["transposed_shape"] = [batch.colmajor.n_virtual_rows,
                                         batch.colmajor.capacity]
        if time_it:
            def fn(obj=obj, batch=batch):
                return obj.value_and_gradient(w, batch)

            entry["ms"] = time_ms(fn, 5)
            by_name = device_kernels_ms(fn)
            entry["device_ms"] = sum(by_name.values()) or None
            entry["device_split_ms"] = (
                split_ell_evaluation(by_name) if batch.colmajor is None
                # X·w: the ELL evaluation's B1 time, on the same arrays.
                else split_colmajor_evaluation(
                    by_name, out["ell"]["device_split_ms"]["gather_rowsum"]))
        out[layout.lower()] = entry
    return out


def phase_game(seed: int, n: int, device: str, d: int = D,
               n_entities: int = N_ENTITIES, time_it: bool = True) -> dict:
    """Config 5 at full width: ``GameEstimator.fit`` for ``GAME_SWEEPS``
    sweeps on the ELL and the transposed-ELL layout, and a fixed-only
    fit of the same data; the gates (module docstring, phase 7)."""
    t = time.perf_counter()
    data = make_game_data(seed, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    out = {"rows": n, "train_rows": n_train, "data_s":
           time.perf_counter() - t}
    fits = {}
    for layout in ("ELL", "COLMAJOR"):
        fits[layout] = _fit_game(game_config(layout, device), train, valid)
    fixed = _fit_game(game_config("ELL", device, fixed_only=True,
                                  sweeps=1), train, valid)
    res = fits["ELL"]["result"]
    out["entity_check"] = _entity_problem_check(res, train,
                                                GAME_ENTITY_CHECKS, seed)
    out["serve_max_abs_err"] = _serve_check(res, valid, device)
    for layout, f in fits.items():
        hist = f["result"].descent.history
        out[layout.lower()] = {
            k: v for k, v in f.items() if k != "result"} | {
            "re_convergence": [{c: h[c] for c in h if c != "global"}
                               for h in hist],
            "fe_solver_iterations": [h["global"]["solver_iterations"]
                                     for h in hist],
            "fe_value": hist[-1]["global"]["value"]}
    # Phase 10's reference (popped before the phase prints).
    out["ell_fe_w"] = res.model.models["global"].coefficients.means.numpy()
    out["fixed_only"] = {"auc": fixed["auc"], "wall_s": fixed["wall_s"]}
    problems = {layout: fe_problem(train, device, layout)
                for layout in ("ELL", "COLMAJOR")}
    out["kernel_shapes"] = [
        check_b1_case(*case, time_it=time_it)
        for case in game_kernel_cases(problems["COLMAJOR"][1], res.model,
                                      valid, device, seed)]
    if time_it and device != "cpu":
        out["one_sweep_profiled"] = profile_sweep(train, device)
        out["fe_evaluation_splits"] = fe_evaluation_splits(problems)
    del problems

    failures = []
    ell, cm = fits["ELL"], fits["COLMAJOR"]
    if not ell["auc"] > fixed["auc"]:
        failures.append(f"GAME AUC {ell['auc']:.4f} does not beat the "
                        f"fixed-only {fixed['auc']:.4f}")
    if not abs(ell["auc"] - cm["auc"]) <= GAME_LAYOUT_AUC_ATOL:
        failures.append(f"ELL and transposed-ELL AUCs {ell['auc']:.5f}, "
                        f"{cm['auc']:.5f} differ by more than "
                        f"{GAME_LAYOUT_AUC_ATOL}")
    if device != "cpu":
        for layout, f in fits.items():
            if not f["fe_evaluation_launches"] >= f["fe_evaluations"] >= 1:
                failures.append(
                    f"{layout} fit launched gather_rowsum "
                    f"{f['fe_evaluation_launches']} time(s) in "
                    f"{f['fe_evaluations']} fixed-effect evaluations")
        # The transposed ELL's Xᵀr is B1 too: with X·w, two launches a
        # value-and-gradient.
        if not cm["fe_gradient_launches"] >= cm["fe_gradients"] >= 1:
            failures.append(
                f"COLMAJOR fit launched gather_rowsum "
                f"{cm['fe_gradient_launches']} time(s) in "
                f"{cm['fe_gradients']} fixed-effect gradients")
    ec = out["entity_check"]
    if ec["checked"] < GAME_ENTITY_CHECKS or not (
            ec["worst_rel"] <= GAME_ENTITY_RTOL):
        failures.append(f"per-entity objectives: {ec['checked']} checked, "
                        f"worst {ec['worst_rel']:g} > {GAME_ENTITY_RTOL:g}")
    if not out["serve_max_abs_err"] <= GAME_SERVE_ATOL:
        failures.append(f"served margins differ from the transformer's by "
                        f"{out['serve_max_abs_err']:g} > {GAME_SERVE_ATOL}")
    out["failures"] = failures
    return out


# -- phase 8: the training driver ------------------------------------------------


def driver_config(out_dir: str) -> dict:
    """tests/test_fixtures.py's config-4 run on the committed Avro
    fixture."""
    return {
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [
            {"name": "global", "kind": "FIXED_EFFECT",
             "feature_shard": "global",
             "optimizer": {"optimizer": "LBFGS", "reg_weight": 1.0,
                           "max_iters": 100}},
            {"name": "per_user", "kind": "RANDOM_EFFECT",
             "feature_shard": "user_re", "entity_key": "userId",
             "optimizer": {"optimizer": "LBFGS", "reg_weight": 2.0,
                           "max_iters": 60}},
        ],
        "update_sequence": ["global", "per_user"],
        "n_iterations": 2,
        "input_path": os.path.join(FIXTURES, "config4_train.avro"),
        "validation_path": os.path.join(FIXTURES, "config4_valid.avro"),
        "output_dir": out_dir,
        "evaluators": ["AUC"],
    }


def _run_module(module: str, args: list) -> tuple[dict, float]:
    """``python -m <module> <args>`` from the repository root; its last
    stdout line as JSON, and its wall."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"phase 8: {module} exited {proc.returncode}:"
                             f" {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    return (json.loads(lines[-1]) if lines else {}), wall


def phase_driver(device_args: list) -> dict:
    """``python -m photon_ml_torch.cli.game_training_driver`` in a
    subprocess on the config-4 fixture: rc 0, and the saved model and
    summary reproduce ``golden.json["config4"]``.  Then, each in a
    subprocess: ``feature_indexing_driver`` on the training file must
    write the training driver's index maps, and ``game_scoring_driver``
    scores the validation file from the saved model to ``.npz`` and to
    ``.avro``: the training driver's validation AUC, the two outputs'
    scores alike, and the Avro file read back by the port's reader.
    The ``.npz`` scoring runs once more in this process with the B1
    launch count set to 0; ``export_model_avro`` writes the model and it
    reads back to the same coefficients."""
    from photon_ml_torch.cli import game_scoring_driver
    from photon_ml_torch.config import load_scoring_config
    from photon_ml_torch.io.avro import read_container
    from photon_ml_torch.io.avro_schemas import read_model_avro
    from photon_ml_torch.io.index_map import load_index_maps
    from photon_ml_torch.io.model_io import export_model_avro

    out_dir = os.path.join(WORK, "driver_out")
    cfg_path = os.path.join(WORK, "driver.json")
    cfg = driver_config(out_dir)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    summary, wall = _run_module("photon_ml_torch.cli.game_training_driver",
                                ["--config", cfg_path, *device_args])
    with open(os.path.join(FIXTURES, "golden.json")) as f:
        want = json.load(f)["config4"]
    model_dir = os.path.join(out_dir, "model")
    model, task = load_game_model(model_dir)
    w = model.models["global"].coefficients.means.numpy()
    auc_v = summary["models"][0]["evaluations"]["AUC"]
    coef_err = float(np.max(np.abs(w - np.asarray(want["fixed_coefficients"]))
                            / (1.0 + np.abs(want["fixed_coefficients"]))))
    out = {"rc": 0, "wall_s": wall, "auc": auc_v,
           "golden_auc": want["auc"], "coef_err_rel": coef_err}
    if not abs(auc_v - want["auc"]) < DRIVER_AUC_ATOL:
        raise AssertionError(f"phase 8: AUC {auc_v} vs golden {want['auc']}")
    np.testing.assert_allclose(w, np.asarray(want["fixed_coefficients"]),
                               rtol=DRIVER_COEF_TOL, atol=DRIVER_COEF_TOL)

    maps_dir = os.path.join(WORK, "index_maps")
    sizes, out["indexing_wall_s"] = _run_module(
        "photon_ml_torch.cli.feature_indexing_driver",
        ["--input", cfg["input_path"], "--output-dir", maps_dir])
    built, trained = (load_index_maps(maps_dir),
                      load_index_maps(os.path.join(out_dir, "index_maps")))
    for mine, theirs in zip(built, trained):
        if ({k: m.index for k, m in mine.items()}
                != {k: m.index for k, m in theirs.items()}):
            raise AssertionError("phase 8: the indexing driver's maps "
                                 "differ from the training driver's")
    out["index_sizes"] = sizes

    scores = {}
    for ext in ("npz", "avro"):
        sc_path = os.path.join(WORK, f"score_{ext}.json")
        with open(sc_path, "w") as f:
            json.dump({"input_path": cfg["validation_path"],
                       "model_dir": model_dir,
                       "output_path": os.path.join(WORK, f"scores.{ext}"),
                       "evaluators": ["AUC"]}, f)
        res, out[f"scoring_{ext}_wall_s"] = _run_module(
            "photon_ml_torch.cli.game_scoring_driver",
            ["--config", sc_path, *device_args])
        scores[ext] = res
    npz = np.load(os.path.join(WORK, "scores.npz"))
    _, recs = read_container(os.path.join(WORK, "scores.avro"))
    recs = list(recs)
    avro_pred = np.asarray([r["predictionScore"] for r in recs])
    out["scoring_auc"] = scores["npz"]["evaluation"]["AUC"]
    out["scoring_auc_gap"] = abs(out["scoring_auc"] - auc_v)
    out["scoring_outputs_max_abs_diff"] = float(
        np.abs(avro_pred - npz["predictions"]).max())
    out["scoring_rows"] = len(recs)
    if not out["scoring_auc_gap"] <= SCORING_ATOL:
        raise AssertionError(f"phase 8: the scoring driver's AUC "
                             f"{out['scoring_auc']} vs the training "
                             f"driver's {auc_v}")
    if not (len(recs) == len(npz["scores"]) and
            out["scoring_outputs_max_abs_diff"] <= SCORING_ATOL):
        raise AssertionError("phase 8: the .avro and .npz scores differ")

    config = load_scoring_config(os.path.join(WORK, "score_npz.json"))
    if device_args:
        config.device = device_args[-1]
    gather_rowsum.launches = 0
    game_scoring_driver.run(config)
    out["scoring_gather_rowsum_launches"] = gather_rowsum.launches

    avro_dir = os.path.join(WORK, "model_avro")
    paths = export_model_avro(model, task, trained[0], avro_dir)
    imap = trained[0][model.models["global"].feature_shard]
    dim = len(w)

    def key_to_index(name, term):
        return dim - 1 if name == "(INTERCEPT)" else imap.get_feature(
            name, term)

    _, means, _ = read_model_avro(os.path.join(avro_dir, "global.avro"),
                                  key_to_index, dim)
    out["export_files"] = [os.path.basename(p) for p in paths]
    out["export_max_abs_diff"] = float(np.abs(means - w).max())
    if out["export_max_abs_diff"] != 0.0:
        raise AssertionError("phase 8: the exported model reads back to "
                             "other coefficients")
    return out


# -- phase 9: the swept λ grid and the tuned fit ------------------------------


class _SweepProbe:
    """Counts, during a fit, the swept evaluations (``SparseBatch.margins``
    with coefficient lanes W [L, d]) and swept gradients
    (``SparseBatch.xt_dot`` with R [L, n]) with the lane-kernel and the
    single-lane B1 launches made inside each; the lane kernel's launches
    by the shape they ran at, ``(product, n, k, L)`` (product ``"xw"``:
    X·Wᵀ over the row ELL; ``"xtr"``: XᵀR over the transposed ELL), with
    the last inputs of each shape, caught at ``lane_gather_rowsum`` in
    its two callers; the ``_fit_point`` calls; each fixed-effect
    solve's result and wall (``train_swept`` and ``train``); and the
    wall of the estimator's data preparation, swept setup and
    validations (``stage_s``, each timed to the card's end)."""

    def __enter__(self):
        self.evaluations = self.evaluation_lane_launches = 0
        self.evaluation_single_launches = 0
        self.evaluations_without_lane_kernel = 0
        self.gradients = self.gradient_lane_launches = 0
        self.gradient_single_launches = 0
        self.fit_point_calls = 0
        self.solves: list = []
        self.lane_launches: dict = {}
        self.lane_inputs: dict = {}
        self.stage_s: dict = {}
        self._stages = {name: getattr(GameEstimator, name)
                        for name in ("_prepare", "_swept_setup",
                                     "_evaluate")}
        self._saved = (SparseBatch.margins, SparseBatch.xt_dot,
                       GameEstimator._fit_point,
                       game_coordinates.FixedEffectCoordinate.train_swept,
                       game_coordinates.FixedEffectCoordinate.train,
                       batch_mod.lane_gather_rowsum,
                       colmajor_mod.lane_gather_rowsum)
        (margins0, xt_dot0, fit_point0, swept0, train0, xw0,
         xtr0) = self._saved
        probe = self

        def margins(batch, w):
            if w.dim() == 1:
                return margins0(batch, w)
            lane0, single0 = (gather_rowsum_lanes.launches,
                              gather_rowsum.launches)
            out = margins0(batch, w)
            probe.evaluations += 1
            lane_launches = gather_rowsum_lanes.launches - lane0
            probe.evaluation_lane_launches += lane_launches
            probe.evaluations_without_lane_kernel += lane_launches == 0
            probe.evaluation_single_launches += (gather_rowsum.launches
                                                 - single0)
            return out

        def xt_dot(batch, r):
            if r.dim() == 1:
                return xt_dot0(batch, r)
            lane0, single0 = (gather_rowsum_lanes.launches,
                              gather_rowsum.launches)
            out = xt_dot0(batch, r)
            probe.gradients += 1
            probe.gradient_lane_launches += (gather_rowsum_lanes.launches
                                             - lane0)
            probe.gradient_single_launches += (gather_rowsum.launches
                                               - single0)
            return out

        def recorder(product, real):
            def lanes(v, vals, ids):
                before = gather_rowsum_lanes.launches
                out = real(v, vals, ids)
                if v.dim() == 2 and v.shape[0] > 1:
                    key = (product, *vals.shape, v.shape[0])
                    probe.lane_launches[key] = (
                        probe.lane_launches.get(key, 0)
                        + gather_rowsum_lanes.launches - before)
                    # The kernel's own table: lane-minor [T, L].
                    probe.lane_inputs[key] = (v.T.contiguous(), vals, ids)
                return out
            return lanes

        def fit_point(est, *a, **kw):
            probe.fit_point_calls += 1
            return fit_point0(est, *a, **kw)

        def timed(kind, fn):
            def solve(coord, *a, **kw):
                t = time.perf_counter()
                w, res = fn(coord, *a, **kw)
                value = res.value.detach().cpu().numpy()   # waits for the card
                probe.solves.append({"kind": kind, "value": value,
                                     "iterations": res.iterations,
                                     "solve_s": time.perf_counter() - t})
                return w, res
            return solve

        def stage(name, fn):
            def run(est, *a, **kw):
                t = time.perf_counter()
                out = fn(est, *a, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                probe.stage_s[name] = (probe.stage_s.get(name, 0.0)
                                       + time.perf_counter() - t)
                return out
            return run

        for name, fn in self._stages.items():
            setattr(GameEstimator, name, stage(name, fn))
        SparseBatch.margins = margins
        SparseBatch.xt_dot = xt_dot
        GameEstimator._fit_point = fit_point
        game_coordinates.FixedEffectCoordinate.train_swept = timed(
            "swept", swept0)
        game_coordinates.FixedEffectCoordinate.train = timed("single", train0)
        batch_mod.lane_gather_rowsum = recorder("xw", xw0)
        colmajor_mod.lane_gather_rowsum = recorder("xtr", xtr0)
        return self

    def __exit__(self, *exc):
        (SparseBatch.margins, SparseBatch.xt_dot, GameEstimator._fit_point,
         game_coordinates.FixedEffectCoordinate.train_swept,
         game_coordinates.FixedEffectCoordinate.train,
         batch_mod.lane_gather_rowsum,
         colmajor_mod.lane_gather_rowsum) = self._saved
        for name, fn in self._stages.items():
            setattr(GameEstimator, name, fn)
        return False

    def counts(self) -> dict:
        """The swept evaluations' and gradients' counts (see the class)."""
        return {
            "evaluations": self.evaluations,
            "evaluation_lane_launches": self.evaluation_lane_launches,
            "evaluations_without_lane_kernel":
                self.evaluations_without_lane_kernel,
            "evaluation_single_launches": self.evaluation_single_launches,
            "gradients": self.gradients,
            "gradient_lane_launches": self.gradient_lane_launches,
            "gradient_single_launches": self.gradient_single_launches,
            "lane_launches_by_shape": {
                lane_shape_name(key): n
                for key, n in self.lane_launches.items()},
        }


def lane_shape_name(key: tuple) -> str:
    """A lane-kernel shape key ``(product, n, k, L)`` as a ``shapes`` name."""
    product, n, k, lanes = key
    return f"sweep_{product}_{n}x{k}_L{lanes}"


def sweep_data(data: dict) -> tuple:
    """Phase 6's arrays (the intercept column included) as the estimator's
    (train, validation) ``GameDataset``s."""
    dim = D + 1

    def ds(rows, labels):
        return GameDataset(labels=labels, features={"global": rows},
                           entity_ids={}, feature_dims={"global": dim})

    return (ds(data["rows"], data["labels"]),
            ds(data["test_rows"], data["test_labels"]))


def sweep_config(layout: str, device: str, **over) -> TrainingConfig:
    """Config 1 as phase 6 fits it (logistic, L-BFGS 20 iterations, L2
    on every coefficient: the intercept is one of phase 6's columns),
    over the λ grid ``SWEEP_LAMS`` unless ``over`` says otherwise."""
    base = dict(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[CoordinateConfig(
            "global", CoordinateKind.FIXED_EFFECT, "global",
            optimizer=OptimizerSettings(max_iters=SWEEP_ITERS,
                                        tolerance=1e-7))],
        update_sequence=["global"], evaluators=[EvaluatorType.AUC],
        reg_weight_grid={"global": list(SWEEP_LAMS)}, intercept=False,
        sparse_layout=layout, device=device)
    base.update(over)
    return TrainingConfig(**base)


def _swept_fit(layout: str, train, valid, device: str) -> dict:
    """``GameEstimator.fit`` of the λ grid on ``layout`` under the probe,
    with the lane kernel's count set to 0 just before and read just
    after: (the fit's figures, the probe)."""
    gather_rowsum_lanes.launches = 0
    with _SweepProbe() as probe:
        t = time.perf_counter()
        results = GameEstimator(sweep_config(layout, device)).fit(train,
                                                                   valid)
        wall = time.perf_counter() - t
    launches = gather_rowsum_lanes.launches
    swept = [sv for sv in probe.solves if sv["kind"] == "swept"]
    # The solve's lanes run λ-descending.
    order = np.argsort(-np.asarray(SWEEP_LAMS), kind="stable")
    loss = np.empty(len(SWEEP_LAMS))
    loss[order] = swept[-1]["value"] if swept else np.nan
    stages = {**probe.stage_s,
              "swept_solve": sum(sv["solve_s"] for sv in swept)}
    stages["rest"] = wall - sum(stages.values())
    return {
        "wall_s": wall, "launches": launches,
        "stage_s": stages,
        "fit_point_calls": probe.fit_point_calls,
        "swept_solves": len(swept),
        "swept_solve_s": stages["swept_solve"],
        "solver_iterations": (swept[-1]["iterations"].tolist()
                              if swept else None),
        **probe.counts(),
        "loss": loss.tolist(),
        "auc": [float(r.evaluations[EvaluatorType.AUC]) for r in results],
        "validation_entries": [len(r.validation_history) for r in results],
    }, probe


def sweep_lane_cases(probes: list, time_it: bool = True) -> list:
    """The lane kernel checked (``check_lanes_case``) at every shape that
    phase 9's fits launched it at, on the last inputs each shape had
    there (the fitted Wᵀ, or the residual Rᵀ, as the table); each entry
    carries the launches the fits of ``probes`` made at its shape."""
    launches, inputs = {}, {}
    for probe in probes:
        for key, n in probe.lane_launches.items():
            launches[key] = launches.get(key, 0) + n
        inputs.update(probe.lane_inputs)
    shapes = []
    for key in sorted(inputs):
        table, vals, ids = inputs[key]
        if key[0] == "xtr":
            atol = COLMAJOR_ATOL
        else:
            # As at phase 7's scoring chunk: the fitted coefficients' terms
            # may pass 1, and rounding scales with them.
            atol = ATOL * max(1.0, float(table.abs().max())
                              * float(vals.abs().max()))
        shapes.append(check_lanes_case(lane_shape_name(key), table, vals,
                                       ids, atol, time_it=time_it))
        shapes[-1]["launches"] = launches[key]
    return shapes


def sweep_evaluation_splits(train, device: str,
                            time_it: bool = True) -> dict:
    """One swept ``value_and_gradient`` at ``LANES_MAIN`` lanes on the
    batch the estimator builds (ELL and transposed ELL): its shapes;
    with ``time_it``, ms back to back, device ms split into the lane
    kernel's X·Wᵀ, the Xᵀr (``index_add_``, or the lane kernel and the
    fold) and the rest, and the card's idle share."""
    out = {}
    rng = np.random.default_rng(10)
    for layout in ("ELL", "COLMAJOR"):
        est = GameEstimator(sweep_config(layout, device, reg_weight_grid={}))
        prep = est._prepare(train)
        obj = est._build_coordinates(train, prep, {})[
            "global"].problem.objective
        batch = prep["global"]["batch"]
        W = torch.from_numpy(rng.normal(0, 0.05, (LANES_MAIN, batch.dim))
                             .astype(np.float32)).to(batch.labels.device)
        l2s = torch.tensor(SWEEP_LAMS, dtype=torch.float32,
                           device=W.device)
        entry = {"shape": list(batch.values.shape), "lanes": LANES_MAIN}
        if batch.colmajor is not None:
            entry["transposed_shape"] = [batch.colmajor.n_virtual_rows,
                                         batch.colmajor.capacity]
        if time_it:
            def fn(obj=obj, batch=batch):
                return sweep_value_and_gradient(obj, W, batch, l2s)

            entry["ms"] = time_ms(fn, 5)
            by_name = device_kernels_ms(fn)
            busy = sum(by_name.values()) or None
            entry["device_ms"] = busy
            entry["idle_share"] = (None if busy is None
                                   else max(0.0, 1.0 - busy / entry["ms"]))
            entry["device_split_ms"] = (
                split_ell_evaluation(by_name) if batch.colmajor is None
                # X·Wᵀ: the ELL evaluation's lane-kernel time, on the
                # same row arrays.
                else split_colmajor_evaluation(
                    by_name, out["ell"]["device_split_ms"]["gather_rowsum"]))
        out[layout.lower()] = entry
        del prep, batch, obj
    return out


def phase_sweep(data: dict, device: str, time_it: bool = True) -> dict:
    """Config 1 at full width over an 8-point λ grid as ONE swept solve on
    the ELL and the transposed-ELL layout, lanes ``SWEEP_CHECK_LANES``
    against single-λ fits, and a RANDOM tuned fit; the gates (module
    docstring, phase 9)."""
    train, valid = sweep_data(data)
    out = {"rows": train.n + valid.n, "train_rows": train.n,
           "lams": list(SWEEP_LAMS)}
    fits, probes = {}, []
    for layout in ("ELL", "COLMAJOR"):
        fits[layout], probe = _swept_fit(layout, train, valid, device)
        probes.append(probe)

    est = GameEstimator(sweep_config("ELL", device, reg_weight_grid={}))
    prep = est._prepare(train)
    singles = []
    with _SweepProbe() as probe:
        for j in SWEEP_CHECK_LANES:
            t = time.perf_counter()
            r = est._fit_point(train, prep, {"global": SWEEP_LAMS[j]}, valid,
                               None)
            singles.append({"lane": j, "lam": SWEEP_LAMS[j],
                            "wall_s": time.perf_counter() - t,
                            "auc": float(r.evaluations[EvaluatorType.AUC])})
        solves = [sv for sv in probe.solves if sv["kind"] == "single"]
    for single, sv in zip(singles, solves):
        single["loss"] = float(sv["value"])
        single["solve_s"] = sv["solve_s"]
    del prep, est
    out["singles"] = singles

    tune_cfg = sweep_config("ELL", device, reg_weight_grid={},
                            tuning=TuningConfig(
                                n_trials=TUNE_TRIALS, mode="RANDOM",
                                trial_batch=TUNE_BATCH, seed=0,
                                reg_weight_ranges={"global": {
                                    "low": SWEEP_LAMS[0],
                                    "high": SWEEP_LAMS[-1]}}))
    gather_rowsum_lanes.launches = 0
    with _SweepProbe() as probe:
        t = time.perf_counter()
        trials = GameEstimator(tune_cfg).fit_tuned(train, valid)
        tuned = {"wall_s": time.perf_counter() - t,
                 "launches": gather_rowsum_lanes.launches,
                 "fit_point_calls": probe.fit_point_calls,
                 "swept_solves": sum(sv["kind"] == "swept"
                                     for sv in probe.solves),
                 **probe.counts()}
    probes.append(probe)
    tuned["lams"] = [t.reg_weights["global"] for t in trials]
    tuned["auc"] = [float(t.evaluations[EvaluatorType.AUC]) for t in trials]
    out["tuned"] = tuned
    for layout, f in fits.items():
        out[layout.lower()] = f
        f["single_solves_s_sum"] = sum(s["solve_s"] for s in singles)
    # The lane kernel at the shapes these fits ran it at.
    out["lane_shapes"] = sweep_lane_cases(probes, time_it=time_it)
    del probes, probe
    if time_it and device != "cpu":
        out["evaluation_splits"] = sweep_evaluation_splits(train, device)

    failures = []
    for layout, f in fits.items():
        if f["fit_point_calls"] or f["swept_solves"] != 1:
            failures.append(f"{layout} grid did not take the swept path "
                            f"({f['fit_point_calls']} _fit_point calls, "
                            f"{f['swept_solves']} swept solves)")
        if f["validation_entries"] != [1] * len(SWEEP_LAMS):
            failures.append(f"{layout} lanes' validation entries "
                            f"{f['validation_entries']} (one a sweep)")
    for name, f in (*fits.items(), ("tuned", tuned)):
        if device != "cpu":
            if f["launches"] < 1 or f["evaluations"] < 1 or \
                    f["evaluations_without_lane_kernel"]:
                failures.append(
                    f"{name} swept fit: gather_rowsum_lanes launched "
                    f"{f['launches']} time(s); "
                    f"{f['evaluations_without_lane_kernel']} of "
                    f"{f['evaluations']} swept evaluations without it")
            # Lanes > 1 never route to the single-lane kernel.
            if f["evaluation_single_launches"] or \
                    f["gradient_single_launches"]:
                failures.append(
                    f"{name} swept products launched single-lane "
                    f"gather_rowsum {f['evaluation_single_launches']} + "
                    f"{f['gradient_single_launches']} time(s)")
            if name == "COLMAJOR" and not (
                    f["gradient_lane_launches"] >= f["gradients"] >= 1):
                failures.append(
                    f"COLMAJOR swept gradients: {f['gradient_lane_launches']}"
                    f" lane launches in {f['gradients']}")
        if sum(f["lane_launches_by_shape"].values()) != f["launches"]:
            failures.append(f"{name} swept fit: lane launches by shape "
                            f"{f['lane_launches_by_shape']} do not sum to "
                            f"{f['launches']}")
    for layout, f in fits.items():
        for single in singles:
            j = single["lane"]
            gap = abs(f["loss"][j] - single["loss"]) / abs(single["loss"])
            single[f"{layout.lower()}_loss_gap_rel"] = gap
            single[f"{layout.lower()}_auc_gap"] = abs(f["auc"][j]
                                                      - single["auc"])
            if not gap <= SWEEP_LOSS_RTOL:
                failures.append(f"{layout} lane {j}: final loss "
                                f"{f['loss'][j]:.6g} vs single "
                                f"{single['loss']:.6g} ({gap:g} > "
                                f"{SWEEP_LOSS_RTOL:g})")
            if not abs(f["auc"][j] - single["auc"]) <= SWEEP_AUC_ATOL:
                failures.append(f"{layout} lane {j}: AUC {f['auc'][j]:.5f} "
                                f"vs single {single['auc']:.5f}")
    fast = lanes_past_bound(out["lane_shapes"])
    if fast:
        failures.append(f"gather_rowsum_lanes read faster than its HBM "
                        f"bound by more than {GRR_BOUND_SLACK - 1:.0%} at "
                        f"{fast}")
    if tuned["fit_point_calls"] or tuned["swept_solves"] < 1:
        failures.append(f"the tuned fit did not take the swept path "
                        f"({tuned['fit_point_calls']} _fit_point calls)")
    if len(tuned["lams"]) != TUNE_TRIALS or not all(
            SWEEP_LAMS[0] <= lam <= SWEEP_LAMS[-1] for lam in tuned["lams"]):
        failures.append(f"tuned trials' λ {tuned['lams']} out of range")
    if not max(tuned["auc"]) >= min(fits["ELL"]["auc"]):
        failures.append(f"the best tuned AUC {max(tuned['auc']):.5f} is "
                        f"below the grid's worst {min(fits['ELL']['auc'])}")
    out["failures"] = failures
    return out


# -- phase 10: the chunk-streamed, disk-spilled fixed effect and resume ------


class _StreamProbe:
    """Records, during a fit: every ``ChunkedGLMObjective`` built; each
    objective call with its kind, its chunk count and the B1 and
    lane-kernel launches made inside it; the device of every placed
    chunk leaf; for each chunked fixed-effect solve (``train`` or
    ``train_swept``) the prefetch.load occurrences of the installed
    injector before and after it and its result; and the wall of data
    preparation (``GameEstimator._prepare``)."""

    KINDS = ("value", "value_and_gradient", "hessian_vector",
             "hessian_diagonal", "value_swept", "value_and_gradient_swept",
             "_per_example")

    def __init__(self, injector=None):
        self.injector = injector

    def __enter__(self):
        self.objectives: list = []
        self.calls: list = []
        self.placed_devices: set = set()
        self.solves: list = []
        self.prepare_s = 0.0
        self._saved = []
        probe = self
        cls = streaming_mod.ChunkedGLMObjective

        def patch(owner, name, make):
            old = getattr(owner, name)
            self._saved.append((owner, name, old))
            setattr(owner, name, make(old))

        def init(old):
            def __init__(obj, *a, **kw):
                old(obj, *a, **kw)
                probe.objectives.append(obj)
            return __init__

        def place(old):
            def _place(obj, host):
                placed = old(obj, host)
                probe.placed_devices.update(
                    str(getattr(placed.batch, leaf).device)
                    for leaf in streaming_mod._LEAVES)
                return placed
            return _place

        def counted(kind):
            def make(old):
                def call(obj, *a, **kw):
                    b1 = gather_rowsum.launches
                    lanes = gather_rowsum_lanes.launches
                    out = old(obj, *a, **kw)
                    probe.calls.append({
                        "kind": kind, "chunks": obj.batch.n_chunks,
                        "b1": gather_rowsum.launches - b1,
                        "lanes": gather_rowsum_lanes.launches - lanes})
                    return out
                return call
            return make

        def solve(kind):
            def make(old):
                def train(coord, *a, **kw):
                    before = probe._loads()
                    t = time.perf_counter()
                    w, res = old(coord, *a, **kw)
                    probe.solves.append({
                        "kind": kind, "loads": (before, probe._loads()),
                        "solve_s": time.perf_counter() - t,
                        "value": res.value.detach().cpu().numpy(),
                        "iterations": np.asarray(
                            res.iterations.cpu() if torch.is_tensor(
                                res.iterations) else res.iterations)})
                    return w, res
                return train
            return make

        def prepare(old):
            def _prepare(est, train):
                t = time.perf_counter()
                out = old(est, train)
                probe.prepare_s += time.perf_counter() - t
                return out
            return _prepare

        patch(cls, "__init__", init)
        patch(cls, "_place", place)
        for kind in self.KINDS:
            patch(cls, kind, counted(kind))
        coord_cls = game_coordinates.ChunkedFixedEffectCoordinate
        patch(coord_cls, "train", solve("single"))
        patch(coord_cls, "train_swept", solve("swept"))
        patch(GameEstimator, "_prepare", prepare)
        return self

    def _loads(self) -> int:
        return (self.injector.occurrences("prefetch.load")
                if self.injector is not None else 0)

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            setattr(owner, name, old)
        return False

    def evaluations(self, kinds) -> list:
        return [c for c in self.calls if c["kind"] in kinds]

    def stores(self) -> list:
        return [o.batch.store for o in self.objectives
                if o.batch.store is not None]


def stream_config(device: str, spill_dir: str | None, chunk_rows: int,
                  **over) -> TrainingConfig:
    """Phase 7's ELL config 5 with the fixed effect chunk-streamed:
    ``chunk_rows`` a chunk, spilled to ``spill_dir`` with one chunk kept
    on the card, two decoded in host RAM and two prefetched, so every
    evaluation streams every chunk from disk."""
    over = {"chunk_rows": chunk_rows, "spill_dir": spill_dir,
            "chunk_max_resident": 1, "host_max_resident": 2,
            "prefetch_depth": 2, **over}
    return dataclasses.replace(game_config("ELL", device), **over)


def _stream_fit(config: TrainingConfig, train, valid,
                injector=None) -> dict:
    """One ``GameEstimator.fit`` under the probe, with the B1 and lane
    counts set to 0 just before and read just after, an injector
    installed (an empty one counts the seams' occurrences), and the run
    log's stages: data preparation, then per sweep each coordinate's
    wall and the validation's."""
    log_path = os.path.join(WORK, f"stream_{time.monotonic_ns()}.jsonl")
    injector = injector if injector is not None else faults.FaultInjector([])
    gather_rowsum.launches = gather_rowsum_lanes.launches = 0
    out = {"log": log_path}
    with RunLogger(log_path) as log, _StreamProbe(injector) as probe, \
            faults.injected(injector):
        t = time.perf_counter()
        try:
            out["results"] = GameEstimator(config).fit(train, valid,
                                                       run_logger=log)
        except faults.InjectedFault as e:
            out["raised"] = repr(e)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t
    out["launches"] = gather_rowsum.launches
    out["lane_launches"] = gather_rowsum_lanes.launches
    out["probe"] = probe
    events = read_run_log(log_path)
    stages: dict = {"prepare_s": probe.prepare_s}
    last_t: dict = {}
    for e in events:
        it = e.get("iteration")
        if e["event"] == "cd_coordinate":
            stages.setdefault(f"sweep{it}", {})[e["coordinate"]] = \
                e["duration_s"]
            last_t[it] = e["t"]
        elif e["event"] == "cd_validation" and it in last_t:
            stages[f"sweep{it}"]["validation"] = e["t"] - last_t[it]
    out["stages"] = stages
    out["events"] = events
    return out


def _fit_summary(fit: dict) -> dict:
    """AUC, the fixed effect's final loss and coefficients of a fit."""
    res = fit["results"][0]
    return {"auc": float(res.evaluations[EvaluatorType.AUC]),
            "fe_value": float(res.descent.history[-1]["global"]["value"]),
            "w": res.model.models["global"].coefficients.means.numpy()}


def _stream_gates(name: str, got: dict, want: dict, failures: list) -> dict:
    """AUC within ``STREAM_AUC_ATOL`` and the fixed effect's final loss
    within ``STREAM_LOSS_RTOL`` of ``want``; max |Δw| and bitwise
    equality reported."""
    gaps = {"auc_gap": abs(got["auc"] - want["auc"]),
            "loss_gap_rel": abs(got["fe_value"] - want["fe_value"])
            / abs(want["fe_value"]),
            "max_abs_dw": float(np.abs(got["w"] - want["w"]).max()),
            "bitwise": bool(np.array_equal(got["w"], want["w"]))}
    if not gaps["auc_gap"] <= STREAM_AUC_ATOL:
        failures.append(f"{name}: AUC {got['auc']:.5f} vs "
                        f"{want['auc']:.5f}")
    if not gaps["loss_gap_rel"] <= STREAM_LOSS_RTOL:
        failures.append(f"{name}: fixed-effect loss {got['fe_value']:.6g} "
                        f"vs {want['fe_value']:.6g}")
    return gaps


def _launch_gates(name: str, probe: _StreamProbe, kinds, counter: str,
                  device: str, failures: list) -> dict:
    """Every chunked evaluation of ``kinds`` launched ``counter`` (``b1``
    or ``lanes``) at least once a chunk, every placed leaf was on the
    card, and every store is quiesced with its chunk files present."""
    evals = probe.evaluations(kinds)
    out = {"evaluations": len(evals),
           "evaluation_launches": sum(c[counter] for c in evals),
           "chunks": max((c["chunks"] for c in evals), default=0),
           "placed_devices": sorted(probe.placed_devices)}
    if not evals:
        failures.append(f"{name}: no chunked evaluation")
    if device != "cpu":
        short = [c for c in evals if c[counter] < c["chunks"]]
        if short:
            failures.append(f"{name}: {len(short)} of {len(evals)} "
                            f"evaluations launched {counter} fewer times "
                            f"than their {out['chunks']} chunks")
        if not all(d.startswith("cuda") for d in probe.placed_devices):
            failures.append(f"{name}: chunks placed on "
                            f"{sorted(probe.placed_devices)}")
        if counter == "lanes" and any(c["b1"] for c in evals):
            failures.append(f"{name}: single-lane gather_rowsum inside "
                            "swept evaluations")
    for store in probe.stores():
        try:
            store.assert_quiesced()
        except RuntimeError as e:
            failures.append(f"{name}: {e}")
        missing = [i for i in range(store.n_chunks) if not store.has(i)]
        if missing:
            failures.append(f"{name}: chunk files {missing} missing")
        out["chunk_files"] = store.n_chunks - len(missing)
        out["rebuilds"] = store.rebuilds
    return out


def streamed_evaluation(co, w, time_it: bool = True) -> dict:
    """One ``value_and_gradient`` of a chunked objective after a warm-up
    call: the bytes and chunks placed, the prefetch consumer's wait and
    the prefetch thread's time loading and placing chunks in one pass;
    with ``time_it``, its CUDA-event ms, the wall of one call, the
    profiler's device ms split into kernels and host-to-device copies,
    the idle share and the copy rate."""
    co.value_and_gradient(w)
    before = dict(co.stats)
    co.value_and_gradient(w)
    out = {key: co.stats[key] - before[key] for key in co.stats}
    if time_it:
        def run():
            return co.value_and_gradient(w)

        out["ms"] = time_ms(run, 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t) * 1e3
        by_name = device_kernels_ms(run, n=3)
        copies = sum(ms for name, ms in by_name.items() if "Memcpy" in name)
        out["device_ms"] = sum(by_name.values()) or None
        out["device_copy_ms"] = copies
        out["device_kernel_ms"] = sum(by_name.values()) - copies
        if out["device_ms"]:
            out["idle_share"] = max(0.0, 1.0 - out["device_ms"] / out["ms"])
        out["h2d_gb_per_s"] = out["placed_bytes"] / (out["ms"] / 1e3) / 1e9
    return out


def _chunk_arrays(co):
    """The first chunk of a chunked objective, placed on its device."""
    return streaming_mod._handover(co._place(co.batch.chunk(0)))


def _fault_at(probe: _StreamProbe) -> int:
    """A prefetch.load occurrence three quarters into sweep 2's
    fixed-effect solve (past its first solver snapshots)."""
    singles = [s for s in probe.solves if s["kind"] == "single"]
    lo, hi = singles[1]["loads"]
    return lo + 3 * (hi - lo) // 4


def _read_log(path: str) -> list:
    """A run log's events, skipping a killed writer's unfinished line."""
    events = []
    with open(path) as f:
        for line in f:
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
    return events


def _resume_events(events: list) -> dict:
    cd = [e for e in events if e["event"] == "cd_resume"]
    solver = [e for e in events if e["event"] == "checkpoint_solver_resume"]
    return {"cd_resume": [(e["iteration"], e["coord_pos"]) for e in cd],
            "solver_resume_iterations": [e["iteration"] for e in solver]}


def phase_stream(ref: dict, device: str, seed: int = 7, n: int = GAME_ROWS,
                 d: int = D, n_entities: int = N_ENTITIES,
                 chunk_rows: int = STREAM_CHUNK_ROWS,
                 time_it: bool = True) -> dict:
    """Phases 10a–10c (module docstring): config 5 with its fixed effect
    chunk-streamed from disk against phase 7's resident ELL fit
    (``ref``: its AUC, final loss and coefficients), the same with the
    chunks kept on the card, a fault inside sweep 2's fixed-effect solve
    and its resume (and again with a chunk file corrupted), then the
    training driver SIGKILLed mid-solve and resumed."""
    failures: list = []
    t = time.perf_counter()
    data = make_game_data(seed, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    del data
    out = {"rows": n, "train_rows": n_train, "chunk_rows": chunk_rows,
           "data_s": time.perf_counter() - t}
    spill = os.path.join(WORK, "stream_spill")

    # 10a: streamed from disk.
    fit = _stream_fit(stream_config(device, spill, chunk_rows), train, valid)
    probe = fit["probe"]
    a = _fit_summary(fit)
    a["blocks"] = {name: m.coefficient_blocks for name, m in
                   fit["results"][0].model.models.items()
                   if hasattr(m, "coefficient_blocks")}
    out["10a"] = {"wall_s": fit["wall_s"], "stages": fit["stages"],
                  "launches": fit["launches"],
                  **_launch_gates("10a", probe, ("value",
                                                 "value_and_gradient"),
                                  "b1", device, failures),
                  **_stream_gates("10a vs phase 7", a, ref, failures),
                  "fe_solves": [{"solve_s": s["solve_s"],
                                 "iterations": int(s["iterations"])}
                                for s in probe.solves]}
    fe = next(o for o in probe.objectives if o.batch.store is not None)
    co = streaming_mod.ChunkedGLMObjective(
        fe.objective, fe.batch, max_resident=0, prefetch_depth=2,
        device=device)
    w = torch.from_numpy(a["w"]).to(device)
    out["10a"]["evaluation"] = streamed_evaluation(co, w, time_it and
                                                   device != "cpu")
    chunk = _chunk_arrays(co)
    scale = max(1.0, float(w.abs().max()) * float(chunk.values.abs().max()))
    out["kernel_shape"] = check_b1_case(
        f"stream_chunk_{chunk.values.shape[0]}x{chunk.values.shape[1]}",
        w, chunk.values, chunk.col_ids, ATOL * scale, time_it=time_it)
    out["kernel_shape"]["launches"] = fit["launches"]
    del co, chunk, fe
    fault_at = _fault_at(probe)
    del fit, probe

    # The same fit with every chunk kept on the card (no spill).
    n_chunks = -(-n_train // chunk_rows)
    fit = _stream_fit(stream_config(device, None, chunk_rows,
                                    chunk_max_resident=n_chunks),
                      train, valid)
    r = _fit_summary(fit)
    fe = fit["probe"].objectives[0]
    out["10a_resident"] = {
        "wall_s": fit["wall_s"], "stages": fit["stages"],
        **_stream_gates("10a resident vs phase 7", r, ref, failures)}
    out["10a_resident"]["evaluation"] = streamed_evaluation(
        fe, w, time_it and device != "cpu")
    del fit, fe

    # 10b: a fault inside sweep 2's fixed-effect solve, then resume.
    ck = os.path.join(WORK, "stream_ck")
    ck_cfg = dict(checkpoint_dir=ck,
                  checkpoint_every_solver_iters=STREAM_CKPT_EVERY)
    inj = faults.FaultInjector([faults.Fault(site="prefetch.load",
                                             kind="error", at=fault_at)])
    fit = _stream_fit(stream_config(device, spill, chunk_rows, **ck_cfg), train, valid,
                      injector=inj)
    b = {"fault_at": fault_at, "raised": fit.get("raised"),
         "fired": inj.fired}
    if "raised" not in fit:
        failures.append("10b: the injected prefetch fault did not raise")
    shutil.copytree(ck, ck + "_copy")
    fit = _stream_fit(stream_config(device, spill, chunk_rows, resume=True,
                                    **ck_cfg),
                      train, valid)
    b.update(_resume_events(fit["events"]), wall_s=fit["wall_s"],
             **_stream_gates("10b resume vs 10a", _fit_summary(fit), a,
                             failures))
    if not any(it > 0 for it in b["solver_resume_iterations"]):
        failures.append(f"10b: no solver snapshot restored at an "
                        f"iteration > 0 ({b['solver_resume_iterations']})")
    out["10b"] = b

    # The same resume with a chunk file corrupted at its first load.
    inj = faults.FaultInjector([faults.Fault(site="store.load",
                                             kind="corrupt_file", at=0)])
    fit = _stream_fit(stream_config(device, spill, chunk_rows, resume=True,
                                    checkpoint_dir=ck + "_copy",
                                    checkpoint_every_solver_iters=
                                    STREAM_CKPT_EVERY),
                      train, valid, injector=inj)
    c = {"fired": inj.fired, "wall_s": fit["wall_s"],
         "rebuilds": sum(s.rebuilds for s in fit["probe"].stores()),
         **_stream_gates("10b corrupt-chunk resume vs 10a",
                         _fit_summary(fit), a, failures)}
    if not c["fired"] or c["rebuilds"] < 1:
        failures.append(f"10b: the corrupted chunk was not rebuilt "
                        f"({c['fired']}, {c['rebuilds']} rebuilds)")
    out["10b_corrupt"] = c
    del fit, train, valid

    # 10c: the driver, SIGKILLed once a solver snapshot appears.
    out["10c"] = phase_stream_driver(
        [] if device != "cpu" else ["--device", "cpu"], failures)
    out["fit_10a"] = a                                # phase 11's reference
    out["failures"] = failures
    return out


def phase_stream_driver(device_args: list, failures: list) -> dict:
    """Phase 8's config-4 fixture through ``python -m
    photon_ml_torch.cli.game_training_driver`` with its fixed effect
    chunked (``STREAM_DRIVER_CHUNK_ROWS``), spilled, and snapshotted
    every solver iteration: a subprocess SIGKILLed once a
    ``solver_*.npz`` appears, then rerun with ``--resume``; its model
    against an uninterrupted run's (both in this process), within phase
    8's coefficient tolerance."""
    from photon_ml_torch.cli import game_training_driver

    cfg = driver_config(os.path.join(WORK, "stream_driver_killed"))
    cfg["chunk_rows"] = STREAM_DRIVER_CHUNK_ROWS
    cfg["n_iterations"] = GAME_SWEEPS
    for c in cfg["coordinates"]:
        c["optimizer"].update(max_iters=STREAM_DRIVER_ITERS,
                              tolerance=1e-12)
    cfg_path = os.path.join(WORK, "stream_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    spill = os.path.join(WORK, "stream_driver_spill")
    ck = os.path.join(WORK, "stream_driver_ck")
    args = ["--config", cfg_path, "--spill-dir", spill,
            "--checkpoint-dir", ck, "--checkpoint-every-solver-iters", "1",
            *device_args]
    out: dict = {}
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_torch.cli.game_training_driver",
         *args], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    killed = False
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and proc.poll() is None:
            if glob.glob(os.path.join(ck, "solver_*.npz")):
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.01)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["killed_after_s"] = time.perf_counter() - t
    out["victim_rc"] = proc.returncode
    if not killed:
        failures.append(f"10c: the driver was not killed mid-solve (rc "
                        f"{proc.returncode}: "
                        f"{proc.stderr.read()[-2000:].decode(errors='replace')})")
        proc.stderr.close()
        return out
    proc.stderr.close()
    out["snapshots_at_kill"] = sorted(os.listdir(ck))
    t = time.perf_counter()
    # In this process; the drivers' summaries stay off this run's stdout.
    with contextlib.redirect_stdout(io.StringIO()):
        game_training_driver.main([*args, "--resume"])
        out["resume_wall_s"] = time.perf_counter() - t
        full_dir = os.path.join(WORK, "stream_driver_full")
        game_training_driver.main([
            "--config", cfg_path, "--output-dir", full_dir, "--spill-dir",
            spill, "--checkpoint-dir", ck + "_full",
            "--checkpoint-every-solver-iters", "1", *device_args])
    got, _ = load_game_model(os.path.join(cfg["output_dir"], "model"))
    want, _ = load_game_model(os.path.join(full_dir, "model"))
    w_got = got.models["global"].coefficients.means.numpy()
    w_want = want.models["global"].coefficients.means.numpy()
    out["max_abs_dw"] = float(np.abs(w_got - w_want).max())
    out["bitwise"] = bool(np.array_equal(w_got, w_want))
    events = _read_log(os.path.join(cfg["output_dir"], "run_log.jsonl"))
    out["run_headers"] = sum(e["event"] == "run_header" for e in events)
    out.update(_resume_events(events))
    if not np.allclose(w_got, w_want, rtol=DRIVER_COEF_TOL,
                       atol=DRIVER_COEF_TOL):
        failures.append(f"10c: the resumed model's coefficients differ by "
                        f"{out['max_abs_dw']:g} from the uninterrupted "
                        "run's")
    if out["run_headers"] != 2 or not (out["cd_resume"]
                                       or out["solver_resume_iterations"]):
        failures.append(f"10c: the resumed run log holds "
                        f"{out['run_headers']} runs, CD resumes "
                        f"{out['cd_resume']} and solver resumes "
                        f"{out['solver_resume_iterations']}")
    return out


def phase_stream_sweep(data: dict, ref: dict, device: str,
                       chunk_rows: int = STREAM_CHUNK_ROWS,
                       time_it: bool = True) -> dict:
    """Phase 10d: phase 9's ELL grid (config 1, 8 λ, L-BFGS 20) with the
    fixed effect chunk-streamed from disk: every swept evaluation runs
    the lane kernel on every chunk, and lanes ``SWEEP_CHECK_LANES`` end
    within phase 9's gates of its resident swept lanes (``ref``: phase
    9's ELL fit)."""
    failures: list = []
    train, valid = sweep_data(data)
    cfg = sweep_config("ELL", device, chunk_rows=chunk_rows,
                       spill_dir=os.path.join(WORK, "sweep_spill"),
                       chunk_max_resident=1, host_max_resident=2,
                       prefetch_depth=2)
    fit = _stream_fit(cfg, train, valid)
    probe = fit["probe"]
    swept = [s for s in probe.solves if s["kind"] == "swept"]
    order = np.argsort(-np.asarray(SWEEP_LAMS), kind="stable")
    loss = np.full(len(SWEEP_LAMS), np.nan)
    if swept:
        loss[order] = swept[-1]["value"]
    aucs = [float(r.evaluations[EvaluatorType.AUC]) for r in fit["results"]]
    out = {"wall_s": fit["wall_s"], "prepare_s": probe.prepare_s,
           "swept_solves": len(swept),
           "swept_solve_s": sum(s["solve_s"] for s in swept),
           "resident_swept_solve_s": ref["swept_solve_s"],
           "lane_launches": fit["lane_launches"],
           **_launch_gates("10d", probe, ("value_swept",
                                          "value_and_gradient_swept"),
                           "lanes", device, failures),
           "loss": loss.tolist(), "auc": aucs, "lanes": {}}
    if len(swept) != 1:
        failures.append(f"10d: {len(swept)} swept solves")
    for j in SWEEP_CHECK_LANES:
        gap = abs(loss[j] - ref["loss"][j]) / abs(ref["loss"][j])
        auc_gap = abs(aucs[j] - ref["auc"][j])
        out["lanes"][j] = {"loss_gap_rel": gap, "auc_gap": auc_gap}
        if not gap <= SWEEP_LOSS_RTOL:
            failures.append(f"10d lane {j}: loss {loss[j]:.6g} vs "
                            f"{ref['loss'][j]:.6g}")
        if not auc_gap <= SWEEP_AUC_ATOL:
            failures.append(f"10d lane {j}: AUC {aucs[j]:.5f} vs "
                            f"{ref['auc'][j]:.5f}")
    fe = next(o for o in probe.objectives if o.batch.store is not None)
    chunk = _chunk_arrays(fe)
    W = torch.stack([r.model.models["global"].coefficients.means
                     for r in fit["results"]]).to(device)
    table = W.T.contiguous()
    atol = ATOL * max(1.0, float(table.abs().max())
                      * float(chunk.values.abs().max()))
    out["kernel_shape"] = check_lanes_case(
        f"stream_chunk_{chunk.values.shape[0]}x{chunk.values.shape[1]}"
        f"_L{table.shape[1]}", table, chunk.values, chunk.col_ids, atol,
        time_it=time_it)
    out["kernel_shape"]["launches"] = fit["lane_launches"]
    out["failures"] = failures
    return out


# -- phase 11: out-of-core GAME training: streamed random effects, the fused
# cycle, and their resumes ----------------------------------------------------


class _OocProbe:
    """Records, during a fit: the coordinates every
    ``GameEstimator._build_coordinates`` returned, the fused engines
    built, and for every fused pass its B1 launches, its chunks, the
    reads of the fixed-effect and sidecar stores it made and the bytes it
    placed on the card."""

    def __enter__(self):
        self.coords: list = []
        self.engines: list = []
        self.passes: list = []
        self._saved = []
        probe = self

        def patch(owner, name, make):
            old = getattr(owner, name)
            self._saved.append((owner, name, old))
            setattr(owner, name, make(old))

        def build(old):
            def _build_coordinates(est, *a, **kw):
                out = old(est, *a, **kw)
                probe.coords.append(out)
                return out
            return _build_coordinates

        def engine(old):
            def _fused_engine(est, *a, **kw):
                out = old(est, *a, **kw)
                probe.engines.append(out)
                return out
            return _fused_engine

        def one_pass(old):
            def _pass(eng, *a, **kw):
                stores = [eng.chunked.store, eng.sidecar_store]
                reads = [0 if s is None else s.loads + s.hits
                         for s in stores]
                b1 = gather_rowsum.launches
                placed = eng._placer.placed_bytes
                out = old(eng, *a, **kw)
                after = [0 if s is None else s.loads + s.hits
                         for s in stores]
                probe.passes.append({
                    "b1": gather_rowsum.launches - b1,
                    "chunks": eng.chunked.n_chunks,
                    "fe_reads": after[0] - reads[0],
                    "sidecar_reads": after[1] - reads[1],
                    "bytes": eng._placer.placed_bytes - placed})
                return out
            return _pass

        patch(GameEstimator, "_build_coordinates", build)
        patch(GameEstimator, "_fused_engine", engine)
        patch(fused_mod.FusedCycleEngine, "_pass", one_pass)
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            setattr(owner, name, old)
        return False


def _ooc_fit(config: TrainingConfig, train, valid, injector=None) -> dict:
    """One ``GameEstimator.fit`` under ``_OocProbe``, the B1 count set to
    0 just before and read just after, an injector installed (an empty
    one counts the seams' occurrences), and its run log's events."""
    log_path = os.path.join(WORK, f"ooc_{time.monotonic_ns()}.jsonl")
    injector = injector if injector is not None else faults.FaultInjector([])
    gather_rowsum.launches = 0
    out = {"log": log_path, "injector": injector}
    with RunLogger(log_path) as log, _OocProbe() as probe, \
            faults.injected(injector):
        t = time.perf_counter()
        try:
            out["results"] = GameEstimator(config).fit(train, valid,
                                                       run_logger=log)
        except faults.InjectedFault as e:
            out["raised"] = repr(e)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t
    out["launches"] = gather_rowsum.launches
    out["probe"] = probe
    out["events"] = read_run_log(log_path)
    return out


def _ooc_summary(fit: dict) -> dict:
    """AUC, the fixed effect's and every random effect's coefficients."""
    res = fit["results"][0]
    models = res.model.models
    return {"auc": float(res.evaluations[EvaluatorType.AUC]),
            "w": models["global"].coefficients.means.numpy(),
            "blocks": {name: [b.numpy() for b in m.coefficient_blocks]
                       for name, m in models.items()
                       if hasattr(m, "coefficient_blocks")}}


def _same_model(a: dict, b: dict) -> bool:
    return (np.array_equal(a["w"], b["w"])
            and all(np.array_equal(x, y)
                    for name in a["blocks"]
                    for x, y in zip(a["blocks"][name], b["blocks"][name])))


def _re_sweeps(events: list) -> dict:
    """A random effect's per-sweep record from the run log's
    ``cd_coordinate`` events: wall, entities solved, newly retired,
    retired at the sweep's start, chunks streamed."""
    out: dict = {}
    for e in events:
        if e["event"] != "cd_coordinate" or e["coordinate"] == "global":
            continue
        rec = out.setdefault(e["coordinate"], {"wall_s": [], "solved": [],
                                               "newly_retired": [],
                                               "retired": [], "chunks": []})
        rec["wall_s"].append(e["duration_s"])
        rec["solved"].append(e.get("entities_solved"))
        rec["newly_retired"].append(e.get("entities_newly_retired"))
        rec["retired"].append(e.get("entities_retired"))
        rec["chunks"].append(e.get("chunks_streamed"))
    return out


def _split_device(by_name: dict, solve_words=()) -> dict:
    """Device ms by part: B1, the ``index_add_`` kernels, the kernels
    named by ``solve_words`` (the batched Newton solves), host ↔ card
    copies, the rest; and the five largest kernels by name."""
    parts = {"gather_rowsum": 0.0, "index_add": 0.0, "solves": 0.0,
             "copies": 0.0, "rest": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("gather_rowsum" if "gather_rowsum" in name
               else "index_add" if "indexFunc" in name
               else "copies" if "Memcpy" in name
               else "solves" if any(w in low for w in solve_words)
               else "rest")
        parts[key] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    parts["largest"] = {name[:96]: ms for name, ms in top}
    return parts


_SOLVE_WORDS = ("getr", "lu_", "trsm", "solve", "pivot", "laswp", "batch")


def _profile_call(fn, time_it: bool) -> dict:
    """One call's wall (synchronized), its device ms by part and the idle
    share; the parts and the idle share only with ``time_it``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {"wall_ms": (time.perf_counter() - t) * 1e3}
    if time_it:
        by_name = device_kernels_ms(fn, n=1)
        out["device"] = _split_device(by_name, _SOLVE_WORDS)
        busy = sum(by_name.values())
        out["device_ms"] = busy or None
        if busy:
            out["idle_share"] = max(0.0, 1.0 - busy / out["wall_ms"])
    return out


def _store_gates(name: str, stores: list, failures: list) -> dict:
    """Every store quiesced with every chunk file present."""
    out = {"stores": len(stores), "chunk_files": 0, "rebuilds": 0}
    if not stores:
        failures.append(f"{name}: no chunk store")
    for store in stores:
        try:
            store.assert_quiesced()
        except RuntimeError as e:
            failures.append(f"{name}: {e}")
        missing = [i for i in range(store.n_chunks) if not store.has(i)]
        if missing:
            failures.append(f"{name}: chunk files {missing} missing")
        out["chunk_files"] += store.n_chunks - len(missing)
        out["rebuilds"] += store.rebuilds
    return out


def _joint_value(engine, summary: dict) -> float:
    """The fused engine's joint objective (data, L2 terms) at a fit's
    coefficients: one more pass, its statistics unused."""
    w = torch.from_numpy(summary["w"]).to(engine.device)
    tabs = [engine._flatten(r, summary["blocks"][r.name])
            for r in engine.res]
    acc, _, _ = engine._pass(w, tabs, engine._actives())
    return engine._total_value(acc[0], w, tabs)


def _fused_against_cpu(part, valid, device: str, chunk_rows: int,
                       cycles: int, failures: list) -> dict:
    """The fused fit over ``part`` on ``device`` and with the port's CPU
    engine, ``cycles`` cycles each: every cycle's (value, step scale)
    within ``FUSED_TRAJ_RTOL`` relative, the coefficients within
    ``FUSED_PARITY_ATOL``."""
    runs = {}
    for tag, dev in (("card", device), ("cpu", "cpu")):
        fit = _ooc_fit(stream_config(
            dev, os.path.join(WORK, f"ooc_fused_check_{tag}"), chunk_rows,
            cd_fused=True, n_iterations=cycles,
            validate_per_iteration=False), part, valid)
        cyc = [e for e in fit["events"] if e["event"] == "cd_fused_cycle"]
        runs[tag] = {"value": np.array([e["value"] for e in cyc]),
                     "alpha": np.array([e["alpha"] for e in cyc]),
                     "rejected": sum(bool(e.get("rejected")) for e in cyc),
                     "wall_s": fit["wall_s"], **_ooc_summary(fit)}
    card, cpu = runs["card"], runs["cpu"]

    def rel(key):
        if len(card[key]) != len(cpu[key]):
            return float("inf")
        return float((np.abs(card[key] - cpu[key])
                      / np.abs(cpu[key])).max())

    out = {"rows": len(part.labels), "cycles": cycles,
           "value_rel": rel("value"), "alpha_rel": rel("alpha"),
           "max_abs_dw": float(np.abs(card["w"] - cpu["w"]).max()),
           "max_abs_dblock": max(
               float(np.abs(x - y).max()) for name in card["blocks"]
               for x, y in zip(card["blocks"][name], cpu["blocks"][name])),
           "rejected": [card["rejected"], cpu["rejected"]],
           "auc": [card["auc"], cpu["auc"]],
           "wall_s": [card["wall_s"], cpu["wall_s"]]}
    if len(card["value"]) != cycles or not (
            out["value_rel"] <= FUSED_TRAJ_RTOL
            and out["alpha_rel"] <= FUSED_TRAJ_RTOL):
        failures.append(f"11b: the card's fused trajectory is "
                        f"{out['value_rel']:.3g} (value) and "
                        f"{out['alpha_rel']:.3g} (alpha) from the CPU "
                        f"engine's")
    if not max(out["max_abs_dw"], out["max_abs_dblock"]) \
            <= FUSED_PARITY_ATOL:
        failures.append(f"11b: the card's fused coefficients are "
                        f"{out['max_abs_dw']:.3g} (fixed effect) and "
                        f"{out['max_abs_dblock']:.3g} (random effects) "
                        f"from the CPU engine's")
    return out


def _fault_mid(injector) -> int:
    """The prefetch.load occurrence halfway through a fit."""
    return injector.occurrences("prefetch.load") // 2


def phase_out_of_core(ref_10a: dict, device: str, seed: int = 7,
                      n: int = GAME_ROWS, d: int = D,
                      n_entities: int = N_ENTITIES,
                      chunk_rows: int = STREAM_CHUNK_ROWS,
                      re_chunk: int = RE_CHUNK_ENTITIES,
                      sweeps: int = RE_STREAM_SWEEPS,
                      cycles: int = FUSED_CYCLES,
                      time_it: bool = True) -> dict:
    """Phase 11 (module docstring) on phase 10's data; ``ref_10a`` is
    phase 10a's per-coordinate streamed fit (its AUC, fixed-effect
    coefficients and random-effect blocks)."""
    failures: list = []
    t = time.perf_counter()
    data = make_game_data(seed, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    del data
    out = {"rows": n, "train_rows": n_train, "data_s": time.perf_counter() - t}

    # 11a: the random effects streamed from disk, retirement on.
    resident = _ooc_fit(game_config("ELL", device, sweeps=sweeps), train,
                        valid)
    r = _ooc_summary(resident)
    re_spill = os.path.join(WORK, "ooc_re_spill")
    re_cfg = dict(re_chunk_entities=re_chunk, spill_dir=re_spill,
                  re_retirement=True, host_max_resident=2, prefetch_depth=2)
    streamed = _ooc_fit(dataclasses.replace(
        game_config("ELL", device, sweeps=sweeps), **re_cfg), train, valid)
    s = _ooc_summary(streamed)
    coords = streamed["probe"].coords[-1]
    re_coords = {name: c for name, c in coords.items()
                 if isinstance(c, game_coordinates
                               .StreamedRandomEffectCoordinate)}
    a = {"sweeps": sweeps, "chunk_entities": re_chunk,
         "chunk_sizes": {k: c.chunk_ents for k, c in re_coords.items()},
         "wall_s": streamed["wall_s"], "resident_wall_s": resident["wall_s"],
         "launches": streamed["launches"],
         "auc": s["auc"], "resident_auc": r["auc"],
         "auc_gap": abs(s["auc"] - r["auc"]),
         "max_abs_dw": float(np.abs(s["w"] - r["w"]).max()),
         "re": _re_sweeps(streamed["events"]),
         "resident_re_wall_s": {k: v["wall_s"] for k, v in
                                _re_sweeps(resident["events"]).items()},
         **_store_gates("11a", [c.store for c in re_coords.values()],
                        failures)}
    if set(re_coords) != {"per_user", "per_item"}:
        failures.append(f"11a: streamed coordinates {sorted(re_coords)}")
    if not a["auc_gap"] <= STREAM_AUC_ATOL:
        failures.append(f"11a: AUC {s['auc']:.5f} vs resident {r['auc']:.5f}")
    for name, rec in a["re"].items():
        solved = rec["solved"]
        if any(x < y for x, y in zip(solved, solved[1:])):
            failures.append(f"11a: {name} solved {solved}: not "
                            "non-increasing")
    a["retired_any"] = any(sum(x or 0 for x in rec["newly_retired"])
                           for rec in a["re"].values())
    user = re_coords.get("per_user")
    if user is not None and user._prev_offsets is not None:
        off = torch.from_numpy(user._prev_offsets.copy())
        a["sweep_profile"] = _profile_call(lambda: user.train(off), time_it)
        a["sweep_profile"]["placed_mb"] = user._placer.placed_bytes / 1e6
        # Retirement at full width: the profiled sweeps re-solved at the
        # offsets of the fit's last, so the converged entities are
        # candidates; committed, the next sweep solves only the rest.
        before = user.train(off)[1]["entities_solved"]
        retired = user.retire_converged()
        after = user.train(off)[1]
        a["still_offsets"] = {"solved": before, "retired": retired,
                              "solved_next": after["entities_solved"],
                              "woken": after["entities_woken"]}
        if not (retired > 0 and after["entities_solved"] == before - retired
                and after["entities_woken"] == 0):
            failures.append(f"11a: still offsets retired {retired} of "
                            f"{before}, then solved "
                            f"{after['entities_solved']}")
    out["11a"] = a
    re_fault_at = _fault_mid(streamed["injector"])
    del resident, streamed, coords, re_coords, user

    # 11b: the fused cycle over phase 10a's chunks, spilled.
    fe_spill = os.path.join(WORK, "ooc_fused_spill")
    fused_cfg = stream_config(device, fe_spill, chunk_rows, cd_fused=True,
                              n_iterations=cycles,
                              validate_per_iteration=False)
    fused = _ooc_fit(fused_cfg, train, valid)
    f = _ooc_summary(fused)
    check = _fused_against_cpu(train.take(slice(
        0, min(n_train, FUSED_CHECK_CHUNKS * chunk_rows))), valid, device,
        chunk_rows, cycles, failures)
    engine = fused["probe"].engines[-1]
    passes = fused["probe"].passes
    K = engine.chunked.n_chunks
    cyc = [e for e in fused["events"] if e["event"] == "cd_fused_cycle"]
    b = {"cycles": cycles, "chunks": K, "chunk_rows": chunk_rows,
         "wall_s": fused["wall_s"], "launches": fused["launches"],
         "auc": f["auc"], "ref_10a_auc": ref_10a["auc"],
         "auc_gap": abs(f["auc"] - ref_10a["auc"]),
         "max_abs_dw": float(np.abs(f["w"] - ref_10a["w"]).max()),
         "auc_gap_vs_11a_resident": abs(f["auc"] - r["auc"]),
         "max_abs_dw_vs_11a_resident": float(np.abs(f["w"] - r["w"]).max()),
         "max_abs_dw_10a_vs_11a_resident": float(
             np.abs(ref_10a["w"] - r["w"]).max()),
         "rejections": engine.rejections,
         "passes": len(passes),
         "pass_b1": sorted({p["b1"] for p in passes}),
         "pass_reads": sorted({(p["fe_reads"], p["sidecar_reads"])
                               for p in passes}),
         "cycle_ms": [e["duration_s"] * 1e3 for e in cyc],
         "alpha": [e["alpha"] for e in cyc],
         "value": [e["value"] for e in cyc],
         "entities_retired": [e["entities_retired"] for e in cyc],
         "against_cpu": check,
         **_store_gates("11b", [engine.chunked.store, engine.sidecar_store]
                        if engine.sidecar_store is not None
                        else [engine.chunked.store], failures)}
    if engine.sidecar_store is None:
        failures.append("11b: the sidecars were not spilled")
    if not b["auc_gap"] <= STREAM_AUC_ATOL:
        failures.append(f"11b: AUC {f['auc']:.5f} vs 10a "
                        f"{ref_10a['auc']:.5f}")
    b["accepted_cycles"] = sum(not e.get("rejected") for e in cyc)
    if not np.isfinite(f["w"]).all():
        failures.append("11b: non-finite fixed-effect coefficients")
    b["joint_value"] = _joint_value(engine, f)
    b["joint_value_10a"] = _joint_value(engine, ref_10a)
    b["joint_value_11a_resident"] = _joint_value(engine, r)
    if not cycles + 1 <= len(passes) <= cycles + 2 or len(cyc) != cycles:
        failures.append(f"11b: {len(passes)} passes, {len(cyc)} cycles for "
                        f"{cycles} cycles")
    if device != "cpu" and any(p["b1"] < p["chunks"] for p in passes):
        failures.append(f"11b: a pass launched B1 fewer times than its "
                        f"{K} chunks: {b['pass_b1']}")
    if any((p["fe_reads"], p["sidecar_reads"]) != (K, K) for p in passes):
        failures.append(f"11b: a pass read {b['pass_reads']} (fixed "
                        f"effect, sidecar) chunks, not {K} each")
    leaves = engine._load(0)
    b["bytes_a_pass"] = {
        "fixed_effect": K * sum(v.nbytes for k, v in leaves.items()
                                if k.startswith("fe.")),
        "sidecar": K * sum(v.nbytes for k, v in leaves.items()
                           if not k.startswith("fe."))}
    b["placed_bytes_a_pass"] = passes[-1]["bytes"] if passes else 0
    models = fused["results"][0].model.models
    coefs = {"global": models["global"].coefficients.means.to(device)}
    coefs.update({name: m.coefficient_blocks for name, m in models.items()
                  if hasattr(m, "coefficient_blocks")})
    b["cycle_profile"] = _profile_call(lambda: engine.run_cycle(coefs),
                                       time_it)
    chunk = streaming_mod.ArrayPlacer.handover(engine._placer.place(leaves))
    w = coefs["global"].contiguous()
    scale = max(1.0, float(w.abs().max())
                * float(chunk["fe.values"].abs().max()))
    vals, ids = chunk["fe.values"], chunk["fe.col_ids"]
    out["kernel_shape"] = check_b1_case(
        f"fused_chunk_{vals.shape[0]}x{vals.shape[1]}", w, vals, ids,
        ATOL * scale, time_it=time_it)
    out["kernel_shape"]["launches"] = fused["launches"]
    out["11b"] = b
    fused_fault_at = (cycles // 2) * K + K // 2
    del fused, engine, chunk, leaves, passes

    # 11c: a prefetch fault in each fit, then the resume from its snapshot.
    c: dict = {}
    for name, cfg, at, want in (
            ("fused", dataclasses.replace(
                fused_cfg, checkpoint_dir=os.path.join(WORK, "ooc_ck_f"),
                checkpoint_every_sweeps=FUSED_CKPT_EVERY), fused_fault_at, f),
            ("re_stream", dataclasses.replace(
                game_config("ELL", device, sweeps=sweeps), **re_cfg,
                checkpoint_dir=os.path.join(WORK, "ooc_ck_re")),
             re_fault_at, s)):
        inj = faults.FaultInjector([faults.Fault(site="prefetch.load",
                                                 kind="error", at=at)])
        first = _ooc_fit(cfg, train, valid, injector=inj)
        if "raised" not in first:
            failures.append(f"11c {name}: the injected fault did not raise")
        again = _ooc_fit(dataclasses.replace(cfg, resume=True), train, valid)
        got = _ooc_summary(again)
        resumes = [e for e in again["events"] if e["event"] == "cd_resume"]
        rec = {"fault_at": at, "fired": inj.fired,
               "raised": first.get("raised"),
               "resumed_at": [x["iteration"] for x in resumes],
               "wall_s": first["wall_s"] + again["wall_s"],
               "auc_gap": abs(got["auc"] - want["auc"]),
               "max_abs_dw": float(np.abs(got["w"] - want["w"]).max()),
               "bitwise": _same_model(got, want)}
        if not resumes or not resumes[0]["iteration"] > 0:
            failures.append(f"11c {name}: no resume past iteration 0 "
                            f"({rec['resumed_at']})")
        ref_auc = ref_10a["auc"] if name == "fused" else r["auc"]
        if not abs(got["auc"] - ref_auc) <= STREAM_AUC_ATOL:
            failures.append(f"11c {name}: AUC {got['auc']:.5f} vs "
                            f"{ref_auc:.5f}")
        c[name] = rec
        del first, again
    out["11c"] = c
    out["failures"] = failures
    return out


# -- main ---------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} "
          f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    # Full float32 products: TF32 off for both matmul and cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        t = time.perf_counter()
        libs = _build.build_all()
        print(f"phase 2 build: {len(libs)} kernel(s) in "
              f"{time.perf_counter() - t:.2f} s: "
              + ", ".join(os.path.relpath(p, REPO) for p in libs))

        t = time.perf_counter()
        train = phase_train_build(seed=3, n=TRAIN_ROWS, device="cuda")
        train["info"]["plan_stats"] = train["grr"].grr.plan_stats()
        train["info"]["card"] = card
        print(f"phase 6 build ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"train_build": train["info"]}))

        model, host = make_model(seed=0)
        table = torch.from_numpy(host["w"]).cuda()
        t = time.perf_counter()
        kernels = [phase_kernels(table, seed=1, ell=train["ell"],
                                 colmajor=train["colmajor"].colmajor)]
        kernels += phase_kernels_grr(train["grr"].grr, seed=5)
        kernels.append(phase_kernels_lanes(train["ell"],
                                           train["colmajor"].colmajor,
                                           seed=9))
        print(f"phase 3 kernel check: ok in {time.perf_counter() - t:.2f} s")

        model_dir = os.path.join(WORK, "model")
        save_game_model(model, TaskType.LOGISTIC_REGRESSION, model_dir)
        rng = np.random.default_rng(2)
        rows = make_rows(rng, host, CLIENTS * REQUESTS * ROWS)
        ref_m, ref_p = reference(host, rows)
        cfg = serving_config(model_dir, os.path.join(WORK, "spill"), "cuda")
        gather_rowsum.launches = 0
        serving = phase_serving(cfg, rows, ref_m, ref_p)
        kernels[0]["launches"] = gather_rowsum.launches
        if kernels[0]["launches"] < max(1, serving["batches"]):
            raise AssertionError(
                f"gather_rowsum launched {kernels[0]['launches']} time(s) "
                f"for {serving['batches']} served batches")
        serving["card"] = card
        print("phase 4 serving: " + json.dumps({"serving": serving}))
        print("phase 4 breakdown: " + json.dumps(
            {"breakdown": phase_breakdown(cfg, rows)}))

        cli_rows = make_rows(rng, host, ROWS)
        cli_m, cli_p = reference(host, cli_rows)
        cli = phase_cli(cfg, cli_rows, cli_m, cli_p)
        print("phase 5 cli: " + json.dumps({"cli": cli}))

        t = time.perf_counter()
        training = phase_training(train)
        training["card"] = card
        print(f"phase 6 training ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"training": training}))
        if training["failures"]:
            raise AssertionError("phase 6: " + "; ".join(
                training["failures"]))
        kernels[0]["launches_ell_fit"] = training[
            "ell_gather_rowsum_launches"]
        kernels[0]["launches_colmajor_fit"] = training[
            "colmajor_gather_rowsum_launches"]
        for k in kernels[1:3]:          # the GRR kernels
            k["launches"] = training["launches"][k["name"]]
            if k["launches"] < 1:
                raise AssertionError(f"{k['name']} was not launched by "
                                     "the GRR fit")
        sweep = {key: train[key] for key in ("rows", "labels", "test_rows",
                                              "test_labels")}
        del train

        t = time.perf_counter()
        game = phase_game(seed=7, n=GAME_ROWS, device="cuda")
        game["card"] = card
        game_ell_fe_w = game.pop("ell_fe_w")
        print(f"phase 7 GAME training ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"game": game}))
        if game["failures"]:
            raise AssertionError("phase 7: " + "; ".join(game["failures"]))
        stream_ref = {"auc": game["ell"]["auc"],
                      "fe_value": game["ell"]["fe_value"],
                      "w": game_ell_fe_w}
        kernels[0]["launches_game_fit"] = game["ell"]["launches"]
        kernels[0]["game_fit_fe_evaluations"] = game["ell"]["fe_evaluations"]
        kernels[0]["shapes"] += game["kernel_shapes"]
        kernels[0]["max_abs_err"] = max(
            sh["max_abs_err"] for sh in kernels[0]["shapes"])

        t = time.perf_counter()
        driver = phase_driver([])
        print(f"phase 8 driver ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"driver": driver}))
        kernels[0]["launches_scoring_driver"] = driver[
            "scoring_gather_rowsum_launches"]
        if kernels[0]["launches_scoring_driver"] < 1:
            raise AssertionError("phase 8: the scoring driver did not "
                                 "launch gather_rowsum")

        t = time.perf_counter()
        swept = phase_sweep(sweep, device="cuda")
        swept["card"] = card
        print(f"phase 9 swept λ ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"sweep": swept}))
        if swept["failures"]:
            raise AssertionError("phase 9: " + "; ".join(swept["failures"]))
        lanes = kernels[3]
        lanes["launches_ell_fit"] = swept["ell"]["launches"]
        lanes["launches_colmajor_fit"] = swept["colmajor"]["launches"]
        lanes["launches_tuned_fit"] = swept["tuned"]["launches"]
        lanes["launches"] = (lanes["launches_ell_fit"]
                             + lanes["launches_colmajor_fit"]
                             + lanes["launches_tuned_fit"])
        # Phase 3's shapes are checks only; phase 9's carry its launches.
        for sh in lanes["shapes"]:
            sh["launches"] = 0
        lanes["shapes"] += swept["lane_shapes"]
        if sum(sh["launches"] for sh in lanes["shapes"]) != \
                lanes["launches"]:
            raise AssertionError("phase 9: lane launches by shape do not "
                                 "sum to the fits' launches")
        lanes["max_abs_err"] = max(sh["max_abs_err"]
                                   for sh in lanes["shapes"])

        t = time.perf_counter()
        stream = phase_stream(stream_ref, device="cuda")
        stream["card"] = card
        fit_10a = stream.pop("fit_10a")
        print(f"phase 10a-c streamed training ({time.perf_counter() - t:.1f}"
              " s): " + json.dumps({"stream": stream}, default=str))
        if stream["failures"]:
            raise AssertionError("phase 10: " + "; ".join(
                stream["failures"]))
        t = time.perf_counter()
        stream_sweep = phase_stream_sweep(sweep, swept["ell"], "cuda")
        stream_sweep["card"] = card
        print(f"phase 10d streamed swept λ ({time.perf_counter() - t:.1f}"
              " s): " + json.dumps({"stream_sweep": stream_sweep},
                                   default=str))
        if stream_sweep["failures"]:
            raise AssertionError("phase 10d: " + "; ".join(
                stream_sweep["failures"]))
        del sweep
        kernels[0]["launches_stream_fit"] = stream["10a"]["launches"]
        kernels[0]["shapes"].append(stream["kernel_shape"])
        kernels[0]["max_abs_err"] = max(
            sh["max_abs_err"] for sh in kernels[0]["shapes"])
        lanes["launches_stream_fit"] = stream_sweep["lane_launches"]
        lanes["launches"] += lanes["launches_stream_fit"]
        lanes["shapes"].append(stream_sweep["kernel_shape"])
        if sum(sh["launches"] for sh in lanes["shapes"]) != \
                lanes["launches"]:
            raise AssertionError("phase 10d: lane launches by shape do "
                                 "not sum to the fits' launches")
        lanes["max_abs_err"] = max(sh["max_abs_err"]
                                   for sh in lanes["shapes"])

        t = time.perf_counter()
        ooc = phase_out_of_core(fit_10a, device="cuda")
        ooc["card"] = card
        print(f"phase 11 out-of-core GAME training ("
              f"{time.perf_counter() - t:.1f} s): "
              + json.dumps({"out_of_core": ooc}, default=str))
        if ooc["failures"]:
            raise AssertionError("phase 11: " + "; ".join(ooc["failures"]))
        kernels[0]["launches_re_stream_fit"] = ooc["11a"]["launches"]
        kernels[0]["launches_fused_fit"] = ooc["11b"]["launches"]
        kernels[0]["fused_chunk_shape"] = [ooc["kernel_shape"]["n"],
                                           ooc["kernel_shape"]["k"]]
        kernels[0]["shapes"].append(ooc["kernel_shape"])
        kernels[0]["max_abs_err"] = max(
            sh["max_abs_err"] for sh in kernels[0]["shapes"])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
