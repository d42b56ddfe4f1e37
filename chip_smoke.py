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
   ``sorted_colsum`` (Xᵀr over a column-sorted copy) at the benchmark's
   ``glm-fit`` shape (10^7 rows of 11 power-law columns of 54,686,452
   and the intercept, drawn on the card; the copy built by
   ``build_column_sorted``, its build timed; a residual in (-0.5, 0.5)),
   launched twice and required bitwise equal, held against its plain
   version and the float64 ``index_add_`` route it replaced within
   2^-22 relative (1e-9 of the largest column where a column's terms
   cancel), timed as B1 is with that route as the library call;
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
   and the same fit on the plain-ELL layout (with the column-sorted
   copy ``make_sparse_batch`` gives it) end at the same loss, having
   launched ``gather_rowsum`` at least once an evaluation and
   ``sorted_colsum`` once a gradient; the same fit
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
   inside every gradient (``SparseBatch.xt_dot``), ``sorted_colsum``
   once inside every gradient of the ELL fit and never in the
   transposed-ELL fit, 64 converged entity
   lanes drawn across every bucket of
   both random effects each reach, within 1e-4 relative, the objective
   of a float64 scipy solve of that entity's problem (with the offsets
   its last solve saw), and the saved model, served by
   ``ScoringEngine``, give the transformer's margins to 1e-4.  Then
   ``gather_rowsum`` is checked and timed as in phase 3 on phase 7's
   own arrays: the fixed effect's ELL as the estimator builds it
   (900,000 x 31 with the intercept), its transposed ELL, and the
   transformer's first scoring chunk of the held-out rows; and
   ``sorted_colsum`` as in phase 3 on that ELL batch's column-sorted
   copy (the residual at coefficients near 0).  Printed:
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
12. streamed scoring: (a) phase 10a's fitted GAME model scores phase
   10's 900,000 training rows through ``StreamingGameScorer`` (131,072
   rows a chunk, 7 chunks, spilled to a spill dir, two in host RAM, two
   prefetched): margins within 1e-5 of the resident
   ``GameTransformer.transform``'s, the streaming AUC within 1e-9 of the
   one-shot AUC of the same margins (its exact path), B1 launched at
   least once a chunk, every chunk file present and the store quiesced;
   a second scorer on the spilled files spills nothing and gives the
   same margins to the bit.  Printed: the cold and warm passes' walls,
   a warm pass's device ms by part (B1, copies), idle share and rows/s;
   B1 checked and timed at the scorer's chunk.  (b) ``python -m
   photon_ml_torch.cli.game_scoring_driver --score-chunk-rows 128
   --spill-dir ...`` in a subprocess on phase 8's validation file and
   model, to ``.npz`` and ``.avro``: the evaluation, the scores and the
   Avro records within 1e-6 of phase 8's resident outputs, one chunk
   file a chunk; then the same run in this process, B1 counted.
13. the telemetry tier: (a) phase 10a's streamed fit again (the same
   data, config and spill files) with telemetry off, in a metrics
   session and in a trace session: when the off rerun reproduces 10a's
   coefficients to the bit, both traced fits must too and launch B1 as
   often as 10a (else phase 10's gates hold, and the output says so);
   ``telemetry report`` on each log reconciles its spans to ≥ 90 % of
   the wall clock and its sweep odometer; ``trace.json`` parses, with
   ``prefetch_load``/``prefetch_place`` on the prefetch thread,
   ``chunk_compute`` on the main one and a device-memory track; the
   chunk program's ``device_cost`` bytes equal the analytic count of a
   chunk (its leaves and w read once, value and gradient written once);
   the device-memory samples come from ``torch.cuda.memory_stats``; one
   streamed evaluation makes as many synchronizing CUDA calls (implicit
   ones and explicit fences, ``analysis.guards``) in a metrics and a
   trace session as without one, and at least its own fence a chunk.
   Printed: the three walls, the overlap efficiency, consumer wait,
   producer stall, load and place, and the chunk program's stream ms
   from the session's CUDA event pairs (kernels and host dispatch) and
   kernel-busy ms from the profiler beside its roofline.  (b) Phase 12a's warm scoring
   pass off and in a metrics session: the same margins to the bit, B1 a
   chunk, the pass split into load, place and wait.  (c) Phase 10d's
   streamed λ grid in a metrics session: the lanes' losses against
   10d's (bitwise, then the lane kernel's launches equal; else phase
   9's loss gate) and the report's odometer.  (d) The training driver
   in a subprocess on phase 8's fixture with ``--telemetry trace`` and
   ``profile_dir`` in its config; ``python -m photon_ml_torch.telemetry
   report`` on its run log exits 0, and the profiler's trace exists.
14. the serving tiers (run right after phase 5, on phase 4's model,
   rows and clients; phases 4 and 5 run with every tier off): the
   server with telemetry, monitor and tracing off, then with the
   defaults (all on; every request trace kept, a run log): every answer
   within 1e-4 of float64 again, B1 launched once a warm-up bucket and
   once a batch, no kernel build; ``/metrics`` holds
   ``photon_serve_stage_seconds`` and request, batch and row counters
   equal to the clients'; ``/status`` holds the monitor's and the
   tracer's sections; ``python -m photon_ml_torch.telemetry
   serve-report`` on the log exits 0.  Printed: p50/p99 off and on, the
   stage table, the p50 and p99 requests split by stage.  Then the
   tiers' cost at their defaults: 4 rounds of a fresh server with the
   tiers off and one with ``ServingConfig``'s defaults, the order
   swapped each round, each run's p50/p99 and the host time a request
   spends inside the trace, telemetry and monitor hooks.  One batch
   through ``ScoringEngine.score_batch`` with and without a batch trace
   makes as many synchronizing CUDA calls (``analysis.guards``), twice,
   with bitwise margins.  A model whose per-item random effect is
   projected onto the sparse shard (4 columns an entity) is served with
   every tier on within 1e-4 of float64.  A ``serve.dispatch`` fault on
   a fresh server and one client: an ``error`` answers 500 within 30 s
   with its request id, a ``slow`` one (0.6 s) answers 200, and the
   monitor latches exactly one ``serve_tail_latency`` alert.
15. the supervised replica fleet (run after phase 14, on a copy of
   phase 4's model dir and phase 4's rows and clients): ``python -m
   photon_ml_torch.serving --replicas 2 --fleet-dir ...`` in a
   subprocess at the serving defaults (telemetry, monitor and tracing
   on), two replica processes on the one card behind one frontend:
   every answer through the frontend within 1e-4 of float64 with no
   failed request; each replica (its pid from the frontend's
   ``/status``) scoring on CUDA by its own ``/status`` and holding the
   card's ``/dev/nvidia*`` files open, the frontend's process none
   (``nvidia-smi``'s compute processes are printed beside: in a
   container whose pid namespace it does not share it lists each as pid
   1); each replica's requests and its own ``/metrics`` batch counter
   above zero (its B1 launches live in its own process: phase 14 gates
   one a batch).  One replica is SIGKILLed under sustained traffic: no request
   fails (the frontend's one retry), the fleet is back to 2 ready within
   ``replica_ready_timeout_s``, ``fleet.replica_restarts`` is counted
   and the monitor latches ``replica_restarts``.  A second model (seed
   1, the same widths) is published: the replicas are recycled one at a
   time, ``/status`` never shows fewer than 1 ready, no request fails,
   and afterwards every answer is within 1e-4 of the new model's float64
   reference; a corrupt publish then aborts the swap and the answers
   stay on the second model.  ``python -m photon_ml_torch.telemetry
   serve-report`` over the frontend's and the replicas' run logs exits
   0 with its join check.  Printed: p50/p99 through the frontend beside
   phase 14's, the frontend's ``route``/``forward``/``retry`` ms, each
   replica's cold start, the restart after the kill, the swap's
   duration and each replica's card memory.
16. the multi-host training fleet over tcp (run after phase 13): a
   ``parallel.fleet.ReduceCoordinator`` in this process (stall timeout
   120 s: a torn fleet ends in one ``FleetBarrierError``) and two host
   processes on the card, each with the ``PHOTON_FLEET_*`` trio, phase
   10a's data remade from its seed, a metrics session and its run log
   under ``host_NNN/``.  (a) Phase 10a's streamed fit, snapshots every
   solver iteration: host 0 streams chunks 0-3, host 1 chunks 4-6 and a
   sentinel step; the hosts' coefficients bitwise equal, phase 10's
   gates against 10a, each host's B1 launches one an owned chunk in
   every streamed pass of its fixed effect (none on a sentinel), its
   reduce count equal to the other's and the coordinator's, and
   ``python -m photon_ml_torch.telemetry fleet-report`` on the two logs
   exits 0; then a value-and-gradient partial's reduce timed between
   two reducers of this process.  (b) The same fleet with host 1
   SIGKILLed at a ``fleet.reduce`` three quarters into sweep 2's
   fixed-effect solve; host 0 holds the barrier, host 1 alone restarts
   with ``resume=True`` against the same coordinator: the coordinator
   answered replays, host 1's log holds two segments and
   ``fleet.seq_restored``, both hosts end bitwise at (a)'s coefficients,
   fleet-report exits 0.  (c) Phase 11b's fused cycle (60 cycles) on the
   two hosts: bitwise across them, AUC within 1e-3 of 11b's, B1 once an
   owned chunk of every pass.  (d) ``python -m
   photon_ml_torch.cli.game_training_driver`` twice, one process a
   host, on phase 10c's chunked config-4 fixture with ``--telemetry
   metrics``: ``host_000/`` and ``host_001/`` output trees with the
   fleet's ``run_info``, bitwise-equal models within phase 8's
   coefficient tolerance of 10c's uninterrupted run, fleet-report rc 0.
   Printed: the fleet's fit walls beside 10a's, each host's barrier wait
   and its share of the pass time, ms a reduce, each host's peak
   allocated card memory, the kill-to-rejoin time, the fused pass's
   reduced statistics' bytes a step and its cycle ms beside 11b's;
17. meshes, 8 shards on the card (17a right after phase 6, 17b after 7,
   17c-d after 10): (a) configs 1 and 2 (TRON) of phase 6 through
   ``GameEstimator`` with ``n_devices: 8`` on the ELL, transposed-ELL
   (padded to the shards' common virtual-row count) and GRR (congruent
   per-shard plans) layouts: the distributed objective's surfaces within
   phase 6's float64 gates, each fit within 1e-3 (final loss, AUC) of
   the same layout's single-device fit, one evaluation launching B1 8
   times (16 on the transposed ELL) and B2/B3 once a padded level a
   shard, and every shard's kernel shapes (its ELL rows, its padded
   transposed ELL with its padding share, each padded GRR level) against
   their plain versions, shard 0's timed; (b) config 5 on 8 shards (the
   random effects' entities sharded): AUC within 1e-3 of phase 7's;
   (c) phase 10a's fit on GRR chunks kept on the card (B2/B3 on every
   chunk of every pass), then on GRR chunks x 2 shards: each within
   phase 10's gates of 10a, the first chunk's padded levels against
   their plain versions; (d) the training driver with
   ``distributed_init`` and 8 shards on 10c's fixture, in this process:
   a world of one NCCL process (the run log's ``distributed``), the
   group gone after the run, the model within phase 8's tolerance of
   10c's.

The line before the card's and the result's is one JSON object with a
``kernels`` list: per kernel its launches on its path (``gather_rowsum``:
phase 4; phase 6's ELL and transposed-ELL fits as ``launches_ell_fit``
and ``launches_colmajor_fit``; phase 7's ELL GAME fit as
``launches_game_fit``; phase 8's in-process scoring as
``launches_scoring_driver``; phase 10a's streamed fit as
``launches_stream_fit``; phase 11's streamed random-effect and fused
fits as ``launches_re_stream_fit`` and ``launches_fused_fit``, the fused
pass's chunk as ``fused_chunk_shape``; phase 12's streamed scoring pass
and streamed scoring driver as ``launches_stream_scoring`` and
``launches_stream_scoring_driver``; phase 13's traced fits and traced
scoring pass as ``launches_telemetry_fits`` and
``launches_telemetry_scoring``; phase 14's traced serving run as
``launches_traced_serving``, phase 15's replicas' batches (one B1
launch each, in each replica's process) as ``fleet_batches`` and phase
16's fleet fit and fleet fused fit, one count a host process, as
``launches_fleet_fit`` and ``launches_fleet_fused``; phase 17's mesh
fits as ``launches_mesh_fits``, ``launches_mesh_game_fit`` and
``launches_mesh_stream_fits``; the GRR kernels: phase 6's GRR fit, and
phase 17's under the same keys;
``gather_rowsum_lanes``: phase 9's ELL, transposed-ELL and tuned fits and
phase 10d's streamed grid, and by shape in ``shapes``; phase 13c's
traced grid as ``launches_telemetry_sweep``),
the largest kernel-vs-plain difference over all checked shapes
(``gather_rowsum``: phases 3, 7, 10, 11 and 12), and its times and bound
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
import tempfile
import threading
import time
import urllib.error
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
from photon_ml_torch.data.colsorted import build_column_sorted
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators import game_transformer
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.estimators.streaming_scorer import StreamingGameScorer
from photon_ml_torch.evaluation.evaluators import EvaluatorType, auc
from photon_ml_torch.evaluation.streaming import make_streaming_evaluator
from photon_ml_torch.game import coordinates as game_coordinates
from photon_ml_torch.game import fused_sweep as fused_mod
from photon_ml_torch.game.dataset import EntityGrouping, GameDataset
from photon_ml_torch.game.projector import SubspaceProjection
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
    sorted_colsum,
    sorted_colsum_reference,
)
from photon_ml_torch.ops.objective import GLMObjective, sweep_value_and_gradient
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim import streaming as streaming_mod
from photon_ml_torch.optim.problem import OptimizationProblem
from photon_ml_torch.reliability import faults
from photon_ml_torch.serving.engine import ScoringEngine, dataset_rows
from photon_ml_torch.serving import tracing
from photon_ml_torch.serving.server import ModelServer
from photon_ml_torch.utils.run_log import RunLogger, read_run_log
from photon_ml_torch import telemetry
from photon_ml_torch.analysis.guards import (
    count_compiles,
    no_implicit_transfers,
)
from photon_ml_torch.telemetry import report as telemetry_report

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

# sorted_colsum (Xᵀr over the column-sorted copy) at the benchmark's
# glm-fit shape (gpubench/configs/kdd12-glm.json): 10^7 rows of 11
# power-law columns of 54,686,452 and the intercept.  Against its plain
# version: both add the same float32 products in float64 in two orders
# and round once, so they differ by a rounding step of float32 (two ulps
# allowed), or, where a column's terms cancel, by float64 rounding of
# terms up to the largest column's size (SORTED_ATOL_SCALE of it).
GLM_ROWS, GLM_FEATURES, GLM_NNZ = 10_000_000, 54_686_452, 11
SORTED_RTOL, SORTED_ATOL_SCALE = 2.0 ** -22, 1e-9

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
# Phase 12: the streamed scorer over phase 10's 900,000 rows in 7 chunks;
# its margins against the resident transform's, its streaming AUC
# against the one-shot AUC of the same margins (the exact path); the
# driver's streamed branch on phase 8's fixture in chunks of 128 rows.
SCORE_MARGIN_ATOL = 1e-5
SCORE_AUC_ATOL = 1e-9
SCORE_DRIVER_CHUNK_ROWS = 128

# Phase 13: the telemetry report's reconciliation threshold.
TELEMETRY_RECONCILE_MIN = 0.9
# Phase 16: the multi-host training fleet over tcp, two host processes
# on the one card and a ReduceCoordinator in this process.  Every
# barrier wait is bounded by the coordinator's stall timeout (a torn
# fleet ends in one FleetBarrierError), every host process by
# FLEET_HOST_TIMEOUT_S.
FLEET_HOSTS = 2
FLEET_STALL_S = 120.0
FLEET_HOST_TIMEOUT_S = 300.0
FLEET_CKPT_EVERY = 1              # solver iterations between snapshots
FLEET_REDUCE_ROUNDS = 50          # the reduce timing's rounds


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


def glm_fit_ell(seed: int, device: str = "cuda", n: int = GLM_ROWS,
                d: int = GLM_FEATURES, k: int = GLM_NNZ) -> tuple:
    """(col_ids [n, k + 1] i32, values f32, dim) of the glm-fit shape, drawn
    on ``device`` as gpubench's generator draws its rows (``k`` distinct
    power-law columns ``(d - k)·u^2.2`` a row, values 1), the intercept
    column ``d`` last in every row."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n, k), generator=g, device=device, dtype=torch.float64)
    cols = ((d - k) * u ** 2.2).long().sort(dim=1).values
    del u
    for j in range(1, k):
        cols[:, j] = torch.maximum(cols[:, j], cols[:, j - 1] + 1)
    cols = torch.cat([cols, torch.full((n, 1), d, device=device)], 1)
    return (cols.to(torch.int32).contiguous(),
            torch.ones((n, k + 1), device=device), d + 1)


def scatter_xt_dot(col_ids, values, dim: int):
    """The float64 ``index_add_`` route that plain-ELL Xᵀr took before the
    column-sorted copy (``SparseBatch.xt_dot`` without it), as a function
    of r."""
    def run(r):
        out = torch.zeros(dim, dtype=torch.float64, device=r.device)
        out.index_add_(0, col_ids.reshape(-1),
                       (values * r[:, None]).reshape(-1).double())
        return out.to(r.dtype)
    return run


def sorted_colsum_bound_ms(cs) -> tuple[float, str]:
    """Least time on one H100 for Xᵀr over the copy ``cs``: rows and vals
    read once, col_ptr read once, out written once, the rows of r that a
    slot gathers read once; a float32 product and a float64 add a slot."""
    nnz, dim = cs.rows.numel(), cs.dim
    touched = int(torch.unique(cs.rows).numel())
    nbytes = nnz * 8 + (dim + 1) * 8 + dim * 4 + touched * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_sorted_case(name: str, cs, r, scatter, time_it: bool = True
                      ) -> dict:
    """Xᵀr over one column-sorted copy ``cs`` with the residual ``r``:
    launched twice (bitwise equal), held against its plain version and
    the ``index_add_`` route it replaced (``scatter``, a function of r)
    within ``SORTED_RTOL`` / ``SORTED_ATOL_SCALE``; how many columns
    differ from the plain version and by how many float32 ulps; with
    ``time_it``, CUDA-event ms (back to back) of the kernel, the plain
    version and that route, the kernel's device ms, and the bound."""
    args = (r, cs.rows, cs.vals, cs.col_ptr)
    before = sorted_colsum.launches
    got = sorted_colsum(*args, cs.tiles)
    again = sorted_colsum(*args, cs.tiles)
    _sync_card()
    if r.is_cuda and sorted_colsum.launches != before + 2:
        raise AssertionError(f"sorted_colsum at {name}: 2 calls counted "
                             f"{sorted_colsum.launches - before}")
    if not torch.equal(got, again):
        raise AssertionError(f"sorted_colsum at {name}: two launches "
                             "differ")
    want = sorted_colsum_reference(*args).cpu().numpy()
    library = scatter(r).cpu().numpy()
    got = got.cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError(f"sorted_colsum at {name} returned non-finite "
                             "values")
    atol = SORTED_ATOL_SCALE * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=SORTED_RTOL, atol=atol)
    np.testing.assert_allclose(got, library, rtol=SORTED_RTOL, atol=atol)
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(
        np.abs(want)).astype(np.float64)
    bound, bound_by = sorted_colsum_bound_ms(cs)
    entry = {"shape": name, "slots": cs.rows.numel(), "columns": cs.dim,
             "rows": r.numel(), "tiles": cs.tiles.numel() - 1,
             "max_abs_err": float(np.abs(got - want).max(initial=0.0)),
             "max_ulps": float(ulps.max(initial=0.0)),
             "columns_differing": int((got != want).sum()),
             "library_max_abs_err": float(np.abs(library - want).max(
                 initial=0.0)),
             "rtol": SORTED_RTOL, "atol": atol,
             "bound_ms": bound, "bound_by": bound_by}
    if time_it:
        def run():
            return sorted_colsum(*args, cs.tiles)

        entry["ms"] = time_ms(run, 5)
        entry["device_ms"] = device_ms(run, 20)
        entry["plain_ms"] = time_ms(lambda: sorted_colsum_reference(*args),
                                    1)
        entry["library_ms"] = time_ms(lambda: scatter(r), 1)
        entry["share_of_bound"] = bound / entry["ms"]
        if entry["share_of_bound"] > GRR_BOUND_SLACK:
            raise AssertionError(f"sorted_colsum at {name} read faster than "
                                 f"its HBM bound: {entry}")
    print(f"  sorted_colsum {name}: " + json.dumps(entry))
    return entry


def phase_kernels_sorted(seed: int, time_it: bool = True,
                         device: str = "cuda", **shape) -> dict:
    """``sorted_colsum`` at the glm-fit shape (``glm_fit_ell`` drawn on
    ``device``, or at its keyword ``shape``; its copy built by
    ``build_column_sorted``, timed; a residual in (-0.5, 0.5)), as
    ``check_sorted_case`` holds it.  Phase 7 adds its fixed effect's
    shape, phases 6 and 7 the launches of their fits."""
    t_check = time.perf_counter()
    cols, vals, dim = glm_fit_ell(seed, device, **shape)
    _sync_card()
    t = time.perf_counter()
    cs = build_column_sorted(cols, vals, dim)
    _sync_card()
    build_s = time.perf_counter() - t
    g = torch.Generator(device=device).manual_seed(seed + 1)
    r = torch.rand(cols.shape[0], generator=g, device=device) - 0.5
    main = check_sorted_case("glm_fit", cs, r,
                             scatter_xt_dot(cols, vals, dim), time_it)
    main["build_s"] = build_s
    main["check_s"] = time.perf_counter() - t_check
    main["copy_bytes"] = sum(t.numel() * t.element_size()
                             for t in (cs.rows, cs.vals, cs.col_ptr,
                                       cs.tiles))
    del cols, vals, cs, r
    if device != "cpu":
        torch.cuda.empty_cache()
    return {
        "name": "sorted_colsum", "route": "cuda",
        "source": "photon_ml_torch/csrc/sorted_colsum.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package's plain-ELL Xᵀr is "
                         "jax.ops.segment_sum (photon_ml_tpu/data/batch.py"
                         ":127-132); it takes the place of the float64 "
                         "index_add_ scatter",
        "launches": None, "launches_ell_fit": None,
        "launches_game_fit": None,
        "max_abs_err": main["max_abs_err"], "max_ulps": main["max_ulps"],
        "ms": main.get("ms"), "device_ms": main.get("device_ms"),
        "plain_ms": main.get("plain_ms"),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main.get("library_ms"),
        "library_call": "float64 index_add_ scatter of the ELL's products "
                        "(the route it replaced)",
        "shapes": [main],
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


def serving_config(model_dir: str, spill_dir: str, device: str,
                   tiers: str = "off") -> ServingConfig:
    """Phase 4's server.  ``tiers="off"`` turns telemetry, the monitor
    and request tracing off (phases 4 and 5, comparable with PRs 1–7);
    ``"defaults"`` keeps ``ServingConfig``'s (all three on); ``"on"``
    also keeps every request trace (``trace_sample_every`` 1) and
    evaluates the monitor's rules every 50 ms."""
    kw = {"off": {"telemetry": "off", "monitor": "off", "trace": "off"},
          "defaults": {},
          "on": {"trace_sample_every": 1, "monitor_every_s": 0.05}}[tiers]
    return ServingConfig(model_dir=model_dir, port=0, batch_rows=BATCH_ROWS,
                         ell_row_capacity=ELL_CAP, spill_dir=spill_dir,
                         hot_swap_poll_s=0.0, device=device, **kw)


def phase_serving(cfg: ServingConfig, rows: list, ref_m, ref_p,
                  run_logger=None, probe=None) -> dict:
    """In-process server; ``CLIENTS`` threads each send ``REQUESTS``
    requests of ``ROWS`` rows over HTTP.  ``probe(server)`` runs after
    the clients and before the server stops; its result is ``probe``."""
    t0 = time.perf_counter()
    srv = ModelServer(cfg, run_logger=run_logger)
    probed = None
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
        if probe is not None:
            probed = probe(srv)
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
        **({"probe": probed} if probe is not None else {}),
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


# -- phase 14: the serving tiers (run after phase 5) -------------------------

# A faulted batch must be answered (500) within this many seconds.
FAULT_ANSWER_S = 30.0
# Fast requests before the slow dispatch (the tail rule needs 20), this
# far apart: the stall must not cut the monitor's rolling throughput
# below a quarter of its median, which the throughput rule would flag.
FAULT_WARM_REQUESTS = 21
FAULT_PACE_S = 0.1
# The slow dispatch's delay: above the monitor's 0.5 s p99 threshold.
FAULT_SLOW_S = 0.6
# Projected random effect (D7): subspace columns an entity.
PROJ_COLS = 4
# Rounds of the tiers' cost run: a server with the tiers off and one at
# their defaults a round, in the order off/defaults, defaults/off, ...
TIER_COST_ROUNDS = 4


def _http(port: int, route: str, data: bytes | None = None,
          headers: dict | None = None, timeout: float = 60.0):
    """(code, headers, body text) of one request; HTTP errors answered."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def prom_values(text: str) -> tuple[dict, dict]:
    """Prometheus text → ({family: type}, {series: value})."""
    families, values = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            families[name] = kind
        elif line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            values[series] = float(value)
    return families, values


def _tier_probe(expect_requests: int):
    """The probe of the tiers-on run: waits (deadline 10 s) until the
    tracer has finished every request (a trace finishes after its reply
    is sent), then reads ``/metrics`` and ``/status``."""
    def probe(srv) -> dict:
        deadline = time.monotonic() + 10.0
        while True:
            status = json.loads(_http(srv.port, "/status")[2])
            done = status["serving"].get("tracing", {}).get("requests", 0)
            if done >= expect_requests or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        families, values = prom_values(_http(srv.port, "/metrics")[2])
        return {"status": status, "families": families, "values": values}
    return probe


@contextlib.contextmanager
def hook_timer():
    """Host time spent inside the serving tiers' hooks while the block
    runs, on every thread: the trace calls (the context, request and
    batch traces, their stamps), telemetry's counters and the monitor's
    progress.  A call is timed at its outermost hook only (a trace's
    finish feeds telemetry's histograms inside its own time), on the
    wall clock and on its thread's CPU clock: the wall time also holds
    the waits for the interpreter lock while other threads run, the CPU
    time is the hooks' own work.  Yields ``{"trace" | "telemetry" |
    "monitor": [wall s, cpu s, calls]}``."""
    from photon_ml_torch.telemetry import monitor as _mon

    sites = {"trace": [(tracing, n) for n in (
                 "from_headers", "set_context", "active", "begin",
                 "take_attached", "finish", "clear")]
             + [(tracing.TraceRecorder, "begin_batch"),
                (tracing.TraceRecorder, "finish_batch"),
                (tracing.RequestTrace, "stamp"),
                (tracing.BatchTrace, "stamp")],
             "telemetry": [(telemetry, n)
                           for n in ("count", "gauge", "observe")],
             "monitor": [(_mon, "progress")]}
    acc = {group: [0.0, 0.0, 0] for group in sites}
    depth = threading.local()
    lock = threading.Lock()

    def timed(group, fn):
        def hook(*a, **kw):
            outer = not getattr(depth, "n", 0)
            depth.n = getattr(depth, "n", 0) + 1
            t, c = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t
                dc = time.thread_time() - c
                depth.n -= 1
                if outer:
                    with lock:
                        acc[group][0] += dt
                        acc[group][1] += dc
                        acc[group][2] += 1
        return hook

    saved = [(owner, name, owner.__dict__[name])
             for group in sites for owner, name in sites[group]]
    try:
        for group in sites:
            for owner, name in sites[group]:
                setattr(owner, name, timed(group, getattr(owner, name)))
        yield acc
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def tier_cost(model_dir: str, spill_dir: str, rows: list, ref_m, ref_p,
              device: str) -> dict:
    """The tiers' cost at their defaults: phase 4's clients on a fresh
    server a run, with the tiers off and with ``ServingConfig``'s
    defaults (telemetry ``metrics``, monitor ``on``, trace ``on``; its
    run log a file, as the CLI's ``log_path``), in the order off,
    defaults, defaults, off, ... over ``TIER_COST_ROUNDS`` rounds.  Each
    run's p50/p99 and the host µs a request spends in the hooks
    (``hook_timer``: wall and CPU); each mode's medians."""
    runs: dict = {"off": [], "defaults": []}
    for i in range(TIER_COST_ROUNDS):
        for mode in (("off", "defaults") if i % 2 == 0
                     else ("defaults", "off")):
            log = (RunLogger(os.path.join(WORK, f"serve_cost_{i}.jsonl"),
                             run_info={"driver": "chip_smoke tier cost"})
                   if mode == "defaults" else None)
            try:
                with hook_timer() as hooks:
                    r = phase_serving(serving_config(
                        model_dir, spill_dir, device, tiers=mode),
                        rows, ref_m, ref_p, run_logger=log)
            finally:
                if log is not None:
                    log.close()
            us = {clock: {g: v[i] * 1e6 / r["requests"]
                          for g, v in hooks.items()}
                  for i, clock in enumerate(("wall", "cpu"))}
            runs[mode].append({
                "p50_ms": r["p50_ms"], "p99_ms": r["p99_ms"],
                "hooks_us": {clock: {**v, "total": sum(v.values())}
                             for clock, v in us.items()},
                "hook_calls": sum(v[2] for v in hooks.values())
                / r["requests"]})
    median = {mode: {
        "p50_ms": float(np.median([run["p50_ms"] for run in rs])),
        "p99_ms": float(np.median([run["p99_ms"] for run in rs])),
        **{f"hooks_{clock}_us": float(np.median(
            [run["hooks_us"][clock]["total"] for run in rs]))
           for clock in ("wall", "cpu")}}
        for mode, rs in runs.items()}
    return {"rounds": TIER_COST_ROUNDS, "runs": runs, "median": median}


def _percentile_row(recs: list, q: float) -> dict:
    """The kept request at quantile ``q`` of ``total_ms`` (nearest rank)."""
    recs = sorted(recs, key=lambda r: r["total_ms"])
    return recs[min(len(recs) - 1, int(round(q * (len(recs) - 1))))]


def request_split(log_path: str) -> dict:
    """The p50 and p99 requests of a trace log, each split into its own
    stages, its batch's stages and the rest (network, handler and
    dispatcher scheduling): ms."""
    events = read_run_log(log_path)
    recs = [e for e in events if e["event"] == "request_trace"
            and e.get("status") == 200]
    batches = {e["batch"]: e for e in events if e["event"] == "batch_trace"}
    out = {}
    for label, q in (("p50", 0.50), ("p99", 0.99)):
        r = _percentile_row(recs, q)
        parts = dict(r["stages_ms"])
        for k, v in batches.get(r.get("batch"), {}).get("stages_ms",
                                                        {}).items():
            parts[k] = parts.get(k, 0.0) + v
        parts["other"] = round(r["total_ms"] - sum(parts.values()), 3)
        out[label] = {"total_ms": r["total_ms"], "stages_ms": parts}
    return out


def run_serve_report(*log_paths: str) -> tuple[int, dict]:
    """``python -m photon_ml_torch.telemetry serve-report`` over
    ``log_paths`` in a subprocess → (rc, its JSON last line)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_torch.telemetry", "serve-report",
         *log_paths], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (json.loads(lines[-1]) if lines else {})


def sync_split(cfg: ServingConfig, rows: list) -> dict:
    """One served batch through ``ScoringEngine.score_batch`` with and
    without a batch trace: the synchronizing CUDA calls of each
    (``analysis.guards``; None on the CPU), and the margins to the bit."""
    model, task = load_game_model(cfg.model_dir)
    engine = ScoringEngine(
        model, task, ell_row_capacity=cfg.ell_row_capacity,
        spill_dir=cfg.spill_dir, entity_chunk=cfg.entity_chunk,
        host_max_resident=cfg.host_max_resident, device=cfg.device)
    engine.warm(cfg.buckets())
    parsed = engine.parse_rows(rows)
    bucket = min(b for b in cfg.buckets() if b >= len(parsed))
    out = {}
    margins = {}
    with count_compiles() as builds:
        for label in ("off", "on", "off_again", "on_again"):
            trace = (tracing.BatchTrace("sync", bucket, len(parsed), 1)
                     if label.startswith("on") else None)
            with no_implicit_transfers("log", device=cfg.device) as log:
                m, _p, _d = engine.score_batch(parsed, bucket, trace=trace)
            out[label] = log.count if log.active else None
            margins[label] = m
            if trace is not None:
                out[f"{label}_stages"] = sorted(trace.stages)
    engine.close()
    out["builds"] = builds.count
    out["bitwise"] = all(np.array_equal(margins["off"], m)
                         for m in margins.values())
    return out


def make_projected_model(seed: int, d: int = D,
                         n_entities: int = N_ENTITIES):
    """Phase 4's model with the per-item random effect projected onto
    the sparse ``global`` shard (D7): ``PROJ_COLS`` distinct columns of
    [0, d) an entity, one in 4 slots padded with -1."""
    model, host = make_model(seed, d=d, n_entities=n_entities)
    rng = np.random.default_rng(seed + 1)
    _shard, key, grouping, _blocks = host["re"]["per_item"]
    fids, blocks = [], []
    for n in grouping.n_entities:
        # Distinct columns: positive gaps summing below d, wrapped.
        gaps = 1 + rng.integers(0, d // (2 * PROJ_COLS), (n, PROJ_COLS))
        f = ((rng.integers(0, d, (n, 1)) + np.cumsum(gaps, axis=1)) % d
             ).astype(np.int32)
        f[rng.random(f.shape) < 0.25] = -1
        fids.append(f)
        blocks.append(rng.normal(0, 0.3, (n, PROJ_COLS)).astype(np.float32))
    models = dict(model.models)
    models["per_item"] = RandomEffectModel(
        [torch.from_numpy(b) for b in blocks], grouping, "global",
        entity_key=key,
        projection=SubspaceProjection(feature_ids=fids, global_dim=d))
    host["proj"] = (key, grouping, fids, blocks)
    del host["re"]["per_item"]
    return GameModel(models), host


def make_projected_rows(rng, host, n: int, d: int = D) -> list[dict]:
    """Phase 4's rows without the ``item`` shard, each carrying its
    item's valid subspace columns among its ``NNZ`` non-zeros."""
    key, g, fids, _blocks = host["proj"]
    rows = make_rows(rng, {"re": {"per_user": host["re"]["per_user"],
                                  "per_item": (None, key, g, None)}},
                     n, d=d)
    for r in rows:
        del r["features"]["item"]
        j = int(np.searchsorted(g.entity_ids, r["ids"][key]))
        if j < len(g.entity_ids) and g.entity_ids[j] == r["ids"][key]:
            sub = fids[g.entity_bucket[j]][g.entity_slot[j]]
            sub = [int(c) for c in sub if c >= 0]
            rest = [cv for cv in r["features"]["global"]
                    if cv[0] not in sub]
            r["features"]["global"] = (
                [[c, float(rng.random())] for c in sub]
                + rest[: NNZ - len(sub)])
    return rows


def projected_reference(host, rows) -> tuple[np.ndarray, np.ndarray]:
    """float64 margins of the projected model: phase 4's reference for
    the fixed effect and the per-user effect, plus each row's item
    subspace columns times their coefficients."""
    m, _ = reference(host, rows)
    key, g, fids, blocks = host["proj"]
    for i, r in enumerate(rows):
        j = int(np.searchsorted(g.entity_ids, r["ids"][key]))
        if j >= len(g.entity_ids) or g.entity_ids[j] != r["ids"][key]:
            continue
        b, slot = g.entity_bucket[j], g.entity_slot[j]
        coef = {int(c): float(w) for c, w in zip(fids[b][slot],
                                                 blocks[b][slot]) if c >= 0}
        m[i] += sum(v * coef.get(int(c), 0.0)
                    for c, v in r["features"]["global"])
    return m, 1.0 / (1.0 + np.exp(-m))


def phase_projected(device: str, seed: int = 11, d: int = D,
                    n_entities: int = N_ENTITIES, n_rows: int = 64
                    ) -> dict:
    """D7: the projected model served with every tier on, sequential
    8-row requests, every margin against ``projected_reference``."""
    model, host = make_projected_model(seed, d=d, n_entities=n_entities)
    model_dir = os.path.join(WORK, "model_projected")
    save_game_model(model, TaskType.LOGISTIC_REGRESSION, model_dir)
    rng = np.random.default_rng(seed + 2)
    rows = make_projected_rows(rng, host, n_rows, d=d)
    ref_m, ref_p = projected_reference(host, rows)
    cfg = serving_config(model_dir, os.path.join(WORK, "spill_projected"),
                         device, tiers="on")
    srv = ModelServer(cfg).start()
    err = 0.0
    try:
        coords = srv.serving_status()["model"]["coordinates"]
        for lo in range(0, n_rows, ROWS):
            err = max(err, _check_answer(_post(srv.port, rows[lo: lo + ROWS]),
                                         ref_m[lo: lo + ROWS],
                                         ref_p[lo: lo + ROWS]))
    finally:
        srv.stop()
    without, _ = reference({"w": host["w"], "re": {
        "per_user": host["re"]["per_user"]}}, rows)
    return {"rows": n_rows, "max_abs_err": err,
            "coordinates": coords,
            "projected_term_max": float(np.abs(ref_m - without).max())}


def phase_fault(cfg: ServingConfig, rows: list, ref_m, ref_p,
                thresholds: dict | None = None) -> dict:
    """A ``serve.dispatch`` fault on a server with every tier on, one
    sequential client: ``FAULT_WARM_REQUESTS`` requests
    ``FAULT_PACE_S`` apart, then an
    ``error`` fault (that batch answers 500 within ``FAULT_ANSWER_S``
    with its request id) and a ``slow`` one of ``FAULT_SLOW_S`` (the
    next batch answers 200, late), then requests until the monitor
    shows an alert and three more: the alerts it latched.  One client
    gains nothing from coalescing, so the batch deadline is 0 (with it,
    on a small model the deadline alone is most of a request and latches
    ``serve_queue_wait``).  ``thresholds``: a monitor with these alert
    thresholds, started here for the server to adopt (the CPU rehearsal
    turns off the rules whose inputs swing with the host's load); None:
    the server's own monitor, with the reference's thresholds."""
    from photon_ml_torch.telemetry import monitor as _mon

    mon = (None if thresholds is None else
           _mon.start(every_s=cfg.monitor_every_s, thresholds=thresholds))
    srv = None
    piece = rows[:ROWS]
    body = json.dumps({"rows": piece}).encode()
    out = {}

    def alerts() -> list:
        if mon is not None:
            return mon.status()["alerts"]
        return json.loads(_http(srv.port, "/status")[2])["alerts"]

    try:
        srv = ModelServer(dataclasses.replace(cfg, batch_deadline_ms=0.0)
                          ).start()
        for _ in range(FAULT_WARM_REQUESTS):
            _check_answer(_post(srv.port, piece), ref_m[:ROWS],
                          ref_p[:ROWS])
            time.sleep(FAULT_PACE_S)
        inj = faults.FaultInjector([
            faults.Fault(site="serve.dispatch", kind="error", at=0),
            faults.Fault(site="serve.dispatch", kind="slow", at=1,
                         delay_s=FAULT_SLOW_S)])
        with faults.injected(inj):
            t = time.perf_counter()
            code, hdrs, text = _http(srv.port, "/v1/score", data=body,
                                     headers={"X-Photon-Request-Id":
                                              "fault-1"},
                                     timeout=FAULT_ANSWER_S)
            out["error_answer"] = {
                "code": code, "s": time.perf_counter() - t,
                "request_id": hdrs.get("X-Photon-Request-Id"),
                "error": json.loads(text).get("error")}
            t = time.perf_counter()
            _check_answer(_post(srv.port, piece), ref_m[:ROWS],
                          ref_p[:ROWS])
            out["slow_answer_s"] = time.perf_counter() - t
        out["fired"] = [list(f) for f in inj.fired]
        deadline = time.monotonic() + 30.0
        while not alerts() and time.monotonic() < deadline:
            time.sleep(0.06)
            _post(srv.port, piece)
        for _ in range(3):
            time.sleep(0.06)
            _post(srv.port, piece)
        out["alerts"] = alerts()
    finally:
        if srv is not None:
            srv.stop()
        if mon is not None:
            mon.close()
    return out


def phase_tiers(model_dir: str, spill_dir: str, rows: list, ref_m, ref_p,
                device: str, proj: dict | None = None,
                fault_thresholds: dict | None = None) -> dict:
    """Phase 14: phase 4's model and clients with every tier off, then
    on (a run log, every trace kept); ``/metrics``, ``/status``,
    ``serve-report`` on the log, the p50/p99 requests split by stage;
    the tiers' cost at their defaults (``tier_cost``);
    one batch's synchronizing calls with tracing off and on; the
    projected model (``proj``: ``phase_projected``'s arguments); the
    ``serve.dispatch`` fault (``phase_fault``, with
    ``fault_thresholds``)."""
    failures: list = []
    n_req = CLIENTS * REQUESTS
    cfg_off = serving_config(model_dir, spill_dir, device)
    cfg_on = serving_config(model_dir, spill_dir, device, tiers="on")
    out = {"off": phase_serving(cfg_off, rows, ref_m, ref_p)}
    log_path = os.path.join(WORK, "serve_tiers.jsonl")
    log = RunLogger(log_path, run_info={"driver": "chip_smoke phase 14"})
    gather_rowsum.launches = 0
    try:
        with count_compiles() as builds:
            on = phase_serving(cfg_on, rows, ref_m, ref_p, run_logger=log,
                               probe=_tier_probe(n_req))
    finally:
        log.close()
    out["launches"] = gather_rowsum.launches
    out["builds"] = builds.count
    probe = on.pop("probe")
    out["on"] = on
    if device == "cuda" and out["launches"] != (on["warmed_buckets"]
                                                + on["batches"]):
        failures.append(f"B1 launched {out['launches']} times for "
                        f"{on['warmed_buckets']} warm-up and "
                        f"{on['batches']} served batches")
    if out["builds"]:
        failures.append(f"{out['builds']} kernel build(s) while serving")
    fam, val = probe["families"], probe["values"]
    out["metrics"] = {k: val.get(k) for k in (
        "photon_serve_requests_total", "photon_serve_batches_total",
        "photon_serve_batch_rows_total", "photon_serve_shed_total")}
    out["metrics"]["stage_family"] = fam.get("photon_serve_stage_seconds")
    want = {"photon_serve_requests_total": n_req,
            "photon_serve_batches_total": on["batches"],
            "photon_serve_batch_rows_total": on["rows"]}
    for k, v in want.items():
        if val.get(k) != v:
            failures.append(f"/metrics {k} = {val.get(k)}, not {v}")
    if fam.get("photon_serve_stage_seconds") != "summary":
        failures.append("/metrics has no photon_serve_stage_seconds")
    st = probe["status"]
    out["status"] = {"keys": sorted(st),
                     "tracing": st["serving"].get("tracing"),
                     "stages": st["serving"].get("stages"),
                     "alerts": st.get("alerts")}
    for k in ("alerts", "stages", "phase"):
        if k not in st:
            failures.append(f"/status has no monitor section '{k}'")
    for k in ("tracing", "stages"):
        if k not in st["serving"]:
            failures.append(f"/status serving has no '{k}'")
    if (st["serving"].get("tracing") or {}).get("requests") != n_req:
        failures.append(f"tracer finished "
                        f"{(st['serving'].get('tracing') or {}).get('requests')}"
                        f" of {n_req} requests")
    rc, rep = run_serve_report(log_path)
    out["serve_report"] = {"rc": rc, "stages": rep.get("stages"),
                           "tail_requests": rep.get("tail_requests"),
                           "dominant_counts": rep.get("dominant_counts"),
                           "dominant_stage": rep.get("dominant_stage")}
    if rc != 0:
        failures.append(f"serve-report exited {rc}")
    out["split"] = request_split(log_path)
    out["latency_ms"] = {"off": {"p50": out["off"]["p50_ms"],
                                 "p99": out["off"]["p99_ms"]},
                         "on": {"p50": on["p50_ms"], "p99": on["p99_ms"]}}
    out["cost"] = tier_cost(model_dir, spill_dir, rows, ref_m, ref_p,
                            device)
    out["sync"] = sync_split(cfg_off, rows[:ROWS])
    if out["sync"]["on"] != out["sync"]["off"] or \
            out["sync"]["on_again"] != out["sync"]["off_again"]:
        failures.append(f"synchronizing calls with tracing on "
                        f"{out['sync']['on']} != off {out['sync']['off']}")
    if not out["sync"]["bitwise"] or out["sync"]["builds"]:
        failures.append("a traced batch changed the margins or built a "
                        "kernel")
    if out["sync"]["on_stages"] != ["assemble", "d2h", "dispatch",
                                    "store_lookup"]:
        failures.append(f"batch stages {out['sync']['on_stages']}")
    if proj is not None:
        out["projected"] = phase_projected(device, **proj)
        if out["projected"]["coordinates"].get("per_item") != \
                "re_projected":
            failures.append("the projected effect is not re_projected")
    out["fault"] = phase_fault(cfg_on, rows, ref_m, ref_p,
                               thresholds=fault_thresholds)
    ans = out["fault"]["error_answer"]
    if ans["code"] != 500 or ans["s"] > FAULT_ANSWER_S or \
            ans["request_id"] != "fault-1":
        failures.append(f"dispatch fault answered {ans}")
    rules = [(a["rule"], a.get("stage")) for a in out["fault"]["alerts"]]
    if rules != [("serve_tail_latency", "serve")]:
        failures.append(f"the fault latched {rules}, not one "
                        "serve_tail_latency alert")
    out["failures"] = failures
    return out


# -- phase 15: the supervised replica fleet (run after phase 14) -------------

FLEET_REPLICAS = 2
# The fleet's breaker opens after this many failed starts (the default is
# 5), so the corrupt publish aborts its swap after two, not five.
FLEET_BREAKER_THRESHOLD = 2
# Traffic kept up this long once the fleet is whole again.
FLEET_SETTLE_S = 1.0


def fleet_config(model_dir: str, spill_dir: str, device: str,
                 log_path: str) -> ServingConfig:
    """Phase 15's fleet: phase 4's server at ``ServingConfig``'s serving
    defaults (telemetry ``metrics``, monitor ``on``, trace ``on``), two
    replicas, the frontend's run log at ``log_path``."""
    return dataclasses.replace(
        serving_config(model_dir, spill_dir, device, tiers="defaults"),
        replicas=FLEET_REPLICAS, log_path=log_path,
        breaker_threshold=FLEET_BREAKER_THRESHOLD)


class FleetCli:
    """``python -m photon_ml_torch.serving --replicas N --fleet-dir ...``
    in a subprocess: the frontend and supervisor process."""

    def __init__(self, cfg: ServingConfig, fleet_dir: str,
                 root: str = REPO):
        os.makedirs(fleet_dir, exist_ok=True)
        self.fleet_dir = fleet_dir
        cfg_path = os.path.join(fleet_dir, "fleet.json")
        with open(cfg_path, "w") as f:
            f.write(config_to_json(cfg))
        self.info = os.path.join(fleet_dir, "fleet.info")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self._out = open(os.path.join(fleet_dir, "fleet.out"), "w+")
        self._err = open(os.path.join(fleet_dir, "fleet.err"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_torch.serving", "--config",
             cfg_path, "--replicas", str(cfg.replicas), "--fleet-dir",
             fleet_dir, "--info-file", self.info],
            cwd=root, env=env, stdout=self._out, stderr=self._err,
            text=True)
        self.port = None

    def _alive(self) -> None:
        if self.proc.poll() is not None:
            self._err.seek(0)
            raise RuntimeError(f"fleet exited rc {self.proc.returncode}:\n"
                               f"{self._err.read()[-4000:]}")

    def status(self) -> dict:
        self._alive()
        return json.loads(_http(self.port, "/status")[2])

    def wait(self, pred, timeout_s: float, what: str,
             every_s: float = 0.1) -> dict:
        """Poll ``/status`` until ``pred(status)``; the last status."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self.port is None:
                self._alive()
                if os.path.exists(self.info):
                    with open(self.info) as f:
                        self.port = json.load(f)["port"]
            if self.port is not None:
                try:
                    st = self.status()
                    if pred(st):
                        return st
                except (OSError, ValueError):
                    pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"fleet: {what} not within {timeout_s} s")
            time.sleep(every_s)

    def stop(self) -> dict:
        """SIGTERM; rc and the JSON last line."""
        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
            rc = self.proc.wait(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._out.seek(0)
            lines = self._out.read().strip().splitlines()
            self._out.close()
            self._err.close()
        return {"rc": rc, "last": json.loads(lines[-1]) if lines else None}


def fleet_traffic(port: int, rows: list, refs: list, stop=None,
                  clients: int = CLIENTS) -> dict:
    """``clients`` threads of ``ROWS``-row requests through the frontend:
    ``REQUESTS`` each over distinct rows (phase 4's clients) or, with a
    ``stop`` event, cycling over the rows until it is set.  Every answer
    is held against each reference of ``refs`` ([(margins, predictions)])
    and must be within ``SERVE_ATOL`` of one; ``matched`` counts the
    answers each reference took."""
    latencies: list = []
    errors: list = []
    matched = [0] * len(refs)
    worst = [0.0]
    lock = threading.Lock()
    n_blocks = len(rows) // ROWS

    def client(c: int) -> None:
        k = 0
        while (k < REQUESTS) if stop is None else not stop.is_set():
            lo = ((c * REQUESTS + k) % n_blocks) * ROWS
            k += 1
            try:
                t = time.perf_counter()
                out = _post(port, rows[lo: lo + ROWS])
                dt = time.perf_counter() - t
                errs = []
                for ref_m, ref_p in refs:
                    try:
                        errs.append(_check_answer(
                            out, ref_m[lo: lo + ROWS], ref_p[lo: lo + ROWS]))
                    except AssertionError:
                        errs.append(None)
                ok = [i for i, e in enumerate(errs) if e is not None]
                with lock:
                    latencies.append(dt)
                    if not ok:
                        errors.append(f"rows {lo}: no reference within "
                                      f"{SERVE_ATOL:g}")
                    else:
                        matched[ok[0]] += 1
                        worst[0] = max(worst[0], errs[ok[0]])
            except Exception as e:   # noqa: BLE001 - counted as a failure
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    if stop is None:
        for t in threads:
            t.join(timeout=300)
    return {"threads": threads, "latencies": latencies, "errors": errors,
            "matched": matched, "max_abs_err": worst}


def _traffic_result(traffic: dict) -> dict:
    for t in traffic["threads"]:
        t.join(timeout=300)
    if any(t.is_alive() for t in traffic["threads"]):
        traffic["errors"].append("a client did not finish in 300 s")
    lat = np.asarray(traffic["latencies"]) * 1e3
    return {"requests": len(lat), "failed": len(traffic["errors"]),
            "errors": traffic["errors"][:5],
            "matched": traffic["matched"],
            "max_abs_err": traffic["max_abs_err"][0],
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
            "p99_ms": float(np.percentile(lat, 99)) if len(lat) else None}


def compute_apps() -> list:
    """[pid, used memory] of each of the card's compute processes, as
    nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    apps = []
    for line in out.stdout.strip().splitlines():
        pid, mem = (x.strip() for x in line.split(",", 1))
        apps.append([int(pid), mem])
    return apps


def opens_nvidia_device(pid: int) -> bool:
    """Whether process ``pid`` holds a ``/dev/nvidia*`` file open (a CUDA
    context does)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith(
                    "/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def _publish_corrupt(model_dir: str) -> None:
    """A torn publish: garbage put in place of the manifest atomically."""
    from photon_ml_torch.io.model_io import model_manifest_path

    path = model_manifest_path(model_dir)
    with open(path + ".tmp", "wb") as f:
        f.write(b"torn copy, not a zip")
    os.replace(path + ".tmp", path)


def phase_fleet(model_dir: str, spill_dir: str, rows: list, ref_m, ref_p,
                device: str, next_model, next_ref) -> dict:
    """Phase 15: ``python -m photon_ml_torch.serving --replicas 2`` in a
    subprocess, serving a copy of phase 4's model (``model_dir``) at the
    serving defaults; phase 4's clients through the frontend; each
    replica scoring on the card and holding its device files, the
    frontend's process not; each replica's batches; one replica SIGKILLed under traffic (no failed
    request, restarted, ``replica_restarts`` latched); ``next_model``
    published and rolled in (never fewer than 1 ready, then every answer
    within 1e-4 of ``next_ref``); a corrupt publish aborted (answers stay
    on ``next_ref``); ``serve-report`` over the three run logs."""
    failures: list = []
    out: dict = {}
    fdir = os.path.join(WORK, "fleet")
    mdir = os.path.join(fdir, "model")
    shutil.copytree(model_dir, mdir)
    log_path = os.path.join(fdir, "frontend.jsonl")
    cfg = fleet_config(mdir, spill_dir, device, log_path)
    fleet = FleetCli(cfg, os.path.join(fdir, "run"))
    ref1, ref2 = (ref_m, ref_p), next_ref
    stopped = None
    try:
        # Cold start: each replica's time from the CLI's spawn to ready.
        first_ready: dict = {}

        def whole(st):
            for r in st["fleet"]["replicas"]:
                if r["state"] == "ready" and r["idx"] not in first_ready:
                    first_ready[r["idx"]] = time.perf_counter() - fleet.t0
            return st["fleet"]["ready"] == cfg.replicas

        st = fleet.wait(whole, cfg.replica_ready_timeout_s, "all ready")
        out["cold_start_s"] = [first_ready[i] for i in sorted(first_ready)]
        frontend_pid = fleet.proc.pid

        # (a) phase 4's clients through the frontend.
        out["serving"] = _traffic_result(fleet_traffic(fleet.port, rows,
                                                       [ref1]))
        if out["serving"]["failed"]:
            failures.append(f"serving: {out['serving']['errors']}")
        st = fleet.status()
        reps = st["fleet"]["replicas"]
        out["replicas"] = []
        for r in reps:
            rport = int(r["url"].rsplit(":", 1)[1])
            _, values = prom_values(_http(rport, "/metrics")[2])
            engine = json.loads(_http(rport, "/status")[2])["serving"][
                "model"]["device"]
            out["replicas"].append({
                "idx": r["idx"], "pid": r["pid"], "served": r["served"],
                "batches": values.get("photon_serve_batches_total"),
                "device": engine})
            if not r["served"] or not values.get(
                    "photon_serve_batches_total"):
                failures.append(f"replica {r['idx']} served {r['served']} "
                                "requests, "
                                f"{values.get('photon_serve_batches_total')}"
                                " batches")
            if engine != device:
                failures.append(f"replica {r['idx']} scores on {engine}")
        out["fleet_batches"] = [r["batches"] for r in out["replicas"]]
        out["frontend_pid"] = frontend_pid
        if device == "cuda":
            # nvidia-smi's pids are its own namespace's: where they are
            # not this one's (in a container it may list each as pid 1)
            # they cannot name a replica, so a process's hold on the
            # card is read from its open /dev/nvidia* files.
            apps = compute_apps()
            out["card_apps"] = apps
            pids = [pid for pid, _mem in apps]
            out["nvidia_fd"] = {"replicas": [opens_nvidia_device(r["pid"])
                                             for r in reps],
                                "frontend": opens_nvidia_device(
                                    frontend_pid)}
            out["replica_pids_listed"] = [r["pid"] in pids for r in reps]
            for r, held in zip(reps, out["nvidia_fd"]["replicas"]):
                if not held:
                    failures.append(f"replica {r['idx']} (pid {r['pid']}) "
                                    "holds no CUDA device")
            if out["nvidia_fd"]["frontend"] or frontend_pid in pids:
                failures.append("the frontend holds a CUDA device")
            if not apps:
                failures.append("nvidia-smi lists no compute process")

        # (b) SIGKILL one replica under sustained traffic.
        stop = threading.Event()
        traffic = fleet_traffic(fleet.port, rows, [ref1], stop=stop)
        time.sleep(FLEET_SETTLE_S)
        victim = reps[0]
        t_kill = time.perf_counter()
        os.kill(victim["pid"], signal.SIGKILL)
        st = fleet.wait(lambda s: s["fleet"]["restarts"] >= 1
                        and s["fleet"]["ready"] == cfg.replicas,
                        cfg.replica_ready_timeout_s, "the restart")
        restart_wall = time.perf_counter() - t_kill
        restart = st["fleet"]
        # The monitor evaluates its rules at the frontend's progress
        # cadence, so the traffic runs on until the alert latches.
        st = fleet.wait(lambda s: any(a["rule"] == "replica_restarts"
                                      for a in s.get("alerts", ())),
                        10 * cfg.monitor_every_s + 5.0,
                        "the replica_restarts alert")
        time.sleep(FLEET_SETTLE_S)
        stop.set()
        out["kill"] = {**_traffic_result(traffic), "victim": victim["idx"],
                       "restart_wall_s": restart_wall,
                       "last_restart_s": restart["last_restart_s"],
                       "alerts": [a["rule"] for a in st["alerts"]]}
        if out["kill"]["failed"]:
            failures.append(f"kill: {out['kill']['errors']}")
        st = fleet.status()
        out["kill"]["retries"] = st["frontend"]["retries"]
        _, values = prom_values(_http(fleet.port, "/metrics")[2])
        out["kill"]["replica_restarts"] = values.get(
            "photon_fleet_replica_restarts_total")
        if not (out["kill"]["replica_restarts"] or 0) >= 1:
            failures.append("fleet.replica_restarts is not counted")

        # (c) the rolling swap onto next_model.
        stop = threading.Event()
        traffic = fleet_traffic(fleet.port, rows, [ref1, ref2], stop=stop)
        min_ready = [cfg.replicas]
        t_pub = time.perf_counter()
        save_game_model(next_model, TaskType.LOGISTIC_REGRESSION, mdir)

        def swapped(s):
            min_ready[0] = min(min_ready[0], s["fleet"]["ready"])
            return s["fleet"]["swaps"] >= 1

        st = fleet.wait(swapped, 2 * cfg.replica_ready_timeout_s,
                        "the rolling swap", every_s=0.02)
        swap_s = time.perf_counter() - t_pub
        stop.set()
        out["swap"] = {**_traffic_result(traffic), "swap_s": swap_s,
                       "min_ready": min_ready[0],
                       "swap_aborts": st["fleet"]["swap_aborts"]}
        if out["swap"]["failed"] or min_ready[0] < 1:
            failures.append(f"swap: min ready {min_ready[0]}, "
                            f"{out['swap']['errors']}")
        out["after_swap"] = _traffic_result(fleet_traffic(fleet.port, rows,
                                                          [ref2]))
        if out["after_swap"]["failed"]:
            failures.append(f"after the swap: {out['after_swap']['errors']}")

        # (d) a corrupt publish: the swap aborts, answers stay on model 2.
        stop = threading.Event()
        traffic = fleet_traffic(fleet.port, rows, [ref2], stop=stop)
        t_pub = time.perf_counter()
        _publish_corrupt(mdir)
        st = fleet.wait(lambda s: s["fleet"]["swap_aborts"] >= 1,
                        2 * cfg.replica_ready_timeout_s, "the swap abort")
        abort_s = time.perf_counter() - t_pub
        stop.set()
        out["corrupt"] = {**_traffic_result(traffic), "abort_s": abort_s,
                          "last_swap_error": st["fleet"].get(
                              "last_swap_error"),
                          "states": [r["state"]
                                     for r in st["fleet"]["replicas"]]}
        if out["corrupt"]["failed"]:
            failures.append(f"corrupt publish: {out['corrupt']['errors']}")
        out["after_abort"] = _traffic_result(fleet_traffic(fleet.port, rows,
                                                           [ref2]))
        if out["after_abort"]["failed"]:
            failures.append("after the abort: "
                            f"{out['after_abort']['errors']}")
        st = fleet.status()
        out["frontend"] = st["frontend"]
        out["fleet"] = {k: v for k, v in st["fleet"].items()
                        if k != "replicas"}
    finally:
        stopped = fleet.stop()
    out["stop"] = {"rc": stopped["rc"],
                   "state": (stopped["last"] or {}).get("serving", {}).get(
                       "state")}
    if stopped["rc"] != 0:
        failures.append(f"the fleet CLI exited {stopped['rc']}")
    logs = [log_path] + sorted(glob.glob(os.path.join(fdir, "run",
                                                      "replica_*.jsonl")))
    rc, rep = run_serve_report(*logs)
    out["serve_report"] = {
        "rc": rc, "logs": [os.path.basename(p) for p in logs],
        **{k: rep.get(k) for k in (
            "frontend_requests", "replica_requests", "tail_requests",
            "joined", "join_fraction", "retried_requests", "retry_cost_ms",
            "dominant_stage")},
        "stages": {k: v for k, v in (rep.get("stages") or {}).items()
                   if k in tracing.FRONTEND_STAGES}}
    if rc != 0:
        failures.append(f"serve-report exited {rc}")
    out["failures"] = failures
    return out


def fleet_cold_build(model_dir: str, spill_dir: str, rows: list, ref_m,
                     ref_p, device: str) -> dict:
    """Two replicas that start at the same moment with no kernel built:
    the fleet CLI run from a copy of ``photon_ml_torch`` (no
    ``build/kernels`` beside it), so each replica builds B1 at its
    warm-up, racing to a temporary file of its own and an
    ``os.replace``.  Both must come up and answer phase 4's clients
    within 1e-4, leaving one library and no temporary file."""
    failures: list = []
    root = os.path.join(WORK, "cold")
    shutil.copytree(os.path.join(REPO, "photon_ml_torch"),
                    os.path.join(root, "photon_ml_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = fleet_config(model_dir, spill_dir, device,
                       os.path.join(root, "frontend.jsonl"))
    run_dir = os.path.join(root, "run")
    fleet = FleetCli(cfg, run_dir, root=root)
    try:
        fleet.wait(lambda s: s["fleet"]["ready"] == cfg.replicas,
                   cfg.replica_ready_timeout_s, "all ready")
        ready_s = time.perf_counter() - fleet.t0
        serving = _traffic_result(fleet_traffic(fleet.port, rows,
                                                [(ref_m, ref_p)]))
    finally:
        stopped = fleet.stop()
    build = os.path.join(root, "build", "kernels")
    files = sorted(os.listdir(build)) if os.path.isdir(build) else []
    built = 0
    for path in glob.glob(os.path.join(run_dir, "replica_*.err")):
        with open(path) as f:
            built += "nvcc gather_rowsum.cu" in f.read()
    out = {"ready_s": ready_s, "serving": serving, "files": files,
           "replicas_that_built": built, "rc": stopped["rc"]}
    if serving["failed"] or stopped["rc"] != 0:
        failures.append(f"cold fleet: {serving['errors']}, "
                        f"rc {stopped['rc']}")
    libs = [f for f in files
            if f.startswith("gather_rowsum-") and ".tmp." not in f]
    if device == "cuda" and (libs != files or len(libs) != 1
                             or built < 1):
        failures.append(f"cold build left {files}; {built} replica(s) "
                        "built B1")
    out["failures"] = failures
    return out


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
    same batch (with its column-sorted copy, as ``make_sparse_batch``
    places a plain-ELL batch) and its transposed-ELL view
    (``build_colmajor``, auto capacity); the held-out batch."""
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
    ell = dataclasses.replace(batch, grr=None, colsorted=build_column_sorted(
        batch.col_ids, batch.values, dim))
    t = time.perf_counter()
    cm = build_colmajor(ell.col_ids.cpu().numpy(), ell.values.cpu().numpy(),
                        dim, device=device)
    colmajor_s = time.perf_counter() - t
    return {
        "grr": batch, "ell": ell,
        "colmajor": dataclasses.replace(ell, colmajor=cm, colsorted=None),
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
    gather_rowsum.launches = sorted_colsum.launches = 0
    res_ell, fit_ell_s = _fit(problem, ell, w0)
    ell_launches = gather_rowsum.launches
    ell_sorted_launches = sorted_colsum.launches
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
    test_auc_ell = float(auc(test.margins(res_ell.w), test.labels,
                             mask=test.mask))
    test_auc_cm = float(auc(test.margins(res_cm.w), test.labels,
                            mask=test.mask))

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
    data["f64"] = {"w": w, "v": v, "ref": ref}     # phase 17a's
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
        "test_auc": test_auc, "test_auc_ell": test_auc_ell,
        "test_auc_colmajor": test_auc_cm, "f64_errors": errors,
        "launches": launches, "ell_gather_rowsum_launches": ell_launches,
        "ell_evaluations": ell_evaluations,
        "ell_sorted_colsum_launches": ell_sorted_launches,
        "ell_gradients": res_ell.iterations + 1,
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
    # Every gradient of the plain-ELL fit is one Xᵀr over its copy.
    if dev.type == "cuda" and ell_sorted_launches != res_ell.iterations + 1:
        failures.append(f"the ELL fit launched sorted_colsum "
                        f"{ell_sorted_launches} time(s) for "
                        f"{res_ell.iterations + 1} gradients")
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
    """A plain-ELL evaluation's device ms by part: B1 (X·w), Xᵀr over the
    column-sorted copy (``sorted_colsum``'s two kernels) or its float64
    ``index_add_`` (PyTorch's ``indexFunc*`` kernels), the rest, and the
    five largest kernels by name."""
    parts = {"gather_rowsum": 0.0, "sorted_colsum": 0.0, "index_add": 0.0,
             "rest": 0.0}
    for name, ms in by_name.items():
        key = ("gather_rowsum" if "gather_rowsum" in name
               else "sorted_colsum" if "sorted_colsum" in name
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
    each (and the ``sorted_colsum`` calls inside the gradients), and
    times each bucket's lane-batched solve."""

    def __enter__(self):
        self.margins_calls = self.margins_launches = 0
        self.xt_dot_calls = self.xt_dot_launches = 0
        self.xt_dot_sorted = 0
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
            sorted_before = sorted_colsum.launches
            out = probe._xt_dot(batch, r)
            probe.xt_dot_calls += 1
            probe.xt_dot_launches += gather_rowsum.launches - before
            probe.xt_dot_sorted += sorted_colsum.launches - sorted_before
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
            "fe_gradient_sorted_colsum": probe.xt_dot_sorted,
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
    # Xᵀr of the fixed effect's ELL batch (the estimator's, intercept
    # included) over its column-sorted copy; the residual at w near 0.
    fe = problems["ELL"][1]
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.05, fe.dim).astype(np.float32)).to(fe.labels.device)
    out["sorted_shape"] = check_sorted_case(
        "game_fe_ell", fe.colsorted,
        (torch.sigmoid(fe.margins(w)) - fe.labels).contiguous(),
        scatter_xt_dot(fe.col_ids, fe.values, fe.dim), time_it)
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
        # The ELL fit's Xᵀr runs over the column-sorted copy, one call a
        # gradient; the transposed ELL's never.
        if (ell["fe_gradient_sorted_colsum"] != ell["fe_gradients"]
                or cm["fe_gradient_sorted_colsum"] != 0):
            failures.append(
                f"sorted_colsum counted {ell['fe_gradient_sorted_colsum']} "
                f"time(s) in the ELL fit's {ell['fe_gradients']} "
                f"fixed-effect gradients and "
                f"{cm['fe_gradient_sorted_colsum']} in the COLMAJOR fit's")
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
                # A mesh chunk is placed piece by piece.
                for piece in getattr(placed.batch, "pieces", [placed]):
                    probe.placed_devices.update(
                        str(getattr(piece.batch, leaf).device)
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
                        "owned": len(obj.batch.owned_chunk_ids),
                        "b1": gather_rowsum.launches - b1,
                        "lanes": gather_rowsum_lanes.launches - lanes})
                    return out
                return call
            return make

        def solve(kind):
            def make(old):
                def train(coord, *a, **kw):
                    before = probe._loads()
                    reduces = probe._reduces()
                    t = time.perf_counter()
                    w, res = old(coord, *a, **kw)
                    probe.solves.append({
                        "kind": kind, "loads": (before, probe._loads()),
                        "reduces": (reduces, probe._reduces()),
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

    def _reduces(self) -> int:
        return (self.injector.occurrences("fleet.reduce")
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
    a["model"] = fit["results"][0].model              # phase 12's
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


def stream_driver_config(out_dir: str) -> dict:
    """Phase 8's config-4 run with its fixed effect chunked
    (``STREAM_DRIVER_CHUNK_ROWS``) and every solve run to its iteration
    budget: phases 10c and 16d."""
    cfg = driver_config(out_dir)
    cfg["chunk_rows"] = STREAM_DRIVER_CHUNK_ROWS
    cfg["n_iterations"] = GAME_SWEEPS
    for c in cfg["coordinates"]:
        c["optimizer"].update(max_iters=STREAM_DRIVER_ITERS,
                              tolerance=1e-12)
    return cfg


def phase_stream_driver(device_args: list, failures: list) -> dict:
    """Phase 8's config-4 fixture through ``python -m
    photon_ml_torch.cli.game_training_driver`` with its fixed effect
    chunked (``STREAM_DRIVER_CHUNK_ROWS``), spilled, and snapshotted
    every solver iteration: a subprocess SIGKILLed once a
    ``solver_*.npz`` appears, then rerun with ``--resume``; its model
    against an uninterrupted run's (both in this process), within phase
    8's coefficient tolerance."""
    from photon_ml_torch.cli import game_training_driver

    cfg = stream_driver_config(os.path.join(WORK, "stream_driver_killed"))
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
                    "owned": len(eng.chunked.owned_chunk_ids),
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
    out["train"] = train                              # phase 12's rows
    return out


# -- phase 12: streamed scoring -------------------------------------------------


def phase_stream_score(model: GameModel, data: GameDataset, device: str,
                       chunk_rows: int = STREAM_CHUNK_ROWS,
                       time_it: bool = True) -> dict:
    """Phase 12a (module docstring): ``model`` scores ``data`` through
    ``StreamingGameScorer`` from a spill dir, cold (planning and
    spilling the chunks) and warm (a new scorer on the spilled files),
    against the resident ``GameTransformer.transform``."""
    failures: list = []
    task = TaskType.LOGISTIC_REGRESSION
    spill = os.path.join(WORK, "score_spill")
    labels = torch.from_numpy(data.labels)
    weights = torch.from_numpy(data.weight_array())

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def scorer():
        return StreamingGameScorer(
            model, task, chunk_rows=chunk_rows, spill_dir=spill,
            host_max_resident=2, prefetch_depth=2, device=device)

    t = time.perf_counter()
    resident = GameTransformer(model=model, task=task,
                               device=device).transform(data)
    out = {"rows": data.n, "chunk_rows": chunk_rows,
           "resident_s": time.perf_counter() - t}

    cold_scorer = scorer()
    sync()
    gather_rowsum.launches = 0
    t = time.perf_counter()
    cold = cold_scorer.score(
        data, evaluators=[make_streaming_evaluator(EvaluatorType.AUC)],
        keep_margins=True)
    sync()
    out["cold_s"] = time.perf_counter() - t
    out["launches"] = gather_rowsum.launches
    K = cold["n_chunks"]
    out.update(n_chunks=K, cold_pass_s=cold["wall_s"], store=cold["store"])
    out["margin_gap"] = float(np.abs(cold["margins"] - resident).max())
    one_shot = float(auc(torch.from_numpy(cold["margins"]), labels, weights))
    out["auc"] = cold["evaluation"]["AUC"]
    out["auc_gap_one_shot"] = abs(out["auc"] - one_shot)
    out["resident_auc"] = float(auc(torch.from_numpy(resident), labels,
                                    weights))
    if not out["margin_gap"] <= SCORE_MARGIN_ATOL:
        failures.append(f"12a: margins {out['margin_gap']:.3g} from the "
                        "resident transform's")
    if not out["auc_gap_one_shot"] <= SCORE_AUC_ATOL:
        failures.append(f"12a: streaming AUC {out['auc']!r} vs one-shot "
                        f"{one_shot!r}")
    if device != "cpu" and out["launches"] < K:
        failures.append(f"12a: B1 launched {out['launches']} times for "
                        f"{K} chunks")
    if cold["store"]["spills"] != K:
        failures.append(f"12a: {cold['store']['spills']} of {K} chunks "
                        "spilled")
    out.update(_store_gates("12a", [cold_scorer.store], failures))

    # The warm pass: a new scorer reads the spilled chunks.
    warm_scorer = scorer()
    gather_rowsum.launches = 0
    warm = warm_scorer.score(data, keep_margins=True)
    out["warm_launches"] = gather_rowsum.launches
    out["warm_store"] = warm["store"]
    out["warm_bitwise"] = bool(np.array_equal(warm["margins"],
                                              cold["margins"]))
    if warm["store"]["spills"] != 0 or not out["warm_bitwise"]:
        failures.append(f"12a: the warm pass spilled "
                        f"{warm['store']['spills']} chunks, bitwise "
                        f"{out['warm_bitwise']}")
    warm_scorer.store.assert_quiesced()
    out["warm"] = {"wall_s": warm["wall_s"],
                   "rows_per_sec": warm["rows_per_sec"]}
    if time_it:
        prof = _profile_call(lambda: warm_scorer.score(data), True)
        prof["rows_per_sec"] = data.n / (prof["wall_ms"] / 1e3)
        out["warm"]["profile"] = prof

    # B1 at the scorer's chunk, the fitted coefficients as table.
    chunk = warm_scorer.store.get(0)
    w = warm_scorer._plan_memo[1][1]["global"]
    vals = torch.from_numpy(np.array(chunk["global.vals"])).to(device)
    ids = torch.from_numpy(np.array(chunk["global.cols"])).to(device)
    scale = max(1.0, float(w.abs().max()) * float(vals.abs().max()))
    out["kernel_shape"] = check_b1_case(
        f"score_chunk_{vals.shape[0]}x{vals.shape[1]}", w, vals, ids,
        ATOL * scale, time_it=time_it)
    out["kernel_shape"]["launches"] = out["launches"]
    out["failures"] = failures
    return out


def phase_stream_score_driver(driver: dict, device_args: list,
                              failures: list) -> dict:
    """Phase 12b (module docstring): ``python -m
    photon_ml_torch.cli.game_scoring_driver`` with
    ``--score-chunk-rows`` and ``--spill-dir`` in a subprocess, on phase
    8's validation file and model (``driver``: phase 8's result), to
    ``.npz`` and to ``.avro``, against phase 8's resident outputs; then
    the ``.npz`` run again in this process with the B1 count set to 0."""
    from photon_ml_torch.cli import game_scoring_driver
    from photon_ml_torch.config import load_scoring_config
    from photon_ml_torch.io.avro import read_container

    spill = os.path.join(WORK, "score_driver_spill")
    extra = ["--score-chunk-rows", str(SCORE_DRIVER_CHUNK_ROWS),
             "--spill-dir", spill]
    out: dict = {"chunk_rows": SCORE_DRIVER_CHUNK_ROWS}
    paths = {}
    for ext in ("npz", "avro"):
        with open(os.path.join(WORK, f"score_{ext}.json")) as f:
            sc = json.load(f)
        sc["output_path"] = os.path.join(WORK, f"scores_streamed.{ext}")
        paths[ext] = os.path.join(WORK, f"score_streamed_{ext}.json")
        with open(paths[ext], "w") as f:
            json.dump(sc, f)
        res, out[f"{ext}_wall_s"] = _run_module(
            "photon_ml_torch.cli.game_scoring_driver",
            ["--config", paths[ext], *extra, *device_args])
        out[f"{ext}_auc"] = res["evaluation"]["AUC"]
    out["auc_gap"] = max(abs(out[f"{ext}_auc"] - driver["scoring_auc"])
                         for ext in ("npz", "avro"))
    got = np.load(os.path.join(WORK, "scores_streamed.npz"))
    want = np.load(os.path.join(WORK, "scores.npz"))
    out["npz_max_abs_diff"] = max(
        float(np.abs(got[k] - want[k]).max()) for k in ("scores",
                                                        "predictions"))
    recs = list(read_container(os.path.join(WORK,
                                            "scores_streamed.avro"))[1])
    rrecs = list(read_container(os.path.join(WORK, "scores.avro"))[1])
    out["avro_max_abs_diff"] = float(np.abs(
        np.asarray([r["predictionScore"] for r in recs])
        - np.asarray([r["predictionScore"] for r in rrecs])).max())
    n_chunks = -(-len(rrecs) // SCORE_DRIVER_CHUNK_ROWS)
    out["rows"], out["n_chunks"] = len(rrecs), n_chunks
    out["chunk_files"] = len(os.listdir(os.path.join(spill, "chunks")))
    if not out["auc_gap"] <= SCORING_ATOL:
        failures.append(f"12b: streamed AUC {out['npz_auc']}, "
                        f"{out['avro_auc']} vs resident "
                        f"{driver['scoring_auc']}")
    if not (out["npz_max_abs_diff"] <= SCORING_ATOL
            and np.array_equal(got["labels"], want["labels"])):
        failures.append(f"12b: .npz scores {out['npz_max_abs_diff']:.3g} "
                        "from the resident branch's")
    if not (out["avro_max_abs_diff"] <= SCORING_ATOL
            and [r["uid"] for r in recs] == [r["uid"] for r in rrecs]):
        failures.append(f"12b: .avro scores {out['avro_max_abs_diff']:.3g}"
                        " from the resident branch's")
    if out["chunk_files"] != n_chunks:
        failures.append(f"12b: {out['chunk_files']} chunk files for "
                        f"{n_chunks} chunks")

    config = load_scoring_config(paths["npz"])
    config.score_chunk_rows, config.spill_dir = SCORE_DRIVER_CHUNK_ROWS, spill
    if device_args:
        config.device = device_args[-1]
    gather_rowsum.launches = 0
    game_scoring_driver.run(config)
    out["launches"] = gather_rowsum.launches
    if config.device != "cpu" and out["launches"] < n_chunks:
        failures.append(f"12b: B1 launched {out['launches']} times for "
                        f"{n_chunks} chunks")
    return out


# -- phase 13: the telemetry tier ---------------------------------------------


def _telemetry_summary(events: list) -> dict:
    """The last ``telemetry_summary`` of a run log's events."""
    return [e for e in events if e["event"] == "telemetry_summary"][-1]


def _report(log_path: str) -> dict:
    """The port's ``telemetry report`` of a run log (its printout kept
    off this run's stdout)."""
    return telemetry_report.report(log_path,
                                   threshold=TELEMETRY_RECONCILE_MIN,
                                   out=io.StringIO())


def _report_gates(name: str, rep: dict, failures: list,
                  traced: bool = False) -> dict:
    """The report's verdict: the odometer identity and, for a traced
    run (span events: ``traced``), reconciliation ≥ 0.9."""
    conv = rep["convergence"] or {}
    out = {"ok": rep["ok"], "reconciliation": rep["reconciliation"],
           "odometer_ok": conv.get("ok"),
           "sweeps": conv.get("sweeps"),
           "unattributed_sweeps": conv.get("unattributed_sweeps"),
           "passes_per_cycle": conv.get("passes_per_cycle")}
    if (not rep["ok"] or conv.get("ok") is False
            or (traced and rep["reconciliation"] is None)):
        failures.append(f"{name}: telemetry report not ok "
                        f"(reconciliation {rep['reconciliation']}, "
                        f"odometer {conv.get('ok')})")
    return out


def pipeline_split(summary: dict) -> dict:
    """A run's streamed passes by stage, from its telemetry summary:
    overlap efficiency, the consumer's wait, the producer's stall, the
    prefetch thread's load and place spans, and the consumer's
    ``chunk_compute`` (host clock: the launches and the fences)."""
    c, spans, d = summary["counters"], summary["spans"], summary["derived"]

    def total(name):
        return spans.get(name, {}).get("total_s", 0.0)

    return {"overlap_efficiency": d.get("overlap_efficiency"),
            "pass_s": d.get("pass_span_total_s"),
            "consumer_wait_s": c.get("prefetch.consumer_wait_s", 0.0),
            "producer_stall_s": c.get("prefetch.producer_stall_s", 0.0),
            "load_s": total("prefetch_load"),
            "place_s": total("prefetch_place"),
            "chunk_compute_s": total("chunk_compute"),
            "chunk_drain_s": total("chunk_drain"),
            "chunks": c.get("prefetch.chunks_consumed", 0)}


def program_split(summary: dict, name: str) -> dict:
    """A captured chunk program: its analytic bytes and flops, its
    roofline at the card's peak rate, and its stream ms a chunk from the
    session's CUDA event pairs (None where it ran on the CPU).  A pair
    starts on a stream the chunk's fence has drained, so its interval
    holds the host's dispatch of the chunk as well as its kernels: it
    is no kernel-busy time, and no roofline share is taken from it."""
    cost = summary.get("device", {}).get("programs", {}).get(name, {})
    ev = summary["histograms"].get(f"device.event_s.{name}")
    return {"bytes": cost.get("bytes_accessed"), "flops": cost.get("flops"),
            "roofline_ms": cost.get("roofline_est_ms"),
            "peak_source": cost.get("peak_source"),
            "stream_ms": None if ev is None else ev["mean"] * 1e3,
            "stream_ms_p50": None if ev is None else ev["p50"] * 1e3,
            "chunks_timed": 0 if ev is None else ev["count"]}


def kernel_busy_split(co, w, program: dict) -> None:
    """Adds to ``program`` (a ``program_split``) the kernel-busy ms a
    chunk of one ``value_and_gradient`` of ``co``: the profiler's kernel
    times of one evaluation (copies left out) over its chunks, and the
    roofline's share of it.  On the CPU both stay None."""
    program["kernel_ms"] = program["roofline_share"] = None
    if w.device.type != "cuda":
        return
    by_name = device_kernels_ms(lambda: co.value_and_gradient(w), 2)
    busy = sum(ms for name, ms in by_name.items()
               if not name.startswith(("Memcpy", "Memset")))
    if busy:
        program["kernel_ms"] = busy / co.batch.n_chunks
        if program["roofline_ms"]:
            program["roofline_share"] = (program["roofline_ms"]
                                         / program["kernel_ms"])


def sync_counts(co, w) -> tuple[dict, list]:
    """Synchronizing CUDA calls of one ``value_and_gradient`` of ``co``
    (after two warm-up calls), with telemetry off, in a metrics and a
    trace session, and off again: the implicit ones and the explicit
    fences (``analysis.guards``); None where the guard is inactive (a
    CPU run).  Also the guard's distinct messages."""
    for _ in range(2):
        co.value_and_gradient(w)
    out, seen = {}, set()
    for mode in ("off", "metrics", "trace", "off_again"):
        session = (telemetry.start(mode, device=w.device)
                   if mode in ("metrics", "trace") else None)
        try:
            with no_implicit_transfers("log", w.device) as log:
                co.value_and_gradient(w)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            if session is not None:
                session.close()
        out[mode] = log.count if log.active else None
        seen.update(log.messages)
    # The guard is live: one deliberate read to the host counts.
    with no_implicit_transfers("log", w.device) as log:
        float(w.sum())
    out["probe_read"] = log.count if log.active else None
    return out, sorted(seen)


def _trace_checks(path: str, failures: list) -> dict:
    """``trace.json`` parses as Chrome trace JSON, with the prefetch
    thread's ``prefetch_load``/``prefetch_place`` and the main thread's
    ``chunk_compute``, and a device-memory counter track."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    on = {}
    for e in evs:
        if e["ph"] == "X":
            on.setdefault(e["name"], set()).add(names.get(e["tid"]))
    out = {"events": len(evs),
           "prefetch_load": sorted(map(str, on.get("prefetch_load", ()))),
           "chunk_compute": sorted(map(str, on.get("chunk_compute", ()))),
           "device_mem_samples": sum(1 for e in evs if e["ph"] == "C"
                                     and e["name"] == "device.mem_mb")}
    if (on.get("prefetch_load") != {"photon-chunk-prefetch"}
            or on.get("prefetch_place") != {"photon-chunk-prefetch"}
            or on.get("chunk_compute") != {"MainThread"}
            or not out["device_mem_samples"]):
        failures.append(f"13a: trace.json spans by thread {out}")
    return out


def phase_telemetry(stream: dict, fit_10a: dict, device: str, seed: int = 7,
                    n: int = GAME_ROWS, d: int = D,
                    n_entities: int = N_ENTITIES,
                    chunk_rows: int = STREAM_CHUNK_ROWS) -> dict:
    """Phase 13a (module docstring): phase 10a's streamed fit with
    telemetry off, in metrics and in trace mode, against 10a
    (``stream``: phase 10's result, ``fit_10a``: its coefficients)."""
    failures: list = []
    data = make_game_data(seed, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    del data
    spill = os.path.join(WORK, "stream_spill")
    trace_dir = os.path.join(WORK, "telemetry_trace")
    out: dict = {"walls": {}, "launches": {}}
    fits = {}
    for mode in ("off", "metrics", "trace"):
        over = {"telemetry": mode}
        if mode == "trace":
            over["telemetry_dir"] = trace_dir
        fit = _stream_fit(stream_config(device, spill, chunk_rows, **over),
                          train, valid)
        fits[mode] = fit
        out["walls"][mode] = fit["wall_s"]
        out["launches"][mode] = fit["launches"]
    want_launches = stream["10a"]["launches"]
    got = {mode: _fit_summary(fit) for mode, fit in fits.items()}
    out["bitwise_10a"] = {mode: bool(np.array_equal(g["w"], fit_10a["w"]))
                          for mode, g in got.items()}
    # 10a is the reference when it reproduces to the bit (the off rerun
    # shows it); else phase 10's gates hold.
    exact = out["bitwise_10a"]["off"]
    out["gates"] = "bitwise" if exact else "phase 10's (10a not bitwise)"
    for mode in ("metrics", "trace"):
        if exact:
            if not out["bitwise_10a"][mode]:
                failures.append(f"13a {mode}: coefficients differ from "
                                "10a's")
            if out["launches"][mode] != want_launches:
                failures.append(f"13a {mode}: B1 launched "
                                f"{out['launches'][mode]} times, 10a "
                                f"{want_launches}")
        else:
            out[f"{mode}_vs_10a"] = _stream_gates(f"13a {mode} vs 10a",
                                                  got[mode], fit_10a,
                                                  failures)
        out[f"{mode}_report"] = _report_gates(f"13a {mode}",
                                              _report(fits[mode]["log"]),
                                              failures,
                                              traced=mode == "trace")
    summary = _telemetry_summary(fits["metrics"]["events"])
    out["split"] = pipeline_split(summary)
    out["program"] = program_split(summary, "chunk_vg")
    out["trace"] = _trace_checks(os.path.join(trace_dir, "trace.json"),
                                 failures)

    # The chunk program's cost against the analytic count of a chunk.
    fe = next(o for o in fits["metrics"]["probe"].objectives
              if o.batch.store is not None)
    chunk = _chunk_arrays(fe)
    dim = len(fit_10a["w"])
    leaves = [getattr(chunk, leaf) for leaf in streaming_mod._LEAVES]
    want_bytes = (sum(t.numel() * t.element_size() for t in leaves)
                  + 4 * dim + 4 + 4 * dim)
    costs = [e for e in fits["metrics"]["events"]
             if e["event"] == "device_cost" and e["program"] == "chunk_vg"]
    out["cost_bytes"] = costs[0]["bytes_accessed"] if costs else None
    out["cost_bytes_analytic"] = want_bytes
    if out["cost_bytes"] != want_bytes:
        failures.append(f"13a: chunk_vg device_cost bytes "
                        f"{out['cost_bytes']} vs analytic {want_bytes}")
    mems = [e for e in fits["metrics"]["events"]
            if e["event"] == "device_memory"]
    sources = {e["source"] for e in mems}
    out["memory"] = {"samples": len(mems), "sources": sorted(sources),
                     "peak_bytes": max((e.get("peak_bytes_in_use", 0)
                                        for e in mems), default=0)}
    want_source = ("torch.cuda.memory_stats" if device != "cpu"
                   else "host_rss (CPU device)")
    if len(mems) < 2 or sources != {want_source}:
        failures.append(f"13a: device memory series {out['memory']}")

    # One streamed evaluation's synchronizing calls, off and on.
    co = streaming_mod.ChunkedGLMObjective(
        fe.objective, fe.batch, max_resident=0, prefetch_depth=2,
        device=device)
    w = torch.from_numpy(fit_10a["w"]).to(device)
    out["syncs"], out["sync_messages"] = sync_counts(co, w)
    kernel_busy_split(co, w, out["program"])
    probe = out["syncs"].pop("probe_read")
    out["sync_probe_read"] = probe
    # On the card the guard must see the evaluation's own fences (one a
    # chunk after the first) and the deliberate read.
    if len(set(out["syncs"].values())) != 1 or (
            device != "cpu" and (not probe or out["syncs"]["off"]
                                 < co.batch.n_chunks - 1)):
        failures.append(f"13a: synchronizing calls of one evaluation "
                        f"{out['syncs']}")
    del co, chunk, fe, fits
    out["failures"] = failures
    return out


def phase_telemetry_score(model: GameModel, data: GameDataset, device: str,
                          chunk_rows: int = STREAM_CHUNK_ROWS) -> dict:
    """Phase 13b: phase 12a's warm streamed scoring pass with telemetry
    off and in a metrics session: the same margins to the bit, B1 a
    chunk, and the pass split into load, place and wait."""
    failures: list = []
    spill = os.path.join(WORK, "score_spill")

    def scorer():
        return StreamingGameScorer(
            model, TaskType.LOGISTIC_REGRESSION, chunk_rows=chunk_rows,
            spill_dir=spill, host_max_resident=2, prefetch_depth=2,
            device=device)

    off = scorer().score(data, keep_margins=True)
    log_path = os.path.join(WORK, "telemetry_score.jsonl")
    gather_rowsum.launches = 0
    with RunLogger(log_path) as log:
        session = telemetry.start("metrics", run_logger=log, device=device)
        try:
            on = scorer().score(data, keep_margins=True)
        finally:
            session.close()
    out = {"launches": gather_rowsum.launches, "n_chunks": on["n_chunks"],
           "wall_s": {"off": off["wall_s"], "metrics": on["wall_s"]},
           "bitwise": bool(np.array_equal(on["margins"], off["margins"])
                           and np.array_equal(on["predictions"],
                                              off["predictions"]))}
    if not out["bitwise"]:
        failures.append("13b: metrics-mode margins differ from the "
                        "off pass's")
    if device != "cpu" and out["launches"] < on["n_chunks"]:
        failures.append(f"13b: B1 launched {out['launches']} times for "
                        f"{on['n_chunks']} chunks")
    summary = _telemetry_summary(read_run_log(log_path))
    out["split"] = pipeline_split(summary)
    out["program"] = program_split(summary, "score_chunk")
    out["report"] = _report_gates("13b", _report(log_path), failures)
    out["failures"] = failures
    return out


def phase_telemetry_sweep(data: dict, ref_10d: dict, device: str,
                          chunk_rows: int = STREAM_CHUNK_ROWS) -> dict:
    """Phase 13c: phase 10d's streamed λ grid in a metrics session: the
    lanes' losses and the lane kernel's launches against 10d's, and the
    odometer identity in the report."""
    failures: list = []
    train, valid = sweep_data(data)
    cfg = sweep_config("ELL", device, chunk_rows=chunk_rows,
                       spill_dir=os.path.join(WORK, "sweep_spill"),
                       chunk_max_resident=1, host_max_resident=2,
                       prefetch_depth=2, telemetry="metrics")
    fit = _stream_fit(cfg, train, valid)
    swept = [s for s in fit["probe"].solves if s["kind"] == "swept"]
    order = np.argsort(-np.asarray(SWEEP_LAMS), kind="stable")
    loss = np.full(len(SWEEP_LAMS), np.nan)
    if swept:
        loss[order] = swept[-1]["value"]
    want = np.asarray(ref_10d["loss"])
    out = {"wall_s": fit["wall_s"], "lane_launches": fit["lane_launches"],
           "lane_launches_10d": ref_10d["lane_launches"],
           "bitwise_10d": bool(np.array_equal(loss, want)),
           "max_loss_gap_rel": float(np.max(np.abs(loss - want)
                                            / np.abs(want)))}
    if out["bitwise_10d"]:
        if out["lane_launches"] != out["lane_launches_10d"]:
            failures.append(f"13c: lane kernel launched "
                            f"{out['lane_launches']} times, 10d "
                            f"{out['lane_launches_10d']}")
    elif not out["max_loss_gap_rel"] <= SWEEP_LOSS_RTOL:
        failures.append(f"13c: lane losses {out['max_loss_gap_rel']:.3g} "
                        "from 10d's")
    summary = _telemetry_summary(fit["events"])
    out["split"] = pipeline_split(summary)
    out["program"] = program_split(summary, "chunk_vg_swept")
    out["report"] = _report_gates("13c", _report(fit["log"]), failures)
    out["failures"] = failures
    return out


def phase_telemetry_driver(device_args: list) -> dict:
    """Phase 13d: ``python -m photon_ml_torch.cli.game_training_driver
    --telemetry trace`` in a subprocess on phase 8's config-4 fixture
    with ``profile_dir`` in the config, then ``python -m
    photon_ml_torch.telemetry report`` on its run log (exit 0), its
    ``trace.json`` and the profiler's trace file."""
    failures: list = []
    out_dir = os.path.join(WORK, "telemetry_driver")
    prof = os.path.join(WORK, "telemetry_profile")
    cfg = driver_config(out_dir)
    cfg["profile_dir"] = prof
    cfg_path = os.path.join(WORK, "telemetry_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_torch.cli.game_training_driver",
         "--config", cfg_path, "--telemetry", "trace", *device_args],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    out = {"driver_rc": proc.returncode,
           "driver_wall_s": time.perf_counter() - t}
    if proc.returncode != 0:
        failures.append(f"13d: the driver exited {proc.returncode}: "
                        f"{proc.stderr[-2000:]}")
        out["failures"] = failures
        return out
    rep = subprocess.run(
        [sys.executable, "-m", "photon_ml_torch.telemetry", "report",
         os.path.join(out_dir, "run_log.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    tail = json.loads(rep.stdout.strip().splitlines()[-1])
    out.update(report_rc=rep.returncode,
               reconciliation=tail["reconciliation"],
               odometer_ok=(tail["convergence"] or {}).get("ok"),
               trace_json=os.path.exists(os.path.join(out_dir,
                                                      "trace.json")))
    prof_file = os.path.join(prof, "fit.pt.trace.json")
    out["profile_bytes"] = (os.path.getsize(prof_file)
                            if os.path.exists(prof_file) else 0)
    if rep.returncode != 0:
        failures.append(f"13d: telemetry report exited {rep.returncode} "
                        f"(reconciliation {tail['reconciliation']})")
    if not out["trace_json"] or not out["profile_bytes"]:
        failures.append(f"13d: trace.json {out['trace_json']}, profiler "
                        f"trace {out['profile_bytes']} bytes")
    out["failures"] = failures
    return out


# -- phase 16: the multi-host training fleet over tcp -------------------------

# The host processes' entry: this module's ``fleet_host`` on a spec file.
_FLEET_HOST_CMD = ("import sys; sys.path.insert(0, sys.argv[2]); "
                   "import chip_smoke; sys.exit(chip_smoke.fleet_host("
                   "sys.argv[1]))")


def fleet_host(spec_path: str) -> int:
    """One host of phase 16's training fleet, in a process of its own
    with the ``PHOTON_FLEET_*`` trio in its environment: phase 10a's
    config-5 data remade from its seed, then a streamed (``kind``
    ``"stream"``) or fused (``"fused"``) fit on the spec's device in a
    metrics session, its run log (with the fleet's ``run_info``) under
    its ``host_NNN/``, an optional ``fleet.reduce`` kill fault.  Writes
    its coefficients to ``coefs.npz`` there and prints one ``RESULT``
    JSON line: the B1 launches of its process and of each streamed
    evaluation or fused pass with its owned chunks, its reduce sequence,
    barrier wait, walls, AUC and peak allocated card memory."""
    from photon_ml_torch.parallel import fleet

    with open(spec_path) as f:
        spec = json.load(f)
    ctx = fleet.initialize_from_env()
    if ctx is None or not ctx.is_fleet:
        raise RuntimeError("fleet_host: no fleet context (set the "
                           "PHOTON_FLEET_* variables)")
    device = spec["device"]
    out_dir = fleet.host_dir(spec["out"], ctx)
    os.makedirs(out_dir, exist_ok=True)
    t = time.perf_counter()
    data = make_game_data(spec["seed"], spec["n"], d=spec["d"],
                          n_entities=spec["n_entities"])
    n_train = spec["n"] - int(spec["n"] * TRAIN_HOLDOUT)
    train = data.take(slice(0, n_train))
    valid = data.take(slice(n_train, spec["n"]))
    del data
    data_s = time.perf_counter() - t
    over = dict(telemetry="metrics", telemetry_dir=out_dir,
                resume=bool(spec.get("resume")))
    if spec.get("ckpt"):
        over.update(checkpoint_dir=spec["ckpt"],
                    checkpoint_every_solver_iters=FLEET_CKPT_EVERY)
    if spec["kind"] == "fused":
        over.update(cd_fused=True, n_iterations=spec["cycles"],
                    validate_per_iteration=False)
    cfg = stream_config(device, spec["spill"], spec["chunk_rows"], **over)
    plan = ([faults.Fault(site="fleet.reduce", kind="kill",
                          at=int(spec["kill_at"]))]
            if spec.get("kill_at") is not None else [])
    injector = faults.FaultInjector(plan)
    run_info = {"driver": "chip_smoke.fleet_host", "device": device,
                "telemetry": "metrics", "resume": over["resume"],
                "fleet_host": ctx.host_id, "fleet_hosts": ctx.n_hosts,
                "fleet_transport": ctx.transport}
    cuda = device != "cpu"
    gather_rowsum.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with RunLogger(os.path.join(out_dir, "run_log.jsonl"),
                   mode="a" if over["resume"] else "w", header=True,
                   run_info=run_info) as log, \
            _StreamProbe(injector) as sprobe, _OocProbe() as oprobe, \
            faults.injected(injector):
        t = time.perf_counter()
        results = GameEstimator(cfg).fit(train, valid, run_logger=log)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    res = results[0]
    models = res.model.models
    arrays = {"global": models["global"].coefficients.means.cpu().numpy()}
    for name, m in models.items():
        if hasattr(m, "coefficient_blocks"):
            for b, blk in enumerate(m.coefficient_blocks):
                arrays[f"{name}.{b}"] = blk.cpu().numpy()
    np.savez(os.path.join(out_dir, "coefs.npz"), **arrays)
    red = fleet.reducer()
    out = {
        "host": ctx.host_id, "kind": spec["kind"],
        "owned": _fe_owned(sprobe, oprobe),
        "data_s": data_s, "wall_s": wall,
        "auc": float(res.evaluations[EvaluatorType.AUC]),
        "seq": red.seq, "barrier_wait_s": red.barrier_wait_s,
        "launches": gather_rowsum.launches,
        "evaluations": [{"kind": c["kind"], "owned": c["owned"],
                         "b1": c["b1"]} for c in sprobe.calls],
        "solve_reduces": [s["reduces"] for s in sprobe.solves
                          if s["kind"] == "single"],
        "passes": [{"owned": p["owned"], "b1": p["b1"]}
                   for p in oprobe.passes],
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "jax_loaded": any(m == "jax" or m.startswith(("jax.",
                                                      "photon_ml_tpu"))
                          for m in sys.modules),
    }
    if spec["kind"] == "stream":
        out["fe_value"] = float(res.descent.history[-1]["global"]["value"])
    if oprobe.engines:
        eng = oprobe.engines[-1]
        out["stats_bytes_a_step"] = 8 * (1 + 2 * eng.chunked.dim + sum(
            (r.E_total + 1) * r.p_max * (1 + r.p_max) for r in eng.res))
        out["rejections"] = eng.rejections
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def _fe_owned(sprobe, oprobe) -> list:
    """The fixed effect's owned chunk ids of a host's fit."""
    objs = [o for o in sprobe.objectives if o.batch.store is not None]
    if objs:
        return objs[-1].batch.owned_chunk_ids
    if oprobe.engines:
        return oprobe.engines[-1].chunked.owned_chunk_ids
    return []


def _fleet_env(coord, host: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PHOTON_FLEET_")}
    env.update({"PHOTON_FLEET_NUM_HOSTS": str(coord.n_hosts),
                "PHOTON_FLEET_HOST_ID": str(host),
                "PHOTON_FLEET_COORDINATOR": coord.address})
    return env


def _spawn_fleet(argv: list, coord, host: int, tag: str
                 ) -> subprocess.Popen:
    """A phase-16 host process (``argv`` after the interpreter) with the
    fleet trio; its output goes to files (a pipe could fill while
    another host is awaited)."""
    base = os.path.join(WORK, f"fleet_{tag}_{host}")
    with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
        return subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                env=_fleet_env(coord, host), stdout=out,
                                stderr=err)


def _spawn_fleet_host(spec: dict, coord, host: int, tag: str
                      ) -> subprocess.Popen:
    path = os.path.join(WORK, f"fleet_{tag}_{host}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return _spawn_fleet(["-c", _FLEET_HOST_CMD, path, REPO], coord, host,
                        tag)


def _fleet_wait(procs: dict, failures: list, name: str,
                need_result: bool = True) -> dict:
    """Wait for every ``{label: (proc, out_base)}`` within
    ``FLEET_HOST_TIMEOUT_S``; a host that times out is killed.  Returns
    each label's rc and RESULT (None without one); a nonzero rc fails
    the part, and so does a missing RESULT where ``need_result``."""
    deadline = time.monotonic() + FLEET_HOST_TIMEOUT_S
    out = {}
    for label, (proc, base) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            failures.append(f"{name}: {label} still running after "
                            f"{FLEET_HOST_TIMEOUT_S:g} s")
        with open(base + ".out") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith("RESULT ")]
        result = json.loads(lines[-1][len("RESULT "):]) if lines else None
        out[label] = {"rc": proc.returncode, "result": result}
        if proc.returncode != 0:
            with open(base + ".err") as f:
                tail = f.read()[-1500:]
            failures.append(f"{name}: {label} exited {proc.returncode}: "
                            f"{tail}")
        elif need_result and result is None:
            failures.append(f"{name}: {label} exited 0 without a RESULT")
    return out


def _fleet_report(paths: list) -> tuple[int, dict]:
    """``python -m photon_ml_torch.telemetry fleet-report`` in a
    subprocess: its exit code and JSON last line."""
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_torch.telemetry", "fleet-report",
         *paths], cwd=REPO, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    try:
        result = json.loads(lines[-1])
    except (IndexError, ValueError):
        result = {"stderr": proc.stderr[-1500:]}
    return proc.returncode, result


def _host_coefs(out_base: str, host: int) -> dict:
    with np.load(os.path.join(out_base, f"host_{host:03d}",
                              "coefs.npz")) as z:
        return {k: z[k] for k in z.files}


def _coefs_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _report_rows(rep: dict) -> list:
    return [{k: r.get(k) for k in ("host", "segments", "reduces",
                                   "final_seq", "chunks_streamed",
                                   "barrier_wait_s",
                                   "barrier_wait_fraction", "seq_restored",
                                   "sweeps")}
            for r in rep.get("hosts", [])]


def _gate_report(name: str, rc: int, rep: dict, rows: list,
                 failures: list) -> None:
    """fleet-report's exit code is 0 and no host waited at the barrier
    longer than its passes took (a share above 1 means a reduction was
    timed outside its pass span)."""
    if rc != 0:
        failures.append(f"{name}: fleet-report rc {rc}: {rep}")
    over = [r["barrier_wait_fraction"] for r in rows
            if (r.get("barrier_wait_fraction") or 0.0) > 1.0]
    if over:
        failures.append(f"{name}: barrier_wait_fraction {over} above 1")


def fleet_reduce_ms(device: str, rounds: int = FLEET_REDUCE_ROUNDS,
                    n: int = D + 1) -> dict:
    """ms a reduce of a value-and-gradient partial (a scalar and n
    float32s) between two reducers on threads of this process through a
    coordinator: the copy down, the tcp round trip through the
    coordinator's sum, the copy up."""
    from photon_ml_torch.parallel import fleet

    coord = fleet.ReduceCoordinator(2, stall_timeout_s=FLEET_STALL_S)
    reds = [fleet.FleetReducer(fleet.FleetContext(
        h, 2, "tcp", coord.address), stall_timeout_s=FLEET_STALL_S)
        for h in range(2)]
    dev = torch.device(device)
    parts = [(torch.ones((), device=dev), torch.full((n,), float(h + 1),
                                                     device=dev))
             for h in range(2)]
    walls = [0.0, 0.0]
    errors: list = []

    def run(h):
        try:
            reds[h].reduce(parts[h])             # connect, warm up
            t = time.perf_counter()
            for _ in range(rounds):
                tot = reds[h].reduce(parts[h])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls[h] = time.perf_counter() - t
            if float(tot[1][0]) != 3.0:
                errors.append(f"host {h}: total {float(tot[1][0])}")
        except BaseException as e:       # reported by the caller
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(h,)) for h in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=FLEET_STALL_S)
    for r in reds:
        r.close()
    coord.close()
    return {"rounds": rounds, "floats": n + 1, "bytes": 4 * (n + 1),
            "ms": max(walls) / rounds * 1e3, "errors": errors}


def _fleet_stream_spec(device: str, out: str, spill: str, n: int, d: int,
                       n_entities: int, chunk_rows: int, **over) -> dict:
    return {"kind": "stream", "device": device, "seed": 7, "n": n, "d": d,
            "n_entities": n_entities, "chunk_rows": chunk_rows,
            "out": out, "spill": spill, **over}


def _b1_gates(name: str, runs: dict, device: str, key: str,
              failures: list) -> dict:
    """Each host's B1 launches in its fixed effect's streamed passes
    (``key``: ``evaluations`` or ``passes``): one a real chunk it owns,
    none on a sentinel step."""
    out = {}
    for label, run in runs.items():
        r = run["result"]
        if r is None:
            continue
        recs = r[key]
        owned = len(r["owned"])
        out[label] = {"owned": owned, "passes": len(recs),
                      "b1": sum(x["b1"] for x in recs),
                      "process_launches": r["launches"]}
        if not recs:
            failures.append(f"{name}: {label} made no streamed pass")
        if device != "cpu" and any(x["b1"] != owned or x["owned"] != owned
                                   for x in recs):
            failures.append(f"{name}: {label}'s passes launched B1 "
                            f"{sorted({x['b1'] for x in recs})} times, "
                            f"not its {owned} owned chunks")
    return out


def fleet_references(device: str, n: int = GAME_ROWS, d: int = D,
                     n_entities: int = N_ENTITIES,
                     chunk_rows: int = STREAM_CHUNK_ROWS,
                     cycles: int = FUSED_CYCLES) -> tuple:
    """Phase 16's single-process references when it runs alone: phase
    10a's streamed fit, phase 11b's fused fit (both on 10a's data and
    chunks) and phase 10c's uninterrupted driver run, as ``main()``
    hands them over from phases 10 and 11."""
    from photon_ml_torch.cli import game_training_driver

    data = make_game_data(7, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    del data
    spill = os.path.join(WORK, "fleet_ref_spill")
    fit = _stream_fit(stream_config(device, spill, chunk_rows), train, valid)
    ref_10a = dict(_fit_summary(fit), wall_s=fit["wall_s"])
    del fit
    fused = _ooc_fit(stream_config(device, spill, chunk_rows, cd_fused=True,
                                   n_iterations=cycles,
                                   validate_per_iteration=False),
                     train, valid)
    cyc = [e["duration_s"] * 1e3 for e in fused["events"]
           if e["event"] == "cd_fused_cycle"]
    ref_11b = {"auc": _ooc_summary(fused)["auc"],
               "cycle_ms": float(np.median(cyc)) if cyc else None}
    del fused, train, valid
    out_dir = os.path.join(WORK, "fleet_ref_driver")
    cfg = stream_driver_config(out_dir)
    cfg_path = os.path.join(WORK, "fleet_ref_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with contextlib.redirect_stdout(io.StringIO()):
        game_training_driver.main([
            "--config", cfg_path, "--spill-dir",
            os.path.join(WORK, "fleet_ref_driver_spill"),
            *(["--device", "cpu"] if device == "cpu" else [])])
    return ref_10a, ref_11b, out_dir


def phase_fleet_training(ref_10a: dict, ref_11b: dict, ref_10c_dir: str,
                         device: str, n: int = GAME_ROWS, d: int = D,
                         n_entities: int = N_ENTITIES,
                         chunk_rows: int = STREAM_CHUNK_ROWS,
                         cycles: int = FUSED_CYCLES,
                         time_it: bool = True) -> dict:
    """Phase 16 (module docstring): phase 10a's streamed fit, its
    killed-host replay and phase 11b's fused fit as two-host fleets, and
    the training driver as a fleet on phase 10c's fixture.  ``ref_10a``:
    10a's AUC, final loss and coefficients; ``ref_11b``: 11b's AUC and
    cycle ms; ``ref_10c_dir``: 10c's uninterrupted run's output dir."""
    from photon_ml_torch.parallel import fleet

    failures: list = []
    out: dict = {"hosts": FLEET_HOSTS, "stall_timeout_s": FLEET_STALL_S}
    spill = os.path.join(WORK, "fleet_spill")
    dims = dict(n=n, d=d, n_entities=n_entities, chunk_rows=chunk_rows)
    pick = ("global", "per_user.0", "per_item.0")

    # 16a: phase 10a's streamed fit on two hosts, snapshots every solver
    # iteration (16b's reference).
    base_a = os.path.join(WORK, "fleet_a")
    spec = _fleet_stream_spec(device, base_a, spill,
                              ckpt=os.path.join(WORK, "fleet_a_ck"), **dims)
    coord = fleet.ReduceCoordinator(FLEET_HOSTS,
                                    stall_timeout_s=FLEET_STALL_S)
    t = time.perf_counter()
    try:
        runs = _fleet_wait({f"host {h}": (
            _spawn_fleet_host(spec, coord, h, "a"),
            os.path.join(WORK, f"fleet_a_{h}"))
            for h in range(FLEET_HOSTS)}, failures, "16a")
    finally:
        coord.close()
    a = {"wall_s": time.perf_counter() - t, "reduces": coord.reduces}
    res = [runs[f"host {h}"]["result"] for h in range(FLEET_HOSTS)]
    if all(r is not None for r in res):
        coefs = [_host_coefs(base_a, h) for h in range(FLEET_HOSTS)]
        a.update(
            owned=[r["owned"] for r in res],
            host_wall_s=[r["wall_s"] for r in res],
            data_s=[r["data_s"] for r in res],
            seq=[r["seq"] for r in res],
            barrier_wait_s=[r["barrier_wait_s"] for r in res],
            peak_allocated_gb=[(r["peak_allocated_bytes"] or 0) / 1e9
                               for r in res],
            bitwise=all(_coefs_equal(coefs[0], c) for c in coefs[1:]),
            launches=[r["launches"] for r in res],
            b1=_b1_gates("16a", runs, device, "evaluations", failures),
            ref_10a_wall_s=ref_10a.get("wall_s"))
        a["vs_10a"] = _stream_gates(
            "16a vs 10a", {"auc": res[0]["auc"],
                           "fe_value": res[0]["fe_value"],
                           "w": coefs[0]["global"]}, ref_10a, failures)
        a["reduce_ms_mean"] = [1e3 * r["barrier_wait_s"] / max(r["seq"], 1)
                               for r in res]
        if not a["bitwise"]:
            failures.append("16a: the hosts' coefficients differ")
        if len(set(a["seq"])) != 1 or a["seq"][0] != coord.reduces:
            failures.append(f"16a: reduce sequences {a['seq']}, "
                            f"coordinator {coord.reduces}")
        if any(r["jax_loaded"] for r in res):
            failures.append("16a: a host process loaded jax")
        rc, rep = _fleet_report([os.path.join(base_a, f"host_{h:03d}",
                                              "run_log.jsonl")
                                 for h in range(FLEET_HOSTS)])
        a["fleet_report"] = {"rc": rc, "ok": rep.get("ok"),
                             "barrier_agreement":
                                 rep.get("barrier_agreement"),
                             "odometer_agreement":
                                 rep.get("odometer_agreement"),
                             "rows": _report_rows(rep)}
        psums = [row["reduces"] for row in a["fleet_report"]["rows"]]
        _gate_report("16a", rc, rep, a["fleet_report"]["rows"], failures)
        if not rep.get("barrier_agreement") \
                or not rep.get("odometer_agreement"):
            failures.append(f"16a: fleet-report agreement: {rep}")
        if len(set(psums)) != 1 or psums[0] != coord.reduces:
            failures.append(f"16a: fleet.psums {psums}, coordinator "
                            f"{coord.reduces}")
        a["pass_share"] = [row["barrier_wait_fraction"]
                           for row in a["fleet_report"]["rows"]]
    out["16a"] = a
    if failures:
        out["failures"] = failures
        return out
    a["reduce"] = fleet_reduce_ms(device, rounds=FLEET_REDUCE_ROUNDS
                                  if time_it else 5)
    if a["reduce"]["errors"]:
        failures.append(f"16a reduce timing: {a['reduce']['errors']}")

    # 16b: host 1 killed at a reduce past its first snapshots; host 0
    # never restarted; host 1 alone resumes against the same coordinator.
    base_b = os.path.join(WORK, "fleet_b")
    # Three quarters into sweep 2's fixed-effect solve: past sweep 1's
    # snapshot and that solve's first ones.
    lo, hi = res[1]["solve_reduces"][1]
    kill_at = lo + 3 * (hi - lo) // 4
    spec_b = dict(spec, out=base_b, ckpt=os.path.join(WORK, "fleet_b_ck"))
    coord = fleet.ReduceCoordinator(FLEET_HOSTS,
                                    stall_timeout_s=FLEET_STALL_S)
    b: dict = {"kill_at": kill_at}
    rejoin: dict = {}
    try:
        survivor = _spawn_fleet_host(spec_b, coord, 0, "b")
        victim = _spawn_fleet_host(dict(spec_b, kill_at=kill_at), coord, 1,
                                   "b")
        try:
            victim.wait(timeout=FLEET_HOST_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            victim.kill()
            victim.wait()
        t_kill = time.perf_counter()
        b["victim_rc"] = victim.returncode
        b["reduces_at_kill"] = at_kill = coord.reduces
        b["survivor_alive_at_kill"] = survivor.poll() is None
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                if coord.reduces > at_kill:
                    rejoin["t"] = time.perf_counter()
                    return
                time.sleep(0.005)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        restarted = _spawn_fleet_host(dict(spec_b, resume=True), coord, 1,
                                      "b_resumed")
        runs = _fleet_wait({
            "host 0": (survivor, os.path.join(WORK, "fleet_b_0")),
            "host 1 resumed": (restarted,
                               os.path.join(WORK, "fleet_b_resumed_1"))},
            failures, "16b")
        stop.set()
        watcher.join(timeout=5)
    finally:
        coord.close()
    b.update(replays=coord.replays, reduces=coord.reduces,
             rejoin_s=(rejoin["t"] - t_kill) if "t" in rejoin else None)
    if b["victim_rc"] != -signal.SIGKILL:
        failures.append(f"16b: the victim exited {b['victim_rc']}, not "
                        "SIGKILL")
    if not b["survivor_alive_at_kill"]:
        failures.append("16b: host 0 died with the victim")
    if not coord.replays > 0:
        failures.append("16b: the resumed host replayed nothing")
    if all(r["result"] is not None for r in runs.values()):
        got = [_host_coefs(base_b, h) for h in range(FLEET_HOSTS)]
        b["bitwise_to_16a"] = [_coefs_equal(g, coefs[0]) for g in got]
        b["max_abs_dw_vs_16a"] = [float(np.abs(g["global"]
                                               - coefs[0]["global"]).max())
                                  for g in got]
        b["seq"] = [r["result"]["seq"] for r in runs.values()]
        if not all(b["bitwise_to_16a"]):
            failures.append(f"16b: coefficients not bitwise 16a's "
                            f"(max |Δw| {b['max_abs_dw_vs_16a']})")
        rc, rep = _fleet_report([os.path.join(base_b, f"host_{h:03d}",
                                              "run_log.jsonl")
                                 for h in range(FLEET_HOSTS)])
        rows = _report_rows(rep)
        b["fleet_report"] = {"rc": rc, "ok": rep.get("ok"),
                             "restarted_hosts": rep.get("restarted_hosts"),
                             "rows": rows}
        _gate_report("16b", rc, rep, rows, failures)
        if rep.get("restarted_hosts") != [1]:
            failures.append(f"16b: fleet-report restarted "
                            f"{rep.get('restarted_hosts')}")
        if not (len(rows) == 2 and rows[1]["segments"] == 2
                and rows[1]["seq_restored"] > 0):
            failures.append(f"16b: host 1's log holds no restored "
                            f"sequence: {rows}")
    out["16b"] = b

    # 16c: phase 11b's fused cycle over 10a's chunks on two hosts.
    base_c = os.path.join(WORK, "fleet_c")
    spec_c = dict(spec, kind="fused", out=base_c, ckpt=None, cycles=cycles)
    coord = fleet.ReduceCoordinator(FLEET_HOSTS,
                                    stall_timeout_s=FLEET_STALL_S)
    t = time.perf_counter()
    try:
        runs = _fleet_wait({f"host {h}": (
            _spawn_fleet_host(spec_c, coord, h, "c"),
            os.path.join(WORK, f"fleet_c_{h}"))
            for h in range(FLEET_HOSTS)}, failures, "16c")
    finally:
        coord.close()
    c = {"cycles": cycles, "wall_s": time.perf_counter() - t,
         "reduces": coord.reduces, "ref_11b_auc": ref_11b["auc"],
         "ref_11b_cycle_ms": ref_11b.get("cycle_ms")}
    res = [runs[f"host {h}"]["result"] for h in range(FLEET_HOSTS)]
    if all(r is not None for r in res):
        got = [_host_coefs(base_c, h) for h in range(FLEET_HOSTS)]
        logs = [os.path.join(base_c, f"host_{h:03d}", "run_log.jsonl")
                for h in range(FLEET_HOSTS)]
        cyc = [[e["duration_s"] * 1e3 for e in _read_log(p)
                if e["event"] == "cd_fused_cycle"] for p in logs]
        c.update(bitwise=all(_coefs_equal(got[0], g) for g in got[1:]),
                 auc=res[0]["auc"], auc_gap=abs(res[0]["auc"]
                                                - ref_11b["auc"]),
                 seq=[r["seq"] for r in res],
                 host_wall_s=[r["wall_s"] for r in res],
                 barrier_wait_s=[r["barrier_wait_s"] for r in res],
                 rejections=[r.get("rejections") for r in res],
                 stats_bytes_a_step=res[0].get("stats_bytes_a_step"),
                 cycle_ms_median=[float(np.median(x)) if x else None
                                  for x in cyc],
                 launches=[r["launches"] for r in res],
                 b1=_b1_gates("16c", runs, device, "passes", failures))
        if not c["bitwise"]:
            failures.append("16c: the hosts' coefficients differ")
        if not c["auc_gap"] <= STREAM_AUC_ATOL:
            failures.append(f"16c: AUC {c['auc']:.5f} vs 11b "
                            f"{ref_11b['auc']:.5f}")
        rc, rep = _fleet_report(logs)
        c["fleet_report"] = {"rc": rc, "ok": rep.get("ok"),
                             "rows": _report_rows(rep)}
        _gate_report("16c", rc, rep, c["fleet_report"]["rows"], failures)
    out["16c"] = c

    # 16d: the training driver, one process a host, on 10c's fixture.
    cfg = stream_driver_config(os.path.join(WORK, "fleet_driver"))
    cfg_path = os.path.join(WORK, "fleet_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    args = ["--config", cfg_path, "--spill-dir",
            os.path.join(WORK, "fleet_driver_spill"), "--telemetry",
            "metrics", *(["--device", "cpu"] if device == "cpu" else [])]
    coord = fleet.ReduceCoordinator(FLEET_HOSTS,
                                    stall_timeout_s=FLEET_STALL_S)
    t = time.perf_counter()
    try:
        runs = _fleet_wait({f"host {h}": (
            _spawn_fleet(["-m", "photon_ml_torch.cli.game_training_driver",
                          *args], coord, h, "d"),
            os.path.join(WORK, f"fleet_d_{h}"))
            for h in range(FLEET_HOSTS)}, failures, "16d",
            need_result=False)
    finally:
        coord.close()
    dd: dict = {"wall_s": time.perf_counter() - t, "reduces": coord.reduces}
    trees = [os.path.join(cfg["output_dir"], f"host_{h:03d}")
             for h in range(FLEET_HOSTS)]
    if all(r["rc"] == 0 for r in runs.values()):
        info = []
        for h, tree in enumerate(trees):
            header = next((e for e in _read_log(os.path.join(
                tree, "run_log.jsonl")) if e["event"] == "run_header"), {})
            info.append({k: header.get(k) for k in (
                "fleet_host", "fleet_hosts", "fleet_transport")})
        dd["run_info"] = info
        if info != [{"fleet_host": h, "fleet_hosts": FLEET_HOSTS,
                     "fleet_transport": "tcp"} for h in range(FLEET_HOSTS)]:
            failures.append(f"16d: run_info fleet fields {info}")
        models = [load_game_model(os.path.join(tree, "model"))[0]
                  for tree in trees]
        want, _ = load_game_model(os.path.join(ref_10c_dir, "model"))
        arrays = []
        for m in models:
            arr = {"global": m.models["global"].coefficients.means.numpy()}
            for name, sub in m.models.items():
                if hasattr(sub, "coefficient_blocks"):
                    for i, blk in enumerate(sub.coefficient_blocks):
                        arr[f"{name}.{i}"] = blk.numpy()
            arrays.append(arr)
        w_want = want.models["global"].coefficients.means.numpy()
        dd["bitwise"] = all(_coefs_equal(arrays[0], x) for x in arrays[1:])
        dd["max_abs_dw_vs_10c"] = float(np.abs(arrays[0]["global"]
                                               - w_want).max())
        if not dd["bitwise"]:
            failures.append("16d: the hosts' saved models differ")
        if not np.allclose(arrays[0]["global"], w_want,
                           rtol=DRIVER_COEF_TOL, atol=DRIVER_COEF_TOL):
            failures.append(f"16d: the fleet model differs by "
                            f"{dd['max_abs_dw_vs_10c']:g} from 10c's")
        rc, rep = _fleet_report([os.path.join(tree, "run_log.jsonl")
                                 for tree in trees])
        dd["fleet_report"] = {"rc": rc, "ok": rep.get("ok"),
                              "rows": _report_rows(rep)}
        _gate_report("16d", rc, rep, dd["fleet_report"]["rows"], failures)
    elif not any("16d" in f for f in failures):
        failures.append("16d: a driver host failed")
    out["16d"] = dd
    out["failures"] = failures
    return out


# -- main ---------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# -- phase 17: meshes ---------------------------------------------------------

MESH_DEVICES = 8          # shards of phase 17's meshes (all on cuda:0 here)
MESH_CHUNK_DEVICES = 2    # 17c's chunks × shards


def _sync_card() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def mesh_fe_config(layout: str, device: str, optimizer=OptimizerType.LBFGS,
                   task=TaskType.LOGISTIC_REGRESSION, iters: int = TRAIN_ITERS,
                   n_devices: int = MESH_DEVICES) -> TrainingConfig:
    """Phase 6's problem (config 1, or config 2 with TRON and the squared
    loss) as a one-coordinate ``TrainingConfig`` on ``n_devices`` shards:
    the rows already carry phase 6's intercept column, and the solver
    settings are ``OptimizationProblem``'s defaults."""
    evaluator = (EvaluatorType.AUC if task == TaskType.LOGISTIC_REGRESSION
                 else EvaluatorType.RMSE)
    return TrainingConfig(
        task_type=task,
        coordinates=[CoordinateConfig(
            "global", CoordinateKind.FIXED_EFFECT, "global",
            optimizer=OptimizerSettings(
                optimizer=optimizer, max_iters=iters, reg_weight=TRAIN_L2,
                tolerance=OptimizerConfig().tolerance))],
        update_sequence=["global"], n_iterations=1, evaluators=[evaluator],
        sparse_layout=layout, intercept=False, n_devices=n_devices,
        device=device)


def _fe_dataset(rows, labels) -> GameDataset:
    return GameDataset(labels=np.asarray(labels, np.float32),
                       features={"global": rows}, entity_ids={},
                       feature_dims={"global": D + 1})


def _mesh_fit(config: TrainingConfig, train, valid, prep) -> dict:
    """One ``GameEstimator.fit`` on an already sharded dataset (``prep``
    from ``_prepare``), with every kernel count set to 0 just before
    and read just after, and the fixed effect's solve wall from the run
    log."""
    est = GameEstimator(config)
    est._prepare = lambda _train: prep
    log_path = os.path.join(WORK, f"mesh_{time.monotonic_ns()}.jsonl")
    gather_rowsum.launches = 0
    grr_contract.launches = grr_contract_dense.launches = 0
    with RunLogger(log_path) as log:
        t = time.perf_counter()
        res = est.fit(train, valid, run_logger=log)[0]
        _sync_card()
        wall = time.perf_counter() - t
    solve_s = sum(e["duration_s"] for e in read_run_log(log_path)
                  if e["event"] == "cd_coordinate")
    ev = next(iter(res.evaluations.values()))
    return {"wall_s": wall, "solve_s": solve_s,
            "fe_value": float(res.descent.history[-1]["global"]["value"]),
            "evaluation": float(ev),
            "launches": {"gather_rowsum": gather_rowsum.launches,
                         "grr_contract": grr_contract.launches,
                         "grr_contract_dense": grr_contract_dense.launches},
            "w": res.model.models["global"].coefficients.means}


def _per_evaluation_launches(dobj, w, batch) -> dict:
    """The kernel launches of one ``value_and_gradient`` on the mesh."""
    gather_rowsum.launches = 0
    grr_contract.launches = grr_contract_dense.launches = 0
    dobj.value_and_gradient(w, batch)
    _sync_card()
    return {"gather_rowsum": gather_rowsum.launches,
            "grr": grr_contract.launches + grr_contract_dense.launches}


def _mesh_shard_shapes(layout: str, batch, w, rng, time_it: bool) -> list:
    """Each shard's kernel shapes against their plain versions: B1 over
    the shard's ELL rows (the table w) and its transposed ELL (the table
    a residual over the shard's rows), B2/B3 at every padded level of
    the shard's GRR plan; shard 0 timed."""
    shapes = []
    for i, shard in enumerate(batch.shards):
        timed = time_it and i == 0
        if layout == "ELL":
            scale = max(1.0, float(w.abs().max()))
            shapes.append(check_b1_case(
                f"mesh_ell_shard{i}_{shard.values.shape[0]}x"
                f"{shard.values.shape[1]}", w, shard.values, shard.col_ids,
                ATOL * scale, time_it=timed))
        elif layout == "COLMAJOR":
            cm = shard.colmajor
            r = ((torch.sigmoid(shard.margins(w)) - shard.labels)
                 * shard.mask).contiguous()
            entry = check_b1_case(
                f"mesh_colmajor_shard{i}_{cm.n_virtual_rows}x{cm.capacity}",
                r, cm.tvals, cm.trows, COLMAJOR_ATOL, time_it=timed)
            entry["padding_share"] = float((cm.tvals == 0).sum()) / \
                cm.tvals.numel()
            shapes.append(entry)
        else:
            for name, d in plan_levels(shard.grr):
                lv = check_grr_level(f"shard{i}.{name}", d, rng, timed)
                lv["real_supertiles"] = int(torch.count_nonzero(
                    d.vals.abs().sum(dim=(1, 2))))
                print(f"  {lv['kernel']} shard{i}.{name}: " + json.dumps(lv))
                shapes.append(lv)
    return shapes


def phase_mesh(data: dict, training: dict, device: str,
               time_it: bool = True) -> dict:
    """Phase 17a (module docstring): config 1 on 8 shards through
    ``GameEstimator`` on the ELL, transposed-ELL and GRR layouts, and
    config 2 (TRON, so the HVP through the mesh) on the transposed ELL,
    against phase 6's float64 surfaces and single-device fits; each new
    per-shard kernel shape against its plain version."""
    from photon_ml_torch.parallel import DistributedGLMObjective

    failures: list = []
    train = _fe_dataset(data["rows"], data["labels"])
    valid = _fe_dataset(data["test_rows"], data["test_labels"])
    f64 = data["f64"]
    w_t = torch.from_numpy(f64["w"].astype(np.float32)).to(device)
    v_t = torch.from_numpy(f64["v"].astype(np.float32)).to(device)
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(TRAIN_L2),
                       NormalizationContext.identity())
    single = {"ELL": (training["loss_final_ell"], training["test_auc_ell"],
                      training["fit_ell_s"]),
              "COLMAJOR": (training["loss_final_colmajor"],
                           training["test_auc_colmajor"],
                           training["fit_colmajor_s"]),
              "GRR": (training["loss_final"], training["test_auc"],
                      training["fit_s"])}
    rng = np.random.default_rng(17)
    out: dict = {"shards": MESH_DEVICES, "shapes": {}}
    launches = {"gather_rowsum": 0, "grr_contract": 0,
                "grr_contract_dense": 0}
    for layout in ("ELL", "COLMAJOR", "GRR"):
        cfg = mesh_fe_config(layout, device)
        t = time.perf_counter()
        prep = GameEstimator(cfg)._prepare(train)
        _sync_card()
        build_s = time.perf_counter() - t
        batch = prep["global"]["batch"]
        dobj = DistributedGLMObjective(obj, batch.mesh)
        val, grad = dobj.value_and_gradient(w_t, batch)
        got = {"gradient": grad,
               "hessian_vector": dobj.hessian_vector(w_t, v_t, batch),
               "hessian_diagonal": dobj.hessian_diagonal(w_t, batch)}
        errors = {"value": abs(float(val) - f64["ref"]["value"])
                  / abs(f64["ref"]["value"])}
        for key, g in got.items():
            ref = f64["ref"][key]
            errors[key] = float(np.abs(g.double().cpu().numpy() - ref).max()
                                / np.abs(ref).max())
        per_eval = _per_evaluation_launches(dobj, w_t, batch)
        fit = _mesh_fit(cfg, train, valid, prep)
        for k, n in fit["launches"].items():
            launches[k] += n
        loss_1, auc_1, solve_1 = single[layout]
        entry = {
            "build_s": build_s, "rows_per_shard": batch.rows_per_shard,
            "f64_errors": errors, "per_evaluation_launches": per_eval,
            "fit_wall_s": fit["wall_s"], "fit_solve_s": fit["solve_s"],
            "single_device_solve_s": solve_1,
            "loss_final": fit["fe_value"], "single_loss_final": loss_1,
            "loss_gap_rel": abs(fit["fe_value"] - loss_1) / abs(loss_1),
            "auc": fit["evaluation"], "single_auc": auc_1,
            "auc_gap": abs(fit["evaluation"] - auc_1),
            "fit_launches": fit["launches"]}
        for key, err in errors.items():
            limit = F64_VALUE_RTOL if key == "value" else F64_VECTOR_RTOL
            if not err <= limit:
                failures.append(f"17a {layout}: {key} differs from the "
                                f"float64 reference by {err:g} > {limit:g}")
        if not entry["loss_gap_rel"] <= LAYOUT_LOSS_RTOL:
            failures.append(f"17a {layout}: the mesh fit ends "
                            f"{entry['loss_gap_rel']:g} from the single "
                            "device's (relative)")
        if not entry["auc_gap"] <= GAME_LAYOUT_AUC_ATOL:
            failures.append(f"17a {layout}: AUC {fit['evaluation']:.5f} vs "
                            f"the single device's {auc_1:.5f}")
        if layout == "GRR":
            levels = sum(len(plan_levels(s.grr)) for s in batch.shards)
            entry["padded_levels"] = levels
        if device == "cpu":
            pass                 # the plain versions count no launch
        elif layout == "GRR":
            if per_eval["grr"] != levels:
                failures.append(f"17a GRR: one evaluation launched B2/B3 "
                                f"{per_eval['grr']} times for {levels} "
                                "padded levels over the shards")
            if fit["launches"]["grr_contract"] \
                    + fit["launches"]["grr_contract_dense"] < levels:
                failures.append("17a GRR: the fit launched B2/B3 fewer "
                                "times than one evaluation")
        else:
            want = MESH_DEVICES * (1 if layout == "ELL" else 2)
            if per_eval["gather_rowsum"] != want:
                failures.append(f"17a {layout}: one evaluation launched B1 "
                                f"{per_eval['gather_rowsum']} times, not "
                                f"{want}")
            # The fit's launches: its evaluations' (8 or 16 each) and
            # the validation's scoring (one a sweep, single device).
            n_b1 = fit["launches"]["gather_rowsum"]
            if n_b1 < want:
                failures.append(f"17a {layout}: the fit launched B1 {n_b1} "
                                f"times, fewer than one evaluation's")
        out["shapes"][layout] = _mesh_shard_shapes(layout, batch, w_t, rng,
                                                   time_it)
        out[layout.lower()] = entry
        print(f"  17a {layout}: " + json.dumps(entry))
        if layout == "COLMAJOR":
            cm_prep = prep            # config 2's: the same shards
        del prep, batch, dobj

    # Config 2: TRON (squared loss) on the transposed ELL.
    cfg = mesh_fe_config("COLMAJOR", device, optimizer=OptimizerType.TRON,
                         task=TaskType.LINEAR_REGRESSION, iters=TRON_ITERS)
    fit = _mesh_fit(cfg, train, valid, cm_prep)
    for k, n in fit["launches"].items():
        launches[k] += n
    want = training["config2"]["tron_colmajor"]["loss_final"]
    gap = abs(fit["fe_value"] - want) / abs(want)
    out["config2_tron_colmajor"] = {
        "loss_final": fit["fe_value"], "single_loss_final": want,
        "loss_gap_rel": gap, "fit_wall_s": fit["wall_s"],
        "fit_solve_s": fit["solve_s"],
        "single_device_solve_s": training["config2"]["tron_colmajor"][
            "fit_s"], "fit_launches": fit["launches"]}
    if not gap <= LAYOUT_LOSS_RTOL:
        failures.append(f"17a config-2 TRON: the mesh fit ends {gap:g} from "
                        "the single device's (relative)")
    del cm_prep
    fast = [lv["level"] for lv in out["shapes"]["GRR"]
            if lv.get("share_of_bound", 0.0) > GRR_BOUND_SLACK]
    if fast:
        failures.append(f"17a: L2-cold times beat the HBM bound at {fast}")
    out["launches"] = launches
    out["failures"] = failures
    return out


def phase_mesh_game(seed: int, n: int, device: str, ref: dict,
                    d: int = D, n_entities: int = N_ENTITIES) -> dict:
    """Phase 17b: config 5 (phase 7's ELL fit) on 8 shards: the fixed
    effect's rows and both random effects' entities sharded; AUC within
    phase 7's layout gate of its fit (``ref``: its AUC and wall)."""
    failures: list = []
    data = make_game_data(seed, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    del data
    fit = _fit_game(dataclasses.replace(game_config("ELL", device),
                                        n_devices=MESH_DEVICES),
                    train, valid)
    res = fit.pop("result")
    shard_entities = sorted({b["entities"] for b in fit["buckets"]})
    out = {k: v for k, v in fit.items() if k != "buckets"}
    out.update(shards=MESH_DEVICES, bucket_solves=len(fit["buckets"]),
               shard_entities=shard_entities,
               single_device_auc=ref["auc"],
               single_device_wall_s=ref["wall_s"],
               auc_gap=abs(fit["auc"] - ref["auc"]))
    if not out["auc_gap"] <= GAME_LAYOUT_AUC_ATOL:
        failures.append(f"17b: AUC {fit['auc']:.5f} vs phase 7's "
                        f"{ref['auc']:.5f}")
    # Every fixed-effect evaluation runs its 8 shards' margins, each one
    # B1 launch: the shard evaluations come in eights, one launch each.
    if fit["fe_evaluations"] % MESH_DEVICES or \
            fit["fe_evaluations"] < MESH_DEVICES:
        failures.append(f"17b: {fit['fe_evaluations']} shard evaluations, "
                        f"not whole evaluations of {MESH_DEVICES} shards")
    if device != "cpu" and \
            fit["fe_evaluation_launches"] != fit["fe_evaluations"]:
        failures.append(f"17b: B1 launched {fit['fe_evaluation_launches']} "
                        f"times in {fit['fe_evaluations']} shard "
                        "evaluations (one each)")
    for name in ("per_user", "per_item"):
        blocks = res.model.models[name].coefficient_blocks
        if any(b.shape[0] % MESH_DEVICES for b in blocks):
            failures.append(f"17b: {name}'s blocks are not padded to the "
                            "entity mesh")
    out["failures"] = failures
    return out


def _chunk_pieces(host) -> list:
    """A host chunk's pieces: its shards' under a mesh, else itself."""
    return host if isinstance(host, list) else [host]


def phase_mesh_stream(ref_10a: dict, device: str, seed: int = 7,
                      n: int = GAME_ROWS, d: int = D,
                      n_entities: int = N_ENTITIES,
                      chunk_rows: int = STREAM_CHUNK_ROWS,
                      time_it: bool = True, spill: bool = False) -> dict:
    """Phase 17c: phase 10a's chunked fit with GRR chunks (B2/B3 on
    every chunk of every pass), then with GRR chunks × 2 shards; each
    within phase 10's gates of 10a (``ref_10a``); the chunk plans' padded
    levels against their plain versions.  The chunks stay on the card
    (placed once through the pinned ring, as 10a's resident variant);
    ``spill`` streams them from disk every pass instead (a GRR pass moves
    its plans, ~1.3 GB: ROADMAP B4.14)."""
    failures: list = []
    data = make_game_data(seed, n, d=d, n_entities=n_entities)
    n_train = n - int(n * TRAIN_HOLDOUT)
    train, valid = data.take(slice(0, n_train)), data.take(slice(n_train, n))
    del data
    out: dict = {"chunk_rows": chunk_rows}
    rng = np.random.default_rng(23)
    launches = {"grr_contract": 0, "grr_contract_dense": 0,
                "gather_rowsum": 0}
    shapes = []
    n_chunks = -(-n_train // chunk_rows)
    for name, over in (("grr", {}),
                       ("grr_mesh", {"n_devices": MESH_CHUNK_DEVICES})):
        spill_dir = (os.path.join(WORK, f"mesh_stream_{name}") if spill
                     else None)
        resident = {} if spill else {"chunk_max_resident": n_chunks}
        grr_contract.launches = grr_contract_dense.launches = 0
        fit = _stream_fit(stream_config(device, spill_dir, chunk_rows,
                                        chunk_layout="GRR", **over,
                                        **resident),
                          train, valid)
        n_grr = grr_contract.launches + grr_contract_dense.launches
        launches["grr_contract"] += grr_contract.launches
        launches["grr_contract_dense"] += grr_contract_dense.launches
        launches["gather_rowsum"] += fit["launches"]
        probe = fit["probe"]
        evals = probe.evaluations(("value", "value_and_gradient"))
        fe = probe.objectives[0]
        pieces = 1 if fe.batch.mesh is None else fe.batch.mesh.size
        chunk_passes = sum(c["chunks"] for c in evals)
        entry = {"wall_s": fit["wall_s"], "stages": fit["stages"],
                 "single_device_ell_wall_s": ref_10a["wall_s"],
                 "evaluations": len(evals), "chunk_passes": chunk_passes,
                 "pieces_a_chunk": pieces, "grr_launches": n_grr,
                 "b1_launches": fit["launches"],
                 **_stream_gates(f"17c {name} vs 10a", _fit_summary(fit),
                                 ref_10a, failures)}
        if not evals:
            failures.append(f"17c {name}: no chunked evaluation")
        if device != "cpu" and n_grr < chunk_passes * pieces:
            failures.append(f"17c {name}: B2/B3 launched {n_grr} times for "
                            f"{chunk_passes} chunk passes × {pieces} pieces")
        # One chunked evaluation launches every padded level of every
        # chunk's pieces exactly once (17a's gate, chunk by chunk).
        levels = sum(len(plan_levels(p.grr))
                     for cid in range(fe.batch.n_chunks)
                     for p in _chunk_pieces(fe.batch.chunk(cid)))
        co = streaming_mod.ChunkedGLMObjective(
            fe.objective, fe.batch, max_resident=0, prefetch_depth=2,
            device=device)
        w = torch.from_numpy(_fit_summary(fit)["w"]).to(device)
        grr_contract.launches = grr_contract_dense.launches = 0
        co.value_and_gradient(w)
        _sync_card()
        entry.update(evaluation_padded_levels=levels,
                     evaluation_grr_launches=grr_contract.launches
                     + grr_contract_dense.launches)
        if device != "cpu" and entry["evaluation_grr_launches"] != levels:
            failures.append(f"17c {name}: one evaluation launched B2/B3 "
                            f"{entry['evaluation_grr_launches']} times for "
                            f"{levels} padded levels over the chunks' "
                            "pieces")
        del co, w
        if device != "cpu" and not all(dv.startswith("cuda")
                                       for dv in probe.placed_devices):
            failures.append(f"17c {name}: chunks placed on "
                            f"{sorted(probe.placed_devices)}")
        # The first chunk's plan (or pieces' plans) level by level.
        for j, piece in enumerate(_chunk_pieces(fe.batch.chunk(0))):
            pair = piece.grr.to(device)
            for lname, lv in plan_levels(pair):
                lvl = check_grr_level(f"{name}.chunk0.piece{j}.{lname}", lv,
                                      rng, time_it and name == "grr")
                lvl["real_supertiles"] = int(torch.count_nonzero(
                    lv.vals.abs().sum(dim=(1, 2))))
                print(f"  {lvl['kernel']} {lvl['level']}: "
                      + json.dumps(lvl))
                shapes.append(lvl)
            del pair
        out[name] = entry
        print(f"  17c {name}: " + json.dumps(entry, default=str))
        del fit, probe, fe
    fast = [lv["level"] for lv in shapes
            if lv.get("share_of_bound", 0.0) > GRR_BOUND_SLACK]
    if fast:
        failures.append(f"17c: L2-cold times beat the HBM bound at {fast}")
    out["shapes"] = shapes
    out["launches"] = launches
    out["failures"] = failures
    return out


def phase_mesh_driver(ref_10c_dir: str, failures: list,
                      device_args: list = ()) -> dict:
    """Phase 17d: the training driver with ``distributed_init`` and 8
    shards on phase 10c's chunked config-4 fixture, in this process (no
    ``JAX_*`` variables: a world of one): the process group is NCCL
    (gloo with ``--device cpu``; the run log's ``distributed``) and gone
    after the run, its model within phase 8's coefficient tolerance of
    10c's uninterrupted run (``ref_10c_dir``)."""
    import torch.distributed as dist

    from photon_ml_torch.cli import game_training_driver

    out_dir = os.path.join(WORK, "mesh_driver")
    cfg = stream_driver_config(out_dir)
    cfg.update(distributed_init=True, n_devices=MESH_DEVICES)
    cfg_path = os.path.join(WORK, "mesh_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        game_training_driver.main([
            "--config", cfg_path, "--spill-dir",
            os.path.join(WORK, "mesh_driver_spill"), *device_args])
    out = {"wall_s": time.perf_counter() - t,
           "group_left": dist.is_initialized()}
    if out["group_left"]:
        failures.append("17d: the driver left its process group behind")
    header = _read_log(os.path.join(out_dir, "run_log.jsonl"))[0]
    out["distributed"] = header.get("distributed")
    backend = "gloo" if "cpu" in device_args else "nccl"
    if out["distributed"] != {"backend": backend, "world": 1, "rank": 0}:
        failures.append(f"17d: process group {out['distributed']}, not a "
                        f"world of one {backend} process")
    got, _ = load_game_model(os.path.join(out_dir, "model"))
    want, _ = load_game_model(os.path.join(ref_10c_dir, "model"))
    w_got = got.models["global"].coefficients.means.numpy()
    w_want = want.models["global"].coefficients.means.numpy()
    out["max_abs_dw"] = float(np.abs(w_got - w_want).max())
    if not np.allclose(w_got, w_want, rtol=DRIVER_COEF_TOL,
                       atol=DRIVER_COEF_TOL):
        failures.append(f"17d: the model differs from 10c's by "
                        f"{out['max_abs_dw']:g}")
    return out


def mesh_references(device: str,
                    parts=("17a", "17b", "17c", "17d")) -> tuple:
    """Phase 17's references when it runs alone, for the sub-phases in
    ``parts`` (None where not needed): phase 6's data, fits and float64
    surfaces (untimed), phase 7's ELL fit, phase 10a's streamed fit and
    phase 10c's uninterrupted driver run, as ``main()`` hands them
    over."""
    from photon_ml_torch.cli import game_training_driver

    train = training = ref_7 = ref_10a = out_dir = None
    if "17a" in parts:
        train = phase_train_build(seed=3, n=TRAIN_ROWS, device=device)
        training = phase_training(train, time_it=False)
    data = make_game_data(7, GAME_ROWS)
    n_train = GAME_ROWS - int(GAME_ROWS * TRAIN_HOLDOUT)
    gtrain = data.take(slice(0, n_train))
    gvalid = data.take(slice(n_train, GAME_ROWS))
    del data
    if "17b" in parts:
        fit = _fit_game(game_config("ELL", device), gtrain, gvalid)
        ref_7 = {"auc": fit["auc"], "wall_s": fit["wall_s"]}
        del fit
    if "17c" in parts:
        fit = _stream_fit(stream_config(device, os.path.join(
            WORK, "mesh_ref_spill"), STREAM_CHUNK_ROWS), gtrain, gvalid)
        ref_10a = dict(_fit_summary(fit), wall_s=fit["wall_s"])
        del fit
    del gtrain, gvalid
    if "17d" not in parts:
        return train, training, ref_7, ref_10a, out_dir
    out_dir = os.path.join(WORK, "mesh_ref_driver")
    cfg_path = os.path.join(WORK, "mesh_ref_driver.json")
    with open(cfg_path, "w") as f:
        json.dump(stream_driver_config(out_dir), f)
    with contextlib.redirect_stdout(io.StringIO()):
        game_training_driver.main([
            "--config", cfg_path, "--spill-dir",
            os.path.join(WORK, "mesh_ref_driver_spill")])
    return train, training, ref_7, ref_10a, out_dir


def add_mesh_shapes(kernels: list, launches: dict, key: str,
                    b1_shapes: list, grr_shapes: list) -> None:
    """Phase 17's launches (under ``key``) and checked shapes into the
    kernel entries of B1 (``kernels[0]``) and of B2/B3."""
    by_name = {k["name"]: k for k in kernels}
    b1 = by_name["gather_rowsum"]
    b1[key] = launches["gather_rowsum"]
    b1["shapes"] += b1_shapes
    for name in ("grr_contract_dense", "grr_contract"):
        entry = by_name[name]
        entry[key] = launches[name]
        entry["shapes"] += [lv for lv in grr_shapes if lv["kernel"] == name]
    for entry in by_name.values():
        entry["max_abs_err"] = max(
            sh["max_abs_err"] for sh in entry["shapes"])


# -- phase 18: the kernel build cache -----------------------------------------

# Run in a fresh process, so that no kernel library is loaded yet: point
# the build directory at argv[1] (which holds the built libraries), load
# every library, launch B1 once on argv[2]'s arrays against its plain
# version (rtol argv[3], atol argv[4]); one JSON line of the result.
_CACHE_CHILD = r"""
import json, sys
import numpy as np
import torch
from photon_ml_torch.cache import enable_compilation_cache
from photon_ml_torch.kernels import _build
from photon_ml_torch.ops.kernels import gather_rowsum, gather_rowsum_reference

builds = []
_build.add_build_listener(builds.append)
kernels_dir = enable_compilation_cache(sys.argv[1])
paths = {name: _build.load(name)._name for name in sorted(_build._SIGNATURES)}
arrays = np.load(sys.argv[2])
table, vals, ids = (torch.from_numpy(arrays[key]).cuda()
                    for key in ("table", "vals", "ids"))
gather_rowsum.launches = 0
got = gather_rowsum(table, vals, ids)
torch.cuda.synchronize()
launches = gather_rowsum.launches
want = gather_rowsum_reference(table, vals, ids).cpu().numpy()
got = got.cpu().numpy()
err = float(np.max(np.abs(got - want)))
np.testing.assert_allclose(got, want, rtol=float(sys.argv[3]),
                           atol=float(sys.argv[4]))
print(json.dumps({"kernels_dir": kernels_dir, "paths": paths,
                  "builds": builds, "launches": launches,
                  "finite": bool(np.isfinite(got).all()),
                  "max_abs_err": err}))
"""


def phase_compile_cache(libs: list, seed: int) -> dict:
    """``enable_compilation_cache`` on the card: a subprocess points the
    kernels' build directory at a fresh cache directory into which the
    built libraries ``libs`` were copied under their hashed names, loads
    every kernel library from there and launches B1 once at the serving
    shape against its plain version.  Gates: every library path lies
    under the directory, no build, one launch, B1 within phase 3's
    tolerance."""
    failures = []
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(0, 1, D).astype(np.float32)).cuda()
    vals, ids = kernel_inputs(rng, table, *KERNEL_SHAPES[0])
    with tempfile.TemporaryDirectory(prefix="photon-compile-cache-") as tmp:
        kdir = os.path.join(tmp, "kernels")
        os.makedirs(kdir)
        for p in libs:
            shutil.copy2(p, os.path.join(kdir, os.path.basename(p)))
        inputs = os.path.join(tmp, "b1.npz")
        np.savez(inputs, table=table.cpu().numpy(), vals=vals.cpu().numpy(),
                 ids=ids.cpu().numpy())
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _CACHE_CHILD, tmp, inputs, repr(RTOL),
             repr(ATOL)], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        wall_s = time.perf_counter() - t
    out = {"wall_s": wall_s, "rc": proc.returncode, "shape": list(
        KERNEL_SHAPES[0]), "rtol": RTOL, "atol": ATOL}
    if proc.returncode != 0:
        failures.append(f"the cache subprocess exited {proc.returncode}: "
                        + proc.stderr[-2000:])
        return dict(out, failures=failures)
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    out.update(res)
    out["paths"] = {n: os.path.relpath(p, tmp)
                    for n, p in res["paths"].items()}
    if res["kernels_dir"] != kdir:
        failures.append(f"build directory {res['kernels_dir']} is not "
                        f"{kdir}")
    if sorted(res["paths"]) != sorted(_build._SIGNATURES):
        failures.append(f"loaded {sorted(res['paths'])}")
    outside = [n for n, p in res["paths"].items()
               if os.path.dirname(p) != kdir]
    if outside:
        failures.append(f"libraries loaded outside the cache: {outside}")
    if res["builds"]:
        failures.append(f"built {res['builds']} with every library cached")
    if res["launches"] != 1 or not res["finite"]:
        failures.append(f"B1 launched {res['launches']} time(s), finite "
                        f"{res['finite']}")
    return dict(out, failures=failures)


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
        compile_cache = phase_compile_cache(libs, seed=18)
        compile_cache["card"] = card
        print("phase 18 compile cache: " + json.dumps(
            {"compile_cache": compile_cache}))
        if compile_cache["failures"]:
            raise AssertionError("phase 18: " + "; ".join(
                compile_cache["failures"]))

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
        kernels.append(phase_kernels_sorted(seed=10))
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
        tiers = phase_tiers(model_dir, os.path.join(WORK, "spill"), rows,
                            ref_m, ref_p, "cuda", proj={})
        tiers["card"] = card
        print(f"phase 14 serving tiers ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"tiers": tiers}, default=str))
        if tiers["failures"]:
            raise AssertionError("phase 14: " + "; ".join(
                tiers["failures"]))
        kernels[0]["launches_traced_serving"] = tiers["launches"]

        t = time.perf_counter()
        model2, host2 = make_model(seed=1)
        fleet = phase_fleet(model_dir, os.path.join(WORK, "spill"), rows,
                            ref_m, ref_p, "cuda", model2,
                            reference(host2, rows))
        del model2, host2
        fleet["card"] = card
        fleet["phase_14_latency_ms"] = tiers["latency_ms"]
        print(f"phase 15 fleet ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"fleet": fleet}, default=str))
        if fleet["failures"]:
            raise AssertionError("phase 15: " + "; ".join(
                fleet["failures"]))
        kernels[0]["fleet_batches"] = fleet["fleet_batches"]

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
        kernels[4]["launches_ell_fit"] = training[
            "ell_sorted_colsum_launches"]
        for k in kernels[1:3]:          # the GRR kernels
            k["launches"] = training["launches"][k["name"]]
            if k["launches"] < 1:
                raise AssertionError(f"{k['name']} was not launched by "
                                     "the GRR fit")
        sweep = {key: train[key] for key in ("rows", "labels", "test_rows",
                                              "test_labels")}

        t = time.perf_counter()
        mesh = phase_mesh(train, training, "cuda")
        mesh["card"] = card
        print(f"phase 17a mesh training ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"mesh": mesh}, default=str))
        if mesh["failures"]:
            raise AssertionError("phase 17a: " + "; ".join(
                mesh["failures"]))
        add_mesh_shapes(kernels, mesh["launches"], "launches_mesh_fits",
                        mesh["shapes"]["ELL"] + mesh["shapes"]["COLMAJOR"],
                        mesh["shapes"]["GRR"])
        del train, mesh

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
        kernels[4]["launches_game_fit"] = game["ell"][
            "fe_gradient_sorted_colsum"]
        kernels[4]["launches"] = (kernels[4]["launches_ell_fit"]
                                  + kernels[4]["launches_game_fit"])
        kernels[4]["shapes"].append(game["sorted_shape"])

        t = time.perf_counter()
        mesh_game = phase_mesh_game(seed=7, n=GAME_ROWS, device="cuda",
                                    ref=game["ell"])
        mesh_game["card"] = card
        print(f"phase 17b mesh GAME training ({time.perf_counter() - t:.1f}"
              " s): " + json.dumps({"mesh_game": mesh_game}, default=str))
        if mesh_game["failures"]:
            raise AssertionError("phase 17b: " + "; ".join(
                mesh_game["failures"]))
        kernels[0]["launches_mesh_game_fit"] = mesh_game["launches"]
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
        kernels[0]["launches_stream_fit"] = stream["10a"]["launches"]

        t = time.perf_counter()
        mesh_stream = phase_mesh_stream(
            dict(fit_10a, wall_s=stream["10a"]["wall_s"]), "cuda")
        mesh_stream["17d"] = phase_mesh_driver(
            os.path.join(WORK, "stream_driver_full"), mesh_stream["failures"])
        mesh_stream["card"] = card
        print(f"phase 17c-d mesh streamed training and driver ("
              f"{time.perf_counter() - t:.1f} s): "
              + json.dumps({"mesh_stream": mesh_stream}, default=str))
        if mesh_stream["failures"]:
            raise AssertionError("phase 17c-d: " + "; ".join(
                mesh_stream["failures"]))
        add_mesh_shapes(kernels, mesh_stream["launches"],
                        "launches_mesh_stream_fits", [],
                        mesh_stream["shapes"])
        del mesh_stream
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
        score_rows = ooc.pop("train")
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

        t = time.perf_counter()
        model_10a = fit_10a.pop("model")
        score = phase_stream_score(model_10a, score_rows, "cuda")
        score["12b"] = phase_stream_score_driver(driver, [],
                                                 score["failures"])
        score["card"] = card
        print(f"phase 12 streamed scoring ({time.perf_counter() - t:.1f} "
              "s): " + json.dumps({"stream_score": score}, default=str))
        if score["failures"]:
            raise AssertionError("phase 12: " + "; ".join(
                score["failures"]))
        kernels[0]["launches_stream_scoring"] = score["launches"]
        kernels[0]["launches_stream_scoring_driver"] = score["12b"][
            "launches"]
        kernels[0]["shapes"].append(score["kernel_shape"])
        kernels[0]["max_abs_err"] = max(
            sh["max_abs_err"] for sh in kernels[0]["shapes"])

        t = time.perf_counter()
        tel = {"13a": phase_telemetry(stream, fit_10a, "cuda")}
        tel["13b"] = phase_telemetry_score(model_10a, score_rows, "cuda")
        del score_rows, model_10a
        tel["13c"] = phase_telemetry_sweep(sweep, stream_sweep, "cuda")
        del sweep
        tel["13d"] = phase_telemetry_driver([])
        tel["card"] = card
        print(f"phase 13 telemetry ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"telemetry": tel}, default=str))
        tel_failures = [f for part in ("13a", "13b", "13c", "13d")
                        for f in tel[part]["failures"]]
        if tel_failures:
            raise AssertionError("phase 13: " + "; ".join(tel_failures))
        kernels[0]["launches_telemetry_fits"] = {
            mode: tel["13a"]["launches"][mode]
            for mode in ("metrics", "trace")}
        kernels[0]["launches_telemetry_scoring"] = tel["13b"]["launches"]
        lanes["launches_telemetry_sweep"] = tel["13c"]["lane_launches"]

        t = time.perf_counter()
        torch.cuda.empty_cache()
        ref_10a = dict(fit_10a, wall_s=stream["10a"]["wall_s"])
        ref_11b = {"auc": ooc["11b"]["auc"],
                   "cycle_ms": float(np.median(ooc["11b"]["cycle_ms"]))}
        fleet_training = phase_fleet_training(
            ref_10a, ref_11b, os.path.join(WORK, "stream_driver_full"),
            "cuda")
        fleet_training["card"] = card
        print(f"phase 16 training fleet ({time.perf_counter() - t:.1f} s): "
              + json.dumps({"fleet_training": fleet_training}, default=str))
        if fleet_training["failures"]:
            raise AssertionError("phase 16: " + "; ".join(
                fleet_training["failures"]))
        kernels[0]["launches_fleet_fit"] = fleet_training["16a"]["launches"]
        kernels[0]["launches_fleet_fused"] = fleet_training["16c"][
            "launches"]
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"compile_cache": {
        key: compile_cache[key] for key in ("wall_s", "builds", "paths",
                                            "launches", "max_abs_err")}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
