"""Training, scoring and serving configuration.

Counterpart of ``photon_ml_tpu/config.py``: ``TrainingConfig`` (with
``CoordinateConfig``, ``OptimizerSettings`` and ``TuningConfig``),
``ScoringConfig`` and ``ServingConfig``, with the same JSON keys plus
``device`` ("cuda", the default, or "cpu").  Checkpoints and resume
(``checkpoint_dir``, ``resume`` and their cadences) and the
chunk-streamed, disk-spilled fixed effect (``chunk_rows``,
``chunk_layout``, ``chunk_max_resident``, ``spill_dir``,
``host_max_resident``, ``prefetch_depth``), streamed random effects
and the fused cycle (``re_chunk_entities``, ``cd_fused``) and streamed
scoring (``score_chunk_rows`` and its knobs), pipeline telemetry
(``telemetry``, ``telemetry_dir``), profiling (``profile_dir``) and the
live monitor (``monitor``, ``monitor_every_s``, ``status_port``) and
the meshes (``n_devices``, ``distributed_init``) are ported, with the
reference's validation.  For serving:

- ``telemetry``, ``monitor`` and ``trace`` have the reference's
  defaults (``"metrics"``, ``"on"``, ``"on"``); ``replicas`` > 1 runs
  the supervised replica fleet (``serving.fleet``), under the
  reference's fleet checks.
- ``compilation_cache_dir`` (or ``$PHOTON_ML_TPU_COMPILE_CACHE``)
  places the port's compiled artifacts, its CUDA kernel libraries:
  they are built into and reused from ``<dir>/kernels`` instead of
  ``build/kernels/`` (``cache.enable_compilation_cache``).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any

from photon_ml_torch.data.normalization import NormalizationType
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops.regularization import RegularizationType
from photon_ml_torch.optim.base import OptimizerType
from photon_ml_torch.optim.variance import VarianceComputationType

# ---------------------------------------------------------------------------
# Sanctioned environment fallbacks: every environment knob the port reads
# is registered here with its meaning and read through ``read_env``.  The
# names are the JAX package's (a variable set for one package acts on the
# other alike); only those the port honours are registered.
# ---------------------------------------------------------------------------

SANCTIONED_ENV = {
    "PHOTON_ML_TPU_PLAN_CACHE": (
        "default on-disk GRR plan cache dir (data.grr cache_dir=None)"),
    "PHOTON_ML_TPU_COMPILE_CACHE": (
        "default persistent XLA compilation cache dir (cache"
        ".compile_cache)"),
    "PHOTON_ML_TPU_SPILL_DIR": (
        "default chunk-store spill dir (data.chunk_store"
        ".resolve_spill_dir)"),
    "JAX_COORDINATOR_ADDRESS": (
        "process-group coordinator host:port (multi-process init, "
        "training driver; the JAX package's name)"),
    "JAX_NUM_PROCESSES": "process-group world size",
    "JAX_PROCESS_ID": "process-group rank",
    "PHOTON_FLEET_NUM_HOSTS": (
        "local-fleet host count (parallel.fleet tcp transport)"),
    "PHOTON_FLEET_HOST_ID": "local-fleet host id (parallel.fleet)",
    "PHOTON_FLEET_COORDINATOR": (
        "local-fleet reduce coordinator host:port (parallel.fleet)"),
}


def read_env(name: str, default: str | None = None) -> str | None:
    """The one sanctioned ``os.environ`` read.

    Raises ``KeyError`` for an unregistered name: adding an environment
    knob means registering it in ``SANCTIONED_ENV`` (with its meaning),
    so the registry is a complete inventory of the port's environment
    surface."""
    if name not in SANCTIONED_ENV:
        raise KeyError(
            f"env var {name!r} is not in config.SANCTIONED_ENV; "
            "register it (with a description) before reading it")
    return os.environ.get(name, default)


def _validate_monitor(cfg) -> None:
    """The live-monitoring knobs every run config carries."""
    if cfg.monitor not in ("off", "on"):
        raise ValueError("monitor must be off|on")
    if cfg.monitor_every_s <= 0:
        raise ValueError("monitor_every_s must be positive")
    if cfg.status_port is not None and not (
            0 <= cfg.status_port <= 65535):
        raise ValueError("status_port must be in [0, 65535] "
                         "(0 = ephemeral)")


def _validate_device(device: str) -> None:
    if device not in ("cuda", "cpu") and not device.startswith("cuda:"):
        raise ValueError("device must be cuda, cuda:<n> or cpu")


class CoordinateKind(str, enum.Enum):
    FIXED_EFFECT = "FIXED_EFFECT"
    RANDOM_EFFECT = "RANDOM_EFFECT"


@dataclasses.dataclass
class OptimizerSettings:
    """Per-coordinate optimizer configuration."""

    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iters: int = 100
    tolerance: float = 1e-6
    regularization: RegularizationType = RegularizationType.L2
    reg_weight: float = 1.0
    elastic_net_alpha: float = 0.5  # only for ELASTIC_NET
    variance_type: VarianceComputationType = VarianceComputationType.NONE
    # Keep the per-solver-iteration (value, ‖g‖) history; it lands in the
    # run log's cd_coordinate events.
    track_states: bool = False

    def validate(self) -> None:
        if not isinstance(self.variance_type, VarianceComputationType):
            self.variance_type = VarianceComputationType(
                str(self.variance_type).upper())
        if self.max_iters <= 0:
            raise ValueError("max_iters must be positive")
        if self.tolerance <= 0:
            raise ValueError("tolerance must be positive")
        if self.reg_weight < 0:
            raise ValueError("reg_weight must be non-negative")
        if not 0.0 <= self.elastic_net_alpha <= 1.0:
            raise ValueError("elastic_net_alpha must be in [0, 1]")
        if (self.optimizer == OptimizerType.TRON
                and self.regularization in (RegularizationType.L1,
                                            RegularizationType.ELASTIC_NET)):
            raise ValueError("TRON cannot handle L1/elastic-net; use LBFGS")


@dataclasses.dataclass
class CoordinateConfig:
    """One GAME coordinate."""

    name: str
    kind: CoordinateKind
    feature_shard: str
    entity_key: str | None = None          # RANDOM_EFFECT only
    optimizer: OptimizerSettings = dataclasses.field(
        default_factory=OptimizerSettings)
    down_sampling_rate: float | None = None  # FIXED_EFFECT only

    def validate(self) -> None:
        self.optimizer.validate()
        if self.kind == CoordinateKind.RANDOM_EFFECT and not self.entity_key:
            raise ValueError(
                f"random-effect coordinate '{self.name}' needs entity_key")
        if self.down_sampling_rate is not None:
            if self.kind != CoordinateKind.FIXED_EFFECT:
                raise ValueError("down-sampling applies to fixed effects")
            if not 0.0 < self.down_sampling_rate <= 1.0:
                raise ValueError("down_sampling_rate must be in (0, 1]")


@dataclasses.dataclass
class TuningConfig:
    """Hyperparameter-tuning settings (``GameEstimator.fit_tuned``)."""

    n_trials: int = 10
    mode: str = "BAYESIAN"                 # BAYESIAN | RANDOM
    # coordinate name → {"low": float, "high": float, "scale": "LOG"|"LINEAR"}
    reg_weight_ranges: dict[str, dict] = dataclasses.field(
        default_factory=dict)
    seed: int = 0
    # Trials proposed (and, when the workload is swept-eligible, trained
    # as one swept solve) a round.  None = the strategy's default
    # (RANDOM: 16 — swept solver state grows with the lane count;
    # BAYESIAN: 4, so later proposals condition on earlier results).
    trial_batch: int | None = None

    def validate(self) -> None:
        if self.n_trials <= 0:
            raise ValueError("n_trials must be positive")
        if self.mode not in ("BAYESIAN", "RANDOM"):
            raise ValueError("tuning mode must be BAYESIAN or RANDOM")
        if self.trial_batch is not None and self.trial_batch <= 0:
            raise ValueError("trial_batch must be positive when set")
        if not self.reg_weight_ranges:
            raise ValueError("tuning needs reg_weight_ranges")
        for name, r in self.reg_weight_ranges.items():
            if "low" not in r or "high" not in r:
                raise ValueError(f"range for '{name}' needs low and high")


@dataclasses.dataclass
class TrainingConfig:
    """A training run (``python -m
    photon_ml_torch.cli.game_training_driver``)."""

    task_type: TaskType
    coordinates: list[CoordinateConfig]
    update_sequence: list[str]
    input_path: str = ""
    input_format: str = "auto"             # auto | jsonl | avro | libsvm
    validation_path: str | None = None
    validation_fraction: float = 0.0       # split from input if no file
    output_dir: str = "output"
    index_dir: str | None = None           # prebuilt index maps (else scan)
    dense_feature_shards: list[str] = dataclasses.field(default_factory=list)
    n_iterations: int = 1
    normalization: NormalizationType = NormalizationType.NONE
    evaluators: list[EvaluatorType] = dataclasses.field(
        default_factory=lambda: [EvaluatorType.AUC])
    # Per-coordinate reg-weight lists, cartesian over coordinates; a
    # grid over one trainable LBFGS fixed effect trains as one swept
    # solve, any other grid point by point.
    reg_weight_grid: dict[str, list[float]] = dataclasses.field(
        default_factory=dict)
    tuning: TuningConfig | None = None     # GameEstimator.fit_tuned
    model_output_mode: str = "BEST"        # ALL | BEST | EXPLICIT
    warm_start_model_dir: str | None = None
    locked_coordinates: list[str] = dataclasses.field(default_factory=list)
    # Regularize toward the warm-start model's coefficients with
    # strength prior_weight/σ² when it has variances.
    use_warm_start_as_prior: bool = False
    prior_weight: float = 1.0
    # Snapshots of the run (reliability.checkpoint): every
    # checkpoint_every_sweeps CD sweeps (the last always), and with
    # checkpoint_every_solver_iters > 0 every that many streaming-solver
    # iterations and after every coordinate; resume restores the most
    # advanced one.
    checkpoint_dir: str | None = None
    resume: bool = False
    checkpoint_every_sweeps: int = 1
    checkpoint_every_solver_iters: int = 0
    intercept: bool = True
    seed: int = 0
    # Score the validation set with every evaluator after each sweep.
    validate_per_iteration: bool = True
    # Sparse fixed-effect layout: AUTO is plain ELL here (as in the JAX
    # package off the TPU); GRR and COLMAJOR select the others.
    sparse_layout: str = "AUTO"
    # Mesh training: the fixed effect's rows and the random effects'
    # entities split into n_devices shards (parallel.mesh), round-robin
    # over the visible devices of the run's kind.
    n_devices: int | None = None
    # The chunk-streamed fixed effect (data.chunked_batch): sparse fixed
    # effects become ceil(n/chunk_rows) congruent chunks streamed to the
    # card every evaluation; chunk_layout AUTO is ELL here (GRR chunks
    # run B2/B3 a chunk); chunk_max_resident placed chunks stay on the
    # card.  spill_dir (default $PHOTON_ML_TPU_SPILL_DIR) spills the
    # chunks to disk, host_max_resident decoded chunks stay in host RAM
    # and prefetch_depth chunks are prefetched disk → host → card ahead
    # of compute (0: no prefetch thread).
    chunk_rows: int | None = None
    chunk_layout: str = "AUTO"
    chunk_max_resident: int = 1
    spill_dir: str | None = None
    host_max_resident: int = 2
    prefetch_depth: int = 2
    # Out-of-core random effects: entities a streamed chunk a bucket
    # (spilled to spill_dir), with converged-entity retirement; cd_fused
    # trains with one store pass a coordinate-descent cycle.
    re_chunk_entities: int | None = None
    re_retirement: bool = True
    cd_fused: bool = False
    # The GRR plan cache (shared with the JAX package), and the
    # compilation cache: the kernel libraries build into
    # <compilation_cache_dir>/kernels (cache.compile_cache).
    plan_cache_dir: str | None = None
    compilation_cache_dir: str | None = None
    # The training phase runs under torch.profiler; its Chrome trace
    # lands here.
    profile_dir: str | None = None
    # Pipeline telemetry: off | metrics | trace (telemetry/__init__.py).
    telemetry: str = "off"
    telemetry_dir: str | None = None
    # Live monitor: progress/ETA/alert events; status_port serves
    # /status and /metrics (0 = ephemeral) and implies the monitor.
    monitor: str = "off"
    monitor_every_s: float = 2.0
    status_port: int | None = None
    # Join a torch.distributed process group from the JAX_* trio before
    # the fit (cli.game_training_driver.distributed_init_from_env).
    distributed_init: bool = False
    # Where training runs: "cuda" (default) or "cpu".
    device: str = "cuda"

    def validate(self) -> None:
        names = [c.name for c in self.coordinates]
        if len(set(names)) != len(names):
            raise ValueError("duplicate coordinate names")
        for c in self.coordinates:
            c.validate()
        for s in self.update_sequence:
            if s not in names:
                raise ValueError(f"update_sequence entry '{s}' unknown")
        for s in self.locked_coordinates:
            if s not in names:
                raise ValueError(f"locked coordinate '{s}' unknown")
        if self.locked_coordinates and not self.warm_start_model_dir:
            raise ValueError(
                "locked_coordinates require warm_start_model_dir (locked "
                "coefficients come from the previous model)")
        if self.use_warm_start_as_prior and not self.warm_start_model_dir:
            raise ValueError(
                "use_warm_start_as_prior requires warm_start_model_dir")
        if self.resume and not self.checkpoint_dir:
            raise ValueError("resume requires checkpoint_dir")
        if self.checkpoint_every_sweeps < 1:
            raise ValueError("checkpoint_every_sweeps must be >= 1")
        if self.checkpoint_every_solver_iters < 0:
            raise ValueError(
                "checkpoint_every_solver_iters must be >= 0")
        if not 0.0 <= self.validation_fraction < 1.0:
            raise ValueError("validation_fraction must be in [0, 1)")
        if self.n_iterations <= 0:
            raise ValueError("n_iterations must be positive")
        if self.model_output_mode not in ("ALL", "BEST", "EXPLICIT"):
            raise ValueError("model_output_mode must be ALL|BEST|EXPLICIT")
        if self.sparse_layout not in ("AUTO", "GRR", "COLMAJOR", "ELL"):
            raise ValueError("sparse_layout must be AUTO|GRR|COLMAJOR|ELL")
        if self.telemetry not in ("off", "metrics", "trace"):
            raise ValueError("telemetry must be off|metrics|trace")
        _validate_monitor(self)
        self._validate_chunked()
        if self.n_devices is not None:
            if self.n_devices <= 0:
                raise ValueError("n_devices must be positive")
            for c in self.coordinates:
                if c.down_sampling_rate is not None:
                    raise ValueError(
                        "down-sampling is not supported with mesh "
                        "training (n_devices); the row subset would "
                        "cross shard boundaries")
        for name, grid in self.reg_weight_grid.items():
            if name not in names:
                raise ValueError(f"grid entry '{name}' unknown")
            if not grid:
                raise ValueError(f"empty grid for '{name}'")
        if self.tuning is not None:
            self.tuning.validate()
            if self.reg_weight_grid:
                raise ValueError("tuning and reg_weight_grid are exclusive")
            if not self.evaluators:
                raise ValueError("tuning needs at least one evaluator")
            for name in self.tuning.reg_weight_ranges:
                if name not in names:
                    raise ValueError(f"tuning range '{name}' unknown")
        _validate_device(self.device)

    def _validate_chunked(self) -> None:
        """The reference's rules for the chunked and spilled tier."""
        if self.chunk_layout not in ("AUTO", "GRR", "ELL"):
            raise ValueError("chunk_layout must be AUTO|GRR|ELL")
        if self.host_max_resident < 1:
            raise ValueError("host_max_resident must be >= 1")
        if self.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0")
        if (self.spill_dir is not None and self.chunk_rows is None
                and self.re_chunk_entities is None):
            raise ValueError(
                "spill_dir requires chunked training (chunk_rows) or "
                "streamed random effects (re_chunk_entities): only "
                "chunk batches spill to the disk tier")
        if self.re_chunk_entities is not None:
            if self.re_chunk_entities <= 0:
                raise ValueError("re_chunk_entities must be positive")
            from photon_ml_torch.data.chunk_store import resolve_spill_dir

            if resolve_spill_dir(self.spill_dir) is None:
                raise ValueError(
                    "re_chunk_entities requires spill_dir (or "
                    "$PHOTON_ML_TPU_SPILL_DIR): streamed random-effect "
                    "training is store-backed")
        self._validate_fused()
        if self.chunk_rows is None:
            return
        if self.chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        if self.chunk_max_resident < 0:
            raise ValueError("chunk_max_resident must be >= 0")
        for c in self.coordinates:
            if c.kind != CoordinateKind.FIXED_EFFECT:
                continue
            if c.down_sampling_rate is not None:
                raise ValueError(
                    "down-sampling is not supported with chunked "
                    "training (chunk_rows)")
            if c.optimizer.variance_type == VarianceComputationType.FULL:
                raise ValueError(
                    "FULL variances materialize a [d, d] Hessian — not "
                    "supported with chunked training (chunk_rows); use "
                    "SIMPLE")
        if self.normalization != NormalizationType.NONE:
            raise ValueError(
                "normalization requires resident feature statistics; "
                "not supported with chunked training (chunk_rows)")

    def _validate_fused(self) -> None:
        """The reference's rules for ``cd_fused``."""
        if not self.cd_fused:
            return
        if self.chunk_rows is None:
            raise ValueError(
                "cd_fused requires chunked training (chunk_rows): the "
                "fixed effect's chunk grid is the fused cycle's master "
                "grid")
        if self.locked_coordinates:
            raise ValueError(
                "cd_fused does not support locked_coordinates (the fused "
                "pass composes every coordinate's margins from live "
                "coefficients)")
        if self.n_devices is not None:
            raise ValueError(
                "cd_fused is single-device (the fused per-chunk program "
                "is not mesh-sharded); drop n_devices")
        fixed = [c for c in self.coordinates
                 if c.name in self.update_sequence
                 and c.kind == CoordinateKind.FIXED_EFFECT]
        if len(fixed) != 1:
            raise ValueError(
                "cd_fused requires exactly one fixed-effect coordinate "
                f"in update_sequence (got {len(fixed)})")
        for c in self.coordinates:
            if (c.name in self.update_sequence
                    and c.optimizer.regularization
                    not in (RegularizationType.NONE, RegularizationType.L2)):
                raise ValueError(
                    "cd_fused requires smooth regularization (NONE or L2) "
                    f"on every coordinate; '{c.name}' uses "
                    f"{c.optimizer.regularization.value} — the Jacobi "
                    "Newton solves have no proximal step")


@dataclasses.dataclass
class ScoringConfig:
    """A scoring run (``python -m
    photon_ml_torch.cli.game_scoring_driver``)."""

    input_path: str
    model_dir: str
    output_path: str = "scores.npz"        # .npz, or .avro records
    input_format: str = "auto"             # auto | jsonl | avro | libsvm
    index_dir: str | None = None           # default: <model_dir>/../index_maps
    dense_feature_shards: list[str] = dataclasses.field(default_factory=list)
    evaluators: list[EvaluatorType] = dataclasses.field(default_factory=list)
    # The kernel libraries build into <dir>/kernels (cache.compile_cache).
    compilation_cache_dir: str | None = None
    # Set: the one-pass streamed scorer (estimators.streaming_scorer),
    # chunks of this many rows, spilled to spill_dir, read through a
    # window of host_max_resident chunks, prefetch_depth ahead.
    score_chunk_rows: int | None = None
    spill_dir: str | None = None
    host_max_resident: int = 2
    prefetch_depth: int = 2
    # Pipeline telemetry: off | metrics | trace; the live monitor as in
    # TrainingConfig.
    telemetry: str = "off"
    telemetry_dir: str | None = None
    monitor: str = "off"
    monitor_every_s: float = 2.0
    status_port: int | None = None
    # Where scoring runs: "cuda" (default) or "cpu".
    device: str = "cuda"

    def validate(self) -> None:
        if self.score_chunk_rows is not None and self.score_chunk_rows <= 0:
            raise ValueError("score_chunk_rows must be positive")
        if self.telemetry not in ("off", "metrics", "trace"):
            raise ValueError("telemetry must be off|metrics|trace")
        _validate_monitor(self)
        if self.host_max_resident < 1:
            raise ValueError("host_max_resident must be >= 1")
        if self.prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0")
        if self.spill_dir is not None and self.score_chunk_rows is None:
            raise ValueError(
                "spill_dir requires streamed scoring (score_chunk_rows):"
                " only score chunks spill to the disk tier")
        _validate_device(self.device)


@dataclasses.dataclass
class ServingConfig:
    """Model-server configuration: ``python -m photon_ml_torch.serving``."""

    # Model source: a manifest directory or a legacy metadata.json dir.
    model_dir: str
    # HTTP bind; port 0 asks for an ephemeral port.
    host: str = "127.0.0.1"
    port: int = 0
    # Micro-batching: concurrent requests coalesce for up to
    # batch_deadline_ms, then dispatch as ONE call padded to the
    # smallest bucket ≥ the batch's rows (default buckets: powers of two
    # up to batch_rows).  Oversized requests split across buckets.
    batch_rows: int = 64
    batch_buckets: list[int] | None = None
    batch_deadline_ms: float = 2.0
    max_queue: int = 1024
    request_timeout_s: float = 30.0
    # Sparse request rows densify to ELL at this per-row capacity; a
    # row with more non-zeros answers 400 naming this knob.
    ell_row_capacity: int = 64
    dense_feature_shards: list[str] = dataclasses.field(
        default_factory=list)
    # Random-effect coefficient store (serving.entity_store): with a
    # spill dir, chunked mmap'd .npz files of entity_chunk entities
    # behind an LRU window of host_max_resident chunks.
    spill_dir: str | None = None
    entity_chunk: int = 4096
    host_max_resident: int = 4
    # Hot model swap: poll the manifest at this cadence (0 = off).
    hot_swap_poll_s: float = 2.0
    # The kernel libraries build into <dir>/kernels (cache.compile_cache).
    compilation_cache_dir: str | None = None
    # Telemetry (the registry behind /metrics) and the live monitor
    # (progress, alert rules, /status): both on by default, as in the
    # reference.  /status and /metrics ride the serving port.
    telemetry: str = "metrics"
    monitor: str = "on"
    monitor_every_s: float = 2.0
    status_port: int | None = None   # unused: /status rides the port
    log_path: str | None = None      # run-log JSONL (default: the logger)
    # The supervised fleet (serving.fleet): replicas > 1 runs N replica
    # servers behind one frontend; the fields below drive its
    # supervisor (probe cadence, wedge threshold, restart backoff, the
    # circuit breaker and the replica warm-up budget).
    replicas: int = 1
    probe_every_s: float = 0.5
    probe_timeout_s: float = 2.0
    unhealthy_after: int = 3
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 10.0
    breaker_threshold: int = 5
    breaker_window_s: float = 30.0
    breaker_reset_s: float = 30.0
    replica_ready_timeout_s: float = 300.0
    # Per-connection socket timeout on the HTTP core.
    http_timeout_s: float = 30.0
    # Request tracing (serving.tracing): per-request stage marks, the
    # shared batch trace and tail sampling.  A request slower than
    # trace_threshold_ms is kept ("tail"), and every
    # trace_sample_every-th one regardless ("floor"; 0 = none);
    # trace_buffer kept traces stay in memory for /status.
    trace: str = "on"
    trace_threshold_ms: float = 50.0
    trace_sample_every: int = 100
    trace_buffer: int = 512
    # Where the engine runs: "cuda" (default) or "cpu".
    device: str = "cuda"

    def validate(self) -> None:
        if not self.model_dir:
            raise ValueError("serving needs model_dir")
        if not 0 <= self.port <= 65535:
            raise ValueError("port must be in [0, 65535] (0 = ephemeral)")
        if self.batch_rows <= 0:
            raise ValueError("batch_rows must be positive")
        if self.batch_buckets is not None:
            b = [int(x) for x in self.batch_buckets]
            if not b or any(x <= 0 for x in b):
                raise ValueError("batch_buckets must be positive")
            if sorted(set(b)) != b:
                raise ValueError("batch_buckets must be strictly ascending")
            if b[-1] != self.batch_rows:
                raise ValueError(
                    "batch_buckets must end at batch_rows (the largest "
                    "bucket IS the max micro-batch)")
        if self.batch_deadline_ms < 0:
            raise ValueError("batch_deadline_ms must be >= 0")
        if self.max_queue <= 0:
            raise ValueError("max_queue must be positive")
        if self.request_timeout_s <= 0:
            raise ValueError("request_timeout_s must be positive")
        if self.ell_row_capacity <= 0:
            raise ValueError("ell_row_capacity must be positive")
        if self.entity_chunk <= 0:
            raise ValueError("entity_chunk must be positive")
        if self.host_max_resident < 1:
            raise ValueError("host_max_resident must be >= 1")
        if self.hot_swap_poll_s < 0:
            raise ValueError("hot_swap_poll_s must be >= 0 (0 = off)")
        if self.http_timeout_s <= 0:
            raise ValueError("http_timeout_s must be positive")
        _validate_device(self.device)
        if self.telemetry not in ("off", "metrics", "trace"):
            raise ValueError("telemetry must be off|metrics|trace")
        _validate_monitor(self)
        if self.trace not in ("on", "off"):
            raise ValueError("trace must be on|off")
        if self.trace_threshold_ms < 0:
            raise ValueError("trace_threshold_ms must be >= 0")
        if self.trace_sample_every < 0:
            raise ValueError(
                "trace_sample_every must be >= 0 (0 = no floor)")
        if self.trace_buffer < 1:
            raise ValueError("trace_buffer must be >= 1")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.probe_every_s <= 0:
            raise ValueError("probe_every_s must be positive")
        if self.probe_timeout_s <= 0:
            raise ValueError("probe_timeout_s must be positive")
        if self.unhealthy_after < 1:
            raise ValueError("unhealthy_after must be >= 1")
        if self.restart_backoff_s < 0:
            raise ValueError("restart_backoff_s must be >= 0")
        if self.restart_backoff_max_s < self.restart_backoff_s:
            raise ValueError(
                "restart_backoff_max_s must be >= restart_backoff_s")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.breaker_window_s <= 0:
            raise ValueError("breaker_window_s must be positive")
        if self.breaker_reset_s <= 0:
            raise ValueError("breaker_reset_s must be positive")
        if self.replica_ready_timeout_s <= 0:
            raise ValueError("replica_ready_timeout_s must be positive")

    def buckets(self) -> list[int]:
        """The closed micro-batch shape set, smallest first."""
        if self.batch_buckets is not None:
            return [int(b) for b in self.batch_buckets]
        out, b = [], 1
        while b < self.batch_rows:
            out.append(b)
            b *= 2
        out.append(self.batch_rows)
        return out


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def config_to_json(config) -> str:
    return json.dumps(_to_jsonable(config), indent=2)


_ENUMS = {
    "TaskType": TaskType,
    "CoordinateKind": CoordinateKind,
    "OptimizerType": OptimizerType,
    "RegularizationType": RegularizationType,
    "NormalizationType": NormalizationType,
    "EvaluatorType": EvaluatorType,
    "VarianceComputationType": VarianceComputationType,
}


def _coerce(type_str, v):
    """Typed coercion from the annotation strings: enums by value or
    name, nested dataclasses by field name."""
    t = type_str if isinstance(type_str, str) else getattr(
        type_str, "__name__", str(type_str))
    if isinstance(v, list):
        if "CoordinateConfig" in t:
            return [_build(CoordinateConfig, c) for c in v]
        for name, enum_cls in _ENUMS.items():
            if name in t:
                return [enum_cls(e) if isinstance(e, str) else e for e in v]
        return v
    if isinstance(v, str):
        for name, enum_cls in _ENUMS.items():
            if name in t:
                try:
                    return enum_cls(v)
                except ValueError:
                    return enum_cls[v]
    if "OptimizerSettings" in t and isinstance(v, dict):
        return _build(OptimizerSettings, v)
    if "TuningConfig" in t and isinstance(v, dict):
        return _build(TuningConfig, v)
    return v


def _build(cls, data: Any):
    if not isinstance(data, dict):
        raise ValueError(f"{cls.__name__} JSON must be an object")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    return cls(**{k: _coerce(fields[k].type, v) for k, v in data.items()})


def training_config_from_json(text: str) -> TrainingConfig:
    cfg = _build(TrainingConfig, json.loads(text))
    cfg.validate()
    return cfg


def load_training_config(path: str) -> TrainingConfig:
    with open(path) as f:
        return training_config_from_json(f.read())


def scoring_config_from_json(text: str) -> ScoringConfig:
    cfg = _build(ScoringConfig, json.loads(text))
    cfg.validate()
    return cfg


def load_scoring_config(path: str) -> ScoringConfig:
    with open(path) as f:
        return scoring_config_from_json(f.read())


def serving_config_from_json(text: str) -> ServingConfig:
    cfg = _build(ServingConfig, json.loads(text))
    cfg.validate()
    return cfg


def load_serving_config(path: str) -> ServingConfig:
    with open(path) as f:
        return serving_config_from_json(f.read())
