"""Serving configuration.

Counterpart of ``ServingConfig`` in ``photon_ml_tpu/config.py``, with
the same JSON keys plus ``device``.  What the port does not have yet is
accepted in the file but must stay off:

- ``telemetry``, ``monitor`` and ``trace`` default to ``"off"``, and
  ``replicas`` to 1; ``validate()`` raises ``NotImplementedError`` when
  a config turns one of them on (ROADMAP D2–D5).
- ``compilation_cache_dir`` is accepted and has no effect: the port has
  no compiled programs to cache (its CUDA kernels are cached under
  ``build/kernels/`` by source hash).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


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
    # Accepted for config compatibility; has no effect in the port.
    compilation_cache_dir: str | None = None
    # Not ported yet: must stay "off" (validate() raises otherwise).
    telemetry: str = "off"
    monitor: str = "off"
    monitor_every_s: float = 2.0
    status_port: int | None = None
    log_path: str | None = None      # run-log JSONL (default: none)
    # The supervised fleet is not ported yet: replicas must be 1.
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
    # Request tracing is not ported yet: must stay "off".
    trace: str = "off"
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
        if self.device not in ("cuda", "cpu") and not \
                self.device.startswith("cuda:"):
            raise ValueError("device must be cuda, cuda:<n> or cpu")
        if self.telemetry not in ("off", "metrics", "trace"):
            raise ValueError("telemetry must be off|metrics|trace")
        if self.monitor not in ("off", "on"):
            raise ValueError("monitor must be off|on")
        if self.trace not in ("on", "off"):
            raise ValueError("trace must be on|off")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        for knob, on, item in (
                ("telemetry", self.telemetry != "off", "D2"),
                ("monitor", self.monitor != "off", "D3"),
                ("trace", self.trace != "off", "D4"),
                ("replicas", self.replicas > 1, "D5")):
            if on:
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)!r} is not ported to "
                    f"photon_ml_torch yet (ROADMAP {item}); set it to its "
                    "default")

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


def config_to_json(config) -> str:
    return json.dumps(dataclasses.asdict(config), indent=2)


def _build(cls, data: Any):
    if not isinstance(data, dict):
        raise ValueError(f"{cls.__name__} JSON must be an object")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    return cls(**data)


def serving_config_from_json(text: str) -> ServingConfig:
    cfg = _build(ServingConfig, json.loads(text))
    cfg.validate()
    return cfg


def load_serving_config(path: str) -> ServingConfig:
    with open(path) as f:
        return serving_config_from_json(f.read())
