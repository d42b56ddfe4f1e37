"""Multi-host chunk-synchronized fleet streaming over tcp.

Counterpart of ``photon_ml_tpu/parallel/fleet.py``.  A streamed fit's
chunk grid is split across processes ("hosts"): each
host builds, spills and streams only its own contiguous shard from a
per-host spill directory, and the streaming objectives reduce every
chunk step's partial across the fleet, so every host holds the same
global totals and the solvers above stay fleet-oblivious.

Pieces:

- ``FleetContext``: (host_id, n_hosts, transport) of this process.
  ``initialize_from_env`` gives the ``psum`` transport (one
  ``torch.distributed.all_reduce`` a leaf: NCCL on the card, gloo on
  the CPU) under an initialized world of more than one process, else
  the ``tcp`` transport from the ``PHOTON_FLEET_*`` trio.
- ``shard_chunk_ids``: a contiguous shard a host, padded with
  ``EMPTY_CHUNK`` sentinels to a common step count, so every host takes
  the same number of reductions (a sentinel step contributes exact
  zeros).
- ``FleetReducer``: the per-step all-reduce of a partial tree (nested
  tuples, lists and dicts of torch tensors or numpy arrays).  A device
  partial is copied down once, explicitly: into pinned host memory,
  then an event fence.  The total comes back to the partial's device.
- ``ReduceCoordinator``: the launcher's star all-reduce server.  It sums
  the contributions in host-id order (so every host, and a replay, sees
  the same bits) and caches each total by sequence number: a host killed
  mid-fit resumes from its own checkpoint, replays its reduce sequence
  against the cache and rejoins the live barrier, while the others wait
  there.

The wire format is the JAX package's (a JSON header line and an npz
payload read with ``allow_pickle=False``), so either package's reducer
talks to either package's coordinator.  Every wait is bounded
(``stall_timeout_s``): a torn fleet ends in one ``FleetBarrierError``,
never a hang.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import os
import socket
import threading
import time

import numpy as np
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.reliability import faults

logger = logging.getLogger(__name__)

# The sentinel chunk id padding ragged shards to a common step count.
EMPTY_CHUNK = -1

# Default bound on any fleet barrier wait: a killed host stalls its peers
# at the barrier (the protocol never restarts them), but a fleet that
# lost a host for good ends in one actionable error.
DEFAULT_STALL_TIMEOUT_S = 600.0

# Reduce results the coordinator keeps: how far a replaying host can
# fast-forward past its checkpoint.
_RESULT_CACHE_CAP = 4096

# The JAX package's marker of a jaxlib without multi-process CPU
# collectives, kept for its surface: a gloo worker never prints it.
MULTIPROC_UNSUPPORTED_MARKER = "Multiprocess computations aren't implemented"


class FleetBarrierError(RuntimeError):
    """A fleet reduction could not complete (torn fleet, dead
    coordinator, stalled peer past the timeout)."""


@dataclasses.dataclass(frozen=True)
class FleetContext:
    """This process's position in the training fleet.

    ``transport``: ``"psum"`` (a ``torch.distributed`` all-reduce over
    the initialized world) or ``"tcp"`` (the star all-reduce through
    ``coordinator``, ``host:port``)."""

    host_id: int
    n_hosts: int
    transport: str = "psum"
    coordinator: str | None = None

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        if not 0 <= self.host_id < self.n_hosts:
            raise ValueError(
                f"host_id {self.host_id} not in [0, {self.n_hosts})")
        if self.transport not in ("psum", "tcp"):
            raise ValueError("transport must be psum|tcp")
        if self.transport == "tcp" and self.n_hosts > 1 \
                and not self.coordinator:
            raise ValueError("tcp transport needs coordinator host:port")

    @property
    def is_fleet(self) -> bool:
        return self.n_hosts > 1


def shard_chunk_ids(n_chunks: int, host_id: int, n_hosts: int
                    ) -> tuple[list[int], list[int]]:
    """One host's contiguous chunk shard and its padded schedule.

    Returns ``(local_ids, schedule)``: the real chunk ids this host owns,
    and those followed by ``EMPTY_CHUNK`` sentinels up to the common
    step count ``ceil(n_chunks / n_hosts)``.  Real chunks come first, so
    the prefetcher never idles behind a sentinel; a host past the end of
    a ragged grid gets an all-sentinel schedule."""
    if n_chunks < 0:
        raise ValueError("n_chunks must be >= 0")
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
    steps = -(-n_chunks // n_hosts) if n_chunks else 0
    lo = min(host_id * steps, n_chunks)
    hi = min(lo + steps, n_chunks)
    local = list(range(lo, hi))
    return local, local + [EMPTY_CHUNK] * (steps - len(local))


def host_dir(base: str, ctx: "FleetContext | None") -> str:
    """Per-host subdirectory of ``base`` (spill, checkpoint and output
    sharding by host id); ``base`` unchanged outside a fleet."""
    if ctx is None or not ctx.is_fleet:
        return base
    return os.path.join(base, f"host_{ctx.host_id:03d}")


# ---------------------------------------------------------------------------
# The active context (library code deep in a fit reads it, as it reads the
# telemetry and checkpoint sessions).
# ---------------------------------------------------------------------------

_ACTIVE: FleetContext | None = None
_REDUCER: "FleetReducer | None" = None
_ACTIVE_LOCK = threading.Lock()


def active() -> FleetContext | None:
    """The active fleet context, or None (a single-host run)."""
    return _ACTIVE


def reducer() -> "FleetReducer | None":
    """The process-wide reducer of the active context (built on first
    use), or None outside a fleet."""
    global _REDUCER
    ctx = _ACTIVE
    if ctx is None or not ctx.is_fleet:
        return None
    with _ACTIVE_LOCK:
        if _REDUCER is None or _REDUCER.ctx is not ctx:
            _REDUCER = FleetReducer(ctx)
        return _REDUCER


def seq() -> int:
    """The active reducer's reduction counter for checkpoint trees (-1
    outside a fleet).  A resumed host restores it (``restore_seq``) and
    replays its reduce sequence: the coordinator answers completed
    sequence numbers from its cache, so the replay fast-forwards to the
    live barrier the rest of the fleet waits at."""
    red = reducer()
    return -1 if red is None else int(red.seq)


def restore_seq(value) -> None:
    """Set the active reducer's counter from a checkpoint's ``seq()``;
    None, a negative value or no fleet is a no-op."""
    if value is None or int(value) < 0:
        return
    red = reducer()
    if red is not None:
        red.seq = int(value)
        telemetry.count("fleet.seq_restored")


def deactivate() -> None:
    """Drop the active fleet context and close its reducer (a driver run
    that made its process group leaves none behind)."""
    global _ACTIVE, _REDUCER
    with _ACTIVE_LOCK:
        red, _REDUCER = _REDUCER, None
        _ACTIVE = None
    if red is not None:
        red.close()


@contextlib.contextmanager
def session(ctx: FleetContext | None):
    """Make ``ctx`` the active fleet for the block; None is a no-op."""
    global _ACTIVE, _REDUCER
    if ctx is None:
        yield None
        return
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fleet session is already active")
        _ACTIVE = ctx
    try:
        yield ctx
    finally:
        with _ACTIVE_LOCK:
            red, _REDUCER = _REDUCER, None
            _ACTIVE = None
        if red is not None:
            red.close()


def initialize_from_env() -> FleetContext | None:
    """Build and activate this process's fleet context, or None.

    An initialized ``torch.distributed`` world of more than one process
    wins (``transport="psum"``, host = rank); otherwise the
    ``PHOTON_FLEET_NUM_HOSTS`` / ``PHOTON_FLEET_HOST_ID`` /
    ``PHOTON_FLEET_COORDINATOR`` trio selects the tcp transport.
    Idempotent: an active context is returned as is."""
    global _ACTIVE
    if _ACTIVE is not None:
        return _ACTIVE
    from photon_ml_torch.config import read_env

    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        ctx = FleetContext(host_id=dist.get_rank(),
                           n_hosts=dist.get_world_size(), transport="psum")
    else:
        n = read_env("PHOTON_FLEET_NUM_HOSTS")
        if n is None or int(n) <= 1:
            return None
        ctx = FleetContext(
            host_id=int(read_env("PHOTON_FLEET_HOST_ID", "0") or 0),
            n_hosts=int(n),
            transport="tcp",
            coordinator=read_env("PHOTON_FLEET_COORDINATOR"),
        )
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            _ACTIVE = ctx
        ctx = _ACTIVE
    logger.info("fleet: host %d of %d (transport=%s)",
                ctx.host_id, ctx.n_hosts, ctx.transport)
    return ctx


# ---------------------------------------------------------------------------
# Partial trees: nested tuples, lists and dicts (sorted keys, as jax
# flattens them; None is an empty subtree) of tensors or arrays.
# ---------------------------------------------------------------------------


def _flatten(tree, leaves: list):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return (type(tree), [_flatten(x, leaves) for x in tree])
    if isinstance(tree, dict):
        keys = sorted(tree)
        return (dict, keys, [_flatten(tree[k], leaves) for k in keys])
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(spec, leaves: list):
    if spec is None:
        return None
    if isinstance(spec, int):
        return leaves[spec]
    if spec[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    items = [_unflatten(s, leaves) for s in spec[1]]
    return tuple(items) if spec[0] is tuple else items


def _to_host(leaves: list) -> list[np.ndarray]:
    """Host copies of the leaves.  Device tensors go down in one planned
    copy: non-blocking into pinned buffers, then one event fence (an
    explicit synchronization, never an implicit one)."""
    out: list = [None] * len(leaves)
    pending = []
    for i, lf in enumerate(leaves):
        if isinstance(lf, torch.Tensor):
            t = lf.detach()
            if t.device.type == "cuda":
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                pending.append((i, buf, t.device))
            else:
                out[i] = t.numpy()
        else:
            out[i] = np.asarray(lf)
    if pending:
        done = torch.cuda.Event()
        with torch.cuda.device(pending[0][2]):
            done.record()
        done.synchronize()
        for i, buf, _dev in pending:
            out[i] = buf.numpy()
    return out


def _like(total: np.ndarray, leaf):
    """The reduced leaf in its contribution's kind: a tensor back on its
    device (one non-blocking copy up from pinned memory), else an
    array."""
    if not isinstance(leaf, torch.Tensor):
        return total
    t = torch.from_numpy(total if total.flags.c_contiguous
                         else total.copy())
    if leaf.device.type == "cuda":
        return t.pin_memory().to(leaf.device, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# Wire codec: one JSON header line and one npz payload, pickle-free.
# ---------------------------------------------------------------------------


def _encode_leaves(leaves: list[np.ndarray]) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, *[np.asarray(lf) for lf in leaves])
    return bio.getvalue()


def _decode_leaves(payload: bytes) -> list[np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return [np.asarray(z[f"arr_{i}"]) for i in range(len(z.files))]


def _send_msg(sock: socket.socket, header: dict, payload: bytes) -> None:
    head = json.dumps({**header, "nbytes": len(payload)}).encode() + b"\n"
    sock.sendall(head + payload)


def _recv_exact(fh, n: int) -> bytes:
    buf = fh.read(n)
    if len(buf) != n:
        raise FleetBarrierError(
            f"fleet connection closed mid-message ({len(buf)}/{n} bytes)")
    return buf


def _recv_msg(fh) -> tuple[dict, bytes]:
    line = fh.readline()
    if not line:
        raise EOFError("fleet connection closed")
    header = json.loads(line.decode())
    return header, _recv_exact(fh, int(header.get("nbytes", 0)))


# ---------------------------------------------------------------------------
# ReduceCoordinator: the launcher's star all-reduce server.
# ---------------------------------------------------------------------------


class ReduceCoordinator:
    """Star all-reduce for the tcp transport.

    Runs in the launcher, outside every worker, so killing a host never
    takes the reduction plane with it.  A sequence number completes when
    all ``n_hosts`` contributions arrived; the total (summed in host-id
    order, a fixed float order) goes to every waiter and into a cache,
    so a restarted host replaying from its checkpoint is answered from
    the cache (a contribution for a completed sequence number is never
    summed again).  ``reduces`` counts completed sequence numbers,
    ``replays`` answers from the cache."""

    def __init__(self, n_hosts: int, host: str = "127.0.0.1",
                 port: int = 0,
                 stall_timeout_s: float = DEFAULT_STALL_TIMEOUT_S):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.n_hosts = int(n_hosts)
        self.stall_timeout_s = float(stall_timeout_s)
        self._cond = threading.Condition()
        self._pending: dict[int, dict[int, list[np.ndarray]]] = {}
        self._done: dict[int, list[np.ndarray]] = {}
        self._done_order: list[int] = []
        self._closed = False
        self.reduces = 0
        self.replays = 0
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.5)
        self.port = self._srv.getsockname()[1]
        self.address = f"{host}:{self.port}"
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="photon-fleet-coordinator")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:  # photon-lint: disable=swallowed-exception (the accept poll tick; the loop re-checks _closed)
                continue
            except OSError as e:
                # close() closes the socket under us; any other failure
                # ends the coordinator, and the hosts would only see
                # their barrier time out.
                if not self._closed:
                    logger.warning("fleet coordinator %s stopped "
                                   "accepting: %r", self.address, e)
                break
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="photon-fleet-conn")
            t.start()
            with self._cond:
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            with conn, conn.makefile("rb") as fh:
                while True:
                    try:
                        header, payload = _recv_msg(fh)
                    except EOFError:
                        # A hang-up between messages: a host done with
                        # its fit, or killed (its restart replays the
                        # sequence).
                        logger.debug("fleet host hung up")
                        return
                    except (FleetBarrierError, ValueError, OSError) as e:
                        logger.warning("fleet host dropped mid-message: "
                                       "%r; a restarted host replays "
                                       "its sequence", e)
                        return
                    total = self._reduce_one(int(header["host"]),
                                             int(header["seq"]),
                                             _decode_leaves(payload))
                    if total is None:
                        return   # closed, or the barrier timed out
                    _send_msg(conn, {"seq": int(header["seq"])},
                              _encode_leaves(total))
        except OSError as e:
            logger.warning("fleet host dropped before its reply: %r; it "
                           "raises its own barrier error", e)
            return

    def _reduce_one(self, host: int, seq: int,
                    leaves: list[np.ndarray]) -> list[np.ndarray] | None:
        deadline = time.monotonic() + self.stall_timeout_s
        with self._cond:
            if seq in self._done:
                self.replays += 1
                return self._done[seq]
            # One contribution per (seq, host): a replaying host's
            # duplicate for a pending seq replaces its earlier one.
            self._pending.setdefault(seq, {})[host] = leaves
            if len(self._pending[seq]) == self.n_hosts:
                contrib = self._pending.pop(seq)
                total = contrib[0]
                for h in range(1, self.n_hosts):
                    total = [np.add(a, b) for a, b in
                             zip(total, contrib[h])]
                self._done[seq] = total
                self._done_order.append(seq)
                self.reduces += 1
                if len(self._done_order) > _RESULT_CACHE_CAP:
                    self._done.pop(self._done_order.pop(0), None)
                self._cond.notify_all()
                return total
            while seq not in self._done and not self._closed:
                if not self._cond.wait(
                        timeout=min(1.0, self.stall_timeout_s)):
                    if time.monotonic() > deadline:
                        return None
            return self._done.get(seq)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            threads = list(self._threads)
        with contextlib.suppress(OSError):
            self._srv.close()
        self._accept_thread.join(timeout=5.0)
        for t in threads:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# FleetReducer: the per-step all-reduce of one host.
# ---------------------------------------------------------------------------


class FleetReducer:
    """Per-step partial-tree all-reduce of one fleet process.

    ``reduce(tree)`` returns the fleet-wide sum with the same structure;
    every host calls it in the same order (the chunk-synchronized
    schedule aligns them).  ``seq`` counts reductions; it rides in the
    per-host checkpoints, so a resumed host replays the exact sequence.
    Wall time inside ``reduce`` (the copies, the transfer and the peer
    wait) accumulates in ``barrier_wait_s`` and the
    ``fleet.barrier_wait_s`` counter; ``fleet.psums`` counts reductions
    and the ``fleet.seq`` gauge holds the sequence reached."""

    def __init__(self, ctx: FleetContext,
                 stall_timeout_s: float = DEFAULT_STALL_TIMEOUT_S):
        self.ctx = ctx
        self.seq = 0
        self.barrier_wait_s = 0.0
        self.stall_timeout_s = float(stall_timeout_s)
        self._sock: socket.socket | None = None
        self._fh = None

    def _connect(self) -> None:
        host, port = self.ctx.coordinator.rsplit(":", 1)
        deadline = time.monotonic() + self.stall_timeout_s
        delay = 0.05
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=self.stall_timeout_s)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                self._fh = self._sock.makefile("rb")
                return
            except OSError as e:
                if time.monotonic() > deadline:
                    raise FleetBarrierError(
                        f"fleet coordinator {self.ctx.coordinator} "
                        f"unreachable: {e}") from e
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    def _psum_reduce(self, leaves: list) -> list:
        """One ``all_reduce`` (SUM) a leaf on this rank's device: the
        group's CUDA device under NCCL, the CPU under gloo.  Every rank
        gets the same bits."""
        dist = torch.distributed
        if not dist.is_initialized():
            raise FleetBarrierError(
                "psum transport without an initialized torch.distributed "
                "process group")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        out = []
        for lf in leaves:
            t = (lf.detach() if isinstance(lf, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(lf)))
            buf = t.to(dev, copy=True).contiguous()
            dist.all_reduce(buf)
            if isinstance(lf, torch.Tensor):
                out.append(buf.to(lf.device))
            else:
                out.append(buf.cpu().numpy())
        return out

    def _tcp_reduce(self, leaves: list[np.ndarray]) -> list[np.ndarray]:
        if self._sock is None:
            self._connect()
        try:
            _send_msg(self._sock,
                      {"host": self.ctx.host_id, "seq": self.seq},
                      _encode_leaves(leaves))
            header, payload = _recv_msg(self._fh)
        except (OSError, EOFError) as e:
            raise FleetBarrierError(
                f"fleet reduce seq={self.seq} failed (coordinator "
                f"{self.ctx.coordinator}): {e}") from e
        if int(header.get("seq", -1)) != self.seq:
            raise FleetBarrierError(
                f"fleet reduce got seq {header.get('seq')} for "
                f"request seq {self.seq} (protocol skew)")
        return _decode_leaves(payload)

    def reduce(self, tree):
        """Fleet-wide sum of ``tree``.  A single-host context returns the
        tree unchanged and counts nothing, so callers never branch on
        fleet-ness."""
        if not self.ctx.is_fleet:
            return tree
        faults.fire("fleet.reduce", seq=self.seq)
        leaves: list = []
        spec = _flatten(tree, leaves)
        t0 = time.perf_counter()
        if self.ctx.transport == "psum":
            out = self._psum_reduce(leaves)
        else:
            totals = self._tcp_reduce(_to_host(leaves))
            if len(totals) != len(leaves):
                raise FleetBarrierError(
                    f"fleet reduce seq={self.seq}: {len(totals)} leaves "
                    f"back for {len(leaves)} sent (hosts disagree on the "
                    "tree)")
            out = [_like(tot, lf) for tot, lf in zip(totals, leaves)]
        dt = time.perf_counter() - t0
        self.seq += 1
        self.barrier_wait_s += dt
        telemetry.count("fleet.psums")
        telemetry.count("fleet.barrier_wait_s", dt)
        telemetry.gauge("fleet.seq", self.seq)
        return _unflatten(spec, out)

    def close(self) -> None:
        if self._fh is not None:
            with contextlib.suppress(OSError):
                self._fh.close()
            self._fh = None
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
            self._sock = None


# ---------------------------------------------------------------------------
# The capability probe of multi-process CPU collectives.
# ---------------------------------------------------------------------------

_PROBE_WORKER = r'''
import os, sys
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=sys.argv[1],
                        world_size=2, rank=int(sys.argv[2]))
t = torch.ones(1)
dist.all_reduce(t)
assert float(t) == 2.0
dist.destroy_process_group()
print("FLEET_PROBE_OK", flush=True)
'''

_PROBE_RESULT: bool | None = None


def probe_cpu_multiprocess_collectives(timeout_s: float = 120.0) -> bool:
    """Whether two processes can run a real gloo all-reduce on the CPU:
    two tiny workers are spawned once a process and the verdict cached.
    The JAX package's psum tests skip on its own probe's verdict (a
    jaxlib may lack multi-process CPU collectives).  gloo always has
    them, so the port's two-rank tests run unguarded; this probe keeps
    the reference's surface and tells whether local tcp works at all."""
    global _PROBE_RESULT
    if _PROBE_RESULT is not None:
        return _PROBE_RESULT
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROBE_WORKER, f"tcp://127.0.0.1:{port}",
         str(rank)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out or "")
    ok = (all(p.returncode == 0 for p in procs)
          and all("FLEET_PROBE_OK" in o for o in outs)
          and not any(MULTIPROC_UNSUPPORTED_MARKER in o for o in outs))
    if not ok:
        logger.info("fleet probe: 2-process CPU collectives unavailable "
                    "(rc=%s)", [p.returncode for p in procs])
    _PROBE_RESULT = ok
    return ok
