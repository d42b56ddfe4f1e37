"""The port's multi-host training fleet (ROADMAP A7a) against the JAX
package's ``parallel.fleet``.

Mirrors ``tests/test_fleet.py`` on the tcp transport:

- **In-process parity**: ``shard_chunk_ids`` over a grid of (n_chunks,
  n_hosts, host_id) with its raises, ``host_dir``, ``FleetContext``'s
  validation messages, the coordinator's totals (bitwise equal to
  ``np.add`` in host-id order), its replay cache and its overwrite per
  (seq, host), a stalled peer raising within the stall timeout, the
  single-host reducer returning its input, and the psum transport's
  context from an initialized world (its two-rank reduce runs in
  ``tests/test_torch_distributed.py``).
- **Wire compatibility** both ways over threads: the port's reducers
  against the reference's coordinator and the reference's reducers
  against the port's, totals bitwise equal.
- **Subprocess drills** with port-only workers (no jax in a worker): a
  streamed L-BFGS fit on 2 hosts (bitwise across hosts, within 5e-4 of
  the JAX package's single-process fit: the reference's own
  fleet-against-solo tolerance); ``slow``: streamed TRON on 2 hosts,
  the fused fit on 3 hosts and the kill-one-host resume (bitwise to an
  uninterrupted fleet).
- **Telemetry**: ``fleet-report`` of each package over host logs the
  other package wrote (equal verdicts, rows and exit codes, passing and
  failing), the port's judgment of a resumed fleet, and the monitor's
  ``_fleet_status`` of both packages under equal counters.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from photon_ml_torch.parallel import fleet as tfleet
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jfleet():
    from photon_ml_tpu.parallel import fleet as jfleet

    return jfleet


# ---------------------------------------------------------------------------
# In-process parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [0, 1, 2, 5, 7, 12, 13])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
def test_shard_chunk_ids_matches_reference(n_chunks, n_hosts):
    jfleet = _jfleet()
    for host in range(n_hosts):
        assert tfleet.shard_chunk_ids(n_chunks, host, n_hosts) == \
            jfleet.shard_chunk_ids(n_chunks, host, n_hosts)
    steps = {len(tfleet.shard_chunk_ids(n_chunks, h, n_hosts)[1])
             for h in range(n_hosts)}
    assert len(steps) == 1
    owned = [c for h in range(n_hosts)
             for c in tfleet.shard_chunk_ids(n_chunks, h, n_hosts)[0]]
    assert owned == list(range(n_chunks))


@pytest.mark.parametrize("args", [(8, 3, 3), (-1, 0, 2), (4, -1, 2)])
def test_shard_chunk_ids_raises_as_reference(args):
    jfleet = _jfleet()
    with pytest.raises(ValueError) as t:
        tfleet.shard_chunk_ids(*args)
    with pytest.raises(ValueError) as j:
        jfleet.shard_chunk_ids(*args)
    assert str(t.value) == str(j.value)


def test_host_dir_matches_reference(tmp_path):
    jfleet = _jfleet()
    base = str(tmp_path / "out")
    for h, n, tr, co in ((2, 3, "tcp", "127.0.0.1:1"), (0, 1, "tcp", None),
                         (1, 2, "psum", None)):
        t = tfleet.FleetContext(host_id=h, n_hosts=n, transport=tr,
                                coordinator=co)
        j = jfleet.FleetContext(host_id=h, n_hosts=n, transport=tr,
                                coordinator=co)
        assert tfleet.host_dir(base, t) == jfleet.host_dir(base, j)
        assert t.is_fleet == j.is_fleet
    assert tfleet.host_dir(base, None) == jfleet.host_dir(base, None) == base
    assert tfleet.host_dir(base, tfleet.FleetContext(
        1, 2, "tcp", "h:1")) == os.path.join(base, "host_001")


@pytest.mark.parametrize("kw", [
    dict(host_id=0, n_hosts=0),
    dict(host_id=3, n_hosts=3),
    dict(host_id=-1, n_hosts=2),
    dict(host_id=0, n_hosts=2, transport="mpi"),
    dict(host_id=0, n_hosts=2, transport="tcp"),
])
def test_fleet_context_validation_matches_reference(kw):
    jfleet = _jfleet()
    with pytest.raises(ValueError) as t:
        tfleet.FleetContext(**kw)
    with pytest.raises(ValueError) as j:
        jfleet.FleetContext(**kw)
    assert str(t.value) == str(j.value)


def _tree(v: float, d: int = 5):
    return {"grad": np.arange(d, dtype=np.float32) * np.float32(v),
            "loss": np.float32(v)}


def _run_hosts(reducers, trees_of):
    """Each reducer reduces ``trees_of(h, step)`` for its steps on its
    own thread; returns each host's results."""
    out = [[] for _ in reducers]
    errors = []

    def run(h):
        try:
            for tree in trees_of(h):
                out[h].append(reducers[h].reduce(tree))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(h,))
               for h in range(len(reducers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return out


def test_coordinator_sums_in_host_order_bitwise():
    """Three hosts' float32 partials: every host gets the total summed
    in host-id order, bitwise, and the sequence numbers advance alike."""
    rng = np.random.default_rng(0)
    parts = [[(rng.normal(0, 1, 64) * 10.0 ** rng.integers(-3, 4, 64))
              .astype(np.float32) for _ in range(3)] for _ in range(4)]
    coord = tfleet.ReduceCoordinator(3)
    reds = [tfleet.FleetReducer(tfleet.FleetContext(
        h, 3, "tcp", coord.address), stall_timeout_s=30.0)
        for h in range(3)]
    try:
        got = _run_hosts(reds, lambda h: [(torch.from_numpy(p[h]),)
                                          for p in parts])
        for step, p in enumerate(parts):
            want = np.add(np.add(p[0], p[1]), p[2])
            for h in range(3):
                t = got[h][step][0]
                assert isinstance(t, torch.Tensor)
                np.testing.assert_array_equal(t.numpy(), want)
        assert [r.seq for r in reds] == [4, 4, 4]
        assert coord.reduces == 4 and coord.replays == 0
    finally:
        for r in reds:
            r.close()
        coord.close()


@pytest.mark.parametrize("impl", ["torch", "jax"])
def test_replay_cache_and_overwrite_per_seq_host(impl):
    """A completed sequence number is answered from the cache (never
    summed again); a host's second contribution to a pending sequence
    number replaces its first."""
    mod = tfleet if impl == "torch" else _jfleet()
    coord = mod.ReduceCoordinator(2, stall_timeout_s=30.0)
    try:
        a = [np.full(3, 1.0, np.float32)]
        b = [np.full(3, 2.0, np.float32)]
        res = {}
        t = threading.Thread(target=lambda: res.setdefault(
            0, coord._reduce_one(0, 0, a)))
        t.start()
        time.sleep(0.2)
        # Host 0 contributes again to the pending seq 0: overwrite.
        t2 = threading.Thread(target=lambda: res.setdefault(
            2, coord._reduce_one(0, 0, [np.full(3, 5.0, np.float32)])))
        t2.start()
        time.sleep(0.2)
        res[1] = coord._reduce_one(1, 0, b)
        t.join(10)
        t2.join(10)
        np.testing.assert_array_equal(res[1][0], np.full(3, 7.0))
        np.testing.assert_array_equal(res[0][0], res[1][0])
        assert coord.reduces == 1
        again = coord._reduce_one(1, 0, [np.zeros(3, np.float32)])
        np.testing.assert_array_equal(again[0], np.full(3, 7.0))
        assert coord.replays == 1 and coord.reduces == 1
    finally:
        coord.close()


def test_stalled_peer_raises_within_stall_timeout():
    coord = tfleet.ReduceCoordinator(2, stall_timeout_s=1.0)
    red = tfleet.FleetReducer(tfleet.FleetContext(0, 2, "tcp",
                                                  coord.address),
                              stall_timeout_s=30.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(tfleet.FleetBarrierError):
            red.reduce(_tree(1.0))
        assert time.monotonic() - t0 < 10.0
    finally:
        red.close()
        coord.close()


def test_coordinator_logs_a_host_dropped_mid_message(caplog):
    """A host that drops mid-message is logged as a warning, one that
    hangs up between messages at debug level; both leave the
    coordinator serving (the others' barrier still holds)."""
    import logging
    import socket

    coord = tfleet.ReduceCoordinator(2, stall_timeout_s=5.0)
    host, port = coord.address.rsplit(":", 1)
    try:
        with caplog.at_level(logging.DEBUG, logger=tfleet.__name__):
            with socket.create_connection((host, int(port))) as s:
                s.sendall(json.dumps({"host": 0, "seq": 0,
                                      "nbytes": 100}).encode()
                          + b"\n" + b"x" * 10)
            with socket.create_connection((host, int(port))):
                pass
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and len(caplog.records) < 2:
                time.sleep(0.05)
        got = sorted((r.levelname, r.getMessage().split(":")[0])
                     for r in caplog.records)
        assert got == [("DEBUG", "fleet host hung up"),
                       ("WARNING", "fleet host dropped mid-message")]
        assert coord.reduces == 0
    finally:
        coord.close()


def test_unreachable_coordinator_raises_barrier_error():
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    red = tfleet.FleetReducer(tfleet.FleetContext(
        0, 2, "tcp", f"127.0.0.1:{port}"), stall_timeout_s=0.5)
    with pytest.raises(tfleet.FleetBarrierError, match="unreachable"):
        red.reduce(_tree(1.0))


def test_single_host_reduce_is_identity():
    for mod in (tfleet, _jfleet()):
        red = mod.FleetReducer(mod.FleetContext(host_id=0, n_hosts=1,
                                                transport="tcp"))
        tree = _tree(2.0)
        assert red.reduce(tree) is tree
        assert red.seq == 0


def test_psum_transport_raises_naming_a7b(monkeypatch):
    # The psum transport is ported now (A7b; it raised before): without
    # an initialized process group its reduce raises a barrier error,
    # and an initialized world of more than one process wins over the
    # tcp trio, as in the reference (the real two-rank reduce is in
    # tests/test_torch_distributed.py).
    ctx = tfleet.FleetContext(0, 2)          # the default transport
    assert ctx.transport == "psum"
    with pytest.raises(tfleet.FleetBarrierError, match="process group"):
        tfleet.FleetReducer(ctx).reduce(_tree(1.0))
    monkeypatch.setattr(tfleet, "_ACTIVE", None)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setenv("PHOTON_FLEET_NUM_HOSTS", "2")
    monkeypatch.setenv("PHOTON_FLEET_COORDINATOR", "127.0.0.1:1")
    got = tfleet.initialize_from_env()
    assert (got.host_id, got.n_hosts, got.transport) == (1, 2, "psum")
    assert tfleet.active() is got
    tfleet.deactivate()
    assert tfleet.active() is None


def test_session_scopes_the_reducer():
    ctx = tfleet.FleetContext(1, 2, "tcp", "127.0.0.1:1")
    assert tfleet.reducer() is None
    with tfleet.session(ctx):
        assert tfleet.active() is ctx
        red = tfleet.reducer()
        assert red is tfleet.reducer() and red.ctx is ctx
        with pytest.raises(RuntimeError, match="already active"):
            with tfleet.session(ctx):
                pass
    assert tfleet.active() is None and tfleet.reducer() is None


def test_device_partial_goes_down_once_and_comes_back():
    """A partial tree of tensors and arrays (tuple, list, dict, None)
    keeps its structure, its kinds and its dtypes through a reduce."""
    coord = tfleet.ReduceCoordinator(2)
    reds = [tfleet.FleetReducer(tfleet.FleetContext(
        h, 2, "tcp", coord.address), stall_timeout_s=30.0)
        for h in range(2)]

    def tree(h):
        return (torch.tensor(float(h + 1), dtype=torch.float64),
                [torch.full((3,), float(h), dtype=torch.float32),
                 np.full(2, h + 1, np.int64)],
                {"b": torch.ones(2, 2) * h, "a": None})

    try:
        got = _run_hosts(reds, lambda h: [tree(h)])
        for h in range(2):
            f, lst, d = got[h][0]
            assert f.dtype == torch.float64 and f.shape == () \
                and float(f) == 3.0
            assert lst[0].dtype == torch.float32
            np.testing.assert_array_equal(lst[0].numpy(), [1.0] * 3)
            assert isinstance(lst[1], np.ndarray)
            np.testing.assert_array_equal(lst[1], [3, 3])
            assert d["a"] is None
            np.testing.assert_array_equal(d["b"].numpy(), np.ones((2, 2)))
    finally:
        for r in reds:
            r.close()
        coord.close()


@pytest.mark.parametrize("spilled", [False, True])
def test_chunked_batch_shards_by_host_as_reference(spilled, tmp_path):
    """Under an active fleet context ``build_chunked_batch`` of both
    packages builds the host's shard only (global chunk ids, the same
    owned ids and sentinel-padded schedule), spilled under the host's
    own ``host_NNN`` subdir."""
    jfleet = _jfleet()
    from photon_ml_tpu.data.chunked_batch import build_chunked_batch as jbuild

    from photon_ml_torch.data.chunked_batch import build_chunked_batch

    cols, vals, y = _lbfgs_workload()
    rows = [(cols[i], vals[i]) for i in range(len(y))]
    got = {}
    for pkg, mod, build in (("torch", tfleet, build_chunked_batch),
                            ("jax", jfleet, jbuild)):
        spill = str(tmp_path / pkg) if spilled else None
        ctx = mod.FleetContext(host_id=1, n_hosts=2, transport="tcp",
                               coordinator="127.0.0.1:1")
        with mod.session(ctx):
            cb = build(rows, _LBFGS_D, y, chunk_rows=120, layout="ell",
                       spill_dir=spill)
        got[pkg] = cb
        assert cb.n_chunks == 5
        if spilled:
            assert os.listdir(tmp_path / pkg) == ["host_001"]
            assert all(cb.store.has(i) == (i in (3, 4)) for i in range(5))
        else:
            assert [c is None for c in cb.chunks] == [True] * 3 + [False] * 2
    t, j = got["torch"], got["jax"]
    assert t.owned_chunk_ids == j.owned_chunk_ids == [3, 4]
    assert t.chunk_schedule == j.chunk_schedule == [3, 4, tfleet.EMPTY_CHUNK]
    for i in (3, 4):
        np.testing.assert_array_equal(np.asarray(t.chunk(i).values),
                                      np.asarray(j.chunk(i).values))
    solo = build_chunked_batch(rows, _LBFGS_D, y, chunk_rows=120)
    assert solo.owned_chunk_ids == solo.chunk_schedule == list(range(5))


# ---------------------------------------------------------------------------
# Wire compatibility, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coordinator", ["jax", "torch"])
def test_wire_compatible_both_ways(coordinator):
    """The port's reducers against the reference's coordinator, and the
    reference's reducers against the port's: equal totals, bitwise, for
    every mix of reducer packages."""
    jfleet = _jfleet()
    cmod = jfleet if coordinator == "jax" else tfleet
    rmods = (tfleet, jfleet) if coordinator == "jax" else (jfleet, tfleet)
    rng = np.random.default_rng(4)
    parts = [[rng.normal(0, 1, 33).astype(np.float32) for _ in range(2)]
             for _ in range(3)]
    coord = cmod.ReduceCoordinator(2)
    reds = [rmods[h].FleetReducer(rmods[h].FleetContext(
        host_id=h, n_hosts=2, transport="tcp", coordinator=coord.address),
        stall_timeout_s=30.0) for h in range(2)]

    def trees(h):
        for p in parts:
            x = p[h]
            yield ({"g": torch.from_numpy(x), "f": torch.tensor(x.sum())}
                   if rmods[h] is tfleet
                   else {"g": x, "f": np.float32(x.sum())})

    try:
        got = _run_hosts(reds, lambda h: list(trees(h)))
        for step, p in enumerate(parts):
            want = np.add(p[0], p[1])
            wf = np.add(np.float32(p[0].sum()), np.float32(p[1].sum()))
            for h in range(2):
                out = got[h][step]
                np.testing.assert_array_equal(np.asarray(out["g"]), want)
                assert np.asarray(out["f"]).tobytes() == \
                    np.asarray(wf).tobytes()
        assert coord.reduces == 3
    finally:
        for r in reds:
            r.close()
        coord.close()


# ---------------------------------------------------------------------------
# Subprocess drills: port-only workers
# ---------------------------------------------------------------------------

_LBFGS_N, _LBFGS_D, _LBFGS_K = 600, 40, 4


def _lbfgs_workload():
    rng = np.random.default_rng(17)
    n, d, k = _LBFGS_N, _LBFGS_D, _LBFGS_K
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int64)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    w_true = rng.normal(0, 1, d).astype(np.float32)
    m = np.einsum("nk,nk->n", vals, w_true[cols])
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    return cols, vals, y


_STREAM_WORKER = r'''
import json
import os
import sys

sys.path.insert(0, os.environ["PML_REPO"])

import numpy as np
import torch


def main():
    from photon_ml_torch.parallel import fleet

    fleet.initialize_from_env()

    from photon_ml_torch.data.chunked_batch import build_chunked_batch
    from photon_ml_torch.data.normalization import NormalizationContext
    from photon_ml_torch.data.sparse_rows import SparseRows
    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops.objective import GLMObjective
    from photon_ml_torch.ops.regularization import RegularizationContext
    from photon_ml_torch.optim.base import OptimizerConfig
    from photon_ml_torch.optim.streaming import (
        ChunkedGLMObjective, streaming_lbfgs_solve, streaming_tron_solve)

    n, d, k = N_D_K
    rng = np.random.default_rng(17)
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int64)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    w_true = rng.normal(0, 1, d).astype(np.float32)
    m = np.einsum("nk,nk->n", vals, w_true[cols])
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    rows = SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * k,
                                cols.reshape(-1), vals.reshape(-1))
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(1.0),
                       norm=NormalizationContext.identity())
    cb = build_chunked_batch(rows, d, y, n_chunks=N_CHUNKS, layout="ell")
    cobj = ChunkedGLMObjective(obj, cb, max_resident=N_CHUNKS,
                               device="cpu")
    cfg = OptimizerConfig(max_iters=60, tolerance=1e-7)
    if os.environ.get("FLEET_T_SOLVER") == "tron":
        res = streaming_tron_solve(
            cobj.value_and_gradient, cobj.hvp_pass,
            torch.zeros(d), OptimizerConfig(max_iters=40, tolerance=1e-8),
            hessian_diag=cobj.hessian_diagonal)
    else:
        res = streaming_lbfgs_solve(cobj.value_and_gradient,
                                    torch.zeros(d), cfg,
                                    value_fn=cobj.value)
    red = fleet.reducer()
    ctx = fleet.active()
    print("RESULT " + json.dumps({
        "w": res.w.numpy().tolist(),
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "seq": red.seq if red is not None else -1,
        "host": ctx.host_id if ctx is not None else -1,
        "owned": cb.owned_chunk_ids,
        "schedule": cb.chunk_schedule,
        "jax_loaded": any(m == "jax" or m.startswith("jax.")
                          or m.startswith("photon_ml_tpu")
                          for m in sys.modules),
    }))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
'''


def _workload_src(template: str, **subs) -> str:
    for key, val in subs.items():
        template = template.replace(key, val)
    return template


def _spawn_worker(script: str, extra_env: dict) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PHOTON_FLEET_")}
    env.update({"PML_REPO": _REPO})
    env.update(extra_env)
    return subprocess.Popen([sys.executable, script], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen, tag: str, timeout=240.0) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{tag} timed out:\n{err[-3000:]}")
    assert proc.returncode == 0, (
        f"{tag} rc={proc.returncode}\n{out[-2000:]}\n{err[-3000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"{tag} printed no RESULT line:\n{out}\n{err[-2000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def _fleet_env(coord, host: int, n_hosts: int, **extra) -> dict:
    env = {"PHOTON_FLEET_NUM_HOSTS": str(n_hosts),
           "PHOTON_FLEET_HOST_ID": str(host),
           "PHOTON_FLEET_COORDINATOR": coord.address}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run_fleet(script: str, n_hosts: int, stall_s: float = 60.0,
               **extra) -> tuple[list, object]:
    coord = tfleet.ReduceCoordinator(n_hosts, stall_timeout_s=stall_s)
    procs: list = []
    try:
        for h in range(n_hosts):
            procs.append(_spawn_worker(script, _fleet_env(
                coord, h, n_hosts, **extra)))
        results = [_result(p, f"host{h}") for h, p in enumerate(procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        coord.close()
    return results, coord


def _jax_solo_stream(n_chunks: int, solver: str = "lbfgs") -> np.ndarray:
    """The JAX package's single-process streamed fit of the drill's
    workload: L-BFGS, or TRON with the worker's settings."""
    import jax.numpy as jnp
    from photon_ml_tpu.data.chunked_batch import build_chunked_batch
    from photon_ml_tpu.data.normalization import NormalizationContext
    from photon_ml_tpu.data.sparse_rows import SparseRows
    from photon_ml_tpu.ops import losses
    from photon_ml_tpu.ops.objective import GLMObjective
    from photon_ml_tpu.ops.regularization import RegularizationContext
    from photon_ml_tpu.optim.base import OptimizerConfig
    from photon_ml_tpu.optim.streaming import (
        ChunkedGLMObjective,
        streaming_lbfgs_solve,
        streaming_tron_solve,
    )

    cols, vals, y = _lbfgs_workload()
    n, k = cols.shape
    rows = SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * k,
                                cols.reshape(-1), vals.reshape(-1))
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(1.0),
                       norm=NormalizationContext.identity())
    cb = build_chunked_batch(rows, _LBFGS_D, y, n_chunks=n_chunks,
                             layout="ell")
    cobj = ChunkedGLMObjective(obj, cb, max_resident=n_chunks)
    if solver == "tron":
        res = streaming_tron_solve(
            cobj.value_and_gradient, cobj.hvp_pass,
            jnp.zeros(_LBFGS_D, jnp.float32),
            OptimizerConfig(max_iters=40, tolerance=1e-8),
            hessian_diag=cobj.hessian_diagonal)
        return np.asarray(res.w)
    res = streaming_lbfgs_solve(cobj.value_and_gradient,
                                jnp.zeros(_LBFGS_D, jnp.float32),
                                OptimizerConfig(max_iters=60,
                                                tolerance=1e-7),
                                value_fn=cobj.value)
    return np.asarray(res.w)


def _stream_script(tmp_path, n_chunks: int) -> str:
    script = tmp_path / "stream_worker.py"
    script.write_text(_workload_src(
        _STREAM_WORKER, N_D_K=repr((_LBFGS_N, _LBFGS_D, _LBFGS_K)),
        N_CHUNKS=str(n_chunks)))
    return str(script)


def test_fleet_streaming_lbfgs_bitwise_across_hosts_and_matches_jax(
        tmp_path):
    """Two tcp-fleet hosts run a streamed L-BFGS fit over a ragged
    3-chunk grid (host 1 owns one chunk and a sentinel): bitwise-equal
    coefficients at equal iterations and reduce sequences, no jax in a
    worker, and within 5e-4 of the JAX package's single-process fit."""
    script = _stream_script(tmp_path, 3)
    results, coord = _run_fleet(script, 2)
    assert [r["owned"] for r in results] == [[0, 1], [2]]
    assert [r["schedule"] for r in results] == [[0, 1], [2, -1]]
    assert not any(r["jax_loaded"] for r in results)
    w = [np.asarray(r["w"], np.float32) for r in results]
    np.testing.assert_array_equal(w[0], w[1])
    assert results[0]["iterations"] == results[1]["iterations"]
    assert results[0]["converged"]
    assert len({r["seq"] for r in results}) == 1
    assert results[0]["seq"] == coord.reduces > 0
    solo = _jax_solo_stream(3)
    np.testing.assert_allclose(w[0], solo, atol=5e-4, rtol=0)


@pytest.mark.slow   # 2 subprocess TRON fits, a solo one and a JAX one
def test_fleet_streaming_tron_bitwise_across_hosts(tmp_path):
    """Two hosts run the streamed TRON fit (value/gradient, the Hessian
    diagonal and every CG pass reduced a chunk step): bitwise equal
    across hosts at the same iteration count and reduce sequence, within
    1e-3 of a single-host run of the same worker, and within 5e-4 of the
    JAX package's single-process TRON fit."""
    script = _stream_script(tmp_path, 4)
    results, coord = _run_fleet(script, 2, FLEET_T_SOLVER="tron")
    solo = _result(_spawn_worker(script, {"FLEET_T_SOLVER": "tron"}),
                   "solo")
    w = [np.asarray(r["w"], np.float32) for r in results]
    np.testing.assert_array_equal(w[0], w[1])
    assert results[0]["iterations"] == results[1]["iterations"]
    assert results[0]["converged"] and solo["converged"]
    assert len({r["seq"] for r in results}) == 1
    assert results[0]["seq"] == coord.reduces > 0 and solo["seq"] == -1
    np.testing.assert_allclose(w[0], np.asarray(solo["w"], np.float32),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(w[0], _jax_solo_stream(4, "tron"), atol=5e-4,
                               rtol=0)


_GAME_WORKER = r'''
import json
import os
import sys

sys.path.insert(0, os.environ.get("PML_REPO", os.getcwd()))

import numpy as np


def _workload(n=240, d=24, k=4, d_re=2):
    rng = np.random.default_rng(7)
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    w_true = rng.normal(0, 1, d)
    ids = np.concatenate([rng.integers(0, 10, (2 * n) // 3),
                          rng.integers(50, 53, n - (2 * n) // 3)])
    b_true = rng.normal(0, 0.7, 60)
    m = np.einsum("nk,nk->n", vals, w_true[cols]) + b_true[ids % 60]
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    rows = [(cols[i], vals[i]) for i in range(n)]
    from PKG.game.dataset import GameDataset
    return GameDataset(
        labels=y,
        features={"f": rows,
                  "re": rng.normal(0, 1, (n, d_re)).astype(np.float32)},
        entity_ids={"u": ids}, feature_dims={"f": d})


def config(out_base, cycles, ckpt, resume, extra):
    from PKG.config import (
        CoordinateConfig, CoordinateKind, OptimizerSettings,
        TrainingConfig)
    from PKG.models.glm import TaskType

    return TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[
            CoordinateConfig(name="global",
                             kind=CoordinateKind.FIXED_EFFECT,
                             feature_shard="f",
                             optimizer=OptimizerSettings(
                                 max_iters=40, reg_weight=1.0,
                                 tolerance=1e-6)),
            CoordinateConfig(name="per_u",
                             kind=CoordinateKind.RANDOM_EFFECT,
                             feature_shard="re", entity_key="u",
                             optimizer=OptimizerSettings(
                                 max_iters=30, reg_weight=2.0,
                                 tolerance=1e-6)),
        ],
        update_sequence=["global", "per_u"],
        n_iterations=cycles,
        intercept=False, chunk_rows=40, chunk_layout="ELL",
        cd_fused=True, validation_fraction=0.0,
        validate_per_iteration=False,
        spill_dir=os.path.join(out_base, "spill"),
        checkpoint_dir=(os.path.join(out_base, "ckpt") if ckpt else None),
        resume=resume, **extra)


def main():
    from photon_ml_torch.parallel import fleet
    from photon_ml_torch.reliability import faults

    fleet.initialize_from_env()
    kill_at = os.environ.get("FLEET_T_KILL_AT")
    if kill_at:
        faults.install(faults.FaultInjector([
            faults.Fault(site="fleet.reduce", kind="kill",
                         at=int(kill_at))]))
    from photon_ml_torch.estimators.game_estimator import GameEstimator

    cfg = config(os.environ["FLEET_T_OUT"],
                 int(os.environ.get("FLEET_T_CYCLES", "6")),
                 bool(os.environ.get("FLEET_T_CKPT")),
                 os.environ.get("FLEET_T_RESUME") == "1",
                 {"device": "cpu"})
    cfg.validate()
    models = GameEstimator(cfg).fit(_workload())[0].model.models
    red = fleet.reducer()
    ctx = fleet.active()
    print("RESULT " + json.dumps({
        "fe": models["global"].coefficients.means.numpy().tolist(),
        "re0": models["per_u"].coefficient_blocks[0].numpy().ravel()
        .tolist(),
        "seq": red.seq if red is not None else -1,
        "host": ctx.host_id if ctx is not None else -1,
        "jax_loaded": any(m == "jax" or m.startswith("jax.")
                          or m.startswith("photon_ml_tpu")
                          for m in sys.modules),
    }))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
'''


def _game_script(tmp_path) -> str:
    script = tmp_path / "game_worker.py"
    script.write_text(_GAME_WORKER.replace("PKG", "photon_ml_torch"))
    return str(script)


def _jax_solo_fused(tmp_path, cycles: int = 6) -> dict:
    """The JAX package's single-process fused fit of the drill's
    workload, in this process."""
    ns: dict = {}
    exec(compile(_GAME_WORKER.replace("PKG", "photon_ml_tpu"),
                 "game_worker_jax", "exec"), ns)
    from photon_ml_tpu.estimators.game_estimator import GameEstimator

    cfg = ns["config"](str(tmp_path / "jax_solo"), cycles, False, False, {})
    cfg.validate()
    models = GameEstimator(cfg).fit(ns["_workload"]())[0].model.models
    return {"fe": np.asarray(models["global"].coefficients.means),
            "re0": np.asarray(models["per_u"].coefficient_blocks[0]).ravel()}


@pytest.mark.slow   # 3 subprocess fits and a JAX one: 8.3 s alone
def test_fleet_fused_fit_bitwise_across_hosts_and_matches_jax(tmp_path):
    """Three hosts train the fused-cycle workload over sharded chunks:
    bitwise-equal coefficients on every host, one reduce count, no jax
    in a worker, and within 5e-4 of the JAX package's single-process
    fit."""
    script = _game_script(tmp_path)
    results, coord = _run_fleet(script, 3,
                                FLEET_T_OUT=str(tmp_path / "fleet"))
    fe = [np.asarray(r["fe"]) for r in results]
    re0 = [np.asarray(r["re0"]) for r in results]
    for h in range(1, 3):
        np.testing.assert_array_equal(fe[0], fe[h])
        np.testing.assert_array_equal(re0[0], re0[h])
    assert len({r["seq"] for r in results}) == 1
    assert results[0]["seq"] == coord.reduces > 0
    assert not any(r["jax_loaded"] for r in results)
    for h in range(3):
        assert os.path.isdir(tmp_path / "fleet" / "spill" / f"host_{h:03d}")
    solo = _jax_solo_fused(tmp_path)
    np.testing.assert_allclose(fe[0], solo["fe"], atol=5e-4, rtol=0)
    np.testing.assert_allclose(re0[0], solo["re0"], atol=5e-4, rtol=0)


@pytest.mark.slow   # 5 subprocess fits with the kill drill: 12.4 s alone
def test_fleet_kill_one_host_resumes_bitwise(tmp_path):
    """Host 1 of a 2-host fleet is SIGKILLed at its 7th ``fleet.reduce``
    (after a per-host checkpoint).  Host 0 is never restarted; host 1
    alone restarts with ``resume=True``, restores its reduce sequence,
    replays it against the coordinator's cache and finishes bitwise
    equal to an uninterrupted fleet."""
    script = _game_script(tmp_path)
    ref, _ = _run_fleet(script, 2, FLEET_T_OUT=str(tmp_path / "ref"),
                        FLEET_T_CKPT=1)
    coord = tfleet.ReduceCoordinator(2, stall_timeout_s=120.0)
    out = str(tmp_path / "drill")
    survivor = restarted = None
    try:
        survivor = _spawn_worker(script, _fleet_env(
            coord, 0, 2, FLEET_T_OUT=out, FLEET_T_CKPT=1))
        victim = _spawn_worker(script, _fleet_env(
            coord, 1, 2, FLEET_T_OUT=out, FLEET_T_CKPT=1,
            FLEET_T_KILL_AT=7))
        victim.wait(timeout=240)
        v_out, v_err = victim.communicate()
        assert victim.returncode == -signal.SIGKILL, (
            f"victim rc={victim.returncode}:\n{v_err[-2000:]}")
        assert survivor.poll() is None, "the survivor died with the victim"
        restarted = _spawn_worker(script, _fleet_env(
            coord, 1, 2, FLEET_T_OUT=out, FLEET_T_CKPT=1, FLEET_T_RESUME=1))
        r1 = _result(restarted, "restarted-host1")
        r0 = _result(survivor, "survivor-host0")
        assert coord.replays > 0
    finally:
        for p in (survivor, restarted):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        coord.close()
    for r in (r0, r1):
        np.testing.assert_array_equal(np.asarray(ref[0]["fe"]),
                                      np.asarray(r["fe"]))
        np.testing.assert_array_equal(np.asarray(ref[0]["re0"]),
                                      np.asarray(r["re0"]))
    assert r0["seq"] == ref[0]["seq"] == r1["seq"]


# ---------------------------------------------------------------------------
# Telemetry: fleet-report across packages, the monitor's fleet slice
# ---------------------------------------------------------------------------


def _write_host_log(pkg: str, path: str, host: int, n_hosts: int,
                    counters: dict, gauges: dict | None = None,
                    mode: str = "w") -> None:
    """A synthetic host log written by ``pkg``'s own run logger and
    telemetry session: a fleet ``run_info`` header and the counters'
    summary."""
    if pkg == "torch":
        from photon_ml_torch import telemetry
        from photon_ml_torch.utils.run_log import RunLogger
        kw = {"device": "cpu"}
    else:
        from photon_ml_tpu import telemetry
        from photon_ml_tpu.utils.run_log import RunLogger
        kw = {}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    log = RunLogger(path, mode=mode, header=True, run_info={
        "driver": "game_training", "fleet_host": host,
        "fleet_hosts": n_hosts, "fleet_transport": "tcp"})
    t = telemetry.start("metrics", run_logger=log, **kw)
    try:
        with telemetry.span("fit", cat="phase"):
            for name, v in counters.items():
                t.count(name, v)
            for name, v in (gauges or {}).items():
                t.gauge(name, v)
    finally:
        t.close()
        log.close()


def _counters(reduces: int, sweeps: int = 12) -> dict:
    return {"fleet.psums": reduces, "fleet.chunks_streamed": 2 * sweeps,
            "fleet.barrier_wait_s": 0.25, "solver.sweeps": sweeps,
            "solver.streamed_solves": 2, "solver.ls_trials": sweeps - 2,
            "solver.iterations": 0}


_ROW_KEYS = ("host", "transport", "segments", "chunks_streamed",
             "reduces", "barrier_wait_s", "seq_restored", "sweeps",
             "passes_per_cycle", "odometer_ok")
_RESULT_KEYS = ("ok", "n_hosts", "expected_hosts", "total_chunks_streamed",
                "reduces", "barrier_agreement", "reduce_counts",
                "odometer_agreement", "odometer_ok", "fleet_sweeps",
                "passes_per_cycle", "restarted_hosts")


def _both_reports(paths: list[str]) -> tuple[dict, dict, int, int]:
    from photon_ml_tpu.telemetry import fleet_report as jreport
    from photon_ml_tpu.telemetry.__main__ import main as jmain

    from photon_ml_torch.telemetry import fleet_report as treport
    from photon_ml_torch.telemetry.__main__ import main as tmain

    t = treport.run_fleet_report(paths, out=io.StringIO())
    j = jreport.run_fleet_report(paths, out=io.StringIO())
    rcs = []
    for main in (tmain, jmain):
        buf = io.StringIO()
        from contextlib import redirect_stdout
        with redirect_stdout(buf):
            rcs.append(main(["fleet-report", *paths]))
        assert json.loads(buf.getvalue().strip().splitlines()[-1])
    return t, j, rcs[0], rcs[1]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", ["agree", "barrier_skew",
                                  "odometer_skew", "missing_host"])
def test_fleet_report_equal_across_packages(writer, case, tmp_path):
    """Each package's ``fleet-report`` over host logs the other package
    (or it) wrote: equal verdicts, equal barrier and odometer rows,
    equal exit codes, passing and failing."""
    counts = {"agree": [(40, 12), (40, 12)],
              "barrier_skew": [(40, 12), (39, 12)],
              "odometer_skew": [(40, 12), (40, 14)],
              "missing_host": [(40, 12)]}[case]
    paths = []
    for h, (reduces, sweeps) in enumerate(counts):
        p = str(tmp_path / f"host_{h:03d}" / "run_log.jsonl")
        _write_host_log(writer, p, h, 2, _counters(reduces, sweeps),
                        {"fleet.seq": reduces} if writer == "torch" else None)
        paths.append(p)
    t, j, trc, jrc = _both_reports(paths)
    for key in _RESULT_KEYS:
        assert t[key] == j[key], key
    for rt, rj in zip(t["hosts"], j["hosts"]):
        for key in _ROW_KEYS:
            assert rt[key] == rj[key], key
    assert trc == jrc == (0 if t["ok"] else 1)
    assert t["ok"] == (case == "agree")


def test_fleet_report_judges_a_resumed_host_by_its_sequence(tmp_path):
    """A host killed and resumed appends a second run segment whose
    counters cover only the run after its restore.  The port judges its
    barrier by the sequence number it reached (the ``fleet.seq`` gauge)
    and leaves its partial odometer out of the agreement: the resumed
    fleet passes and host 1 is flagged.  The JAX package's report, which
    reads only the last segment's counts, fails the same logs."""
    p0 = str(tmp_path / "host_000" / "run_log.jsonl")
    p1 = str(tmp_path / "host_001" / "run_log.jsonl")
    _write_host_log("torch", p0, 0, 2, _counters(40, 12), {"fleet.seq": 40})
    _write_host_log("torch", p1, 1, 2, _counters(15, 5), {"fleet.seq": 15})
    _write_host_log("torch", p1, 1, 2,
                    {**_counters(26, 8), "fleet.seq_restored": 1},
                    {"fleet.seq": 40}, mode="a")
    t, j, trc, jrc = _both_reports([p0, p1])
    assert t["ok"] and trc == 0
    assert t["restarted_hosts"] == [1] and t["reduces"] == 40
    assert [r["segments"] for r in t["hosts"]] == [1, 2]
    assert t["hosts"][1]["seq_restored"] == 1
    assert not j["ok"] and jrc == 1


def test_fleet_status_equal_across_packages():
    """The monitor's ``/status`` fleet slice, both packages, in an active
    two-host session with equal counters."""
    jfleet = _jfleet()
    from photon_ml_tpu import telemetry as jtel
    from photon_ml_tpu.telemetry import monitor as jmon

    from photon_ml_torch import telemetry as ttel
    from photon_ml_torch.telemetry import monitor as tmon

    assert tmon._fleet_status() is None and jmon._fleet_status() is None
    counts = {"fleet.psums": 9, "fleet.chunks_streamed": 7,
              "fleet.barrier_wait_s": 1.23456}
    got = []
    for tel, mon, mod, kw in ((ttel, tmon, tfleet, {"device": "cpu"}),
                              (jtel, jmon, jfleet, {})):
        ctx = mod.FleetContext(host_id=1, n_hosts=2, transport="tcp",
                               coordinator="127.0.0.1:1")
        with mod.session(ctx):
            t = tel.start("metrics", **kw)
            try:
                assert mon._fleet_status() == {
                    "host": 1, "n_hosts": 2, "transport": "tcp",
                    "reduces": 0, "chunks_streamed": 0,
                    "barrier_wait_s": 0.0}
                for k, v in counts.items():
                    t.count(k, v)
                got.append(mon._fleet_status())
            finally:
                t.close()
    assert got[0] == got[1]
    assert got[0]["barrier_wait_s"] == 1.235 and got[0]["reduces"] == 9
