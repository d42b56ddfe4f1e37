"""The port's runtime guards and CUDA-event timing.

``analysis.guards``: ``count_compiles`` counts kernel builds (the
listener of ``kernels._build``, the same one telemetry's
``kernels.builds`` uses); ``no_implicit_transfers`` is
``torch.cuda.set_sync_debug_mode`` over its scope plus a count of the
explicit fences (``torch.cuda.synchronize``, ``Event.synchronize``,
``Stream.synchronize``), a no-op for a CPU device.
``utils.timing``: ``device_fence`` and ``measure``.

This file imports no JAX, so its ``cuda`` tests also run on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_guards.py

There, one streamed evaluation of a spilled objective makes as many
synchronizing CUDA calls with telemetry on (metrics and trace) as with
it off, and its coefficients after a short fit are bitwise the same; one
served batch makes as many with a request trace as without.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.analysis import guards
from photon_ml_torch.analysis.guards import (
    count_compiles,
    no_implicit_transfers,
)
from photon_ml_torch.data.chunked_batch import build_chunked_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.kernels import _build
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.streaming import (
    ChunkedGLMObjective,
    streaming_lbfgs_solve,
)
from photon_ml_torch.utils.timing import device_fence, measure

D, K, CHUNK_ROWS, N_CHUNKS = 257, 8, 4096, 4


@pytest.fixture(autouse=True)
def _no_leaked_session():
    assert telemetry.active() is None
    yield
    t = telemetry.active()
    if t is not None:
        t.close()
        raise AssertionError("test leaked an active telemetry session")


def _objective(tmp_path, device, name="spill"):
    rng = np.random.default_rng(3)
    n = CHUNK_ROWS * N_CHUNKS
    cols = np.stack([np.sort(rng.choice(D, K, replace=False))
                     for _ in range(n)]).astype(np.int64)
    vals = rng.normal(size=(n, K)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    rows = SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * K,
                                cols.reshape(-1), vals.reshape(-1))
    obj = GLMObjective(loss=losses.LOGISTIC,
                       reg=RegularizationContext.l2(1.0),
                       norm=NormalizationContext.identity())
    cb = build_chunked_batch(rows, D, labels, n_chunks=N_CHUNKS,
                             layout="ell", spill_dir=str(tmp_path / name),
                             host_max_resident=1)
    return ChunkedGLMObjective(obj, cb, max_resident=0, prefetch_depth=2,
                               device=device)


def test_count_compiles_counts_kernel_builds():
    """Each build notification is one entry, in order; nested scopes each
    see the builds inside them; the listener leaves with the scope."""
    with count_compiles() as outer:
        _build._notify_build("gather_rowsum")
        with count_compiles() as inner:
            _build._notify_build("grr_contract")
    assert outer.programs == ["gather_rowsum", "grr_contract"]
    assert inner.count == 1 and inner.named("grr_contract")
    assert not _build._BUILD_LISTENERS


def test_warm_refit_builds_nothing(tmp_path):
    """A second streamed fit builds no kernel (on the CPU, none at all)."""
    cobj = _objective(tmp_path, "cpu")
    cfg = OptimizerConfig(max_iters=2, tolerance=1e-9)
    streaming_lbfgs_solve(cobj.value_and_gradient, torch.zeros(D), cfg)
    with count_compiles() as cc:
        streaming_lbfgs_solve(cobj.value_and_gradient, torch.zeros(D), cfg)
    assert cc.count == 0


def test_sync_guard_is_a_noop_without_a_device(tmp_path):
    """Where no CUDA device is in use the guard yields an inactive log
    and changes nothing, as the reference's guard does on the CPU."""
    cobj = _objective(tmp_path, "cpu")
    with no_implicit_transfers("disallow", "cpu") as log:
        f, _ = cobj.value_and_gradient(torch.zeros(D))
        float(f)
    assert log.active is False
    assert log.count == 0
    with pytest.raises(ValueError, match="level"):
        with no_implicit_transfers("loud"):
            pass


def test_sync_guard_counts_explicit_fences(monkeypatch):
    """The fences the sync debug mode does not see: each one called in
    the scope, from any thread, lands in ``fences`` by name before it
    waits, and the originals are back after the scope.  The fences are
    stubs here (no card)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: calls.append("event"))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: calls.append("stream"))
    originals = [getattr(o, a) for o, a, _ in guards._fence_sites()]
    log = guards.SyncLog(active=True)
    with guards._counting_fences(log):
        torch.cuda.synchronize()
        torch.cuda.Event.synchronize(None)
        th = threading.Thread(target=torch.cuda.Stream.synchronize,
                              args=(None,))
        th.start()
        th.join()
    assert calls == ["sync", "event", "stream"]
    assert log.fences == ["torch.cuda.synchronize", "Event.synchronize",
                          "Stream.synchronize"]
    assert log.count == 3
    assert [getattr(o, a) for o, a, _ in guards._fence_sites()] == originals
    torch.cuda.synchronize()                 # no longer counted
    assert log.count == 3


def test_timing_on_the_cpu():
    x = torch.ones(64, 64)
    s = measure(lambda a: a @ a, x, iters=3)
    assert s > 0
    device_fence(x @ x)              # a CPU result: nothing to wait for


# -- on the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_telemetry_adds_no_sync_to_a_streamed_evaluation(tmp_path):
    """One streamed evaluation (spilled, prefetched, fenced once a chunk
    by design) counted by the sync guard, implicit calls and explicit
    fences: as many with a metrics or trace session as without one, and
    at least the evaluation's own fences."""
    dev = _card()
    cobj = _objective(tmp_path, dev)
    w = torch.zeros(D, device=dev)
    for _ in range(2):                    # builds, warms the staging ring
        cobj.value_and_gradient(w)
    torch.cuda.synchronize()
    counts, seen = {}, []
    for mode in ("off", "metrics", "trace", "off"):
        session = (telemetry.start(mode, telemetry_dir=str(tmp_path),
                                   device=dev)
                   if mode != "off" else None)
        try:
            with no_implicit_transfers("log", dev) as log:
                cobj.value_and_gradient(w)
            torch.cuda.synchronize()
        finally:
            if session is not None:
                session.close()
        assert log.active
        counts.setdefault(mode, []).append(log.count)
        seen += log.messages
    assert counts["metrics"] == counts["trace"] == counts["off"][:1], (
        counts, seen)
    assert counts["off"][0] == counts["off"][1], (counts, seen)
    assert counts["off"][0] >= N_CHUNKS - 1, (counts, seen)
    with no_implicit_transfers("log", dev) as log:      # the guard is live
        float(w.sum())
    assert log.count >= 1
    with pytest.raises(RuntimeError):
        with no_implicit_transfers("disallow", dev):
            float(w.sum())


@pytest.mark.cuda
def test_telemetry_leaves_a_card_fit_bitwise(tmp_path):
    """A short streamed fit on the card: bitwise the same coefficients
    with telemetry off, metrics and trace; the session's CUDA event
    pairs give a device time for the chunk program."""
    dev = _card()
    cfg = OptimizerConfig(max_iters=3, tolerance=1e-9)
    out = {}
    for mode in ("off", "metrics", "trace"):
        cobj = _objective(tmp_path, dev, name=f"spill_{mode}")
        session = (telemetry.start(mode, telemetry_dir=str(tmp_path / mode),
                                   device=dev)
                   if mode != "off" else None)
        try:
            with telemetry.span("fit", cat="phase"):
                res = streaming_lbfgs_solve(cobj.value_and_gradient,
                                            torch.zeros(D, device=dev), cfg,
                                            value_fn=cobj.value)
                torch.cuda.synchronize()
        finally:
            summary = None
            if session is not None:
                session._read_event_pairs()
                summary = session.summary()
                session.close()
        out[mode] = res.w.cpu()
        if summary is not None:
            h = summary["histograms"]["device.event_s.chunk_vg"]
            assert h["count"] > 0 and h["min"] > 0
            assert summary["device"]["memory"]["source"] == \
                "torch.cuda.memory_stats"
    assert torch.equal(out["metrics"], out["off"])
    assert torch.equal(out["trace"], out["off"])


@pytest.mark.cuda
def test_measure_times_between_cuda_events():
    dev = _card()
    x = torch.randn(1024, 1024, device=dev)
    s = measure(lambda a: a @ a, x, iters=5)
    assert 0 < s < 1.0
    device_fence(x)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_served_batch_syncs_equal_with_tracing(tmp_path, device):
    """One served batch of a small GAME model through
    ``ScoringEngine.score_batch`` with and without a batch trace
    (``chip_smoke.sync_split``): the same synchronizing calls (on the
    card; the guard is a no-op on the CPU), no kernel build, margins to
    the bit, and the four batch stages stamped."""
    import chip_smoke as cs

    if device == "cuda":
        _card()
    model, host = cs.make_model(seed=0, d=2000, n_entities=500)
    model_dir = str(tmp_path / "model")
    cs.save_game_model(model, cs.TaskType.LOGISTIC_REGRESSION, model_dir)
    rows = cs.make_rows(np.random.default_rng(2), host, cs.ROWS, d=2000)
    out = cs.sync_split(cs.serving_config(model_dir, str(tmp_path / "spill"),
                                          device), rows)
    assert out["on"] == out["off"] and out["on_again"] == out["off_again"]
    assert (out["on"] is None) == (device == "cpu")
    if device == "cuda":
        assert out["on"] >= 1                    # the copy back at least
    assert out["bitwise"] and out["builds"] == 0
    assert out["on_stages"] == ["assemble", "d2h", "dispatch",
                                "store_lookup"]
