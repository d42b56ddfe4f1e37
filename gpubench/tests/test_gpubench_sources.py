"""The harness's reach beyond the plain-ELL fixed effect: byte counts on
any resident batch, a GAME fit through the estimator's coordinate
descent, the port's own spans and counters read in the traced window's
session span (and nowhere else), profiler ranges kept out of the
trace's busy time and idle gaps, and kernel launch counts kept whole by
the instruments."""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from gpubench import bounds, manifest, port, run
from gpubench.metrics import _roofline
from gpubench.tests.helpers import faulty_port, tiny
from gpubench.trace import summarize
from gpubench.traffic.generate import bernoulli, dot, power_law_rows

SEED = 2 ** 31 + 23          # a seed past 32 signed bits

SOLVER = {"memory": 10, "ls_shrink": 0.5, "ls_c1": 0.0001,
          "ls_max_steps": 30, "curvature_eps": 1e-10}


def game_config(rows: int, features: int, nnz: int, entities: int,
                sweeps: int, fe_iters: int, re_iters: int) -> dict:
    """A GAME configuration held in the test: a fixed effect over sparse
    rows, a per-user random effect ([1, x] a row) and a per-item one (an
    intercept), logistic, L2 1.0, L-BFGS on every coordinate."""
    def coord(name, kind, shard, iters, key=None):
        c = {"name": name, "kind": kind, "shard": shard,
             "max_iters": iters, "tolerance": 1e-6, "l2": 1.0}
        return {**c, "entity_key": key} if key else c

    return {
        "name": "test-game", "task": "logistic_regression",
        "precision": "float32", "data": "test_game", "rows": rows,
        "features": features, "nnz_per_row": nnz, "entities": entities,
        "intercept": True, "n_iterations": sweeps,
        "update_sequence": ["global", "per_user", "per_item"],
        "coordinates": [
            coord("global", "fixed", "global", fe_iters),
            coord("per_user", "random", "user_re", re_iters, "userId"),
            coord("per_item", "random", "item_re", re_iters, "itemId")],
        "solver": dict(SOLVER)}


def draw(config: dict, rng) -> dict:
    """Rows of planted global, per-user and per-item effects, power-law
    user and item ids; the same sizes for every seed."""
    n, d, k = (int(config["rows"]), int(config["features"]),
               int(config["nnz_per_row"]))
    e = int(config["entities"])
    indptr, cols, vals, w_true = power_law_rows(rng, n, d, k)
    user = (e * rng.random(n) ** 1.8).astype(np.int64)
    item = (e * rng.random(n) ** 1.8).astype(np.int64)
    x_user = np.stack([np.ones(n), rng.normal(size=n)], 1).astype(np.float32)
    u_eff = rng.normal(0, 1.0, (e, 2)) * [1.2, 0.5]
    i_eff = rng.normal(0, 0.8, e)
    margins = (dot(indptr, cols, vals, w_true).astype(np.float64)
               + (u_eff[user] * x_user).sum(1) + i_eff[item] - 1.0)
    return {"dim": d, "indptr": indptr, "cols": cols, "vals": vals,
            "labels": bernoulli(rng, margins),
            "entity_ids": {"userId": user, "itemId": item},
            "shards": {"user_re": x_user,
                       "item_re": np.ones((n, 1), np.float32)}}


class GameEntry:
    """A GAME fit at the traffic's λ on every coordinate, from zero, the
    coordinates built once in set-up."""

    def __init__(self, port, data, config, traffic, device):
        self.port = port
        t = time.perf_counter()
        self.train = port.game_dataset(data)
        self.est = port.estimator(config, traffic, device)
        self.prep = port.prepare(self.est, self.train)
        self.lams = {c["name"]: float(traffic["lambda"])
                     for c in config["coordinates"]}
        self.coords = port.build_coordinates(self.est, self.train,
                                             self.prep, self.lams)
        self.prepare_s = time.perf_counter() - t

    def fit(self, record=False) -> dict:
        got = self.port.game_fit(self.est, self.coords)
        return {k: v if isinstance(v, list) else [v] for k, v in got.items()}

    def keep(self, leaves):
        return {k: [b.detach().clone() for b in v] for k, v in leaves.items()}

    def host(self, kept):
        return {k: [b.cpu().double().numpy() for b in v]
                for k, v in kept.items()}

    def release(self):
        self.train = self.est = self.prep = self.coords = None


def judge(kept, data, config, traffic, device):
    """Whether a kept fit left every coordinate at zero (1) or not (0)."""
    return {i: {"unmoved": float(all(not b.any() for v in a.values()
                                     for b in v))}
            for i, a in kept.items()}


class Watched:
    """Where a test watches the port through the harness: the
    instruments a run makes, the session summaries it takes, and whether
    the harness holds a session open."""

    def __init__(self, monkeypatch):
        self.instruments, self.summaries, self.open = [], [], False
        open_session, close_session = port.open_session, port.close_session
        watch = self

        class Recorded(port.Instruments):
            def __init__(self):
                super().__init__()
                watch.instruments.append(self)

        def opened(device):
            watch.open = True
            return open_session(device)

        def closed(session):
            watch.open = False
            watch.summaries.append(close_session(session))
            return watch.summaries[-1]

        monkeypatch.setattr(port, "Instruments", Recorded)
        monkeypatch.setattr(port, "open_session", opened)
        monkeypatch.setattr(port, "close_session", closed)


@pytest.fixture
def game_cell(monkeypatch):
    """A cell held in the test: its data model, entry and one metric
    reader that keeps the run's sources, put where the harness finds
    them by name."""
    seen: list = []
    modules = {
        "gpubench.traffic.test_game": {"draw": draw},
        "gpubench.entries.test_game": {"Entry": GameEntry, "judge": judge},
        "gpubench.metrics.test_game_sources": {
            "read": lambda sources: seen.append(sources)},
    }
    for name, attrs in modules.items():
        monkeypatch.setitem(sys.modules, name,
                            types.SimpleNamespace(__name__=name, **attrs))
    monkeypatch.setitem(bounds.CARD_PEAK_BYTES_PER_S, "cpu", 3.35e12)

    def cell(config):
        metrics = [{"name": n, "unit": "count"} for n in
                   ("test_game_sources", "evals_per_fit", "fit_mfu")]
        return {"workload": {"name": "test-game", "chips": 1},
                "config": config,
                "traffic": {"entry": "test_game", "layout": "AUTO",
                            "lambda": 1.0},
                "limits": {"unmoved": 0.5},
                "end_to_end": [{"name": "fit_s", "unit": "s"}],
                "per_layer": metrics}
    return cell, seen


TINY_GAME = dict(rows=3000, features=300, nnz=8, entities=40, sweeps=2,
                 fe_iters=5, re_iters=5)


def test_a_traced_game_run_counts_dense_evaluations_and_reads_the_spans(
        game_cell, monkeypatch):
    monkeypatch.setattr(run, "PROFILE_S", 0.05)
    watched = Watched(monkeypatch)
    cell, seen = game_cell
    result, lines = run.run_cell(cell(game_config(**TINY_GAME)), SEED, 0.2,
                                 True, "cpu", time.time())
    assert result["correct"], lines
    (sources,) = seen
    fits = sources["fits"]
    (inst,) = watched.instruments
    assert inst.batches["DenseBatch"] > 0 and inst.batches["SparseBatch"] > 0
    assert inst.uncounted == 0 and all(f["eval_bytes"] for f in fits)
    assert sum(f["evaluations"] for f in fits) == sum(inst.batches.values())
    (summary,) = watched.summaries
    assert {"re.bucket_solve", "cd_coordinate", "lbfgs.solve",
            "xtr"} <= set(summary["spans"])
    assert summary["spans"]["cd_coordinate"]["count"] == 6 * sum(
        f["span"] == "session" for f in fits)
    assert sources["counters"]["solver.resident.iterations"] > 0
    assert {"evals_per_fit", "fit_mfu"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_planted_fault_changes_the_game_answer(fault):
    config = game_config(**TINY_GAME)
    traffic = {"entry": "test_game", "layout": "AUTO", "lambda": 1.0}
    entry = GameEntry(port, draw(config, np.random.default_rng(SEED)),
                      config, traffic, "cpu")
    sound = entry.fit()
    entry.port = faulty_port(fault)
    bad = entry.fit()
    assert set(bad) == set(sound) == {"global", "per_user", "per_item"}
    for name, blocks in sound.items():
        assert any(b.any() for b in blocks), name
        assert [b.shape for b in bad[name]] == [b.shape for b in blocks]
        if fault == "unchanged":
            assert not any(b.any() for b in bad[name]), name
        else:
            assert sum((x != y).sum().item()
                       for x, y in zip(bad[name], blocks)) == 1, name


def test_tiny_applies_the_configurations_own_overrides(monkeypatch):
    plain = tiny("glm-fit")["config"]
    assert "tiny" not in plain and "entities" not in plain
    assert plain["rows"] == 6000
    cell = manifest.cell("glm-fit")
    cell["config"]["tiny"] = {"entities": 40, "rows": 2000}
    monkeypatch.setattr(manifest, "cell", lambda name: cell)
    got = tiny("glm-fit")["config"]
    assert (got["rows"], got["features"], got["nnz_per_row"],
            got["entities"]) == (2000, 500, 10, 40)


def _tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_evaluation_bytes_of_a_dense_batch_by_hand():
    """Random-effect lanes: E entities of c rows and p features."""
    e, c, p = 7, 5, 3
    batch = port.DenseBatch(x=torch.zeros(e, c, p), labels=torch.zeros(e, c),
                            weights=torch.ones(e, c),
                            offsets=torch.zeros(e, c), mask=torch.ones(e, c))
    w = torch.zeros(e, p)
    read = 4 * (e * c * p + 4 * e * c + e * p)
    assert port.evaluation_bytes(w, batch, False) == read + 4 * e
    assert port.evaluation_bytes(w, batch, True) == read + 4 * e + 4 * e * p


def _prepared_batch(layout: str):
    """The tiny glm-fit cell's batch prepared by the estimator in
    ``layout``."""
    from gpubench.traffic.generate import generate

    c = tiny("glm-fit")
    traffic = {**c["traffic"], "layout": layout}
    train = port.game_dataset(generate(c["config"], SEED))
    est = port.estimator(c["config"], traffic, "cpu")
    prep = port.prepare(est, train)
    coords = port.build_coordinates(est, train, prep, {"global": 1.0})
    return port.fixed_batch(coords["global"])


def test_evaluation_bytes_of_the_plain_ell_batch_is_unchanged():
    b = _prepared_batch("ELL")
    w = torch.zeros(b.dim)
    read = _tensor_bytes(b.values, b.col_ids, b.labels, b.weights, b.offsets,
                         b.mask, w)
    assert port.evaluation_bytes(w, b, False) == read + 4
    assert port.evaluation_bytes(w, b, True) == read + 4 + 4 * b.dim


@pytest.mark.parametrize("layout", ["GRR", "COLMAJOR"])
def test_evaluation_bytes_is_none_for_a_layout_it_cannot_count(layout):
    b = _prepared_batch(layout)
    assert port.evaluation_bytes(torch.zeros(b.dim), b, True) is None


def test_an_uncounted_evaluation_leaves_its_fit_without_bytes(monkeypatch):
    monkeypatch.setattr(run, "PROFILE_S", 0.05)
    monkeypatch.setitem(bounds.CARD_PEAK_BYTES_PER_S, "cpu", 3.35e12)
    monkeypatch.setattr(port, "evaluation_bytes", lambda w, b, g: None)
    c = tiny("glm-fit")
    result, _ = run.run_cell(c, SEED, 0.2, True, "cpu", time.time())
    assert result["correct"] and "fit_mfu" not in result["metrics"]
    assert "evals_per_fit" in result["metrics"]


def test_a_traced_run_opens_the_session_in_its_span_alone(monkeypatch):
    """A traced tiny glm-fit run: a session is open in every fit of the
    session span and in no other fit (set-up's warm fit, the device-only
    and host-and-device spans, the unprofiled fits); the port's
    evaluation count equals the instruments' count over the same
    fits."""
    monkeypatch.setattr(run, "PROFILE_S", 0.05)
    monkeypatch.setitem(bounds.CARD_PEAK_BYTES_PER_S, "cpu", 3.35e12)
    seen, counted = [], []
    watch = Watched(monkeypatch)
    solve = port.fixed_effect_solve

    def watched(coord, w0):
        seen.append(watch.open)
        return solve(coord, w0)

    monkeypatch.setattr(port, "fixed_effect_solve", watched)
    real = run.read_metrics

    def keep(names, sources):
        counted.append(sources)
        return real(names, sources)

    monkeypatch.setattr(run, "read_metrics", keep)
    c = tiny("glm-fit")
    result, _ = run.run_cell(c, SEED, 0.8, True, "cpu", time.time(),
                             port=port)
    (sources,) = counted
    fits = sources["fits"]
    spans = [f["span"] for f in fits]
    assert spans[0] is None and {"device", "host", "session"} <= set(spans)
    assert not watch.open and len(watch.summaries) == 1
    # The warm fit in set-up, then the window's fits.
    assert seen == [False] + [s == "session" for s in spans]
    traced = [f for f in fits if f["span"] == "session"]
    per_fit = sum(f["evaluations"] for f in traced) / len(traced)
    assert sources["counters"]["solver.resident.evaluations"] == per_fit
    assert result["metrics"]["evals_per_fit"]["value"] == per_fit


def test_an_untraced_run_reads_no_session(monkeypatch):
    watch = Watched(monkeypatch)
    result, _ = run.run_cell(tiny("glm-fit"), SEED, 0.2, False, "cpu",
                             time.time())
    assert result["correct"] and not watch.summaries
    assert result["metrics"].keys() == {"fit_s", "setup_s"}


def _event(name, start, end, device=True, thread=0, annotation=False):
    return types.SimpleNamespace(
        name=name, thread=thread, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_summarize_leaves_the_ranges_out():
    """Device rows that copy a range cover the gaps between kernels;
    host ranges enclose the operations.  Left out, busy time, the
    operations and the idle gaps read as with no ranges at all."""
    work = [_event("kernel_a", 0, 10), _event("kernel_b", 30, 40),
            _event("aten::item", 12, 28, device=False),
            _event("aten::mul", 0, 10, device=False)]
    ranges = [_event("photon::lbfgs.solve", 0, 40, annotation=True),
              _event("gpu_user_annotation", 0, 40, annotation=True),
              _event("photon::lbfgs.direction", 10, 30, annotation=True),
              _event("photon::lbfgs.solve", -1, 41, device=False,
                     annotation=True),
              _event("photon::lbfgs.update", 11, 29, device=False,
                     annotation=True)]
    plain = summarize(work)
    got = summarize(work + ranges)
    assert got == plain
    assert got["busy_s"] == pytest.approx(20e-6)
    assert got["idle_gaps"] == [["aten::item", pytest.approx(20e-6)]]
    counted = [types.SimpleNamespace(**{**vars(e), "is_user_annotation":
                                        False}) for e in ranges]
    assert summarize(work + counted)["busy_s"] == pytest.approx(40e-6)


def test_a_roofline_counts_the_kernels_a_launch_makes():
    """sorted_colsum's launch is its kernel and a fix-up: both times are
    the launch's, scaled by launches over the main kernel's events."""
    kernels = port.kernel_specs()
    launch = {"shapes": {"rows": (1000,), "col_ptr": (101,)},
              "distinct": {"rows": 50}}
    trace = {"by_name": {"void sorted_colsum_kernel<...>": 3e-3,
                         "void sorted_colsum_fixup_kernel<...>": 1e-3,
                         "gather_rowsum_kernel": 5e-3},
             "count": {"void sorted_colsum_kernel<...>": 3,
                       "void sorted_colsum_fixup_kernel<...>": 3,
                       "gather_rowsum_kernel": 1}}
    sources = {"trace": trace, "launches": {"sorted_colsum": [launch] * 6},
               "kernels": kernels, "bytes_per_s": 3.35e12}
    bound = bounds.sorted_colsum_bound_s(1000, 100, 50, 3.35e12)
    got = _roofline.share(sources, "sorted_colsum",
                          lambda x, peak: bound)
    assert got == pytest.approx(100.0 * 6 * bound / (4e-3 * 6 / 3))


def test_instruments_keep_a_launchers_own_count(monkeypatch):
    """A launcher patched where its callers look it up (and not in its
    own module) keeps counting itself; one patched in its own module is
    counted through the wrapper.  Both counts survive the instruments."""
    own = types.ModuleType("gpubench_test_launchers")

    def kernel(x):
        own.kernel.launches += 1
        return x

    kernel.launches = 0
    own.kernel = kernel
    caller = types.ModuleType("gpubench_test_caller")
    caller.kernel = kernel
    for m in (own, caller):
        monkeypatch.setitem(sys.modules, m.__name__, m)
    specs = {"at_caller": {"launcher": "gpubench_test_caller:kernel",
                           "args": ["x"], "distinct": [],
                           "device_name": "k"}}
    monkeypatch.setattr(port, "kernel_specs", lambda: specs)
    inst = port.Instruments()
    with inst:
        inst.recording = True
        caller.kernel(1)
        caller.kernel(2)
    assert kernel.launches == 2 and caller.kernel is kernel
    assert len(inst.launches["at_caller"]) == 2
    specs = {"at_home": {"launcher": "gpubench_test_launchers:kernel",
                         "args": ["x"], "distinct": [], "device_name": "k"}}
    with port.Instruments():
        own.kernel(3)
    assert own.kernel is kernel and kernel.launches == 3


@pytest.mark.cuda
def test_game_seam_on_the_card(game_cell, monkeypatch):
    """The traced GAME seam at config 5's sizes (10^6 rows over 100,000
    features, 30 a row; 100,000 users and items; two sweeps, 20 and 30
    L-BFGS iterations) on the card: the random effects' bucket solves
    hold device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "mode at these sizes)")
    import json

    monkeypatch.setattr(run, "PROFILE_S", 0.05)
    port.use_build_dir(manifest.ROOT)
    cell, seen = game_cell
    config = game_config(rows=1_000_000, features=100_000, nnz=30,
                         entities=100_000, sweeps=2, fe_iters=20,
                         re_iters=30)
    result, lines = run.run_cell(cell(config), SEED, 1.0, True, "cuda",
                                 time.time())
    (sources,) = seen
    by_span = sources["span_device_s"]
    print("game seam: " + json.dumps({
        "card": torch.cuda.get_device_name(0),
        "fits_s": [f["end"] - f["start"] for f in sources["fits"]],
        "span_busy_s": sources["span_busy_s"], "spans_s": by_span,
        "counters": sources["counters"], "metrics": result["metrics"],
        "busy_s": result["device"].get("busy_s"),
        "window_s": result["device"].get("window_s"),
        "breakdown": result.get("breakdown"), "lines": lines}))
    assert result["correct"], lines
    assert by_span["re.bucket_solve"] > 0
    assert by_span["cd_coordinate"] > 0
