"""Each cell's set-up, window and check on the CPU at a tiny size: the
port agrees with the reference, both result lines have their keys, and
the control and every planted fault come out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import bounds, calibrate, entries, port, run
from gpubench.tests.helpers import (
    CELLS, faulty_port, half_rows_objective, tiny)

SEED = 2 ** 31 + 11          # a seed past 32 signed bits


@pytest.fixture(autouse=True)
def _short_traces(monkeypatch):
    monkeypatch.setattr(run, "PROFILE_S", 0.05)
    # The CPU has no listed peak; the card's stands in for the readers.
    monkeypatch.setitem(bounds.CARD_PEAK_BYTES_PER_S, "cpu", 3.35e12)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_is_correct_with_its_metrics(cell):
    c = tiny(cell)
    result, lines = run.run_cell(c, SEED, 0.3, False, "cpu", time.time())
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in c["end_to_end"]}
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(c["limits"])
    assert lines[-1].split()[0] in c["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_host_side_metrics(cell):
    c = tiny(cell)
    result, _ = run.run_cell(c, SEED, 0.2, True, "cpu", time.time())
    assert result["correct"]
    got = set(result["metrics"])
    # Device readings need the card; the host-side ones read here.
    assert {"prepare_s", "fit_mfu"} <= got
    assert got <= {m["name"] for m in c["per_layer"]}
    assert "busy_s" in result["device"] and "breakdown" in result


def test_same_seed_same_inputs_and_every_seed_the_same_sizes():
    from gpubench.traffic.generate import generate

    cfg = tiny("glm-fit")["config"]
    a, b, other = generate(cfg, SEED), generate(cfg, SEED), generate(cfg, 6)
    for key in ("indptr", "cols", "vals", "labels"):
        assert (a[key] == b[key]).all()
        assert a[key].shape == other[key].shape
    assert not (a["cols"] == other["cols"]).all()
    assert not (a["labels"] == other["labels"]).all()
    assert (a["indptr"] == other["indptr"]).all() and a["dim"] == other["dim"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell):
    c = tiny(cell)
    got = calibrate.readings(c, SEED, True, "cpu")
    limits = c["limits"]
    for number, limit in limits.items():
        if number in got["program"]:
            assert got["program"][number] <= limit, number
    for kind in ("control", "unchanged", "half_rows", "altered"):
        assert any(got[kind][k] > limit for k, limit in limits.items()
                   if k in got[kind]), kind


def test_coef_max_gap_reads_one_altered_coefficient_as_two():
    """However many coefficients a leaf has, one of them negated reads 2
    by ``coef_max_gap`` where the Euclidean ``coef_gap`` shrinks; a zero
    leaf is scaled by the median leaf."""
    import numpy as np

    from gpubench import compare

    rng = np.random.default_rng(SEED)
    ref = {"a": rng.normal(size=100_000), "b": rng.normal(size=50),
           "c": np.zeros(10)}
    bad = compare.altered({"a": ref["a"]})
    got = {**ref, **bad}
    assert compare.coef_max_gap(got, ref) == pytest.approx(2.0)
    assert compare.coef_gap(got, ref) < 0.05
    assert compare.coef_max_gap(ref, ref) == 0.0
    off = {**ref, "c": np.full(10, 0.1)}
    median = np.median([np.abs(v).max() for v in ref.values()])
    assert compare.coef_max_gap(off, ref) == pytest.approx(0.1 / median)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_rows"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    c = tiny(cell)
    fake = port
    if fault == "half_rows":
        half_rows_objective(monkeypatch)
    else:
        fake = faulty_port(fault)
    result, lines = run.run_cell(c, SEED, 0.2, False, "cpu", time.time(),
                                 port=fake)
    assert not result["correct"] and result["failed"] >= 1, lines


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in bfloat16, put in the program's place, judged as
    the program is judged."""
    from gpubench.traffic.generate import generate

    c = tiny(cell)
    module = entries.load(c["traffic"]["entry"])
    data = generate(c["config"], SEED)
    control = module.reference_answer(data, c["config"], c["traffic"],
                                      torch.bfloat16, "cpu")
    got, _ = module.numbers([control], data, c["config"], c["traffic"],
                            "cpu")
    assert any(got[0][k] > limit for k, limit in c["limits"].items()
               if k in got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """A short run of each cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "mode at these sizes)")
    from gpubench import manifest

    result, lines = run.run_cell(manifest.cell(cell), SEED, 2.0, False,
                                 "cuda", time.time())
    assert result["correct"], lines
