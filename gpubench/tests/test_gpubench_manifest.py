"""BENCHMARK.json against the contract's form, and every file it names
found by name."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from gpubench import entries, manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# Keys that would name a width (the contract forbids cutting them).
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|features|nnz_per_row)")


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "gpubench"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(manifest.ROOT, p))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_time_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


def test_metric_entries():
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_and_a_layer():
    for w in BENCH["workloads"]:
        cell = manifest.cell(w["name"])
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]


def test_workloads():
    pairs = set()
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _one_line(c["source"])
        assert _one_line(c["why"]) and c["file"] not in files
        files.add(c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data and not WIDTH.search(key)
            assert key in data["source_scale"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = manifest.cell(cell)
    module = entries.load(c["traffic"]["entry"])
    assert c["limits"]
    for name in ("Entry", "reference_answer", "leaf_lambdas", "numbers",
                 "judge"):
        assert hasattr(module, name), name
    for m in c["end_to_end"] + c["per_layer"]:
        reader = importlib.import_module(manifest.metric_module(m["name"]))
        assert callable(reader.read)


def test_every_metric_reader_is_named_in_the_manifest():
    here = os.path.join(manifest.HERE, "metrics")
    readers = {f[:-3] for f in os.listdir(here)
               if f.endswith(".py") and not f.startswith("_")}
    named = {manifest.metric_module(m["name"]).rsplit(".", 1)[1]
             for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert readers == named


def test_every_kernel_file_names_a_launcher_and_its_arguments():
    from gpubench import port

    for name, spec in port.kernel_specs().items():
        assert NAME.match(name)
        module, attr = spec["launcher"].split(":")
        owner = importlib.import_module(module)
        assert callable(getattr(owner, attr))
        assert set(spec["distinct"]) <= set(spec["args"])
        assert spec["device_name"]
