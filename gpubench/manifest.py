"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (its ``file``), a
traffic (``gpubench/traffic/<traffic>.json``, the job and the entry that
runs it) and has a file of its own (``gpubench/workloads/<cell>.json``:
the limits that decide ``correct``, and the readings they were set
from).  A metric is read by ``gpubench/metrics/<name>.py`` (dots in a
name become underscores).
"""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")


def _load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """Everything one cell runs from: its manifest entry, configuration,
    traffic, limits, and the metrics it reports."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reports(m: dict) -> bool:
        return name in m.get("workloads", [name])

    return {
        "workload": w,
        "config": _load(os.path.join(root, config["file"])),
        "traffic": _load(os.path.join(HERE, "traffic",
                                      w["traffic"] + ".json")),
        "limits": _load(os.path.join(HERE, "workloads",
                                     name + ".json"))["limits"],
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
        "run_seconds": int(bench["run_seconds"]),
    }


def metric_module(name: str) -> str:
    return "gpubench.metrics." + name.replace(".", "_").replace("-", "_")
