"""What a run measures, found by name: the cell in BENCHMARK.json, its
configuration's file, its traffic mix's file and the readers of its metrics.

Everything that belongs to one configuration, one mix or one metric sits in
a file of its own, so a cell, a mix or a metric is added by adding files and
entries, never by editing one:

    <root>/BENCHMARK.json                 the cells and the metrics
    <file of the configuration>           sizes, engine, variant (configs/)
    <root>/portbench/traffic/<mix>.json   one mix's parameters
    <root>/portbench/metrics/<name>.py    one metric's reader: read(run)
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = "portbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list
    root: Path

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` of ``root``/BENCHMARK.json with its
    configuration, its mix and the metrics it reports."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, workload)]
    layer = [m for m in bench["per_layer"] if _reported_in(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer, root)


def reader(root: Path, metric: str):
    """The ``read(run)`` function of ``root``/portbench/metrics/<metric>.py."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
