"""A throwaway benchmark root at a size the CPU runs in seconds: its own
BENCHMARK.json, configuration, traffic mix and the harness's metric
readers, written under a temporary directory."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

CONFIG = {
    "k": 30, "precalc_k": 6, "variant": "plain-matrix", "engine": "turbo", "turbo_arity": 3,
    "genome": {"base_bases": 3000, "strains": 3, "strain_substitution_rate": 0.01,
               "add_reverse_complements": True},
}
MIX = {
    "batch_reads": 32, "pool_batches": 3, "read_length": [100, 100], "pad_quantum": 32,
    "source_share": 1.0, "reverse_strand_share": 0.5, "substitution_rate": 0.01,
}


def write_root(tmp: Path, config: dict | None = None, mix: dict | None = None,
               cell: str = "tiny-cfg.tiny-mix", extra_metrics: dict | None = None) -> Path:
    """A root whose BENCHMARK.json has one cell, ``cell`` (config.mix), of
    ``config`` and ``mix`` (the tiny ones by default), every metric of the
    real BENCHMARK.json, and the readers of portbench/metrics plus
    ``extra_metrics`` ({name: source of its reader})."""
    cfg_name, mix_name = cell.split(".", 1)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": cfg_name, "source": "test", "why": "test", "reduced": [],
                         "file": f"portbench/configs/{cfg_name}.json"}]
    bench["workloads"] = [{"name": cell, "config": cfg_name, "traffic": mix_name, "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "portbench" / "configs").mkdir(parents=True)
    (tmp / "portbench" / "traffic").mkdir()
    shutil.copytree(BENCH / "metrics", tmp / "portbench" / "metrics")
    for name, source in (extra_metrics or {}).items():
        (tmp / "portbench" / "metrics" / f"{name}.py").write_text(source)
        bench["per_layer"].append({"name": name, "unit": "x", "better": "higher",
                                   "source": "program_counter", "layer": "test",
                                   "moves": "answers_per_s"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "portbench" / "configs" / f"{cfg_name}.json").write_text(
        json.dumps(copy.deepcopy(config or CONFIG)))
    (tmp / "portbench" / "traffic" / f"{mix_name}.json").write_text(
        json.dumps(copy.deepcopy(mix or MIX)))
    return tmp
