"""The benchmark harness on the CPU at a tiny size, through the program's
plain versions: a whole run, the reference against the port, the
generators, cells found by name, the control and the faults that the check
has to refuse, and the modules a run may not load.

    python -m pytest portbench/tests -q

The tests marked ``cuda`` run a cell on the card, and skip without one.
"""
from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import control, deploy, gen, harness, spec
from portbench.reference import buckets
from portbench.reference.sbwt_ref import ReferenceIndex
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 977
CELLS = {
    "turbo": {},
    "lf": {"variant": "rrr-split", "engine": "lf"},
}


def run_tiny(tmp_path, config_over=None, mix_over=None, seed=SEED, trace=False, setup=None,
             seconds=0.2):
    root = tiny.write_root(tmp_path, dict(tiny.CONFIG, **(config_over or {})),
                           dict(tiny.MIX, **(mix_over or {})))
    cell = spec.load_cell(root, "tiny-cfg.tiny-mix")
    kw = {} if setup is None else {"setup": setup}
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                            log=lambda line: None, **kw)


@pytest.fixture(autouse=True)
def _few_samples(monkeypatch):
    monkeypatch.setattr(harness, "SAMPLED_CALLS", 1)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("engine", sorted(CELLS))
def test_tiny_cell_end_to_end(tmp_path, engine, trace):
    line = run_tiny(tmp_path, CELLS[engine], trace=trace)
    buf = io.StringIO()
    with redirect_stdout(buf):
        print(json.dumps(line))
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert last["checks"]["mismatched_answers"] == {"value": 0, "limit": 0}
    names = set(last["metrics"])
    if trace:
        assert {"build_s", "dispatch_ms", "launches_per_batch"} <= names
        assert ("table_s" in names) == (engine == "turbo")
        assert ("variant_s" in names) == (engine == "lf")
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in last["device"]
    else:
        assert names == {"answers_per_s", "batch_ms_p95", "setup_s"}
        assert all(m["value"] > 0 for m in last["metrics"].values())


def edge_reads(strains, k, g):
    """Reads of the tiny mix with short, empty and over-long lengths and
    codes other than ACGT inside a read."""
    b = gen.read_batch(dict(tiny.MIX, batch_reads=24, read_length=[20, 100]), strains, k, g)
    codes, lengths = b.codes.clone(), b.lengths.clone()
    lengths[:4] = torch.tensor([k, k - 1, 0, 100], dtype=torch.int32)
    codes[4, 40] = -1
    codes[5, 10] = 5
    return codes, lengths


@pytest.mark.parametrize("variant", ["plain-matrix", "rrr-split", "mef-concat"])
def test_reference_equals_port(variant):
    from sbwt_tpu_torch import SBWT
    from sbwt_tpu_torch.ops.search import streaming_search
    from sbwt_tpu_torch.ops.turbo import build_turbo, turbo_streaming_search

    strains, seqs = gen.genome(tiny.CONFIG["genome"], SEED, "cpu")
    k = tiny.CONFIG["k"]
    codes, lengths = edge_reads(strains, k, gen.generator(SEED, 9, "cpu"))
    ref = buckets.streaming_answers(seqs, k, [(codes, lengths)], max_keys=2000)
    assert len(ref.buckets) > 1
    sb = SBWT.build_on_device([s.numpy() for s in seqs], k, "cpu", precalc_k=5)
    assert ref.n_nodes == sb.number_of_subsets()
    if variant != "plain-matrix":
        sb = sb.to_variant(variant)
    want = ref.answers[0]
    assert (want >= 0).any() and (want < 0).any()
    got_lf = streaming_search(sb.device_index, codes, lengths)
    got_turbo = turbo_streaming_search(build_turbo(sb.device_index, 2), sb.device_index, codes,
                                       lengths)
    assert torch.equal(got_lf.long(), want)
    assert torch.equal(got_turbo.long(), want)


def test_generators_deterministic():
    k = 30
    mix = dict(tiny.MIX, source_share=0.25)
    s1, q1 = gen.genome(tiny.CONFIG["genome"], SEED, "cpu")
    s2, q2 = gen.genome(tiny.CONFIG["genome"], SEED, "cpu")
    s3, _ = gen.genome(tiny.CONFIG["genome"], SEED + 1, "cpu")
    assert torch.equal(s1, s2) and all(torch.equal(a, b) for a, b in zip(q1, q2))
    assert not torch.equal(s1, s3)
    assert len(q1) == 6 and torch.equal(q1[3], (3 - s1[0].flip(0)).to(torch.int8))
    p1, p2 = gen.read_pool(mix, s1, k, SEED), gen.read_pool(mix, s1, k, SEED)
    p3 = gen.read_pool(mix, s1, k, SEED + 1)
    for a, b, c in zip(p1, p2, p3):
        assert torch.equal(a.codes, b.codes) and torch.equal(a.lengths, b.lengths)
        assert not torch.equal(a.codes, c.codes)
        assert (a.bases, a.answers) == (b.bases, b.answers) == (c.bases, c.answers)
    # the same counts from every seed: 8 of 32 reads from the strains
    ref = ReferenceIndex(q1, k)
    for seed in (SEED, 5, 2**40):
        for b in gen.read_pool(dict(mix, substitution_rate=0.0), s1, k, seed):
            hits = ref.streaming_answers(b.codes, b.lengths)[:, : 100 - k + 1]
            assert int((hits >= 0).all(dim=1).sum()) == 8


def test_throwaway_cell_and_metric_found_by_name(tmp_path):
    reader = "def read(run):\n    return run['batches'] * 2.0\n"
    root = tiny.write_root(tmp_path, dict(tiny.CONFIG, precalc_k=4),
                           dict(tiny.MIX, batch_reads=8), cell="throwaway-cfg.throwaway-mix",
                           extra_metrics={"twice_batches": reader})
    cell = spec.load_cell(root, "throwaway-cfg.throwaway-mix")
    assert cell.config["precalc_k"] == 4 and cell.traffic["batch_reads"] == 8
    line = harness.run_cell(cell, SEED, 0.1, True, "cpu", time.perf_counter(),
                            log=lambda s: None)
    assert line["correct"] is True
    assert line["metrics"]["twice_batches"]["value"] == 2.0 * line["attempted"]
    with pytest.raises(KeyError):
        spec.load_cell(root, "coli3-turbo3.isolate")


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sbwt_tpu_torchlike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sbwt_tpu.utils", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["sbwt_tpu"]


def test_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter loads neither JAX nor the
    JAX package."""
    root = tiny.write_root(tmp_path)
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import harness, spec\n"
        "harness.SAMPLED_CALLS = 1\n"
        "cell = spec.load_cell(sys.argv[2], 'tiny-cfg.tiny-mix')\n"
        "line = harness.run_cell(cell, 7, 0.1, True, 'cpu', time.perf_counter(),"
        " log=lambda s: None)\n"
        "print(line['correct'], ','.join(harness.forbidden_modules()) or 'none')\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(REPO), str(root)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True", "none"]


def test_run_py_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "coli3-turbo3.isolate",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("engine", sorted(CELLS))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_refused(tmp_path, engine, seed):
    line = run_tiny(tmp_path, CELLS[engine], seed=seed, setup=control.setup)
    assert line["correct"] is False
    assert line["checks"]["mismatched_answers"]["value"] > 0


def faulty(fault):
    """A setup that runs the program with ``fault`` planted in its answers."""
    def setup(config, seqs, device):
        dep = deploy.program(config, seqs, device)
        engine, state = dep.engine, {}

        def run(codes, lengths):
            out = engine(codes, lengths)
            if fault == "unchanged":  # a call returns the answers of the call before it
                before, state["last"] = state.get("last", out), out
                return before
            out = out.clone()
            if fault == "half":  # the second half of the batch left out
                out[out.shape[0] // 2 :] = -1
            elif fault == "altered":  # one answer altered where it is produced
                out[0, 0] += 1
            return out

        dep.engine = run
        return dep
    return setup


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("engine", sorted(CELLS))
def test_faults_are_refused(tmp_path, engine, fault):
    line = run_tiny(tmp_path, CELLS[engine], setup=faulty(fault))
    assert line["correct"] is False
    assert line["checks"]["mismatched_answers"]["value"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cell_on_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "coli3-turbo3.isolate", "--seed", "5", "--seconds", "2",
                          "--trace", "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_run_py_refuses_without_program(card, tmp_path):
    """In a directory that holds only BENCHMARK.json and the harness, a run
    fails and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "coli3-turbo3.isolate", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
