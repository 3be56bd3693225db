"""One run of one cell: set-up, the window, the reading of the metrics and
the check, as the result's last line.

``run_cell`` takes the device as an argument, so the tests drive the whole
run on the CPU through the program's plain versions; ``run.py`` gives it
the card and refuses to run without one.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from portbench import check, deploy, gen, spec, window, yardstick

# calls whose answers are kept and judged besides each pool batch's last,
# drawn from the seed among the first SAMPLE_CAP_PER_S x seconds calls
SAMPLED_CALLS = 4
SAMPLE_CAP_PER_S = 50
# top-level module names that may not be loaded in a run: JAX, and the JAX
# package that the program under test was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "sbwt_tpu")
# a device op's name in the breakdown is cut to this many characters
NAME_CHARS = 160


def forbidden_modules() -> list:
    """The forbidden top-level names in sys.modules, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def sample_calls(seed: int, seconds: float) -> set:
    cap = max(1, int(seconds * SAMPLE_CAP_PER_S))
    g = gen.generator(seed, 3, "cpu")
    return set(torch.randperm(cap, generator=g)[:SAMPLED_CALLS].tolist())


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             setup=deploy.program, log=None) -> dict:
    """Run ``cell`` once and return its result line as a dict. ``t0`` is the
    host clock at the run's start; ``setup(config, seqs, device)``
    gives the system under test (the program unless a test or the control
    puts something in its place); ``log`` takes lines for standard error."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    cuda = torch.device(device).type == "cuda"
    config, mix = cell.config, cell.traffic
    k = int(config["k"])
    stages = {"start": time.perf_counter() - t0}
    strains, seqs = deploy.timed(stages, "genome", device, gen.genome, config["genome"], seed,
                                 device)
    pool = deploy.timed(stages, "pool", device, gen.read_pool, mix, strains, k, seed)
    del strains
    dep = setup(config, seqs, device)
    pool_args = [dep.prepare(b) for b in pool]
    calls = sample_calls(seed, seconds)
    deploy.timed(stages, "warm_up", device, window.warm_up, dep.engine, pool_args, len(calls),
                 device)
    before = dep.launches() if dep.launches else None
    setup_s = time.perf_counter() - t0

    run = window.closed_loop(dep.engine, pool_args, seconds, calls, device, profile=trace)

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = dep.launches() if dep.launches else None
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    answers = sum(pool[s].answers for s in run.slots)
    width = yardstick.answer_bytes(next(iter(run.last.values())))
    record = {
        "setup_s": setup_s,
        "spans": dep.spans,
        "batches": run.batches,
        "window_s": run.window_s,
        "batch_s": run.batch_s,
        "dispatch_s": run.dispatch_s,
        "answers": answers,
        "compulsory_bytes": sum(
            yardstick.compulsory_bytes(pool[s].bases, pool[s].codes.shape[0], pool[s].answers,
                                       width)
            for s in run.slots),
        "launches": None if before is None else {n: after[n] - before[n] for n in after},
        "trace": run.trace,
        "peaks": yardstick.peaks(kind),
    }
    log(f"[setup] {dict(dep.info, **stages, **dep.spans)} setup_s={setup_s}")
    log(f"[window] batches={run.batches} window_s={run.window_s} answers={answers} "
        f"batch_ms_median={statistics.median(run.batch_s) * 1e3} "
        f"trace_reduce_s={run.trace['reduce_s'] if run.trace else None}")
    tenth = max(1, run.batches // 10)
    log("[window] batch_ms_median by tenth: " + " ".join(
        f"{statistics.median(run.batch_s[i : i + tenth]) * 1e3:.4f}"
        for i in range(0, run.batches, tenth)))
    log(f"[window] dispatch_ms_mean={sum(run.dispatch_s) / run.batches * 1e3}")
    del dep, pool_args
    _free(device)

    t_check = time.perf_counter()
    result = check.compare(run, pool, seqs, k)
    t_check = time.perf_counter() - t_check
    checks = result["checks"]
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(cell.root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": memory_peak}
    line = {"correct": check.passed(checks), "attempted": run.batches,
            "failed": result["calls_wrong"], "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        ops = sorted(t["op_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(t["gaps"], key=lambda g: -g[1])[:10]
        line["breakdown"] = {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                             "idle_gaps": [[n, s] for n, s in gaps]}
    log(f"[check] calls_judged={result['calls_judged']} answers_judged={result['answers_judged']} "
        f"calls_wrong={result['calls_wrong']} hit_share={result['hit_share']} check_s={t_check}")
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return line
