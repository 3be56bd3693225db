"""Count and time the work of K14 and K4 at the benchmark's cells, for one
checkout of the repository on the card:

    python3 tools/work_ab.py <checkout root> [--seed N] [--trace-batches N]

For each cell of BENCHMARK.json it sets up the system as the benchmark does
(portbench's generator and deployment from the running tree, the program
from the checkout) and prints one JSON line:

* ``ms``: six means of five engine calls on the first pool batch by CUDA
  events, counting nothing; with the checkout's ``kernels.count_work``
  also ``count_ms``, the counting instance's.
* ``work``: the counts summed over the pool's batches (each counted once),
  ``positions`` against the pool's real answers.
* ``split``: the same for a batch of forward-strand reads and one of
  reverse-strand reads (the mix's other parameters kept): each batch's
  counts and ms, its ``shares`` of the positions (restarts, K14's probes
  included; skipped; LF steps a position), and the per-position and
  per-restart costs that the two give, ms = other x t_ext + restarts x
  t_restart, applied to the pool batch, where other is the positions less
  the restarts and the skipped positions (before K14's probes: the
  extensions and the windows with a non-ACGT char). A checkout whose
  counters lack ``skipped`` skips none.
* ``spans`` (a profiled closed loop of ``--trace-batches`` calls, the
  harness's dispatch and sync ranges around each, reduced by
  ``portbench.spans``): host milliseconds a call by span with the spans
  inside subtracted, and the device's idle milliseconds a call by the
  innermost span open at each gap's middle; ``call_ms`` is the loop's
  milliseconds a call.

First a ``build`` line: the library's nvcc seconds (a build from nothing
when the checkout has none) and, from nvcc's -Xptxas -v log, each K14 and
K4 instance's registers, spill bytes and static shared memory, named with
the counting flag taken out (``count`` marks the counting instances).
Run the parent and the change in turns in one call.
"""
import argparse
import json
import re
import statistics
import sys
import tempfile
from pathlib import Path

CHECKOUT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(".").resolve()
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(Path(__file__).resolve().parent)]
import torch  # noqa: E402

import ab_common  # noqa: E402
from portbench import deploy, gen, spans, spec, window  # noqa: E402

sys.path.insert(0, str(CHECKOUT))  # the program (deploy imports it at set-up) is the checkout's
from sbwt_tpu_torch import kernels  # noqa: E402



def build_line() -> dict:
    path, seconds = kernels.build()
    inst, entry, spill = {}, "", 0
    for line in path.with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif ("lf_stream_kernel" in entry or "turbo_stream_kernel" in entry) and (
                m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            cmem = re.search(r"(\d+) bytes cmem\[0\]", line)
            name = ("count " if "Lb1E" in entry else "") + re.sub(r"Lb[01]E", "", entry)
            inst[name] = {"registers": int(m.group(1)), "spill_bytes": spill,
                          "smem": int(smem.group(1)) if smem else 0,
                          "cmem0": int(cmem.group(1)) if cmem else None}
    return {"checkout": str(CHECKOUT), "nvcc_s": seconds, "instances": inst}


def counted(engine, args, device) -> dict | None:
    if not hasattr(kernels, "count_work"):
        return None
    with kernels.count_work(device):
        engine(*args)
    return kernels.work_counts()


def add(total: dict | None, counts: dict | None) -> dict | None:
    if counts is None:
        return None
    return {n: (total or {}).get(n, 0) + v for n, v in counts.items()}


def timed(engine, args, device) -> dict:
    ms, _ = ab_common.mean_ms(lambda: engine(*args))
    out = {"ms": ms}
    if hasattr(kernels, "count_work"):
        with kernels.count_work(device):
            out["count_ms"], _ = ab_common.mean_ms(lambda: engine(*args))
    return out


def profiled_loop(engine, pool_args, batches: int, device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(batches):
            with torch.profiler.record_function(window.DISPATCH):
                out = engine(*pool_args[i % len(pool_args)])
            with torch.profiler.record_function(window.SYNC):
                torch.cuda.synchronize(device)
            del out
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    r = spans.reduce_spans(events)
    per = 1e3 / batches
    return {"call_ms": r["window_s"] * per, "batches": batches,
            "self_ms": {n: v * per for n, v in r["span_s"].items()},
            "idle_ms": {n: v * per for n, v in r["idle_by_span"].items()}}


def strand_split(cell, strains, dep, seed: int, device, pool_batch: dict) -> dict:
    """Forward-only and reverse-only batches of the cell's mix: counts and
    ms each, and the per-extension and per-restart costs they give."""
    k = int(cell.config["k"])
    out = {}
    for name, share in (("forward", 0.0), ("reverse", 1.0)):
        g = gen.generator(seed, 77 + int(share), device)
        b = gen.read_batch(dict(cell.traffic, reverse_strand_share=share), strains, k, g)
        args = dep.prepare(b)
        dep.engine(*args)
        out[name] = {"ms": statistics.median(ab_common.mean_ms(lambda: dep.engine(*args))[0]),
                     "work": counted(dep.engine, args, device)}
        if (w := out[name]["work"]) is not None:
            out[name]["shares"] = {"restarts": w["restarts"] / w["positions"],
                                   "skipped": w.get("skipped", 0) / w["positions"],
                                   "lf_steps_per_position": w["lf_steps"] / w["positions"]}
    if out["forward"]["work"] is None:
        return out

    def other(w):
        return w["positions"] - w["restarts"] - w.get("skipped", 0)

    rows = [(other(w), w["restarts"], o["ms"])
            for o in (out["forward"], out["reverse"]) for w in [o["work"]]]
    (e1, r1, t1), (e2, r2, t2) = rows
    det = e1 * r2 - e2 * r1
    t_ext, t_restart = (t1 * r2 - t2 * r1) / det, (e1 * t2 - e2 * t1) / det
    w = pool_batch["work"]
    ext, rst = other(w), w["restarts"]
    out["model"] = {"t_ext_ns": t_ext * 1e6, "t_restart_ns": t_restart * 1e6,
                    "pool_batch_ext_ms": ext * t_ext, "pool_batch_restart_ms": rst * t_restart,
                    "pool_batch_ms_modelled": ext * t_ext + rst * t_restart,
                    "pool_batch_ms": pool_batch["ms"]}
    return out


def run_cell(name: str, seed: int, trace_batches: int, device) -> dict:
    cell = spec.load_cell(ROOT, name)
    k = int(cell.config["k"])
    strains, seqs = gen.genome(cell.config["genome"], seed, device)
    pool = gen.read_pool(cell.traffic, strains, k, seed)
    dep = deploy.program(cell.config, seqs, device)
    pool_args = [dep.prepare(b) for b in pool]
    for args in pool_args:
        dep.engine(*args)
    torch.cuda.synchronize(device)
    line = {"cell": name, "seed": seed, **timed(dep.engine, pool_args[0], device)}
    total, first = None, None
    for args in pool_args:
        counts = counted(dep.engine, args, device)
        first = first or counts
        total = add(total, counts)
    line["work"] = total
    line["answers"] = sum(b.answers for b in pool)
    line["split"] = strand_split(cell, strains, dep, seed, device,
                                 {"work": first, "ms": statistics.median(line["ms"])})
    line["spans"] = profiled_loop(dep.engine, pool_args, trace_batches, device)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkout")
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--trace-batches", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("work_ab: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(json.dumps({"card": torch.cuda.get_device_name(device), **build_line()}), flush=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        print(json.dumps(run_cell(w["name"], args.seed, args.trace_batches, device)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
