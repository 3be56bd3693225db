"""The uncut E. coli pangenome on one card: the ranged device build, one
batch searched by K14, its answers judged by the benchmark's reference.

    python3 tools/pangenome_uncut.py [--strains 3682] [--seed N] [--max-keys 2^29]

The sequences are portbench/gen.py's pangenome shape at the values of
portbench/configs/ecoli-pangenome.json with ``--strains`` strains (3682,
the upstream data set's genomes, by default) and their reverse
complements. They are laid out once, on the card, as the build's codes
(each strain, then each reverse complement, a -1 after each), and the
generator's strains and the reference's sequences are views of those
codes, so the card holds one copy (36.8 GB at 3682 strains). The strains
are drawn as gen.pangenome draws them (its reverse complements take no
draws), so these are the sequences a cell of that size would index.

Then: ``construct.device.build_sbwt_device`` over the codes (the ranged
build, int64 tables past 2^31 columns; host seconds to a synchronize, its
build record, the device memory peak); one pool batch of the ``isolate``
mix (2^20 reads of 100 bp); K14 over it (``ops.search.streaming_search``,
six means of five calls by CUDA events); the index freed; the batch's
answers against ``portbench/reference/buckets.py`` at ``--max-keys``.
Prints one JSON line a step and a last one with ``correct``. A step that
does not fit the card raises there, and the last line says which.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import gen  # noqa: E402
from portbench.reference import buckets  # noqa: E402
from sbwt_tpu_torch.construct import device as td  # noqa: E402
from sbwt_tpu_torch.ops.search import streaming_search  # noqa: E402


def say(step: str, **fields) -> None:
    print(json.dumps({"step": step, **fields}), flush=True)


def gib(n) -> float:
    return round(n / 2**30, 3)


def lay_out(params: dict, seed: int, dev):
    """(codes int8 [2 S (G + 1)], strains view [S, G], sequences as views):
    the strains of gen.pangenome, then their reverse complements."""
    strains, _ = gen.pangenome(dict(params, add_reverse_complements=False), seed, dev)
    S, G = strains.shape
    codes = torch.full((2 * S * (G + 1),), -1, dtype=torch.int8, device=dev)
    rows = codes.view(2 * S, G + 1)
    rows[:S, :G] = strains
    del strains
    for i in range(S):
        rows[S + i, :G] = gen.reverse_complement(rows[i, :G])
    return codes, rows[:S, :G], [rows[i, :G] for i in range(2 * S)]


def k14_ms(fn, reps: int = 5, rounds: int = 6) -> list:
    fn()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strains", type=int, default=3682)
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--max-keys", type=int, default=1 << 29)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    config = json.loads((ROOT / "portbench/configs/ecoli-pangenome.json").read_text())
    mix = dict(json.loads((ROOT / "portbench/traffic/isolate.json").read_text()),
               pool_batches=1)
    k, p = int(config["k"]), int(config["precalc_k"])
    step = "sequences"
    try:
        t0 = time.perf_counter()
        codes, strains, seqs = lay_out(dict(config["genome"], strains=args.strains), args.seed,
                                       dev)
        torch.cuda.synchronize()
        say(step, strains=args.strains, codes=codes.numel(), seconds=time.perf_counter() - t0,
            card_gib=gib(torch.cuda.memory_allocated(dev)))
        step = "pool"
        batch = gen.read_pool(mix, strains, k, args.seed)[0]
        del strains
        step = "build"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = td.build_sbwt_device(None, k, dev, precalc_k=p, prepared=codes)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        record = {key: v for key, v in td.LAST_BUILD.items() if key != "range_columns"}
        say(step, seconds=seconds, **record, peak_gib=gib(record["peak_bytes"]),
            rank_tbl_elements=index.rank_tbl.numel(), index_gib=gib(record["table_bytes"]))
        step = "search"
        ms = k14_ms(lambda: streaming_search(index, batch.codes, batch.lengths))
        answers = streaming_search(index, batch.codes, batch.lengths)
        torch.cuda.synchronize()
        say(step, k14_ms=ms, k14_ms_median=statistics.median(ms), answers=batch.answers,
            dtype=str(answers.dtype), answers_per_s=batch.answers / statistics.median(ms) * 1e3)
        del index
        torch.cuda.empty_cache()
        step = "check"
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        want = buckets.streaming_answers(seqs, k, [(batch.codes, batch.lengths)],
                                         max_keys=args.max_keys).answers[0]
        wrong = int((answers.long() != want).sum())
        say(step, seconds=time.perf_counter() - t0, max_keys=args.max_keys,
            mismatched_answers=wrong, hit_share=float((want >= 0).sum()) / batch.answers,
            peak_gib=gib(torch.cuda.max_memory_allocated(dev)))
        say("result", correct=wrong == 0)
        return 0 if wrong == 0 else 1
    except torch.OutOfMemoryError as e:
        say("result", correct=None, stopped_at=step, reason=str(e).splitlines()[0])
        return 1


if __name__ == "__main__":
    sys.exit(main())
