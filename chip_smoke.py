#!/usr/bin/env python3
"""Smoke test of sbwt_tpu_torch on one CUDA card: the port's main path at
the bench's real size, every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of the repository

Phases, one line each; any failure exits nonzero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles K1-K4, K13, K14, K18-K21 and fast_search from
   sbwt_tpu_torch/csrc, one process per source;
3. main path (launches counted): ``SBWT.build`` of a 4 Mbp uniform random
   genome (numpy seed 20260817, as bench.py) at k = 30 with precalc_k = 13
   (K1's fill), ``enable_turbo(arity=3)`` (K2, K3),
   ``streaming_search_batch`` of 1M reads of 100 bp at the hit98 and hit0
   mixes (K4) and ``search_batch`` of their first k-mers (K1's search);
   then the bench's stats programs (K4, then K13's answer reductions):
   ``ops.turbo._turbo_reduced_stats`` of the hit98 batch and
   ``_turbo_with_stats`` of the hit0 batch, equal to the answers' own
   checksum and hits;
4. variants path (launches counted): for each of the ten variants,
   ``to_variant`` (carrying the p = 13 table), ``streaming_search_batch``
   of both 1M-read batches on the LF engine (K14 over the variant's ranks,
   K15-K17), whose answers must equal K4's, ``search_batch`` of 1M 30-mers
   (the variant's K1 search) and the variant's K1 fill at p = 12;
5. variant turbo (launches counted): for each of the nine compressed
   variants, ``enable_turbo(3)`` from the variant's own ranks (succ1 of its
   rank type, then compose), whose table must be byte-equal to
   plain-matrix's, and ``streaming_search_batch`` of both batches through
   K4 of its rank type, equal to plain-matrix's answers; one table at a
   time. For all ten variants, ``partial_search_batch`` and
   ``forward_batch`` of 1M lanes (the rank type's forward kernel, one char
   a lane), equal to plain-matrix's;
6. wide turbo (launches counted): the same genome index forced onto the
   wide (int64) tier through ``from_packed_rows_wide`` (K18: the wide K1
   fill at p = 13), its LF answers (wide K14) and, after
   ``enable_turbo`` (wide succ1 and seed bits: an int64 [n, 4] table), its
   turbo answers (wide K4) on both batches, equal to the narrow ones, and
   the stats programs over them (wide K13 on int64 answers);
7. k-mer access (launches counted): ``ops.turbo.fast_search`` of the first
   k-mer of every read of both mixes and of the spiked batch, over the
   arity-3 table, narrow tables of arity 1 and 2 and the wide int64 table,
   each equal to its plain version and, where needs_slow is false, to K1's
   search (hit98: needs_slow rare, hit fraction near 0.98); K2's compose
   at arity 1 beside ``succ.t().contiguous()``, the one PyTorch call that
   computes it (its library time);
   ``compute_dummy_node_marks`` (one succ1 launch a BFS level), equal to
   the labels of ``reconstruct_all_kmers`` that start with $;
   ``get_kmers_batch`` of 1M sampled columns and ``get_kmer_fast`` of 1,000,
   equal to those labels, each full k-mer searched back to its column;
8. wide giant (launches counted): the complete order-16 de Bruijn graph,
   4,294,967,297 columns (a 6.44 GB rank table and a 1.07 GB suffix-group
   table on the card), from its packed pattern through ``SBWT.from_packed``,
   which must route to the wide index by itself; the pattern is first held
   to the host constructor at order 8. ``search_batch`` of 1M 16-mers,
   ``streaming_search_batch`` of 1M reads of 100 bp and of the same reads
   with an N every 20-40 bases, ``partial_search_batch`` and
   ``forward_batch`` of 1M lanes (the wide forward kernel), every answer
   against the closed form
   1 + sum code_i * 4^i; ``enable_turbo(None)`` must find no room for a
   table (137 GB) and leave the LF engine;
9. device build (launches counted): ``SBWT.build_on_device`` (K19) of the
   same genome with precalc_k = 13, whose tables, counts and p = 13 table
   must equal phase 3's host-built index word for word and whose turbo
   answers to the hit98 batch must equal phase 3's; then of the first
   200,000 reads of the hit98 batch as separate sequences, equal to the
   host build of the same reads;
10. parallel (launches counted): the five steps of the JAX package's
   multichip dry run (``__graft_entry__.py:32-95``) through
   ``sbwt_tpu_torch.parallel.sharded`` on the main path's index and both
   1M-read batches, slots round-robin over the cards (each slot's device
   printed): DP ``dp_search`` (the 1M 30-mers), ``dp_streaming_search`` and
   ``dp_turbo_streaming_search`` over a (2, 1) mesh; over a (2, 4) mesh TP
   ``tp_search`` and ``tp_streaming_search`` (K20a), then
   ``tp_turbo_streaming_search`` (K20b) over ``shard_turbo_rows`` of the
   arity-3 table and over ``build_turbo_sharded(arity=3)`` (K20c), whose real
   rows must be byte-equal to the table; every answer equal to the main
   path's. At most two 4.1 GB tables are alive at once. Then K20a-c against
   their plain versions, and one ``tp_streaming_search`` under the port's
   ``utils.profiling.trace`` (its top device ops);
11. probe (launches counted): ``ops.gather_chain`` (K21) at
   scratch/gather_bench.py's shapes (B = 65,536 lanes, 64 steps, [2M, 2] and
   [2M, 8] tables) and over 2^26-row tables past L2 (and a table on a second
   card, if there is one), each against its plain version, with gathers/s,
   the byte bound (the distinct rows read) and beside it the card's
   dependent-gather ceiling, measured in the run from fresh start rows;
12. kernels against their plain versions on the card, at the main path's
   shapes, with times: K1 on plain-matrix (the p = 13 fill, the 1M
   30-mers), K2, K3 (also at p = 1 and 5 from fresh fills, narrow and
   wide), K13 on each batch's answers beside ``torch.sum`` and the hit
   count (its library time; wide K13 on the wide K4's int64 answers), K4
   on each whole 1M-read batch (its bound counts the
   table, seed-bits, precalc and rank rows the batch's answers ask for,
   ``turbo_work``, printed beside the bound of codes and answers alone);
   K14 of each variant on each whole 1M-read batch (time and bound) and
   on its first 2^16 reads against its plain version (its bound counts
   the suffix-group, rank and precalc rows the batch's answers ask for,
   ``lf_work``, printed beside the bound of codes and answers alone, with
   K14's shared memory per block), and on a batch with lowercase, N
   and short lengths; each variant's K1 search on the 1M 30-mers and fill
   at p = 8, and its p = 12 table of phase 4 against the plain version's;
   K19's four kernels at the genome build's shapes (edge_src_probe beside
   ``torch.searchsorted`` of its queries, its library time; pack_windows
   also at k = 63 and 255, 4 and 16 key words, with registers), the build's
   sorts, and the build's time split by stage; succ1 and K4 of each compressed
   variant and partial_search of all eleven rank types; the wide kernels
   at the 4M-column index (whole batches, beside the narrow times; succ1
   over all its columns, as the table build launches it) and at
   the giant's size (K14 on 2^16 reads, the others on 1M lanes; the giant
   can have no table, so wide K4 is held at 4M columns only); fast_search
   over each table on the 1M first k-mers of each mix;
13. the CLI (``python -m sbwt_tpu_torch build`` / ``build-variant`` /
   ``search``, ``ascii-export``) on the reference's golden inputs, byte-equal
   to the golden output, on plain-matrix (turbo) and rrr-split (LF, turbo3
   and auto); the two exports byte-equal, and mef-split's refused;
14. ``examples/scaling_example_torch.py`` on the card (DP over 8 slots and
   TP over (4, 2), every slot the one card, held equal), whose lines must
   equal its CPU run's.

It prints one JSON line of per-kernel results (launches on its path, error
against the plain version, time, the plain version's time, the least
time the card could take: compulsory bytes over the HBM rate or counted
operations over the peak rate, whichever is larger, and the time of the
PyTorch calls that compute the same function where there are any, else
null), the card's nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 2 and prints no result. Every output is an integer, so each
comparison is exact (max_abs_err must be 0). At its end no ``jax`` and no
``sbwt_tpu`` module may be loaded.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
K = 30
READ_LEN = 100
PRECALC_K = 13
ARITY = 3
GENOME_SEED = 20260817
GENOME_BP = 4_000_000
N_READS = 1 << 20  # reads per mix
MIXES = {"hit98": 0.02, "hit0": 1.0}  # fraction of reads replaced by random sequence

# the reference's end_to_end_build_and_query inputs and output (test_CLI.hh)
GOLDEN_SEQS = (["ACTAGTGTAGCTACAAA", "ATGTGCTGATGCTAGCATTTTTTT"], ["GTGTACTAGTGTGTAGTCGAT"])
GOLDEN_QUERIES = [
    "GGAGAACTAGTGTAGCTACAAAGAGAG",
    "AGTGTGTAGCAAAATGTGCTGATGCTAGCAAAAAAAA",
    "CTCTACACACTTC",
]
GOLDEN = (
    "-1 -1 -1 -1 -1 74 55 77 22 47 36 70 19 31 8 4 3 -1 -1 -1 -1 -1 \n"
    "57 78 23 47 36 -1 -1 -1 -1 -1 52 -1 -1 39 73 54 15 65 53 38 72 20 46 35 11 -1 -1 -1 -1 2 2 2 \n"
    "-1 -1 26 5 25 66 -1 -1 \n"
)

VARIANTS = ("plain-matrix", "rrr-matrix", "mef-matrix", "plain-split", "rrr-split",
            "mef-split", "plain-concat", "mef-concat", "plain-subsetwt", "rrr-subsetwt")
GENERIC_P = 12  # the largest precalc a compressed variant fills itself
PLAIN_READS = 1 << 16  # reads per mix that K14's plain version answers
BUILD_READS = 200_000  # reads of the hit98 batch that the device build takes as sequences
WIDE_PACK_K = (63, 255)  # pack_windows at 4 and 16 key words, beside the build's k
COMPRESSED = VARIANTS[1:]
WIDE = "wide-matrix"  # the rank type of the int64 tier (kernels.WIDE)
GIANT_K = 16  # the complete order-16 de Bruijn graph: 4^16 + 1 columns
GIANT_P = 8  # the reference's default prefix length (sbwt_build.cpp -p 8)
TURBO_PLAIN_READS = {"hit98": 1 << 16, "hit0": 1 << 14}  # reads K4's plain version answers per variant
DP_MESH = (2, 1)  # (n_data, n_model) of the parallel phase's data-parallel steps
TP_MESH = (2, 4)  # and of its row-sharded steps; slots go round-robin over the cards
# the gather probe at scratch/gather_bench.py's shapes (a [4N, 2] table of
# 16 MB, inside the 50 MB L2), and at a table of 2^26 rows, past it
PROBE_N, PROBE_B, PROBE_STEPS = 500_000, 65_536, 64
PROBE_BIG_ROWS = 1 << 26
# the card's dependent-gather ceiling at each probe table is measured in the
# run from fresh start rows: the unloaded step latency from 32 lanes at
# PROBE_STEPS and at PROBE_LONG_STEPS, the saturated rate at PROBE_WIDE_LANES
PROBE_LONG_STEPS = 320
PROBE_WIDE_LANES = (1 << 18, 1 << 20)

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and the float32 rate outside the
# tensor cores, which stands in for the integer ALU rate of these kernels
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
SPIN_CYCLES = 4_000_000  # a spin of the card before a timed run: about 2 ms at 1,980 MHz

# kernel entry point -> (source, the XLA program it replaces)
KERNELS = {
    "precalc_fill[plain-matrix]": ("sbwt_tpu_torch/csrc/lf_stream.cu",
                                   "sbwt_tpu/models/matrix.py:267"),
    "kmer_search[plain-matrix]": ("sbwt_tpu_torch/csrc/lf_stream.cu", "sbwt_tpu/ops/search.py:83"),
    "succ1": ("sbwt_tpu_torch/csrc/succ_table.cuh", "sbwt_tpu/ops/turbo.py:294"),
    "succ_compose": ("sbwt_tpu_torch/csrc/succ_table.cu", "sbwt_tpu/ops/turbo.py:342"),
    "seed_bits": ("sbwt_tpu_torch/csrc/seed_bits.cu", "sbwt_tpu/ops/turbo.py:271"),
    "turbo_stream": ("sbwt_tpu_torch/csrc/turbo_stream.cuh", "sbwt_tpu/ops/turbo.py:610"),
    "answer_stats": ("sbwt_tpu_torch/csrc/answer_stats.cu", "sbwt_tpu/ops/turbo.py:1382"),
}
# K19, the on-device build (csrc/build_sbwt.cu)
BUILD_KERNELS = {
    "pack_windows": ("sbwt_tpu_torch/csrc/build_sbwt.cu", "sbwt_tpu/construct/device.py:198"),
    "edge_src_probe": ("sbwt_tpu_torch/csrc/build_sbwt.cu", "sbwt_tpu/construct/device.py:221"),
    "emit_dummies": ("sbwt_tpu_torch/csrc/build_sbwt.cu", "sbwt_tpu/construct/device.py:247"),
    "finalize_tables": ("sbwt_tpu_torch/csrc/build_sbwt.cu", "sbwt_tpu/construct/device.py:307"),
}
# the LF entry points of the variants path, one instance per variant
# (csrc/lf_stream.cuh); plain-matrix's K1 is in KERNELS
LF_KERNELS = {}
for _v in VARIANTS:
    _fam = _v.split("-")[1]
    _src = "sbwt_tpu_torch/csrc/" + ("lf_stream.cu" if _fam == "matrix" else f"lf_{_fam}.cu")
    LF_KERNELS[f"lf_stream[{_v}]"] = (_src, "sbwt_tpu/ops/search.py:185")
    if _v != "plain-matrix":
        LF_KERNELS[f"kmer_search[{_v}]"] = (_src, "sbwt_tpu/ops/search.py:83")
        LF_KERNELS[f"precalc_fill[{_v}]"] = (_src, "sbwt_tpu/models/variants.py:125")

# turbo from a compressed variant's own ranks, and partial_search on every
# narrow rank type: instances of the templates in succ_table.cuh,
# turbo_stream.cuh and lf_stream.cuh
VARIANT_TURBO_KERNELS = {}
for _v in VARIANTS:
    _fam = _v.split("-")[1]
    _src = "sbwt_tpu_torch/csrc/" + ("lf_stream.cu" if _fam == "matrix" else f"lf_{_fam}.cu")
    if _v != "plain-matrix":
        VARIANT_TURBO_KERNELS[f"succ1[{_v}]"] = (_src, "sbwt_tpu/ops/turbo.py:294")
        VARIANT_TURBO_KERNELS[f"turbo_stream[{_v}]"] = (_src, "sbwt_tpu/ops/turbo.py:610")
    VARIANT_TURBO_KERNELS[f"partial_search[{_v}]"] = (_src, "sbwt_tpu/ops/search.py:291")
    VARIANT_TURBO_KERNELS[f"forward[{_v}]"] = (_src, "sbwt_tpu/ops/search.py:136")
# K18, the wide tier: the same templates at 64-bit positions
_WIDE_SRC = "sbwt_tpu_torch/csrc/lf_wide.cu"
WIDE_KERNELS = {
    f"precalc_fill[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/models/wide.py:157"),
    f"kmer_search[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/ops/search.py:83"),
    f"lf_stream[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/ops/search.py:185"),
    f"partial_search[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/ops/search.py:291"),
    f"succ1[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/ops/turbo.py:209"),
    f"seed_bits[{WIDE}]": ("sbwt_tpu_torch/csrc/seed_bits.cu", "sbwt_tpu/ops/turbo.py:271"),
    f"turbo_stream[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/ops/turbo.py:661"),
    f"answer_stats[{WIDE}]": ("sbwt_tpu_torch/csrc/answer_stats.cu", "sbwt_tpu/ops/turbo.py:1382"),
}
# the wide forward kernel, which only the giant's path launches
GIANT_FORWARD = {f"forward[{WIDE}]": (_WIDE_SRC, "sbwt_tpu/ops/search.py:136")}
# what the giant's path launches: it can have no table, so no K4, no seed
# bits and no succ1 (its succ1 entry, over 1M sampled columns, keeps the
# forced-wide path's count)
GIANT_KERNELS = [f"{op}[{WIDE}]" for op in
                 ("precalc_fill", "kmer_search", "lf_stream", "partial_search", "forward")]

# K20, the row-sharded (TP) path (csrc/lf_sharded.cu, succ_table.cu), and
# K21, the gather probe (csrc/gather_chain.cu)
PARALLEL_KERNELS = {
    "kmer_search[sharded-matrix]": ("sbwt_tpu_torch/csrc/lf_sharded.cu",
                                    "sbwt_tpu/parallel/sharded.py:208"),
    "lf_stream[sharded-matrix]": ("sbwt_tpu_torch/csrc/lf_sharded.cu",
                                  "sbwt_tpu/parallel/sharded.py:478"),
    "turbo_stream[plain-matrix/sharded-table]": ("sbwt_tpu_torch/csrc/lf_sharded.cu",
                                                 "sbwt_tpu/parallel/sharded.py:233"),
    "succ_compose[column-range]": ("sbwt_tpu_torch/csrc/succ_table.cu",
                                   "sbwt_tpu/parallel/sharded.py:343"),
}
PROBE_KERNELS = {"gather_chain": ("sbwt_tpu_torch/csrc/gather_chain.cu", "scratch/gather_bench.py:58")}
# the facade's k-mer access path: fast_search over the narrow tables (arity
# 1-3) and over the wide tier's (csrc/fast_search.cu)
KMER_ACCESS_KERNELS = {
    "fast_search[plain-matrix]": ("sbwt_tpu_torch/csrc/fast_search.cu", "sbwt_tpu/ops/turbo.py:491"),
    f"fast_search[{WIDE}]": ("sbwt_tpu_torch/csrc/fast_search.cu", "sbwt_tpu/ops/turbo.py:491"),
}
SAMPLED_COLUMNS = 1 << 20  # columns whose labels get_kmers_batch gives
FAST_COLUMNS = 1000  # of them, the labels get_kmer_fast gives one by one

# plain-matrix's succ1 and K4 keep, in this script's output, the bare names
# they had as the only instances; their launch counters are named as the others'
COUNTER = {"succ1": "succ1[plain-matrix]", "turbo_stream": "turbo_stream[plain-matrix]"}

ALL_KERNELS = {**KERNELS, **LF_KERNELS, **BUILD_KERNELS, **VARIANT_TURBO_KERNELS, **WIDE_KERNELS,
               **GIANT_FORWARD,
               **PARALLEL_KERNELS, **PROBE_KERNELS, **KMER_ACCESS_KERNELS}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def ptxas_lines(log: str) -> list:
    """(entry point, registers, spill bytes stored and loaded) of every
    kernel in nvcc's ``-Xptxas -v`` output."""
    out, entry, spill = [], "?", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            out.append((entry, int(m.group(1)), spill))
    return out


# each rank type as it stands in the kernels' mangled entry points (regular
# expressions: K1's fill and partial_search run rrr-subsetwt as
# SubsetWTRank<RRR15Staged>)
MANGLED = {"plain-matrix": "11PlainMatrix", "rrr-matrix": "10MatrixRankINS_5RRR15",
           "mef-matrix": "10MatrixRankINS_3MEF", "plain-split": "9SplitRankINS_7PlainBV",
           "rrr-split": "9SplitRankINS_5RRR15", "mef-split": "9SplitRankINS_3MEF",
           "plain-concat": "10ConcatRankINS_7PlainBV", "mef-concat": "10ConcatRankINS_5RRR15",
           "plain-subsetwt": "12SubsetWTRankINS_7PlainBV",
           "rrr-subsetwt": "12SubsetWTRankINS_(?:5RRR15|11RRR15Staged)", WIDE: "10WideMatrix",
           "sharded-matrix": "13ShardedMatrix"}
SEARCH_OPS = ("kmer_search", "partial_search")  # the kernels whose records carry their registers
# and every rank-templated kernel (kernels.LF_OPS) of these rank types: RRR15,
# ConcatRank, SplitRank and SubsetWTRank inside
RANK_OPS = ("lf_stream", "precalc_fill", "kmer_search", "partial_search", "succ1", "turbo_stream",
            "forward")
REGISTER_RANK_TYPES = ("rrr-matrix", "plain-split", "rrr-split", "mef-split", "plain-concat",
                       "mef-concat", "plain-subsetwt", "rrr-subsetwt")


def carries_registers(name: str) -> bool:
    op, _, rank_type = name[:-1].partition("[")
    return op in SEARCH_OPS or (op in RANK_OPS and rank_type in REGISTER_RANK_TYPES)


def instance_registers(regs: list, name: str) -> dict:
    """Registers and spill bytes of the entry points of one rank-templated
    kernel's instance ``op[rank type]``: the most registers and the spill
    bytes summed over them. A search kernel has one (its staged form or,
    where the rank type keeps it, its one-thread-a-lane form), the fill one
    a subtree depth, succ1 its span form beside its one-a-column form.
    K14's and K4's instances that count their work (``Lb1E``) are left out."""
    op, rank_type = name[:-1].split("[")
    pattern = re.compile(rf"\d+{op}(_lane|_span)?_kernelI(Li\d+E)?NS_{MANGLED[rank_type]}E")
    found = [(r, s) for entry, r, s in regs if pattern.search(entry) and "Lb1E" not in entry]
    check(len(found) >= 1 and (op not in SEARCH_OPS or len(found) == 1),
          f"{name}: {len(found)} entry points in the ptxas log")
    return {"registers": max(r for r, _ in found), "spill_bytes": sum(s for _, s in found)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs after one warm-up, by CUDA
    events. The runs are queued behind a spin of the card, so that the
    host's time to launch a call (tens of us) does not count for a kernel
    that takes less."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn):
    """fn's result and the device time of that one run in ms, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def host_seconds(*functions):
    """While the block runs, the (module, name) functions add the host
    seconds of their calls to the one-element list that is yielded."""
    total = [0.0]

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                total[0] += time.perf_counter() - t0
        return call

    with contextlib.ExitStack() as stack:
        for module, name in functions:
            stack.enter_context(mock.patch.object(module, name, timed(getattr(module, name))))
        yield total


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# Work of the LF and turbo kernels from their shapes, as (bytes moved,
# integer operations). How many LF steps a lane takes before it empties
# depends on the data, so operations are counted low: the one step that
# every row, k-mer or answer needs, at LF_OPS operations (a rank pair with
# its interval update: shifts, masks, a popcount, adds, read off the
# source). The bound stays a lower bound.
LF_OPS = 40


def device_bytes(di) -> int:
    """The bytes of an index's rank structure as the card holds it (a
    subset wavelet tree's device form differs from its file form)."""
    return di.device_bytes() if hasattr(di, "device_bytes") else di.size_in_bytes()


def fill_work(structure_bytes: int, p: int):
    """K1 fill: the structure read once, the table written."""
    return structure_bytes + 4**p * 8, 4**p * LF_OPS


def search_work(structure_bytes: int, B: int, k: int):
    """K1 search: codes, one precalc row and the answer per k-mer."""
    return structure_bytes + B * (k + 8 + 4), B * LF_OPS


def answer_walk(precalc, k: int, p: int, codes, lengths, ans, chunk: int = 1 << 16):
    """The walk over a batch's answers that K4's and K14's bounds share, a
    chunk of reads at a time: for each chunk, its answers a (int64) and
    codes c, the valid positions, each position's previous answer (-1 at
    position 0), the chain (valid positions after a live answer), the
    restarts (valid positions after a -1 whose window is all ACGT, as row
    and position index tensors rb, ci), their precalc indices pidx and
    seed rows (int64)."""
    B, P = ans.shape
    dev = ans.device
    idx = torch.arange(P, device=dev)
    for s in range(0, B, chunk):
        a, c = ans[s : s + chunk].long(), codes[s : s + chunk]
        m = len(a)
        valid = idx[None] < (lengths[s : s + chunk].long() - k + 1).clamp(0, P)[:, None]
        prev = torch.cat([torch.full((m, 1), -1, dtype=torch.long, device=dev), a[:, :-1]], 1)
        chain = valid & (prev >= 0)
        bad = torch.nn.functional.pad(((c < 0) | (c > 3)).int().cumsum(1), (1, 0))
        rb, ci = (valid & (prev < 0) & (bad[:, k : k + P] == bad[:, :P])).nonzero(as_tuple=True)
        pidx = torch.zeros_like(rb)
        for j in range(p):
            pidx |= (c[rb, ci + j].long() & 3) << (2 * j)
        yield dict(a=a, c=c, idx=idx, valid=valid, prev=prev, chain=chain, rb=rb, ci=ci, pidx=pidx,
                   seed=precalc[pidx].long() if p > 0 else None)


def table_row_bytes(turbo) -> int:
    """The bytes of the table row a step of K4's or fast_search's walk
    reads: 8 at arity 2, 16 at arity 1 and 3 (the wide tier: the 16-byte
    half of the int64 [n, 4] row that the char picks)."""
    return 8 if turbo.arity == 2 else 16


def walk_rows(turbo, col, chars) -> int:
    """The table rows the walks from the singleton seeds col (-1: none)
    over the chars [m, k - p] read: min(arity, chars left) chars a row, up
    to the walk's end or first -1 (walk_singleton, fast_search)."""
    A, rows = turbo.arity, 0
    for j in range(0, chars.shape[1], A):
        take = min(A, chars.shape[1] - j)
        alive = col >= 0
        rows += int(alive.sum())
        ch = [chars[:, j + t].long() & 3 for t in range(take)]
        if A == 1:
            nxt = turbo.row(col.clamp(min=0)).gather(-1, ch[0][:, None])[:, 0]
        else:
            sub = sum(ch[t] * 4 ** (A - 1 - t) for t in range(take))
            nxt = turbo.row(col.clamp(min=0), sub)[:, take - 1]
        col = torch.where(alive, nxt.long(), -1)
    return rows


def turbo_work(turbo, index, codes, lengths, ans, chunk: int = 1 << 16):
    """K4 and K20b: codes and lengths in, answers out, and the rows read at
    random that this run's answers and codes ask for. A chain (the
    positions after a live answer, up to its first -1) reads one table row
    for every arity answers. A restart (position 0, or a position after a
    -1, whose window is all ACGT) reads its seed-bits word (each distinct
    word counted once), its precalc row when the seed is live, then the
    table rows of a singleton seed's walk up to its end or first -1, or
    the rank rows of a wider seed's exact LF steps up to the first empty
    interval (one row a step when l == r, else two; 8 bytes each, counted
    low for the compressed and wide rank types). turbo is the flat table
    (K20b's shards hold the same rows). Returns (bytes, operations, the
    counts and the bound of codes and answers alone)."""
    from sbwt_tpu_torch.ops import search as ts

    k, p, A = turbo.k, turbo.precalc_k, turbo.arity
    B, P = ans.shape
    row_bytes, precalc_bytes = table_row_bytes(turbo), 2 * turbo.precalc.element_size()
    seen = torch.zeros(4**p // 16 + 1, dtype=torch.bool, device=ans.device)
    n = dict(chain_rows=0, restarts=0, live_seeds=0, walk_rows=0, lf_rank_rows=0)
    for w in answer_walk(turbo.precalc, k, p, codes, lengths, ans, chunk):
        c, idx, chain, rb, ci, pidx, seed = (w[x] for x in ("c", "idx", "chain", "rb", "ci", "pidx",
                                                             "seed"))
        m = len(chain)
        first = chain & ~torch.cat([torch.zeros((m, 1), dtype=torch.bool, device=chain.device),
                                    chain[:, :-1]], 1)
        start = torch.where(first, idx[None], -1).cummax(dim=1).values
        n["chain_rows"] += int((chain & ((idx[None] - start) % A == 0)).sum())
        n["restarts"] += len(rb)
        seen[pidx >> 4] = True
        live = seed[:, 0] >= 0
        n["live_seeds"] += int(live.sum())
        single = live & (seed[:, 0] == seed[:, 1])
        wb, wc = rb[single], ci[single]
        n["walk_rows"] += walk_rows(turbo, seed[single, 0],
                                    c[wb[:, None], wc[:, None] + p + torch.arange(k - p, device=c.device)])
        wide = live & (seed[:, 0] != seed[:, 1])
        l, r, lb, lc = seed[wide, 0], seed[wide, 1], rb[wide], ci[wide]
        alive = torch.ones_like(l, dtype=torch.bool)
        for j in range(p, k):
            n["lf_rank_rows"] += int(torch.where(l == r, 1, 2)[alive].sum())
            l, r, alive = ts.lf_step(index, l, r, c[lb, lc + j].long() & 3, alive)
    n["seed_words"] = int(seen.sum()) if turbo.seed_bits is not None else 0
    base = codes.numel() + 4 * B + ans.numel() * ans.element_size()
    moved = (base + (n["chain_rows"] + n["walk_rows"]) * row_bytes + 4 * n["seed_words"]
             + precalc_bytes * (n["live_seeds"] if turbo.seed_bits is not None else n["restarts"])
             + 8 * n["lf_rank_rows"])
    return moved, B * P * LF_OPS, dict(n, codes_answers_bound_ms=base / HBM_BYTES_PER_S * 1e3)


def lf_rows(index, codes, lengths, ans, chunk: int = 1 << 16):
    """The rows K14 reads besides codes and answers, from this run's
    answers and codes, each distinct row counted once: an extension (a
    position after a live answer whose char extends) reads the
    suffix-group row of the previous column and the rank row of its char
    at the group's start; a restart reads the precalc row of its seed (K14
    has no seed-bits pre-test), and a live seed the rank rows of its exact
    LF steps up to the first empty interval (row l >> 5 of the char, and
    (r + 1) >> 5 when l != r). Rank rows are numbered as plain-matrix's
    (char * n_words + word), so the counts hold for every rank type of the
    same index (the sharded one too), with their number of accesses."""
    from sbwt_tpu_torch.ops import search as ts

    k, p, W = index.k, index.precalc_k, (index.n_nodes + 31) // 32
    dev = ans.device
    seen_sg = torch.zeros(W, dtype=torch.bool, device=dev)
    seen_rank = torch.zeros(4 * W, dtype=torch.bool, device=dev)
    seen_pre = torch.zeros(4**p if p > 0 else 1, dtype=torch.bool, device=dev)
    n = dict(extensions=0, restarts=0, live_seeds=0, lf_rank_rows=0)
    for w in answer_walk(index.precalc, k, p, codes, lengths, ans, chunk):
        a, c, valid, prev, chain = w["a"], w["c"], w["valid"], w["prev"], w["chain"]
        P = a.shape[1]
        # lowercase extends until the read's first -1 answer
        lenient = torch.nn.functional.pad((valid & (a < 0)).int().cumsum(1), (1, 0))[:, :P] == 0
        ch = c[:, k - 1 : k - 1 + P].long()
        ext = chain & (ch >= 0) & (lenient | (ch < 4))
        col = prev[ext]
        n["extensions"] += len(col)
        seen_sg[col >> 5] = True
        seen_rank[(ch[ext] & 3) * W + (index.sg_start(col).long() >> 5)] = True
        rb, ci = w["rb"], w["ci"]
        n["restarts"] += len(rb)
        if p == 0:
            l = torch.zeros_like(rb)
            r, lb, lc = torch.full_like(rb, index.n_nodes - 1), rb, ci
        else:
            seen_pre[w["pidx"]] = True
            live = w["seed"][:, 0] >= 0
            n["live_seeds"] += int(live.sum())
            l, r, lb, lc = w["seed"][live, 0], w["seed"][live, 1], rb[live], ci[live]
        alive = torch.ones_like(l, dtype=torch.bool)
        for j in range(p, k):
            cj = c[lb, lc + j].long() & 3
            seen_rank[(cj * W + (l >> 5))[alive]] = True
            two = alive & (l != r)
            seen_rank[(cj * W + ((r + 1) >> 5))[two]] = True
            n["lf_rank_rows"] += int(alive.sum()) + int(two.sum())
            l, r, alive = ts.lf_step(index, l, r, cj, alive)
    return dict(n, sg_rows=int(seen_sg.sum()), rank_rows=int(seen_rank.sum()),
                precalc_rows=int(seen_pre.sum()) if p > 0 else 0)


def lf_work(rows: dict, index, structure_bytes: int, B: int, L: int):
    """K14 over B reads of L codes: codes and lengths in, answers out, and
    the rows of lf_rows read once: suffix-group rows of 8 bytes, rank rows
    of 8 (12 on the wide tier; at most the rank type's structure_bytes, so
    counted low for the compressed types) and precalc rows of two
    positions. Returns (bytes, operations, the counts with the bound of
    codes and answers alone)."""
    k, pos_bytes = index.k, index.precalc.element_size()
    base = B * L + 4 * B + B * (L - k + 1) * pos_bytes
    rank_bytes = min(rows["rank_rows"] * (12 if pos_bytes == 8 else 8), structure_bytes)
    moved = base + 8 * rows["sg_rows"] + rank_bytes + 2 * pos_bytes * rows["precalc_rows"]
    return moved, B * (L - k + 1) * LF_OPS, dict(rows, codes_answers_bound_ms=base / HBM_BYTES_PER_S * 1e3)


# (batch, reads) -> lf_rows of the first reads of a main-path batch over the
# main index. Every K14 instance of that index (the ten variants, the
# forced-wide copy, K20a) gives the same answers and reads its rows at the
# same positions, so the counts are taken once.
_MAIN_LF_ROWS = {}


def main_lf_rows(di, runs, mix: str, n_reads: int) -> dict:
    if (mix, n_reads) not in _MAIN_LF_ROWS:
        codes = torch.from_numpy(runs[mix][0][:n_reads]).to(di.device)
        ans = torch.from_numpy(runs[mix][1][:n_reads]).to(di.device)
        lengths = torch.full((n_reads,), READ_LEN, dtype=torch.int32, device=di.device)
        _MAIN_LF_ROWS[mix, n_reads] = lf_rows(di, codes, lengths, ans)
    return _MAIN_LF_ROWS[mix, n_reads]


def k14_bounds(rows_sample: dict, rows_full: dict, index, structure_bytes: int, n_sample: int,
               n_full: int):
    """K14's (bytes, operations) on the timed sample of n_sample reads, and
    as fields its counts, the whole batch's bound and counts (prefixed
    full_) and the codes-and-answers bounds of both."""
    moved, ops, work = lf_work(rows_sample, index, structure_bytes, n_sample, READ_LEN)
    fmoved, fops, fwork = lf_work(rows_full, index, structure_bytes, n_full, READ_LEN)
    return moved, ops, dict(work, full_batch_bound_ms=bound_ms(fmoved, fops),
                            **{f"full_{key}": v for key, v in fwork.items()})


def partial_work(lengths: torch.Tensor, matched: torch.Tensor, pos_bytes: int = 4):
    """partial_search: the codes a lane reads before it stops (its matched
    chars and, short of its length, the char that ended it) and the lengths
    in; l, r and the matched length out."""
    B = len(lengths)
    codes_read = int(torch.minimum(matched.long() + 1, lengths.long()).sum())
    return codes_read + 4 * B + B * (2 * pos_bytes + 4), B * LF_OPS


def seed_bits_work(precalc: torch.Tensor, out: torch.Tensor, p: int):
    """seed_bits: the whole precalc table in (a row's left bound shares its
    32-byte sector with its right one, so no load can take the left bounds
    alone), the packed bits out."""
    return nbytes(precalc, out), 4 ** (p + 1) * 4


def stats_work(out: torch.Tensor):
    """answer_stats: the answers read once, two int64 out; an add and a
    compare an answer."""
    return nbytes(out) + 16, 2 * out.numel()


def succ_work(structure_bytes: int, sgs_tbl, out):
    """succ1 over all columns: the structure and the marks read once, the
    successors written; four rank pairs a column."""
    return structure_bytes + nbytes(sgs_tbl, out), out.numel() * LF_OPS


def bound_ms(moved: int, ops: int) -> float:
    """The least time of the work: bytes over the HBM rate or operations
    over the peak rate, whichever is larger."""
    return max(moved / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def sample_reads(genome: np.ndarray, n_reads: int, seed: int, random_fraction: float):
    """int8 [n_reads, READ_LEN] windows of the genome, a fraction of them
    replaced by uniform random reads (bench.py sample_read_codes), and the
    bool mask of the genomic rows."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    n_rand = max(1, int(n_reads * random_fraction))
    rows = rng.choice(n_reads, size=n_rand, replace=False)
    codes[rows] = rng.integers(0, 4, size=(n_rand, READ_LEN), dtype=np.int8)
    genomic = np.ones(n_reads, dtype=bool)
    genomic[rows] = False
    return codes, genomic


def spiked_reads(genome: np.ndarray, n_reads: int, seed: int):
    """Genomic reads with lowercase spans, N and short lengths (padding -1)."""
    rng = np.random.default_rng(seed)
    codes, _ = sample_reads(genome, n_reads, seed, 0.25)
    codes[0::3, 20:31] |= 4  # lowercase: extends the chain, never seeds
    codes[1::4, rng.integers(0, READ_LEN, size=len(codes[1::4]))] = -1  # N
    lengths = np.full(n_reads, READ_LEN, dtype=np.int32)
    lengths[2::5] = rng.integers(0, READ_LEN, size=len(lengths[2::5]))
    codes[np.arange(READ_LEN)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def run_main_path(dev):
    """The user's path through the port's entry points; returns the index
    and the per-mix reads and answers."""
    from sbwt_tpu_torch.models.sbwt import SBWT

    genome = np.random.default_rng(GENOME_SEED).integers(
        0, 4, size=GENOME_BP, dtype=np.int8)
    t0 = time.perf_counter()
    sbwt = SBWT.build([genome], K, dev, precalc_k=PRECALC_K)
    torch.cuda.synchronize()
    n = sbwt.number_of_subsets()
    say("index", k=K, precalc_k=PRECALC_K, genome_bp=len(genome), n_columns=n,
        n_kmers=sbwt.number_of_kmers(), seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    check(sbwt.enable_turbo(arity=ARITY) == ARITY, "enable_turbo arity")
    torch.cuda.synchronize()
    turbo = sbwt._turbo
    say("turbo", arity=ARITY, tbl_shape=tuple(turbo.tbl.shape), tbl_bytes=turbo.tbl.numel() * 4,
        seed_bits_bytes=turbo.seed_bits.numel() * 4,
        seconds=round(time.perf_counter() - t0, 3))
    runs = {}
    for i, (mix, frac) in enumerate(MIXES.items()):
        codes, genomic = sample_reads(genome, N_READS, 2 + i, frac)
        t0 = time.perf_counter()
        ans = sbwt.streaming_search_batch(codes)
        seconds = time.perf_counter() - t0
        first = sbwt.search_batch(np.ascontiguousarray(codes[:, :K]))
        check(ans.shape == (N_READS, READ_LEN - K + 1) and ans.dtype == np.int32, f"{mix} shape")
        check(bool(((ans >= -1) & (ans < n)).all()), f"{mix}: answer outside [-1, n)")
        check(np.array_equal(first, ans[:, 0]), f"{mix}: search_batch != streaming position 0")
        hit = float((ans >= 0).mean())
        # every k-mer of a genomic read is in the index
        check(bool((ans[genomic] >= 0).all()), f"{mix}: a k-mer of the genome was not found")
        runs[mix] = (codes, ans)
        say("stream", mix=mix, reads=N_READS, answers=ans.size,
            checksum=int(ans.sum(dtype=np.int64)), hit_fraction=hit,
            host_seconds_with_copies=round(seconds, 4))
    check(float((runs["hit0"][1] >= 0).mean()) < 0.01, "hit0: random reads hit")
    check_stats_programs(sbwt._turbo, sbwt.device_index, runs, dev, "main path")
    return genome, sbwt, runs


def check_stats_programs(turbo, index, runs, dev, what: str):
    """The bench's form end to end (K4, then K13): ``_turbo_reduced_stats``
    of the hit98 batch and ``_turbo_with_stats`` of the hit0 batch, whose
    checksum, hits and answers must equal the batches' own."""
    from sbwt_tpu_torch.ops import turbo as tt

    lengths = torch.full((N_READS,), READ_LEN, dtype=torch.int32, device=dev)
    codes_np, ans_np = runs["hit98"]
    checksum, hits = tt._turbo_reduced_stats(turbo, index, torch.from_numpy(codes_np).to(dev),
                                             lengths)
    check(checksum.dtype == torch.int64 and hits.dtype == torch.int64, f"{what}: stats dtypes")
    check(int(checksum) == int(ans_np.sum(dtype=np.int64)) and int(hits) == int((ans_np >= 0).sum()),
          f"{what}: _turbo_reduced_stats of hit98 differs from its answers' checksum and hits")
    codes_np, ans_np = runs["hit0"]
    out, hits0 = tt._turbo_with_stats(turbo, index, torch.from_numpy(codes_np).to(dev), lengths)
    check(torch.equal(out.cpu().long(), torch.from_numpy(ans_np).long())
          and int(hits0) == int((ans_np >= 0).sum()),
          f"{what}: _turbo_with_stats of hit0 differs from its answers and hits")
    say("stats", path=what, hit98_checksum=int(checksum), hit98_hits=int(hits),
        hit0_hits=int(hits0))


def run_variants_path(sbwt, runs):
    """The LF engine on each of the ten variants, through the entry points:
    ``to_variant`` (carrying the p = 13 table), ``streaming_search_batch``
    of both whole batches, whose answers must equal K4's, ``search_batch``
    of the hit98 batch's first 30-mers, and the fill wrapper at p = 12 (the
    largest table a compressed variant fills itself). Returns variant ->
    (SBWT at p = 13, its p = 12 table)."""
    from sbwt_tpu_torch import kernels

    km = np.ascontiguousarray(runs["hit98"][0][:, :K])
    first = runs["hit98"][1][:, 0]
    out = {}
    for v in VARIANTS:
        t0 = time.perf_counter()
        vs = sbwt.to_variant(v)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(vs.variant == v and vs.get_precalc_k() == PRECALC_K, f"{v}: precalc not carried")
        fields = {}
        for mix, (codes, ans) in runs.items():
            t0 = time.perf_counter()
            got = vs.streaming_search_batch(codes)
            fields[f"{mix}_host_seconds"] = round(time.perf_counter() - t0, 4)
            check(np.array_equal(got, ans), f"{v} {mix}: LF answers differ from K4's")
            del got
        check(np.array_equal(vs.search_batch(km), first), f"{v}: search_batch != K4 position 0")
        di = vs.device_index
        out[v] = (vs, kernels.precalc_fill(v, di.kernel_desc(di.device), di.C, di.n_nodes,
                                           GENERIC_P))
        say("variant", name=v, structure_bytes=vs.structure_size_in_bytes(),
            device_structure_bytes=device_bytes(di),
            to_variant_seconds=round(build_s, 3), **fields)
    return out


def lane_batch(runs, seed: int = 31, width: int = 40):
    """1M lanes for partial_search and forward: the first ``width`` chars of
    the hit98 reads with lengths 0..width, and random nodes and chars."""
    rng = np.random.default_rng(seed)
    codes = np.ascontiguousarray(runs["hit98"][0][:, :width])
    lengths = rng.integers(0, width + 1, size=len(codes)).astype(np.int32)
    return codes, lengths, rng


def forward_lanes(runs, n: int):
    """The 1M (node, char) lanes of forward: random nodes of n and chars,
    drawn after lane_batch's lengths."""
    _, _, rng = lane_batch(runs)
    nodes = rng.integers(0, n, size=len(runs["hit98"][0]))
    return nodes, rng.integers(0, 4, size=len(nodes))


def run_variant_turbo_path(sbwt, runs, variants):
    """Turbo from each compressed variant's own ranks, through the entry
    points: ``enable_turbo(3)`` (succ1 of the variant's rank type, then
    compose), whose table must be byte-equal to plain-matrix's, and
    ``streaming_search_batch`` of both whole batches through K4 of that rank
    type, equal to plain-matrix's answers. One table (4.1 GB) at a time.
    ``partial_search_batch`` and ``forward_batch`` of 1M lanes on all ten
    variants, equal to plain-matrix's."""
    plain_tbl = sbwt._turbo.tbl
    codes, lengths, _ = lane_batch(runs)
    nodes, chars = forward_lanes(runs, sbwt.number_of_subsets())
    ref_partial = sbwt.partial_search_batch(codes, lengths)
    ref_forward = sbwt.forward_batch(nodes, chars)
    check(int(ref_partial[2].max()) > K and int((ref_partial[2] == lengths).sum()) > 0
          and int((ref_partial[2] < lengths).sum()) > 0, "partial_search: lanes all alike")
    check(0.2 < float((ref_forward >= 0).mean()) < 0.3, "forward: a quarter of the edges exist")
    for v, (vs, _) in variants.items():
        fields = {}
        if v != "plain-matrix":
            t0 = time.perf_counter()
            check(vs.enable_turbo(arity=ARITY) == ARITY, f"{v}: enable_turbo arity")
            torch.cuda.synchronize()
            fields["enable_turbo_seconds"] = round(time.perf_counter() - t0, 4)
            check(torch.equal(vs._turbo.tbl, plain_tbl),
                  f"{v}: turbo table differs from plain-matrix's")
            check(torch.equal(vs._turbo.seed_bits, sbwt._turbo.seed_bits), f"{v}: seed bits differ")
            for mix, (reads, ans) in runs.items():
                t0 = time.perf_counter()
                got = vs.streaming_search_batch(reads)
                fields[f"{mix}_host_seconds"] = round(time.perf_counter() - t0, 4)
                check(np.array_equal(got, ans), f"{v} {mix}: turbo answers differ from plain-matrix's")
                del got
            vs._turbo = None  # the next variant's table takes its place
            torch.cuda.empty_cache()
        got = vs.partial_search_batch(codes, lengths)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref_partial)),
              f"{v}: partial_search differs from plain-matrix's")
        check(np.array_equal(vs.forward_batch(nodes, chars), ref_forward),
              f"{v}: forward differs from plain-matrix's")
        say("variant_turbo", name=v, table="byte-equal" if fields else "main path's", **fields)
    return codes, lengths


def run_wide_turbo_path(dev, sbwt, runs, lanes):
    """The main path's 4M-column index forced onto the wide tier: the wide
    K1 fill at p = 13, wide K14 and, after ``enable_turbo``, wide K4 on both
    whole batches, int64 answers equal to the narrow ones. Returns the wide
    SBWT with its table."""
    from sbwt_tpu_torch.models.sbwt import SBWT
    from sbwt_tpu_torch.models.wide import WideMatrixIndex, from_packed_rows_wide
    from sbwt_tpu_torch.ops.turbo import WideTurboIndex

    di = sbwt.device_index
    n = di.n_nodes
    words = di.rank_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32).reshape(4, di.n_words)
    sgs_words = di.sgs_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32)
    t0 = time.perf_counter()
    wide = from_packed_rows_wide(words, n, sgs_words, K, di.n_kmers, dev, precalc_k=PRECALC_K)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(isinstance(wide, WideMatrixIndex) and wide.precalc.dtype == torch.int64
          and wide.C.dtype == torch.int64, "forced-wide index: types")
    check(torch.equal(wide.precalc, di.precalc.long()) and torch.equal(wide.C, di.C.long()),
          "forced-wide index: precalc or C differ from the narrow ones")
    wsb = SBWT(wide, sbwt._bits_packed, n, sbwt._sgs_packed)
    km = np.ascontiguousarray(runs["hit98"][0][:, :K])
    first = wsb.search_batch(km)
    check(first.dtype == np.int64 and np.array_equal(first, runs["hit98"][1][:, 0]),
          "forced-wide index: search_batch differs from the narrow one")
    fields = {}
    for engine in ("lf", "turbo"):
        if engine == "turbo":
            check(wsb.enable_turbo(arity=ARITY) == 1 and isinstance(wsb._turbo, WideTurboIndex)
                  and wsb._turbo.tbl.dtype == torch.int64 and tuple(wsb._turbo.tbl.shape) == (n, 4),
                  "forced-wide index: build_turbo did not give the arity-1 int64 table")
            # the first successors in the narrow arity-3 rows col * 64 + c * 16
            narrow1 = sbwt._turbo.tbl.view(n, 4, 16, 4)[:, :, 0, 0]
            check(torch.equal(wsb._turbo.tbl, narrow1.long()),
                  "forced-wide index: successor table differs from the narrow one")
            check(torch.equal(wsb._turbo.seed_bits, sbwt._turbo.seed_bits),
                  "forced-wide index: seed bits differ from the narrow ones")
        for mix, (reads, ans) in runs.items():
            t0 = time.perf_counter()
            got = wsb.streaming_search_batch(reads)
            fields[f"{engine}_{mix}_host_seconds"] = round(time.perf_counter() - t0, 4)
            check(got.dtype == np.int64 and np.array_equal(got, ans),
                  f"forced-wide index, {engine} {mix}: answers differ from the narrow K4's")
            del got
    check_stats_programs(wsb._turbo, wide, runs, dev, "forced-wide index")
    got = wsb.partial_search_batch(*lanes)
    check(all(np.array_equal(a, b) for a, b in zip(got, sbwt.partial_search_batch(*lanes))),
          "forced-wide index: partial_search differs from the narrow one")
    say("wide_turbo", n_columns=n, build_seconds_with_upload_and_precalc=round(seconds, 4),
        structure_bytes=wsb.structure_size_in_bytes(),
        table_bytes=nbytes(wsb._turbo.tbl), precalc_bytes=nbytes(wide.precalc), **fields)
    return wsb


def fast_search_batches(genome, runs):
    """The rows fast_search is given: the first k-mer of every read of each
    1M-read mix, and of the spiked batch (lowercase, N, padding: invalid
    rows), int8 on the card."""
    spiked, _ = spiked_reads(genome, 4096, 11)
    rows = {mix: codes[:, :K] for mix, (codes, _) in runs.items()}
    rows["spiked"] = spiked[:, :K]
    return rows


def check_fast_search(turbo, index, km, what: str):
    """fast_search of the int8 rows km through the entry point: both outputs
    against the plain version, and ans against K1's search where needs_slow
    is false. Returns (ans, needs_slow, the search's answers)."""
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    ans, slow = tt.fast_search(turbo, km)
    want = tt.fast_search_plain(turbo, km)
    check(ans.dtype == turbo.pos_dtype and torch.equal(ans, want[0]) and torch.equal(slow, want[1]),
          f"fast_search {what}: differs from its plain version")
    search = ts.search_batch(index, km)
    check(torch.equal(torch.where(slow, search.to(ans.dtype), ans), search.to(ans.dtype)),
          f"fast_search {what}: an answer without needs_slow differs from K1's search")
    return ans, slow, search


def run_kmer_access_path(dev, genome, sbwt, wsb, runs):
    """The facade's k-mer access through the entry points, on the main
    path's index: ``ops.turbo.fast_search`` over the arity-3 table, over
    narrow tables of arity 1 and 2 built for the phase, and over the
    forced-wide index's int64 table; ``compute_dummy_node_marks`` (one
    succ1 launch a BFS level); ``reconstruct_all_kmers``, ``get_kmers_batch``
    of SAMPLED_COLUMNS columns, ``get_kmer_fast`` of FAST_COLUMNS of them,
    and ``get_kmer`` searched back to its column."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.ops import turbo as tt

    di = sbwt.device_index
    rows = {name: torch.from_numpy(np.ascontiguousarray(r)).to(dev)
            for name, r in fast_search_batches(genome, runs).items()}
    narrow = {ARITY: sbwt._turbo}
    for arity in (1, 2):
        narrow[arity] = tt.build_turbo(di, arity)
    # the compose at arity 1 is the transpose of succ: one PyTorch call
    # computes it, timed beside the kernel as its yardstick (the port never
    # calls it)
    succ = tt.succ1(di)
    k_c1 = lambda: kernels.succ_compose(succ, 1)  # noqa: E731
    lib_c1 = lambda: succ.t().contiguous()  # noqa: E731
    check(torch.equal(k_c1(), lib_c1()) and torch.equal(narrow[1].tbl, lib_c1()),
          "succ_compose at arity 1 differs from the transpose of succ")
    say("kernel", name="succ_compose", arity=1, shape=tuple(narrow[1].tbl.shape),
        ms=cuda_ms(k_c1, 5), library_ms=cuda_ms(lib_c1, 5),
        bound_ms=bound_ms(2 * nbytes(succ), 0), card=repr(nvidia_smi_line()))
    del succ
    for name, km in rows.items():
        ref = None
        for arity in (ARITY, 1, 2):
            ans, slow, search = check_fast_search(narrow[arity], di, km, f"{name} arity {arity}")
            if ref is None:
                ref = (ans, slow)
                hit = float((search >= 0).float().mean())
                slow_share = float(slow.float().mean())
                say("kmer_access", call="fast_search", batch=name, rows=len(km),
                    needs_slow_share=slow_share, hit_fraction=hit,
                    fast_hit_fraction=float((ans >= 0).float().mean()))
                if name == "hit98":
                    check(slow_share < 0.15 and 0.97 < hit < 0.99,
                          f"fast_search hit98: needs_slow share {slow_share}, hit fraction {hit}")
            check(torch.equal(ans, ref[0]) and torch.equal(slow, ref[1]),
                  f"fast_search {name}: arity {arity} differs from arity {ARITY}")
        ans, slow, _ = check_fast_search(wsb._turbo, wsb.device_index, km, f"{name} wide")
        check(torch.equal(ans, ref[0].long()) and torch.equal(slow, ref[1]),
              f"fast_search {name}: the wide table differs from the narrow one")
    del narrow

    n, k = sbwt.number_of_subsets(), sbwt.k
    fields = {}
    before = kernels.LAUNCHES["succ1[plain-matrix]"]
    t0 = time.perf_counter()
    marks = sbwt.compute_dummy_node_marks()
    fields["dummy_marks_seconds"] = round(time.perf_counter() - t0, 4)
    levels = kernels.LAUNCHES["succ1[plain-matrix]"] - before
    check(int(marks.sum()) == n - sbwt.number_of_kmers(),
          f"compute_dummy_node_marks: {int(marks.sum())} marks, {n - sbwt.number_of_kmers()} dummies")
    check(1 <= levels <= k - 1, f"compute_dummy_node_marks: {levels} succ1 launches")
    t0 = time.perf_counter()
    dump = sbwt.reconstruct_all_kmers()
    fields["reconstruct_seconds"] = round(time.perf_counter() - t0, 4)
    labels = np.frombuffer(dump.encode("ascii"), dtype=np.uint8).reshape(n, k)
    check(np.array_equal(marks, labels[:, 0] == ord("$")),
          "compute_dummy_node_marks: marks differ from the labels that start with $")
    cols = np.random.default_rng(7).integers(0, n, size=SAMPLED_COLUMNS)
    cols[:4] = [0, 1, n - 1, int(np.flatnonzero(marks)[-1])]
    t0 = time.perf_counter()
    batch = sbwt.get_kmers_batch(cols)
    fields["get_kmers_batch_seconds"] = round(time.perf_counter() - t0, 4)
    got = np.frombuffer("".join(batch).encode("ascii"), dtype=np.uint8).reshape(len(cols), k)
    check(np.array_equal(got, labels[cols]), "get_kmers_batch differs from reconstruct_all_kmers")
    ss = sbwt.select_support()
    t0 = time.perf_counter()
    one_by_one = [sbwt.get_kmer_fast(int(c), ss) for c in cols[:FAST_COLUMNS]]
    fields["get_kmer_fast_seconds"] = round(time.perf_counter() - t0, 4)
    check(one_by_one == batch[:FAST_COLUMNS], "get_kmer_fast differs from get_kmers_batch")
    check(all(sbwt.get_kmer(int(c)) == batch[i] for i, c in enumerate(cols[:8])),
          "get_kmer differs from get_kmers_batch")
    # every sampled full k-mer searches back to its column (A, C, G, T -> 0..3)
    full = ~marks[cols]
    lut = np.full(256, -1, dtype=np.int8)
    lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)
    t0 = time.perf_counter()
    back = sbwt.search_batch(lut[got[full]])
    fields["round_trip_search_seconds"] = round(time.perf_counter() - t0, 4)
    check(np.array_equal(back, cols[full]), "search of get_kmer's label is not its column")
    say("kmer_access", n_columns=n, dummies=int(marks.sum()), bfs_levels=levels,
        sampled_columns=len(cols), full_kmers_searched_back=int(full.sum()), **fields)


def complete_dbg_packed(order: int):
    """The SBWT of the complete de Bruijn graph of that order, byte-packed:
    columns are the root and all 4^order k-mers in colex order. Suffix groups
    are runs of 4 (k-mers that differ in their first char only), and only
    each group's first column carries its four out-edges: k-mer indices
    m % 4 == 0, columns j % 4 == 1, the byte 0x22 in every row. The last
    byte holds only the last column (j % 4 == 0). Returns (rows [4, nb],
    suffix-group starts [nb], columns, k-mers)."""
    n_kmers = 4**order
    n = n_kmers + 1
    row = np.full((n + 7) // 8, 0x22, dtype=np.uint8)
    row[-1] = 0
    sgs = row.copy()
    sgs[0] = 0x23  # the root column is always marked
    return np.stack([row] * 4), sgs, n, n_kmers


def check_dbg_pattern(order: int = 8) -> None:
    """The packed pattern against the host constructor on all 4^order k-mers."""
    from sbwt_tpu_torch.construct.inmemory import build_from_kmers
    from sbwt_tpu_torch.utils import kmers as km

    vals = np.arange(4**order)
    codes = ((vals[:, None] >> (2 * np.arange(order))) & 3).astype(np.int8)
    packed = np.array([km.pack_kmer(row) for row in codes], dtype=np.uint64)
    built = build_from_kmers(np.unique(packed), order)
    rows, sgs, n, _ = complete_dbg_packed(order)
    check(built.bits.shape == (4, n), "order-8 pattern: column count")
    check(np.array_equal(np.packbits(built.bits, axis=1, bitorder="little"), rows)
          and np.array_equal(np.packbits(built.suffix_group_starts, bitorder="little"), sgs),
          "order-8 pattern differs from the host constructor's index")
    say("wide_giant", pattern=f"order {order} equals the host constructor's index")


def dbg_oracle(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Column of every k-window of codes [B, L] in the complete graph:
    1 + sum_i code_i * 4^i, or -1 where the window holds a code < 0."""
    P = codes.shape[1] - k + 1
    col = torch.ones((codes.shape[0], P), dtype=torch.int64, device=codes.device)
    bad = torch.zeros_like(col, dtype=torch.bool)
    for i in range(k):
        c = codes[:, i : i + P].long()
        bad |= c < 0
        col += c.clamp(min=0) << (2 * i)
    return torch.where(bad, -1, col)


def giant_batches(dev):
    """The giant's queries, made from a seed: 1M reads of 100 bp, the same
    with an N every 20-40 bases, and 1M prefix lengths 1..16."""
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, size=(N_READS, READ_LEN), dtype=np.int8)
    reads[0, :] = 0  # AAAA...: column 1
    reads[1, :] = 3  # TTTT...: the last column
    with_n = reads.copy()
    pos = np.cumsum(rng.integers(20, 41, size=(N_READS, READ_LEN // 20)), axis=1) - 10
    rows = np.broadcast_to(np.arange(N_READS)[:, None], pos.shape)
    keep = pos < READ_LEN
    with_n[rows[keep], pos[keep]] = -1
    prefix_len = rng.integers(1, GIANT_K + 1, size=N_READS).astype(np.int32)
    return reads, with_n, prefix_len


def run_wide_giant_path(dev):
    """The slice's path at full width: the complete order-16 de Bruijn
    graph, 4^16 + 1 columns, through ``SBWT.from_packed``, every answer held
    to the closed form. Returns the SBWT and the query batches."""
    from sbwt_tpu_torch.models import wide
    from sbwt_tpu_torch.models.sbwt import SBWT
    from sbwt_tpu_torch.models.wide import WideMatrixIndex
    from sbwt_tpu_torch.ops import bitvector

    check_dbg_pattern()
    t0 = time.perf_counter()
    rows, sgs, n, n_kmers = complete_dbg_packed(GIANT_K)
    pattern_s = time.perf_counter() - t0
    check(n == 4_294_967_297, "giant: column count")
    t0 = time.perf_counter()
    with host_seconds((bitvector, "rank_table_from_words_wide"), (wide, "sgs_pair_table"),
                      (wide, "c_array_from_rows")) as tables_s:
        sb = SBWT.from_packed(rows, n, sgs, GIANT_K, n_kmers, dev, precalc_k=GIANT_P)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del rows, sgs
    di = sb.device_index
    check(isinstance(di, WideMatrixIndex), f"giant: from_packed gave a {type(di).__name__}")
    C = sb.C
    check(C.tolist() == [1 + c * (n_kmers // 4) for c in range(4)] and int(C[3]) > 2**31,
          f"giant: C = {C.tolist()}")
    say("wide_giant", n_columns=n, k=GIANT_K, precalc_k=GIANT_P, n_words=di.n_words,
        rank_tbl_bytes=nbytes(di.rank_tbl), sgs_tbl_bytes=nbytes(di.sgs_tbl),
        structure_bytes=sb.structure_size_in_bytes(), pattern_seconds=round(pattern_s, 3),
        from_packed_seconds=round(seconds, 3),
        host_tables_seconds=round(tables_s[0], 3),
        repack_upload_fill_seconds=round(seconds - tables_s[0], 3))

    reads, with_n, prefix_len = giant_batches(dev)
    pows = 4 ** np.arange(GIANT_K, dtype=np.int64)
    kmers = np.ascontiguousarray(reads[:, :GIANT_K])
    want = 1 + (kmers.astype(np.int64) * pows).sum(axis=1)
    t0 = time.perf_counter()
    got = sb.search_batch(kmers)
    fields = {"search_host_seconds": round(time.perf_counter() - t0, 4)}
    check(got.dtype == np.int64 and np.array_equal(got, want), "giant: search_batch != oracle")
    check(int(got[0]) == 1 and int(got[1]) == n - 1 and int(got.max()) > 2**31,
          "giant: AAAA, TTTT or no answer over 2^31")
    over = int((got >= 2**31).sum())
    for name, batch in (("reads", reads), ("reads_with_n", with_n)):
        oracle = dbg_oracle(torch.from_numpy(batch).to(dev), GIANT_K).cpu().numpy()
        t0 = time.perf_counter()
        ans = sb.streaming_search_batch(batch)
        fields[f"{name}_host_seconds"] = round(time.perf_counter() - t0, 4)
        check(ans.dtype == np.int64 and ans.shape == (N_READS, READ_LEN - GIANT_K + 1),
              f"giant {name}: shape or type")
        check(np.array_equal(ans, oracle), f"giant {name}: streaming answers != oracle")
        fields[f"{name}_hit_fraction"] = float((ans >= 0).mean())
        fields[f"{name}_checksum"] = int(ans.sum(dtype=np.int64))
        del ans, oracle
    check(fields["reads_hit_fraction"] == 1.0 and 0.3 < fields["reads_with_n_hit_fraction"] < 0.7,
          f"giant: hit fractions {fields}")

    # partial search of a prefix of m chars: the columns of all k-mers that end with it
    l, r, m = sb.partial_search_batch(kmers, prefix_len)
    idx = np.arange(GIANT_K)[None, :]
    shift = 2 * (GIANT_K - prefix_len[:, None] + idx)
    lo = 1 + np.where(idx < prefix_len[:, None], kmers.astype(np.int64) << shift, 0).sum(axis=1)
    check(np.array_equal(m, prefix_len) and np.array_equal(l, lo)
          and np.array_equal(r, lo + 4 ** (GIANT_K - prefix_len.astype(np.int64)) - 1),
          "giant: partial_search != closed form")
    # forward: column(x) by c is column(x[1:] + c)
    chars = np.random.default_rng(5).integers(0, 4, size=N_READS)
    nxt = sb.forward_batch(want, chars)
    succ = np.concatenate([kmers[:, 1:], chars[:, None].astype(np.int8)], axis=1)
    check(nxt.dtype == np.int64 and np.array_equal(nxt, 1 + (succ.astype(np.int64) * pows).sum(axis=1)),
          "giant: forward != closed form")
    first = 1 + int((np.array([0, 1, 2, 3, 0]) * pows[GIANT_K - 5 :]).sum())
    check(sb.partial_search("ACGTA") == ((first, first + 4 ** (GIANT_K - 5) - 1), 5)
          and sb.forward(1, "T") == 1 + 3 * 4 ** (GIANT_K - 1),
          "giant: partial_search or forward of one string")
    # a table would take 32 B a column, 137 GB: auto must leave the LF engine
    check(sb.enable_turbo(None) is None and sb._turbo is None, "giant: enable_turbo found room")
    check(np.array_equal(sb.streaming_search_batch(reads[:4096]),
                         dbg_oracle(torch.from_numpy(reads[:4096]), GIANT_K).numpy()),
          "giant: answers after enable_turbo(None)")
    say("wide_giant", queries="1M 16-mers, 2 x 1M reads of 100 bp, 1M prefixes, 1M edges: all equal "
        "the closed form", answers_over_2_31=over, **fields)
    return sb, reads, with_n, prefix_len


def check_same_index(got, want, what: str) -> None:
    """Two SBWT objects hold the same index: tables, counts, host rows."""
    a, b = got.device_index, want.device_index
    check((a.n_nodes, a.n_kmers, a.n_words, a.k, a.precalc_k, a.has_streaming)
          == (b.n_nodes, b.n_kmers, b.n_words, b.k, b.precalc_k, b.has_streaming),
          f"{what}: counts differ")
    for field in ("rank_tbl", "sgs_tbl", "C", "precalc"):
        err = max_abs_err(getattr(a, field), getattr(b, field))
        check(err == 0, f"{what}: {field} differs from the host build (max_abs_err {err})")
    check(np.array_equal(got._bits_packed, want._bits_packed)
          and np.array_equal(got._sgs_packed, want._sgs_packed), f"{what}: host rows differ")


def run_device_build_path(dev, genome, sbwt, runs):
    """K19 through ``SBWT.build_on_device``: the genome, held to the main
    path's host-built index and its turbo answers, then the first
    BUILD_READS reads of the hit98 batch as separate sequences, held to
    the host build of the same reads."""
    from sbwt_tpu_torch.models.sbwt import SBWT

    t0 = time.perf_counter()
    on_dev = SBWT.build_on_device([genome], K, dev, precalc_k=PRECALC_K)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_same_index(on_dev, sbwt, "device build of the genome")
    check(on_dev.enable_turbo(arity=ARITY) == ARITY, "device build: enable_turbo arity")
    codes, want = runs["hit98"]
    ans = on_dev.streaming_search_batch(codes)
    check(np.array_equal(ans, want), "device build: turbo answers differ from the host build's")
    del on_dev
    # the same call again: without PyTorch's first use of its sort and scan kernels
    t0 = time.perf_counter()
    again = SBWT.build_on_device([genome], K, dev, precalc_k=PRECALC_K)
    torch.cuda.synchronize()
    again_seconds = time.perf_counter() - t0
    check_same_index(again, sbwt, "second device build of the genome")
    say("device_build", input="genome", bp=len(genome), n_columns=again.number_of_subsets(),
        n_kmers=again.number_of_kmers(), max_abs_err=0, checksum=int(ans.sum(dtype=np.int64)),
        seconds_with_upload_and_precalc=round(seconds, 4),
        second_call_seconds=round(again_seconds, 4))
    del again, ans

    reads = list(codes[:BUILD_READS])
    t0 = time.perf_counter()
    on_dev = SBWT.build_on_device(reads, K, dev, precalc_k=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = SBWT.build(reads, K, dev, precalc_k=8, method="memory")
    torch.cuda.synchronize()
    host_seconds = time.perf_counter() - t0
    check_same_index(on_dev, host, "device build of the reads")
    sample = codes[BUILD_READS : BUILD_READS + 4096]
    check(np.array_equal(on_dev.streaming_search_batch(sample),
                         host.streaming_search_batch(sample)), "device build of the reads: answers")
    say("device_build", input="reads", reads=len(reads), n_columns=on_dev.number_of_subsets(),
        n_kmers=on_dev.number_of_kmers(),
        dummies=on_dev.number_of_subsets() - on_dev.number_of_kmers(), max_abs_err=0,
        seconds_with_upload_and_precalc=round(seconds, 4), host_build_seconds=round(host_seconds, 4))


def profile_build(dev, codes):
    """Device time of one genome build by kind of kernel, from torch.profiler
    (a measurement only: it is skipped with a note if the profiler fails)."""
    from torch.profiler import ProfilerActivity, profile

    from sbwt_tpu_torch.construct import device as td

    kinds = {"kernels": ("pack_windows", "edge_src_probe", "emit_dummies", "finalize_tables"),
             "sorts": ("sort", "radix", "merge"), "scans": ("scan", "cumsum"),
             "compaction": ("index", "nonzero", "select", "masked", "gather", "scatter"),
             "copies": ("memcpy", "memset")}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            td.build_sbwt_device(None, K, dev, prepared=codes)
            torch.cuda.synchronize()
        split = dict.fromkeys([*kinds, "elementwise_and_other"], 0.0)
        top = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            low = ev.key.lower()
            kind = next((k for k, words in kinds.items() if any(w in low for w in words)),
                        "elementwise_and_other")
            split[kind] += us / 1e3
            top.append((us / 1e3, ev.count, ev.key[:80]))
        say("build_profile", device_ms_total=round(sum(split.values()), 4),
            **{f"{k}_ms": round(v, 4) for k, v in split.items()})
        for ms, count, key in sorted(top, reverse=True)[:12]:
            print(f"  profiler: {ms:.4f} ms in {count} launches of {key}")
    except Exception as e:  # the trace is not part of the check
        say("build_profile", unavailable=repr(e)[:200])


def radix_sort_bytes(rows: int, columns: int) -> int:
    """The compulsory bytes of ``columns`` stable radix sorts of int64 keys
    with int64 indices over ``rows`` rows (colex_order: one sort a column):
    8 passes of 8-bit digits, each reading and writing every 16-byte
    (key, index) pair, after one histogram read of the keys."""
    return columns * rows * (8 + 8 * 2 * 16)


def searchsorted_probe(dv: torch.Tensor, k: int):
    """The PyTorch yardstick of edge_src_probe for W <= 2: each k-mer's
    (k-1)-prefix (pred) and each key with its first char cleared, packed as
    one int64 with the sign bit flipped so that signed order is the
    unsigned word order; then the lower bound of every pred by
    ``torch.searchsorted`` in the masked list and the equality gather.
    Returns the timed call (packing excluded) and its answer: bool [n],
    whether each k-mer has a predecessor."""
    from sbwt_tpu_torch.construct import device as td
    from sbwt_tpu_torch.ops import bitvector as bv

    n, W = dv.shape
    if W > 2:
        raise ValueError(f"searchsorted_probe: {W} key words do not fit one int64")
    u = bv.word_u32(dv)
    pred = (u << 2) & 0xFFFFFFFF
    pred[:, :-1] |= u[:, 1:] >> 30

    def pack(words):
        low = words[:, 1] if W == 2 else torch.zeros_like(words[:, 0])
        return ((words[:, 0] << 32) | low) ^ (-(1 << 63))

    masked, queries = pack(td._drop_first(u, k)), pack(pred)

    def call():
        lb = torch.searchsorted(masked, queries)
        return (lb < n) & (masked[lb.clamp(max=n - 1)] == queries)

    return call, call()


def build_registers(regs: list, kernel: str, W: int) -> dict:
    """Registers and spill bytes of the instance of a K19 kernel that W key
    words take (its word capacity: 2, 4 or 16)."""
    wmax = 2 if W <= 2 else 4 if W <= 4 else 16
    found = [(r, s) for entry, r, s in regs if re.search(rf"{kernel}_kernelILi{wmax}E", entry)]
    check(len(found) == 1, f"{kernel}<{wmax}>: {len(found)} entry points in the ptxas log")
    return {"registers": found[0][0], "spill_bytes": found[0][1]}


def compare_build_kernels(dev, genome, record, card, regs):
    """K19's four kernels against their plain versions at the genome
    build's shapes, the build's sorts timed alone, and the whole build's
    wall time with the codes already on the card."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.construct import device as td

    W = kernels.key_words(K)
    codes = td.prepare_device_codes([genome], K, dev)
    keys, valid = kernels.pack_windows(codes, K)
    plain = td.pack_windows_plain(codes, K)
    record("pack_windows", max_abs_err(keys, plain[0]) + max_abs_err(valid, plain[1]),
           cuda_ms(lambda: kernels.pack_windows(codes, K), 5),
           cuda_ms(lambda: td.pack_windows_plain(codes, K), 1),
           nbytes(codes, keys, valid), keys.shape[0] * K * 4, shape=tuple(keys.shape),
           **build_registers(regs, "pack_windows", W))
    # the same kernel over the genome at 4 and 16 key words
    for k in WIDE_PACK_K:
        codes_k = td.prepare_device_codes([genome], k, dev)
        got, plain_k = kernels.pack_windows(codes_k, k), td.pack_windows_plain(codes_k, k)
        err = max_abs_err(got[0], plain_k[0]) + max_abs_err(got[1], plain_k[1])
        check(err == 0, f"pack_windows at k = {k}: kernel differs from its plain version")
        moved = nbytes(codes_k, *got)
        say("kernel", name="pack_windows", k=k, shape=tuple(got[0].shape), max_abs_err=err,
            ms=cuda_ms(lambda: kernels.pack_windows(codes_k, k), 5),
            plain_ms=cuda_ms(lambda: td.pack_windows_plain(codes_k, k), 1),
            bound_ms=bound_ms(moved, 0), bound_by="bytes", bytes_moved=moved, card=repr(card),
            **build_registers(regs, "pack_windows", kernels.key_words(k)))
        del codes_k, got, plain_k
    valid_keys = keys[valid]
    sort_kmers_ms = cuda_ms(lambda: td.colex_order(valid_keys), 3)
    sort_kmers_bound_ms = radix_sort_bytes(valid_keys.shape[0], -(-W // 2)) / HBM_BYTES_PER_S * 1e3
    del keys, valid, plain

    dv = td.sorted_distinct_kmers(codes, K)
    n = dv.shape[0]
    probe = kernels.edge_src_probe(dv, K)
    plain = td.edge_src_probe_plain(dv, K)
    groups = int(probe[1].sum())
    library, has_pred = searchsorted_probe(dv, K)
    check(torch.equal(has_pred, ~probe[2]), "edge_src_probe: sources differ from torch.searchsorted's")
    # bound: the keys read once and three bytes a k-mer written; operations,
    # one W-word compare a merge step (four runs of the n list keys, and the
    # n queries). Beside it, the operations of the binary searches the merge
    # replaced: ceil(log2 n) steps of W word compares, four a group start
    # and one a k-mer.
    record("edge_src_probe", sum(max_abs_err(a, b) for a, b in zip(probe, plain)),
           cuda_ms(lambda: kernels.edge_src_probe(dv, K), 5),
           cuda_ms(lambda: td.edge_src_probe_plain(dv, K), 1),
           nbytes(dv, *probe), 5 * n * W, library_ms=cuda_ms(library, 5),
           shape=tuple(dv.shape), group_starts=groups, sources=int(probe[2].sum()),
           binary_search_ops_bound_ms=bound_ms(0, (4 * groups + n) * n.bit_length() * 4 * W),
           library="torch.searchsorted of the sign-flipped int64 keys, and the equality gather")
    src = dv[probe[2]]
    del plain

    dummies = kernels.emit_dummies(src, K)
    plain = td.emit_dummies_plain(src, K)
    record("emit_dummies", sum(max_abs_err(a, b) for a, b in zip(dummies, plain)),
           cuda_ms(lambda: kernels.emit_dummies(src, K), 5),
           cuda_ms(lambda: td.emit_dummies_plain(src, K), 1),
           nbytes(src, *dummies), dummies[0].shape[0] * 4 * W, shape=tuple(dummies[0].shape))
    # the same kernel where it has work: one source a row of 2^18 k-mers
    many = dv[:: max(1, n >> 18)].contiguous()
    plain, plain_ms = timed_ms(lambda: td.emit_dummies_plain(many, K))
    got = kernels.emit_dummies(many, K)
    err = sum(max_abs_err(a, b) for a, b in zip(got, plain))
    check(err == 0, "emit_dummies on many sources: kernel differs from its plain version")
    say("kernel", name="emit_dummies", shape=tuple(got[0].shape), max_abs_err=err,
        ms=cuda_ms(lambda: kernels.emit_dummies(many, K), 5), plain_ms=plain_ms,
        bound_ms=nbytes(many, *got) / HBM_BYTES_PER_S * 1e3)
    del many, got, plain

    nodes = td.merged_nodes(td.dummy_nodes(src, K), dv, probe[0], K)
    sort_nodes_ms = cuda_ms(lambda: td.colex_order(nodes[0], nodes[1]), 3)
    sort_nodes_bound_ms = radix_sort_bytes(nodes[0].shape[0], -(-W // 2) + 1) / HBM_BYTES_PER_S * 1e3
    tables = kernels.finalize_tables(*nodes, K, True)
    plain = td.finalize_tables_plain(*nodes, K, True)
    record("finalize_tables", sum(max_abs_err(a, b) for a, b in zip(tables, plain)),
           cuda_ms(lambda: kernels.finalize_tables(*nodes, K, True), 5),
           cuda_ms(lambda: td.finalize_tables_plain(*nodes, K, True), 1),
           nbytes(*nodes, *tables), nodes[0].shape[0] * 4 * W, shape=tuple(nodes[0].shape),
           **build_registers(regs, "finalize_tables", W))
    del nodes, tables, plain, dv, probe, src, dummies, valid_keys

    def build():
        td.build_sbwt_device(None, K, dev, prepared=codes)

    build()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    say("build_time", input="genome, codes on the card, no precalc", wall_ms=[round(w * 1e3, 3) for w in walls],
        device_ms=cuda_ms(build, 3), sort_kmers_ms=sort_kmers_ms, sort_nodes_ms=sort_nodes_ms,
        sort_kmers_radix_bound_ms=sort_kmers_bound_ms, sort_nodes_radix_bound_ms=sort_nodes_bound_ms)
    profile_build(dev, codes)


def recorder(launches: dict, card: str, regs: list):
    """The per-kernel results of the JSON line, and the function that checks
    and adds one; the search kernels' lines carry their registers (regs:
    ptxas_lines of the build)."""
    results = {}

    def record(name, err, ms, plain_ms, moved, ops, library_ms=None, **extra):
        """moved: the bytes the function must move at this shape (each input
        read once, each output written once; of a table read at random, the
        rows this run's data asks for). ops: its integer operations, counted
        from the shape. library_ms: the time of the PyTorch call that
        computes the same function, where there is one, else null."""
        check(err == 0, f"{name}: kernel differs from its plain version (max_abs_err {err})")
        src, replaces = ALL_KERNELS[name]
        results[name] = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": launches[name], "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(moved, ops),
                         "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / ALU_OPS_PER_S
                         else "operations",
                         "library_ms": library_ms}
        if carries_registers(name):
            extra = {**instance_registers(regs, name), **extra}
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=results[name]["bound_ms"], bound_by=results[name]["bound_by"],
            library_ms=library_ms, bytes_moved=moved, card=repr(card), **extra)

    return results, record


SMALL_P = (1, 5)  # precalc lengths of the fresh fills that seed_bits is also held at


def small_p_seed_bits_err(index, dev) -> int:
    """seed_bits of the index's own fill at each small p against its plain
    version: p = 1 packs 4 rows into one word, p = 5 fills 32 bitmap words
    of which a warp's chunk (256 narrow rows, 128 wide) is cut short."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.ops import turbo as tt

    err = 0
    for p in SMALL_P:
        pre = kernels.precalc_fill(index.variant, index.kernel_desc(dev), index.C, index.n_nodes, p)
        err += max_abs_err(kernels.seed_bits(pre, p), tt.seed_bits_plain(pre, p))
    return err


def compare_answer_stats(name, out, checksum: int, hits: int, mix: str, record):
    """K13 on one batch's answers: against its plain version and the
    batch's own checksum and hits, exactly, and timed beside the two
    PyTorch calls that compute it (its library time). ``record`` is None
    for a batch that is checked and printed only."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.ops import turbo as tt

    got = kernels.answer_stats(out)
    err = max_abs_err(got, tt.answer_stats_plain(out))
    check(err == 0 and got.tolist() == [checksum, hits],
          f"{name} {mix}: {got.tolist()}, expected [{checksum}, {hits}] (max_abs_err {err})")
    ms = cuda_ms(lambda: kernels.answer_stats(out), 5)
    sum_ms = cuda_ms(lambda: torch.sum(out, dtype=torch.int64), 5)
    hits_ms = cuda_ms(lambda: (out >= 0).sum(), 5)
    plain_ms = cuda_ms(lambda: tt.answer_stats_plain(out), 5)
    moved, ops = stats_work(out)
    extra = dict(mix=mix, shape=tuple(out.shape), dtype=str(out.dtype), checksum=checksum,
                 hits=hits, library_sum_ms=sum_ms, library_hits_ms=hits_ms)
    if record is not None:
        record(name, err, ms, plain_ms, moved, ops, library_ms=sum_ms + hits_ms, **extra)
    else:
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms(moved, ops), library_ms=sum_ms + hits_ms, **extra)


def compare_kernels(dev, genome, sbwt, runs, record, card):
    """Each kernel of the main path against its plain version on the main
    path's shapes."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.models import matrix as tm
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    di, turbo = sbwt.device_index, sbwt._turbo
    p = di.precalc_k
    desc = di.kernel_desc(dev)
    k_pre = lambda: kernels.precalc_fill("plain-matrix", desc, di.C, di.n_nodes, p)
    plain = tm.precalc_fill_plain(di, p)
    record("precalc_fill[plain-matrix]", max_abs_err(k_pre(), plain) + max_abs_err(di.precalc, plain),
           cuda_ms(k_pre, 3), cuda_ms(lambda: tm.precalc_fill_plain(di, p), 1),
           *fill_work(di.size_in_bytes(), p), shape=tuple(plain.shape))
    del plain

    km = torch.from_numpy(np.ascontiguousarray(runs["hit98"][0][:, :K])).to(dev)
    km0 = torch.from_numpy(np.ascontiguousarray(runs["hit0"][0][:, :K])).to(dev)
    k_km = lambda: ts.search_batch(di, km)
    record("kmer_search[plain-matrix]", max_abs_err(k_km(), ts.search_batch_plain(di, km))
           + max_abs_err(ts.search_batch(di, km0), ts.search_batch_plain(di, km0)),
           cuda_ms(k_km, 5), cuda_ms(lambda: ts.search_batch_plain(di, km), 1),
           *search_work(di.size_in_bytes(), *km.shape), shape=tuple(km.shape),
           hit0_ms=cuda_ms(lambda: ts.search_batch(di, km0), 5))

    k_s1 = lambda: tt.succ1(di)
    succ = k_s1()
    record("succ1", max_abs_err(succ, tt.succ1_plain(di)), cuda_ms(k_s1, 5),
           cuda_ms(lambda: tt.succ1_plain(di), 1), nbytes(di.rank_tbl, di.sgs_tbl, succ),
           succ.numel() * LF_OPS, shape=tuple(succ.shape))

    err = max_abs_err(turbo.tbl, tt.compose_plain(succ, ARITY))
    plain_ms = cuda_ms(lambda: tt.compose_plain(succ, ARITY), 1)
    record("succ_compose", err, cuda_ms(lambda: kernels.succ_compose(succ, ARITY), 3), plain_ms,
           nbytes(succ, turbo.tbl), turbo.tbl.numel(), shape=tuple(turbo.tbl.shape))
    del succ

    k_sb = lambda: kernels.seed_bits(di.precalc, p)
    record("seed_bits", max_abs_err(turbo.seed_bits, tt.seed_bits_plain(di.precalc, p))
           + max_abs_err(k_sb(), turbo.seed_bits) + small_p_seed_bits_err(di, dev),
           cuda_ms(k_sb, 5), cuda_ms(lambda: tt.seed_bits_plain(di.precalc, p), 1),
           *seed_bits_work(di.precalc, turbo.seed_bits, p), shape=tuple(turbo.seed_bits.shape),
           small_p=SMALL_P)

    n_answers = None
    for mix, (codes_np, ans_np) in runs.items():
        codes = torch.from_numpy(codes_np).to(dev)
        lengths = torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev)
        stream = lambda: tt.turbo_streaming_search(turbo, di, codes, lengths)
        out = stream()
        check(torch.equal(out.cpu(), torch.from_numpy(ans_np)), f"{mix}: rerun differs")
        checksum = int(torch.sum(out, dtype=torch.int64).item())
        check(checksum == int(ans_np.sum(dtype=np.int64)), f"{mix}: checksum")
        # K13, the checksum and hit-count reductions, beside PyTorch's two calls
        compare_answer_stats("answer_stats", out, checksum, int((ans_np >= 0).sum()), mix,
                             record if mix == "hit98" else None)
        # the plain version on the whole batch; its one run is also its time
        plain, plain_ms = timed_ms(
            lambda: tt.turbo_streaming_search_plain(turbo, di, codes, lengths))
        err = max_abs_err(out, plain)
        moved, ops, work = turbo_work(turbo, di, codes, lengths, out)
        del out, plain
        ms = cuda_ms(stream, 5)
        n_answers = ans_np.size
        extra = dict(mix=mix, reads=len(codes_np), checksum=checksum,
                     hit_fraction=float((ans_np >= 0).mean()),
                     answers_per_s=n_answers / (ms / 1e3),
                     plain_answers_per_s=n_answers / (plain_ms / 1e3),
                     smem_per_block=kernels.turbo_smem_bytes(K, ARITY), **work)
        if mix == "hit98":
            record("turbo_stream", err, ms, plain_ms, moved, ops, **extra)
        else:
            check(err == 0, f"turbo_stream {mix}: kernel differs from its plain version")
            say("kernel", name="turbo_stream", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(moved, ops), **extra)
        del codes, lengths

    codes_np, lengths_np = spiked_reads(genome, 4096, 11)
    codes, lengths = torch.from_numpy(codes_np).to(dev), torch.from_numpy(lengths_np).to(dev)
    got = tt.turbo_streaming_search(turbo, di, codes, lengths)
    err = max_abs_err(got, tt.turbo_streaming_search_plain(turbo, di, codes, lengths))
    check(err == 0, "turbo_stream spiked batch: kernel differs from its plain version")
    say("kernel", name="turbo_stream", batch="lowercase_N_short_lengths", reads=len(codes_np),
        max_abs_err=err, hit_fraction=float((got >= 0).float().mean()))


def compare_lf_kernels(dev, genome, sbwt, runs, variants, record):
    """The LF entry points of each variant against their plain versions on
    the card. K14: the kernel on each whole batch (rate) and on the first
    PLAIN_READS reads of each mix against its plain version (ms and
    plain_ms at that shape), and on the spiked batch. The p = 12 table of
    the variants path against the plain version's. For the compressed
    variants, K1: kmer_search on the hit98 batch's 1M 30-mers, and
    precalc_fill at p = 8 against its plain version (and its p = 12 time);
    compare_kernels holds plain-matrix's K1."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.models import matrix as tm
    from sbwt_tpu_torch.ops import search as ts

    ref12 = tm.precalc_fill_plain(sbwt.device_index, GENERIC_P)
    batches = {}
    for mix, (codes_np, _) in runs.items():
        codes = torch.from_numpy(codes_np).to(dev)
        batches[mix] = (codes, torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev))
    km = batches["hit98"][0][:, :K].contiguous()
    km0 = batches["hit0"][0][:, :K].contiguous()
    want0 = ts.search_batch(sbwt.device_index, km0)
    spiked_np, spiked_len_np = spiked_reads(genome, 4096, 11)
    spiked = torch.from_numpy(spiked_np).to(dev), torch.from_numpy(spiked_len_np).to(dev)
    for v, (vs, tbl12) in variants.items():
        di = vs.device_index
        err12 = max_abs_err(tbl12, ref12)
        check(err12 == 0, f"{v}: p = 12 table differs from the plain version (max_abs_err {err12})")
        name = f"lf_stream[{v}]"
        for mix, (codes, lengths) in batches.items():
            full = lambda: ts.streaming_search(di, codes, lengths)
            ms_full = cuda_ms(full, 3)
            answers = len(codes) * (READ_LEN - K + 1)
            sc, sl = codes[:PLAIN_READS], lengths[:PLAIN_READS]
            sample = lambda: ts.streaming_search(di, sc, sl)
            got = sample()
            plain, plain_ms = timed_ms(lambda: ts.streaming_search_plain(di, sc, sl))
            err = max_abs_err(got, plain)
            check(torch.equal(got.cpu(), torch.from_numpy(runs[mix][1][:PLAIN_READS])),
                  f"{name} {mix}: sample differs from K4's answers")
            moved, ops, work = k14_bounds(
                main_lf_rows(sbwt.device_index, runs, mix, PLAIN_READS),
                main_lf_rows(sbwt.device_index, runs, mix, len(codes)), di, device_bytes(di),
                PLAIN_READS, len(codes))
            extra = dict(variant=v, mix=mix, shape=tuple(sc.shape), full_batch_ms=ms_full,
                         answers_per_s=answers / (ms_full / 1e3),
                         plain_answers_per_s=plain.numel() / (plain_ms / 1e3),
                         smem_per_block=kernels.lf_smem_bytes(v, K), **work)
            del got, plain
            if mix == "hit98":
                record(name, err, cuda_ms(sample, 3), plain_ms, moved, ops, **extra)
            else:
                check(err == 0, f"{name} {mix}: kernel differs from its plain version")
                say("kernel", name=name, max_abs_err=err, ms=cuda_ms(sample, 3),
                    plain_ms=plain_ms, bound_ms=bound_ms(moved, ops), **extra)
        got = ts.streaming_search(di, *spiked)
        err = max_abs_err(got, ts.streaming_search_plain(di, *spiked))
        check(err == 0, f"{name} spiked batch: kernel differs from its plain version")
        say("kernel", name=name, batch="lowercase_N_short_lengths", reads=len(spiked_np),
            max_abs_err=err, hit_fraction=float((got >= 0).float().mean()))
        if v == "plain-matrix":
            continue
        k_km = lambda: ts.search_batch(di, km)
        plain, plain_ms = timed_ms(lambda: ts.search_batch_plain(di, km))
        record(f"kmer_search[{v}]", max_abs_err(k_km(), plain)
               + max_abs_err(ts.search_batch(di, km0), want0), cuda_ms(k_km, 5), plain_ms,
               *search_work(device_bytes(di), *km.shape), shape=tuple(km.shape),
               hit0_ms=cuda_ms(lambda: ts.search_batch(di, km0), 5))
        desc = di.kernel_desc(dev)
        k_pre = lambda: kernels.precalc_fill(v, desc, di.C, di.n_nodes, 8)
        plain, plain_ms = timed_ms(lambda: tm.precalc_fill_plain(di, 8))
        err = max_abs_err(k_pre(), plain)
        ms12 = cuda_ms(lambda: kernels.precalc_fill(v, desc, di.C, di.n_nodes, GENERIC_P), 3)
        record(f"precalc_fill[{v}]", err, cuda_ms(k_pre, 5), plain_ms,
               *fill_work(device_bytes(di), 8), shape=(4**8, 2),
               p12_ms=ms12, p12_shape=tuple(ref12.shape))
        del plain


def forward_work(cols, out):
    """forward: the columns and chars read, the successors written, and of
    each lane a suffix-group row and a rank row (8 bytes each, counted low
    for the compressed and wide rank types); one rank pair a lane."""
    return nbytes(cols, out) + cols.numel() * (1 + 16), cols.numel() * LF_OPS


def compare_forward(name, di, cols, chars, record, **extra):
    """The forward kernel of di's rank type over the lanes (cols, chars)
    against its plain version, beside succ1 over the same columns and the
    gather of one of its four successors, what forward_batch launched
    before it had its own kernel."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.ops import search as ts

    k_fw = lambda: ts.forward_batch(di, cols, chars)
    ch = chars.long()
    plain, plain_ms = timed_ms(lambda: ts.extend_from_column(di, cols, ch).to(di.pos_dtype))
    old = lambda: kernels.succ1(di.variant, di.kernel_desc(cols.device), di.sgs_tbl, di.C,
                                di.n_nodes, cols=cols, row_major=True).gather(1, ch[:, None])[:, 0]
    err = max_abs_err(k_fw(), plain) + max_abs_err(old(), plain)
    record(name, err, cuda_ms(k_fw, 5), plain_ms, *forward_work(cols, plain),
           shape=tuple(cols.shape), succ1_gather_ms=cuda_ms(old, 5), **extra)


def compare_variant_turbo_kernels(dev, runs, variants, lanes, record):
    """partial_search and forward of each of the ten variants on the 1M
    lanes, and succ1 (all columns) and K4 of each compressed variant: K4 on
    each whole batch beside K14 on the same variant (rates), and on the
    first TURBO_PLAIN_READS reads of each mix against its plain version."""
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    lane_codes, lane_len = (torch.from_numpy(a).to(dev) for a in lanes)
    nodes, chars = forward_lanes(runs, next(iter(variants.values()))[0].number_of_subsets())
    fw_chars = torch.from_numpy(chars).to(dev, torch.int8)
    batches = {}
    for mix, (codes_np, _) in runs.items():
        codes = torch.from_numpy(codes_np).to(dev)
        batches[mix] = (codes, torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev))
    for v, (vs, _) in variants.items():
        di = vs.device_index
        k_ps = lambda: ts.partial_search_batch(di, lane_codes, lane_len)
        plain, plain_ms = timed_ms(lambda: ts.partial_search_plain(di, lane_codes, lane_len))
        record(f"partial_search[{v}]", sum(max_abs_err(a, b) for a, b in zip(k_ps(), plain)),
               cuda_ms(k_ps, 5), plain_ms, *partial_work(lane_len, plain[2]),
               shape=tuple(lane_codes.shape))
        del plain
        compare_forward(f"forward[{v}]", di, torch.from_numpy(nodes).to(dev, di.pos_dtype),
                        fw_chars, record)
        if v == "plain-matrix":
            continue
        k_s1 = lambda: tt.succ1(di)
        succ = k_s1()
        plain, plain_ms = timed_ms(lambda: tt.succ1_plain(di))
        record(f"succ1[{v}]", max_abs_err(succ, plain), cuda_ms(k_s1, 5), plain_ms,
               *succ_work(device_bytes(di), di.sgs_tbl, succ), shape=tuple(succ.shape))
        del succ, plain
        turbo = tt.build_turbo(di, ARITY)
        name = f"turbo_stream[{v}]"
        for mix, (codes, lengths) in batches.items():
            ms_full = cuda_ms(lambda: tt.turbo_streaming_search(turbo, di, codes, lengths), 3)
            lf_ms_full = cuda_ms(lambda: ts.streaming_search(di, codes, lengths), 3)
            nb = TURBO_PLAIN_READS[mix]
            sc, sl = codes[:nb], lengths[:nb]
            sample = lambda: tt.turbo_streaming_search(turbo, di, sc, sl)
            got = sample()
            plain, plain_ms = timed_ms(lambda: tt.turbo_streaming_search_plain(turbo, di, sc, sl))
            err = max_abs_err(got, plain)
            check(torch.equal(got.cpu(), torch.from_numpy(runs[mix][1][:nb])),
                  f"{name} {mix}: sample differs from plain-matrix's answers")
            moved, ops, work = turbo_work(turbo, di, sc, sl, got)
            answers = len(codes) * (READ_LEN - K + 1)
            extra = dict(variant=v, mix=mix, shape=tuple(sc.shape), full_batch_ms=ms_full,
                         lf_full_batch_ms=lf_ms_full, turbo_over_lf=lf_ms_full / ms_full,
                         answers_per_s=answers / (ms_full / 1e3), **work)
            del got, plain
            if mix == "hit98":
                record(name, err, cuda_ms(sample, 3), plain_ms, moved, ops, **extra)
            else:
                check(err == 0, f"{name} {mix}: kernel differs from its plain version")
                say("kernel", name=name, max_abs_err=err, ms=cuda_ms(sample, 3), plain_ms=plain_ms,
                    bound_ms=bound_ms(moved, ops), **extra)
        del turbo
        torch.cuda.empty_cache()


def compare_wide_kernels_4m(dev, sbwt, wsb, runs, record):
    """The wide kernels at the 4M-column index, beside the narrow ones in
    the same run: K14 and K4 on each whole batch (K4 also against the narrow
    arity-1 table, the like-for-like of the wide one), K1's p = 13 fill and
    1M-k-mer search, and the wide seed bits. Records wide K4 and the wide
    seed bits; the giant records the others."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    di, wide, wturbo = sbwt.device_index, wsb.device_index, wsb._turbo
    p = wide.precalc_k
    fill = lambda index: kernels.precalc_fill(index.variant, index.kernel_desc(dev), index.C,
                                              index.n_nodes, p)
    check(torch.equal(fill(wide), wide.precalc), "wide fill: rerun differs")
    say("kernel", name=f"precalc_fill[{WIDE}]", n_columns=wide.n_nodes, shape=tuple(wide.precalc.shape),
        ms=cuda_ms(lambda: fill(wide), 3), narrow_ms=cuda_ms(lambda: fill(di), 3))
    k_sb = lambda: kernels.seed_bits(wide.precalc, p)
    record(f"seed_bits[{WIDE}]", max_abs_err(k_sb(), tt.seed_bits_plain(wide.precalc, p))
           + small_p_seed_bits_err(wide, dev),
           cuda_ms(k_sb, 5), cuda_ms(lambda: tt.seed_bits_plain(wide.precalc, p), 1),
           *seed_bits_work(wide.precalc, wturbo.seed_bits, p),
           shape=tuple(wturbo.seed_bits.shape), narrow_ms=cuda_ms(lambda: kernels.seed_bits(di.precalc, p), 5))
    # succ1 over all columns, as the forced-wide table build launched it (the
    # kernels line keeps the giant's 1M sampled columns)
    k_s1 = lambda: tt.succ1(wide, row_major=True)
    succ = k_s1()
    check(torch.equal(succ, wturbo.tbl), "wide succ1 over all columns: rerun differs from the table")
    plain, plain_ms = timed_ms(lambda: tt.succ1_plain(wide))
    err = max_abs_err(succ, plain.t().contiguous())
    check(err == 0, "wide succ1 over all columns: kernel differs from its plain version")
    del plain
    say("kernel", name=f"succ1[{WIDE}]", columns="all", n_columns=wide.n_nodes,
        shape=tuple(succ.shape), max_abs_err=err, ms=cuda_ms(k_s1, 5), plain_ms=plain_ms,
        bound_ms=bound_ms(*succ_work(wide.size_in_bytes(), wide.sgs_tbl, succ)),
        narrow_ms=cuda_ms(lambda: tt.succ1(di), 5))
    del succ
    km = torch.from_numpy(np.ascontiguousarray(runs["hit98"][0][:, :K])).to(dev)
    err = max_abs_err(ts.search_batch(wide, km), ts.search_batch_plain(wide, km))
    check(err == 0, "wide kmer_search at 4M columns: kernel differs from its plain version")
    say("kernel", name=f"kmer_search[{WIDE}]", n_columns=wide.n_nodes, shape=tuple(km.shape),
        max_abs_err=err, ms=cuda_ms(lambda: ts.search_batch(wide, km), 5),
        narrow_ms=cuda_ms(lambda: ts.search_batch(di, km), 5))
    narrow1 = tt.build_turbo(di, 1)
    for mix, (codes_np, ans_np) in runs.items():
        codes = torch.from_numpy(codes_np).to(dev)
        lengths = torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev)
        answers = ans_np.size
        # wide K14: whole batch beside the narrow one, a sample against its plain version
        lf = lambda index: ts.streaming_search(index, codes, lengths)
        sc, sl = codes[:PLAIN_READS], lengths[:PLAIN_READS]
        err = max_abs_err(ts.streaming_search(wide, sc, sl), ts.streaming_search_plain(wide, sc, sl))
        check(err == 0, f"wide lf_stream at 4M columns, {mix}: kernel differs from its plain version")
        ms = cuda_ms(lambda: lf(wide), 3)
        moved, ops, work = lf_work(main_lf_rows(di, runs, mix, len(codes)), wide,
                                   wide.size_in_bytes(), len(codes), READ_LEN)
        say("kernel", name=f"lf_stream[{WIDE}]", n_columns=wide.n_nodes, mix=mix, max_abs_err=err,
            full_batch_ms=ms, narrow_full_batch_ms=cuda_ms(lambda: lf(di), 3),
            answers_per_s=answers / (ms / 1e3), full_batch_bound_ms=bound_ms(moved, ops),
            smem_per_block=kernels.lf_smem_bytes(WIDE, K), **work)
        # wide K4 on the whole batch against its plain version
        stream = lambda: tt.turbo_streaming_search(wturbo, wide, codes, lengths)
        out = stream()
        check(torch.equal(out.cpu(), torch.from_numpy(ans_np).long()), f"wide K4 {mix}: rerun differs")
        plain, plain_ms = timed_ms(lambda: tt.turbo_streaming_search_plain(wturbo, wide, codes, lengths))
        err = max_abs_err(out, plain)
        moved, ops, work = turbo_work(wturbo, wide, codes, lengths, out)
        compare_answer_stats(f"answer_stats[{WIDE}]", out, int(ans_np.sum(dtype=np.int64)),
                             int((ans_np >= 0).sum()), mix, record if mix == "hit98" else None)
        del out, plain
        ms = cuda_ms(stream, 5)
        extra = dict(mix=mix, reads=len(codes_np), n_columns=wide.n_nodes,
                     narrow_arity3_ms=cuda_ms(lambda: tt.turbo_streaming_search(sbwt._turbo, di, codes, lengths), 5),
                     narrow_arity1_ms=cuda_ms(lambda: tt.turbo_streaming_search(narrow1, di, codes, lengths), 5),
                     answers_per_s=answers / (ms / 1e3), **work)
        if mix == "hit98":
            record(f"turbo_stream[{WIDE}]", err, ms, plain_ms, moved, ops, **extra)
        else:
            check(err == 0, f"wide K4 {mix}: kernel differs from its plain version")
            say("kernel", name=f"turbo_stream[{WIDE}]", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(moved, ops), **extra)


def fast_search_work(turbo, km, ans, slow):
    """fast_search: codes in, ans and needs_slow out, a precalc row for each
    valid row, and the table rows that the walks from its singleton seeds
    read (walk_rows, at K4's row bytes: table_row_bytes), as turbo_work
    counts K4's. Operations: a check and a shift of each code, a select and
    a row address a table row."""
    k, p = turbo.k, turbo.precalc_k
    valid = ((km >= 0) & (km < 4)).all(dim=1)
    pidx = ((km[:, :p].long() & 3) << (2 * torch.arange(p, device=km.device))).sum(dim=1)
    seed = turbo.precalc[pidx].long()
    singleton = valid & (seed[:, 0] >= 0) & (seed[:, 0] == seed[:, 1])
    rows = walk_rows(turbo, seed[singleton, 0], km[singleton, p:])
    moved = (nbytes(km, ans, slow) + int(valid.sum()) * 2 * turbo.precalc.element_size()
             + rows * table_row_bytes(turbo))
    return moved, len(km) * 2 * k + rows * 8


def compare_fast_search(dev, genome, sbwt, wsb, runs, record):
    """fast_search against its plain version on the 1M first k-mers of each
    mix: the narrow kernel over the main arity-3 table (recorded at hit98),
    arity 1 and 2, and the wide kernel over the int64 arity-1 table (recorded
    at hit98), each beside K1's search of the same rows."""
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    di = sbwt.device_index
    tables = {(False, ARITY): sbwt._turbo, (True, 1): wsb._turbo}
    for arity in (1, 2):
        tables[(False, arity)] = tt.build_turbo(di, arity)
    for mix in MIXES:
        km = torch.from_numpy(np.ascontiguousarray(runs[mix][0][:, :K])).to(dev)
        search_ms = cuda_ms(lambda: ts.search_batch(di, km), 5)
        for (wide, arity), turbo in sorted(tables.items()):
            ans, slow = tt.fast_search(turbo, km)
            (pa, ps), plain_ms = timed_ms(lambda: tt.fast_search_plain(turbo, km))
            err = max_abs_err(ans, pa) + max_abs_err(slow, ps)
            ms = cuda_ms(lambda: tt.fast_search(turbo, km), 5)
            name = f"fast_search[{WIDE if wide else 'plain-matrix'}]"
            moved, ops = fast_search_work(turbo, km, ans, slow)
            extra = dict(mix=mix, arity=arity, shape=tuple(km.shape), kmer_search_ms=search_ms,
                         needs_slow_share=float(slow.float().mean()),
                         kmers_per_s=len(km) / (ms / 1e3))
            if mix == "hit98" and arity == (1 if wide else ARITY):
                record(name, err, ms, plain_ms, moved, ops, **extra)
            else:
                check(err == 0, f"{name} {mix} arity {arity}: kernel differs from its plain version")
                say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(moved / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S) * 1e3, **extra)
            del ans, slow, pa, ps
    del tables
    torch.cuda.empty_cache()


def compare_giant_kernels(dev, sb, reads, with_n, prefix_len, record):
    """The wide kernels at the giant's size against their plain versions:
    K1's p = 8 fill and 1M-k-mer search, K14 on the first PLAIN_READS reads
    of each batch (and its time on each whole batch), partial_search of the
    1M prefixes, succ1 over 1M sampled columns and forward over them."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.models import matrix as tm
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    di = sb.device_index
    desc = di.kernel_desc(dev)
    k_pre = lambda: kernels.precalc_fill(WIDE, desc, di.C, di.n_nodes, GIANT_P)
    plain, plain_ms = timed_ms(lambda: tm.precalc_fill_plain(di, GIANT_P))
    # the fill reads two rank rows a step of each lane, not the whole 6.4 GB table
    record(f"precalc_fill[{WIDE}]", max_abs_err(k_pre(), plain) + max_abs_err(di.precalc, plain),
           cuda_ms(k_pre, 5), plain_ms, 4**GIANT_P * (16 + GIANT_P * 2 * 12), 4**GIANT_P * LF_OPS,
           shape=tuple(plain.shape), n_columns=di.n_nodes)
    codes = torch.from_numpy(reads).to(dev)
    km = codes[:, :GIANT_K].contiguous()
    k_km = lambda: ts.search_batch(di, km)
    plain, plain_ms = timed_ms(lambda: ts.search_batch_plain(di, km))
    steps = GIANT_K - GIANT_P
    # the complete graph holds every ACGT 16-mer: its misses are the rows
    # with a lowercase char, each of which ends at the validity test
    km0 = km.clone()
    km0[torch.arange(len(km), device=dev), torch.from_numpy(
        np.random.default_rng(7).integers(0, GIANT_K, size=len(km))).to(dev)] |= 4
    record(f"kmer_search[{WIDE}]", max_abs_err(k_km(), plain)
           + max_abs_err(ts.search_batch(di, km0), torch.full_like(plain, -1)), cuda_ms(k_km, 5),
           plain_ms, len(km) * (GIANT_K + 16 + 8 + steps * 2 * 12), len(km) * steps * LF_OPS,
           shape=tuple(km.shape), n_columns=di.n_nodes,
           hit0_ms=cuda_ms(lambda: ts.search_batch(di, km0), 5),
           hit0_batch="each 16-mer with one lowercase char")
    del plain
    lengths = torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev)
    answers = len(codes) * (READ_LEN - GIANT_K + 1)
    for name, batch in (("reads", codes), ("reads_with_n", torch.from_numpy(with_n).to(dev))):
        full = lambda: ts.streaming_search(di, batch, lengths)
        ms_full = cuda_ms(full, 3)
        sc, sl = batch[:PLAIN_READS], lengths[:PLAIN_READS]
        sample = lambda: ts.streaming_search(di, sc, sl)
        plain, plain_ms = timed_ms(lambda: ts.streaming_search_plain(di, sc, sl))
        got = sample()
        err = max_abs_err(got, plain)
        rows_sample = lf_rows(di, sc, sl, got)
        del got
        out = full()
        rows_full = lf_rows(di, batch, lengths, out)
        del out
        moved, ops, work = k14_bounds(rows_sample, rows_full, di, di.size_in_bytes(), PLAIN_READS,
                                      len(batch))
        extra = dict(batch=name, shape=tuple(sc.shape), n_columns=di.n_nodes, full_batch_ms=ms_full,
                     answers_per_s=answers / (ms_full / 1e3),
                     plain_answers_per_s=plain.numel() / (plain_ms / 1e3),
                     smem_per_block=kernels.lf_smem_bytes(WIDE, GIANT_K), **work)
        del plain
        if name == "reads":
            record(f"lf_stream[{WIDE}]", err, cuda_ms(sample, 3), plain_ms, moved, ops, **extra)
        else:
            check(err == 0, f"giant lf_stream {name}: kernel differs from its plain version")
            say("kernel", name=f"lf_stream[{WIDE}]", max_abs_err=err, ms=cuda_ms(sample, 3),
                plain_ms=plain_ms, bound_ms=bound_ms(moved, ops), **extra)
    plen = torch.from_numpy(prefix_len).to(dev)
    k_ps = lambda: ts.partial_search_batch(di, km, plen)
    plain, plain_ms = timed_ms(lambda: ts.partial_search_plain(di, km, plen))
    record(f"partial_search[{WIDE}]", sum(max_abs_err(a, b) for a, b in zip(k_ps(), plain)),
           cuda_ms(k_ps, 5), plain_ms, *partial_work(plen, plain[2], 8), shape=tuple(km.shape),
           n_columns=di.n_nodes)
    cols = torch.from_numpy(np.random.default_rng(6).integers(0, di.n_nodes, size=len(km))).to(dev)
    k_s1 = lambda: tt.succ1(di, cols, row_major=True)
    succ = k_s1()
    plain, plain_ms = timed_ms(lambda: tt.succ1_plain(di, cols))
    # per column: its index, one suffix-group row, four rank rows, four successors
    record(f"succ1[{WIDE}]", max_abs_err(succ, plain.t().contiguous()), cuda_ms(k_s1, 5), plain_ms,
           len(cols) * (8 + 8 + 4 * 12 + 32), succ.numel() * LF_OPS, shape=tuple(succ.shape),
           n_columns=di.n_nodes, columns="1M sampled")
    del succ, plain
    chars = torch.from_numpy(np.random.default_rng(8).integers(0, 4, size=len(cols))).to(dev, torch.int8)
    compare_forward(f"forward[{WIDE}]", di, cols, chars, record, n_columns=di.n_nodes,
                    columns="1M sampled")


def card_list() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def run_parallel_path(sbwt, runs):
    """The five steps of the JAX package's multichip dry run
    (``__graft_entry__.py:32-95``) through the port's parallel entry points,
    on the main path's index, arity-3 table and whole 1M-read batches, each
    held to the main path's answers exactly. Returns the TP mesh, the
    row-sharded index and the table built sharded."""
    from sbwt_tpu_torch.parallel import sharded

    dev = sbwt.device
    di, turbo = sbwt.device_index, sbwt._turbo
    n = di.n_nodes
    dp = sharded.make_mesh(*DP_MESH, card_list())
    tp = sharded.make_mesh(*TP_MESH, card_list())
    for name, mesh in (("dp", dp), ("tp", tp)):
        say("parallel", mesh=name, shape=mesh.shape,
            slots=[[str(d) for d in row] for row in mesh.devices])
    want = {mix: torch.from_numpy(ans).to(dev) for mix, (_, ans) in runs.items()}
    km = np.ascontiguousarray(runs["hit98"][0][:, :K])

    def step(name, fn, mixes=tuple(MIXES)):
        fields = {}
        for mix in mixes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(runs[mix][0])
            torch.cuda.synchronize()
            fields[f"{mix}_host_seconds"] = round(time.perf_counter() - t0, 4)
            check(torch.equal(got, want[mix]), f"parallel {name} {mix}: answers differ from the main path's")
            del got
        say("parallel", step=name, answers="equal to the main path's", **fields)

    # 1. DP: replicated index, rows cut over the data axis
    index = sharded.replicate_index(di, dp)
    got = sharded.dp_search(index, km, dp)
    check(torch.equal(got, want["hit98"][:, 0]), "parallel dp_search: differs from K4's position 0")
    say("parallel", step="dp_search", kmers=len(km), answers="equal to the main path's")
    step("dp_streaming_search", lambda codes: sharded.dp_streaming_search(index, codes, None, dp))
    # 2. DP turbo: the arity-3 table replicated
    step("dp_turbo_streaming_search",
         lambda codes: sharded.dp_turbo_streaming_search(turbo, index, codes, None, dp))
    # 3. TP: rank and suffix-group tables row-sharded over `model` (K20a)
    placed = sharded.shard_index_rows(di, tp)
    check(sharded.shard_index_rows(placed, tp) is placed, "shard_index_rows: placed again")
    got = sharded.tp_search(placed, km, tp)
    check(torch.equal(got, want["hit98"][:, 0]), "parallel tp_search: differs from K4's position 0")
    say("parallel", step="tp_search", kmers=len(km), answers="equal to the main path's",
        rank_rows_per_shard=placed.views[0].rank_shard_0.shape[0])
    step("tp_streaming_search", lambda codes: sharded.tp_streaming_search(placed, codes, None, tp))
    # 4. TP turbo over the table placed sharded (K20b): whole shards are views
    # of the main path's table, the padded last one a copy
    on_rows = sharded.shard_turbo_rows(turbo, tp)
    step("tp_turbo_streaming_search[placed]",
         lambda codes: sharded.tp_turbo_streaming_search(on_rows, di, codes, None, tp))
    del on_rows
    torch.cuda.empty_cache()
    # 5. TP turbo over the table built sharded (K20c): each shard composed
    # into its own allocation; real rows byte-equal to the main path's table
    t0 = time.perf_counter()
    built = sharded.build_turbo_sharded(di, tp, arity=ARITY)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cols, rpc = built.views[0].cols, 4**ARITY
    for m, shard in enumerate(built.views[0].tbl_shards):
        real = max(0, min(n, (m + 1) * cols) - m * cols) * rpc
        check(torch.equal(shard[:real], turbo.tbl[m * cols * rpc :][:real]),
              f"build_turbo_sharded: shard {m}'s rows differ from enable_turbo's table")
        check(not bool(shard[real:].any()), f"build_turbo_sharded: shard {m}'s pad rows not zero")
    say("parallel", step="build_turbo_sharded", arity=ARITY, cols_per_shard=cols,
        shard_bytes=[nbytes(t) for t in built.views[0].tbl_shards],
        real_rows="byte-equal to enable_turbo's table", seconds=round(build_s, 4))
    step("tp_turbo_streaming_search[built]",
         lambda codes: sharded.tp_turbo_streaming_search(built, di, codes, None, tp))
    return tp, placed, built


def compare_parallel_kernels(dev, sbwt, runs, parallel, record, card):
    """K20a-c against their plain versions at the main path's shapes: K20a's
    kmer_search on the 1M 30-mers and lf_stream on the first PLAIN_READS
    reads of each mix (and on each whole batch, beside flat K14), K20b on
    the first PLAIN_READS reads of each mix (and on each whole batch,
    beside flat K4), K20c on one whole shard (the last, with its pad
    columns); then one tp_streaming_search under utils.profiling.trace."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt
    from sbwt_tpu_torch.parallel import sharded

    tp, placed, built = parallel
    di, turbo = sbwt.device_index, sbwt._turbo
    view, tview = placed.views[0], built.views[0]
    km = torch.from_numpy(np.ascontiguousarray(runs["hit98"][0][:, :K])).to(dev)
    km0 = torch.from_numpy(np.ascontiguousarray(runs["hit0"][0][:, :K])).to(dev)
    k_km = lambda: ts.search_batch(view, km)
    plain, plain_ms = timed_ms(lambda: ts.search_batch_plain(view, km))
    record("kmer_search[sharded-matrix]", max_abs_err(k_km(), plain)
           + max_abs_err(ts.search_batch(view, km0), ts.search_batch(di, km0)), cuda_ms(k_km, 5),
           plain_ms, *search_work(di.size_in_bytes(), *km.shape), shape=tuple(km.shape),
           shards=view.n_shards, flat_ms=cuda_ms(lambda: ts.search_batch(di, km), 5),
           hit0_ms=cuda_ms(lambda: ts.search_batch(view, km0), 5))
    del plain
    for mix, (codes_np, ans_np) in runs.items():
        codes = torch.from_numpy(codes_np).to(dev)
        lengths = torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev)
        sc, sl = codes[:PLAIN_READS], lengths[:PLAIN_READS]
        answers = ans_np.size
        for name, fn, flat, plain_fn in (
            ("lf_stream[sharded-matrix]", lambda c, n: ts.streaming_search(view, c, n),
             lambda: ts.streaming_search(di, codes, lengths),
             lambda: ts.streaming_search_plain(view, sc, sl)),
            (kernels.TURBO_SHARDED, lambda c, n: sharded.tp_turbo_block(tview, di, c, n),
             lambda: tt.turbo_streaming_search(turbo, di, codes, lengths),
             lambda: tt.turbo_streaming_search_plain(tview, di, sc, sl)),
        ):
            got = fn(sc, sl)
            check(torch.equal(got.cpu(), torch.from_numpy(ans_np[:PLAIN_READS])),
                  f"{name} {mix}: sample differs from the main path's answers")
            plain, plain_ms = timed_ms(plain_fn)
            err = max_abs_err(got, plain)
            if name == kernels.TURBO_SHARDED:
                moved, ops, work = turbo_work(turbo, di, sc, sl, got)
            else:
                moved, ops, work = k14_bounds(
                    main_lf_rows(di, runs, mix, PLAIN_READS), main_lf_rows(di, runs, mix, len(codes)),
                    view, di.size_in_bytes(), PLAIN_READS, len(codes))
                work["smem_per_block"] = kernels.lf_smem_bytes(kernels.SHARDED, K)
            del got, plain
            ms_full = cuda_ms(lambda: fn(codes, lengths), 3)
            extra = dict(mix=mix, shape=tuple(sc.shape), shards=tp.shape["model"],
                         full_batch_ms=ms_full, flat_full_batch_ms=cuda_ms(flat, 3),
                         answers_per_s=answers / (ms_full / 1e3), **work)
            if mix == "hit98":
                record(name, err, cuda_ms(lambda: fn(sc, sl), 3), plain_ms, moved, ops, **extra)
            else:
                check(err == 0, f"{name} {mix}: kernel differs from its plain version")
                say("kernel", name=name, max_abs_err=err, ms=cuda_ms(lambda: fn(sc, sl), 3),
                    plain_ms=plain_ms, bound_ms=bound_ms(moved, ops), **extra)
        del codes, lengths

    succ = tt.succ1(di)
    m = tview.n_shards - 1
    cols = tview.cols
    k_c = lambda: kernels.succ_compose(succ, ARITY, m * cols, cols)
    plain, plain_ms = timed_ms(lambda: tt.compose_plain(succ, ARITY, col0=m * cols, n_cols=cols))
    out = k_c()
    err = max_abs_err(out, plain) + max_abs_err(out, tview.tbl_shards[m])
    del plain
    record("succ_compose[column-range]", err, cuda_ms(k_c, 3), plain_ms, nbytes(succ, out),
           out.numel(), shape=tuple(out.shape), shard=m, cols=cols,
           real_cols=di.n_nodes - m * cols)
    del out, succ
    trace_tp_streaming(dev, tp, placed, runs)


def trace_tp_streaming(dev, tp, placed, runs):
    """One tp_streaming_search of the hit98 batch under the port's own
    utils.profiling.trace: its device time by op, the top ops named."""
    from sbwt_tpu_torch.parallel import sharded
    from sbwt_tpu_torch.utils.profiling import annotate, trace

    codes = torch.from_numpy(runs["hit98"][0]).to(dev)
    sharded.tp_streaming_search(placed, codes, None, tp)  # warm
    torch.cuda.synchronize()
    span = "chip_smoke.tp_streaming_search"
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with trace(d) as prof, annotate(span):
            sharded.tp_streaming_search(placed, codes, None, tp)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trace_bytes = (Path(d) / "trace.json").stat().st_size
    top = []
    for ev in prof.key_averages():
        # the span itself shows on the device timeline too: not an op
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key == span:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        top.append((us / 1e3, ev.count, ev.key[:60]))
    top.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in top)
    check(device_ms > 0, "trace: no device time in the profile")
    say("trace", call="tp_streaming_search, hit98, 1M reads", mesh=tp.shape,
        wall_ms_with_profiler_start_and_export=round(wall * 1e3, 3), device_ms=round(device_ms, 4),
        trace_json_bytes=trace_bytes,
        top_device_ops=[{"op": key, "ms": round(ms, 4), "count": count} for ms, count, key in top[:5]])


def probe_tables(dev):
    """The probe's tables, made on the card from a seed: [4N, 2] and [4N, 8]
    at scratch/gather_bench.py's N, and [2^26, 2] and [2^26, 8] past L2; the
    B start indices in [0, N)."""
    g = torch.Generator(device=dev).manual_seed(0)
    tables = {}
    for rows in (4 * PROBE_N, PROBE_BIG_ROWS):
        for width in (2, 8):
            tables[(rows, width)] = torch.randint(0, 2**31 - 1, (rows, width), dtype=torch.int32,
                                                  device=dev, generator=g)
    idx0 = torch.randint(0, PROBE_N, (PROBE_B,), dtype=torch.int32, device=dev, generator=g)
    return tables, idx0


def run_probe_path(dev):
    """gather_chain at scratch/gather_bench.py's shapes, both widths, through
    the op a user would call."""
    from sbwt_tpu_torch.ops import gather_chain as gc

    tables, idx0 = probe_tables(dev)
    for width in (2, 8):
        out = gc.gather_chain(tables[(4 * PROBE_N, width)], idx0, PROBE_STEPS)
        check(out.shape == idx0.shape and bool(((out >= 0) & (out < 4 * PROBE_N)).all()),
              f"gather_chain width {width}: index out of range")
    return tables, idx0


def chain_rows_read(tbl, idx0, steps: int) -> int:
    """The distinct rows of tbl that the chains from idx0 read, one step of
    the plain version at a time: the rows this run's data asks for."""
    from sbwt_tpu_torch.ops import gather_chain as gc

    seen, idx = [], idx0
    for _ in range(steps):
        seen.append(idx)
        idx = gc.gather_chain_plain(tbl, idx, 1)
    return int(torch.unique(torch.cat(seen)).numel()) if seen else 0


def gather_ceiling(dev, tbl, g) -> dict:
    """The card's dependent-gather ceiling on tbl at the probe's shape,
    measured here, every launch from fresh start rows (g): the probe's shape
    itself (``fresh_ms``), the unloaded step latency (32 lanes at
    PROBE_LONG_STEPS less at PROBE_STEPS, over the steps between), the
    saturated dependent gathers/s (the most at PROBE_WIDE_LANES), and the
    ceiling max(steps x latency, lanes x steps / rate), which fresh_ms is
    held against."""
    from sbwt_tpu_torch.ops import gather_chain as gc

    def fresh_ms(lanes, steps, reps):
        starts = iter([torch.randint(0, tbl.shape[0], (lanes,), dtype=torch.int32, device=dev,
                                     generator=g) for _ in range(reps + 1)])
        return cuda_ms(lambda: gc.gather_chain(tbl, next(starts), steps), reps)

    probe_ms = fresh_ms(PROBE_B, PROBE_STEPS, 5)
    latency_ns = (fresh_ms(32, PROBE_LONG_STEPS, 10) - fresh_ms(32, PROBE_STEPS, 10)) \
        / (PROBE_LONG_STEPS - PROBE_STEPS) * 1e6
    rate = max(lanes * PROBE_STEPS / (fresh_ms(lanes, PROBE_STEPS, 5) / 1e3)
               for lanes in PROBE_WIDE_LANES)
    return dict(fresh_ms=probe_ms, step_latency_ns=latency_ns, saturated_gathers_per_s=rate,
                ceiling_ms=max(PROBE_STEPS * latency_ns / 1e6, PROBE_B * PROBE_STEPS / rate * 1e3))


def compare_probe(dev, tables, idx0, record, card):
    """K21 against its plain version at each table, with its time,
    dependent gathers/s, its bound (bytes: the distinct rows the chains
    read, idx0 and the answers, over the HBM rate) and beside it the card's
    ceiling on the table, measured here from fresh start rows
    (``gather_ceiling``), which is what really bounds it. The probe's
    launches repeat one set of start rows, so rows of a table past L2 may
    hit from the launch before; its fresh-row time is the one held against
    the ceiling."""
    from sbwt_tpu_torch.ops import gather_chain as gc

    gathers = PROBE_B * PROBE_STEPS
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(key, tbl, "local") for key, tbl in tables.items()]
    if torch.cuda.device_count() > 1:  # a table on a second card, read over NVLink
        peer = torch.device("cuda", 1)
        cases += [((rows, width), tables[(rows, width)].to(peer), f"peer {peer}")
                  for rows, width in tables]
    for (rows, width), tbl, where in cases:
        k = lambda: gc.gather_chain(tbl, idx0, PROBE_STEPS)
        plain, plain_ms = timed_ms(lambda: gc.gather_chain_plain(tbl, idx0, PROBE_STEPS))
        err = max_abs_err(k(), plain)
        ms = cuda_ms(k, 5)
        rows_read = chain_rows_read(tbl, idx0, PROBE_STEPS)
        moved = rows_read * width * 4 + nbytes(idx0) * 2
        extra = dict(table=f"[{rows}, {width}]", table_bytes=nbytes(tbl), where=where, lanes=PROBE_B,
                     steps=PROBE_STEPS, gathers_per_s=gathers / (ms / 1e3), rows_read=rows_read,
                     byte_bound_ms=moved / HBM_BYTES_PER_S * 1e3, **gather_ceiling(dev, tbl, g))
        if (rows, width, where) == (4 * PROBE_N, 2, "local"):  # pallas_chain's table
            record("gather_chain", err, ms, plain_ms, moved, gathers * 4, **extra)
        else:
            check(err == 0, f"gather_chain {extra['table']} {where}: kernel differs from its plain version")
            say("kernel", name="gather_chain", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                card=repr(card), **extra)
        del plain


def run_cli(device: str) -> None:
    """The CLI on the golden inputs, in a subprocess, as a user runs it."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        inputs = []
        for i, seqs in enumerate(GOLDEN_SEQS):
            path = tmp / f"seqs{i + 1}.fna"
            path.write_text("".join(f">s{j}\n{s}\n" for j, s in enumerate(seqs)))
            inputs.append(str(path))
        (tmp / "inputs.txt").write_text("\n".join(inputs) + "\n")
        (tmp / "q.fna").write_text("".join(f">q{j}\n{s}\n" for j, s in enumerate(GOLDEN_QUERIES)))
        (tmp / "q.fq").write_text("".join(
            f"@q{j}\n{s}\n+\n{'I' * len(s)}\n" for j, s in enumerate(GOLDEN_QUERIES)))
        index, rrr, mef = tmp / "index.sbwt", tmp / "rrr-split.sbwt", tmp / "mef-split.sbwt"
        cli = [sys.executable, "-m", "sbwt_tpu_torch"]
        for argv in (
            ["build", "-i", str(tmp / "inputs.txt"), "-o", str(index), "-k", "6",
             "--add-reverse-complements", "--temp-dir", str(tmp), "--precalc-length", "4"],
            ["search", "-i", str(index), "-q", str(tmp / "q.fna"), "-o", str(tmp / "o1.txt")],
            ["search", "-i", str(index), "-q", str(tmp / "q.fq"), "-o", str(tmp / "o2.txt")],
            ["build-variant", "-i", str(index), "-o", str(rrr), "--variant", "rrr-split"],
            ["search", "-i", str(rrr), "-q", str(tmp / "q.fq"), "-o", str(tmp / "o3.txt"),
             "--engine", "lf"],
            ["search", "-i", str(rrr), "-q", str(tmp / "q.fq"), "-o", str(tmp / "o4.txt"),
             "--engine", "turbo3"],
            ["search", "-i", str(rrr), "-q", str(tmp / "q.fna"), "-o", str(tmp / "o5.txt"),
             "--engine", "auto"],
            ["ascii-export", "-i", str(index), "-o", str(tmp / "e1.txt")],
            ["ascii-export", "-i", str(rrr), "-o", str(tmp / "e2.txt")],
            ["build-variant", "-i", str(index), "-o", str(mef), "--variant", "mef-split"],
        ):
            proc = subprocess.run(cli + argv + ["--device", device], cwd=REPO, env=env,
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"CLI {argv[0]} failed:\n{proc.stderr[-2000:]}")
            if "rrr-split.sbwt" in argv[2] and argv[-1] in ("turbo3", "auto"):
                check("Turbo successor engine enabled" in proc.stderr,
                      f"CLI search --engine {argv[-1]} on rrr-split did not enable turbo:\n"
                      f"{proc.stderr[-2000:]}")
        for name in ("o1.txt", "o2.txt", "o3.txt", "o4.txt", "o5.txt"):
            check((tmp / name).read_text() == GOLDEN, f"CLI output {name} differs from GOLDEN")
        export = (tmp / "e1.txt").read_bytes()
        check(export.startswith(b"version: v0.1\nk: 6\n") and export == (tmp / "e2.txt").read_bytes(),
              "CLI ascii-export: plain-matrix and rrr-split exports differ or lack the header")
        proc = subprocess.run(cli + ["ascii-export", "-i", str(mef), "-o", str(tmp / "e3.txt"),
                                     "--device", device], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 1 and "Error: ascii export not supported for mef variants\n"
              in proc.stderr and not (tmp / "e3.txt").exists(),
              f"CLI ascii-export of mef-split did not refuse:\n{proc.stderr[-2000:]}")
    say("cli", golden="byte-equal", files=5,
        variants="plain-matrix (turbo), rrr-split (lf, turbo3, auto)",
        ascii_export="plain-matrix and rrr-split byte-equal, mef-split refused",
        ascii_export_bytes=len(export))


def run_scaling_example(device: str) -> None:
    """examples/scaling_example_torch.py on the card, as a user runs it: it
    must exit 0 (it asserts DP == TP) and print the lines of its CPU run."""
    example = str(REPO / "examples" / "scaling_example_torch.py")
    lines, seconds = {}, {}
    for where in (device, "cpu"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, example, "--device", where], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        seconds[where] = round(time.perf_counter() - t0, 3)
        check(proc.returncode == 0,
              f"scaling example on {where} failed:\n{proc.stderr[-2000:]}")
        lines[where] = proc.stdout.splitlines()
    check(lines[device] == lines["cpu"] and len(lines["cpu"]) == 2,
          f"scaling example: {lines[device]} on the card, {lines['cpu']} on the CPU")
    say("scaling_example", lines=repr(" | ".join(lines[device])), seconds=seconds[device],
        cpu_seconds=seconds["cpu"])


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: chip_smoke needs a CUDA device",
              file=sys.stderr)
        return 2
    from sbwt_tpu_torch import kernels

    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev)
    card = nvidia_smi_line()
    say("device", name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(card, flush=True)

    t_start = t0 = time.perf_counter()
    lib, compile_s = kernels.build()
    regs = ptxas_lines(lib.with_suffix(".log").read_text())
    say("build", library=lib.name, nvcc_seconds=round(compile_s, 3),
        seconds=round(time.perf_counter() - t0, 3), kernels=len(regs),
        max_registers=max(r for _, r, _ in regs), spill_bytes=sum(s for _, _, s in regs))
    for entry, registers, spill in regs:
        print(f"  ptxas: {entry} registers={registers} spill_bytes={spill}")

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    genome, sbwt, runs = run_main_path(dev)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[COUNTER.get(name, name)] for name in KERNELS}
    say("launches", path="main", **launches)
    check(all(launches[name] > 0 for name in KERNELS), f"a kernel of the path never launched: {launches}")
    say("memory", peak_main_path_bytes=torch.cuda.max_memory_allocated(dev))

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    variants = run_variants_path(sbwt, runs)
    torch.cuda.synchronize()
    lf_launches = {name: kernels.LAUNCHES[name] for name in LF_KERNELS}
    say("launches", path="variants", seconds=round(time.perf_counter() - t0, 3), **lf_launches)
    check(all(n > 0 for n in lf_launches.values()),
          f"an LF kernel of the variants path never launched: {lf_launches}")
    launches.update(lf_launches)
    say("memory", peak_bytes=torch.cuda.max_memory_allocated(dev))

    def counted(path, names, t0):
        """Read the counts of a path's kernels, just after it ran. The giant
        launches five kernels that the forced-wide path launched before it:
        their entries keep the giant's counts, as they keep its times, and the
        forced-wide path's own stand in its ``launches`` line."""
        torch.cuda.synchronize()
        counts = {name: kernels.LAUNCHES[name] for name in names}
        say("launches", path=path, seconds=round(time.perf_counter() - t0, 3), **counts)
        check(all(n > 0 for n in counts.values()),
              f"a kernel of the {path} path never launched: {counts}")
        launches.update(counts)
        say("memory", peak_bytes=torch.cuda.max_memory_allocated(dev),
            host_peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    lanes = run_variant_turbo_path(sbwt, runs, variants)
    counted("variant_turbo", VARIANT_TURBO_KERNELS, t0)

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    wsb = run_wide_turbo_path(dev, sbwt, runs, lanes)
    counted("wide_turbo", WIDE_KERNELS, t0)

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    run_kmer_access_path(dev, genome, sbwt, wsb, runs)
    counted("kmer_access", KMER_ACCESS_KERNELS, t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    run_device_build_path(dev, genome, sbwt, runs)
    counted("device_build", BUILD_KERNELS, t0)
    torch.cuda.empty_cache()

    results, record = recorder(launches, card, regs)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    parallel = run_parallel_path(sbwt, runs)
    counted("parallel", PARALLEL_KERNELS, t0)
    compare_parallel_kernels(dev, sbwt, runs, parallel, record, card)
    del parallel
    torch.cuda.empty_cache()
    say("parallel", seconds_with_kernel_comparisons=round(time.perf_counter() - t0, 3))

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    probe = run_probe_path(dev)
    counted("probe", PROBE_KERNELS, t0)
    compare_probe(dev, *probe, record, card)
    del probe
    torch.cuda.empty_cache()

    compare_kernels(dev, genome, sbwt, runs, record, card)
    compare_lf_kernels(dev, genome, sbwt, runs, variants, record)
    compare_variant_turbo_kernels(dev, runs, variants, lanes, record)
    compare_wide_kernels_4m(dev, sbwt, wsb, runs, record)
    compare_fast_search(dev, genome, sbwt, wsb, runs, record)
    del sbwt, wsb, runs, variants, lanes
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    giant = run_wide_giant_path(dev)
    counted("wide_giant", GIANT_KERNELS, t0)
    compare_giant_kernels(dev, *giant, record)
    del giant
    torch.cuda.empty_cache()

    compare_build_kernels(dev, genome, record, card, regs)
    torch.cuda.empty_cache()
    run_cli(str(dev))
    run_scaling_example(str(dev))

    check(set(results) == set(ALL_KERNELS), "a kernel was not compared")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sbwt_tpu"))
    check(not loaded, f"modules of JAX or of the JAX package were loaded: {loaded}")
    say("total", seconds=round(time.perf_counter() - t_start, 1), kernel_entries=len(results))
    print(json.dumps({"kernels": [results[name] for name in ALL_KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
