#!/usr/bin/env python3
"""Smoke test of sbwt_tpu_torch on one CUDA card: the port's main path at
the bench's real size, every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of the repository

Phases, one line each; any failure exits nonzero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles K1-K4, K14 and K19 from sbwt_tpu_torch/csrc, one
   process per source;
3. main path (launches counted): ``SBWT.build`` of a 4 Mbp uniform random
   genome (numpy seed 20260817, as bench.py) at k = 30 with precalc_k = 13
   (K1's fill), ``enable_turbo(arity=3)`` (K2, K3),
   ``streaming_search_batch`` of 1M reads of 100 bp at the hit98 and hit0
   mixes (K4) and ``search_batch`` of their first k-mers (K1's search);
4. variants path (launches counted): for each of the ten variants,
   ``to_variant`` (carrying the p = 13 table), ``streaming_search_batch``
   of both 1M-read batches on the LF engine (K14 over the variant's ranks,
   K15-K17), whose answers must equal K4's, ``search_batch`` of 1M 30-mers
   (the variant's K1 search) and the variant's K1 fill at p = 12;
5. device build (launches counted): ``SBWT.build_on_device`` (K19) of the
   same genome with precalc_k = 13, whose tables, counts and p = 13 table
   must equal phase 3's host-built index word for word and whose turbo
   answers to the hit98 batch must equal phase 3's; then of the first
   200,000 reads of the hit98 batch as separate sequences, equal to the
   host build of the same reads;
6. kernels against their plain versions on the card, at the main path's
   shapes, with times: K1 on plain-matrix (the p = 13 fill, the 1M
   30-mers), K2, K3, K4 on each whole 1M-read batch; K14 of each variant
   on the first 2^16 reads of each mix and on a batch with lowercase, N
   and short lengths; each variant's K1 search on the 1M 30-mers and fill
   at p = 8, and its p = 12 table of phase 4 against the plain version's;
   K19's four kernels at the genome build's shapes, the build's sorts, and
   the build's time split by stage;
7. the CLI (``python -m sbwt_tpu_torch build`` / ``build-variant`` /
   ``search``) on the reference's golden inputs, byte-equal to the golden
   output, on plain-matrix (turbo) and rrr-split (LF).

It prints one JSON line of per-kernel results (launches on its path, error
against the plain version, time, the plain version's time, and the least
time the card could take: compulsory bytes over the HBM rate or counted
operations over the peak rate, whichever is larger), the card's nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 2 and prints no result. Every output is an integer, so each
comparison is exact (max_abs_err must be 0). At its end no ``jax`` and no
``sbwt_tpu`` module may be loaded.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and the float32 rate outside the
# tensor cores, which stands in for the integer ALU rate of these kernels
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# kernel entry point -> (source, the XLA program it replaces)
KERNELS = {
    "precalc_fill[plain-matrix]": ("sbwt_tpu_torch/csrc/lf_stream.cu",
                                   "sbwt_tpu/models/matrix.py:267"),
    "kmer_search[plain-matrix]": ("sbwt_tpu_torch/csrc/lf_stream.cu", "sbwt_tpu/ops/search.py:83"),
    "succ1": ("sbwt_tpu_torch/csrc/succ_table.cu", "sbwt_tpu/ops/turbo.py:294"),
    "succ_compose": ("sbwt_tpu_torch/csrc/succ_table.cu", "sbwt_tpu/ops/turbo.py:342"),
    "seed_bits": ("sbwt_tpu_torch/csrc/seed_bits.cu", "sbwt_tpu/ops/turbo.py:271"),
    "turbo_stream": ("sbwt_tpu_torch/csrc/turbo_stream.cu", "sbwt_tpu/ops/turbo.py:610"),
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


ALL_KERNELS = {**KERNELS, **LF_KERNELS, **BUILD_KERNELS}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# Work of the LF and turbo kernels from their shapes, as (bytes moved,
# integer operations). How many LF steps a lane takes before it empties
# depends on the data, so operations are counted low: the one step that
# every row, k-mer or answer needs, at LF_OPS operations (a rank pair with
# its interval update: shifts, masks, a popcount, adds, read off the
# source). The bound stays a lower bound.
LF_OPS = 40


def fill_work(structure_bytes: int, p: int):
    """K1 fill: the structure read once, the table written."""
    return structure_bytes + 4**p * 8, 4**p * LF_OPS


def search_work(structure_bytes: int, B: int, k: int):
    """K1 search: codes, one precalc row and the answer per k-mer."""
    return structure_bytes + B * (k + 8 + 4), B * LF_OPS


def stream_work(B: int, L: int, k: int):
    """K4, K14: codes and lengths in, answers out. The table rows a read
    walks depend on the data and are left out."""
    return B * L + 4 * B + B * (L - k + 1) * 4, B * (L - k + 1) * LF_OPS


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
    return genome, sbwt, runs


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
            to_variant_seconds=round(build_s, 3), **fields)
    return out


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


def compare_build_kernels(dev, genome, record):
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
           nbytes(codes, keys, valid), keys.shape[0] * K * 4, shape=tuple(keys.shape))
    valid_keys = keys[valid]
    sort_kmers_ms = cuda_ms(lambda: td.colex_order(valid_keys), 3)
    del keys, valid, plain

    dv = td.sorted_distinct_kmers(codes, K)
    n = dv.shape[0]
    probe = kernels.edge_src_probe(dv, K)
    plain = td.edge_src_probe_plain(dv, K)
    groups = int(probe[1].sum())
    # a search is ceil(log2 n) steps of W word compares; four a group start, one a k-mer
    record("edge_src_probe", sum(max_abs_err(a, b) for a, b in zip(probe, plain)),
           cuda_ms(lambda: kernels.edge_src_probe(dv, K), 5),
           cuda_ms(lambda: td.edge_src_probe_plain(dv, K), 1),
           nbytes(dv, *probe), (4 * groups + n) * n.bit_length() * 4 * W,
           shape=tuple(dv.shape), group_starts=groups, sources=int(probe[2].sum()))
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
    tables = kernels.finalize_tables(*nodes, K, True)
    plain = td.finalize_tables_plain(*nodes, K, True)
    record("finalize_tables", sum(max_abs_err(a, b) for a, b in zip(tables, plain)),
           cuda_ms(lambda: kernels.finalize_tables(*nodes, K, True), 5),
           cuda_ms(lambda: td.finalize_tables_plain(*nodes, K, True), 1),
           nbytes(*nodes, *tables), nodes[0].shape[0] * 4 * W, shape=tuple(nodes[0].shape))
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
        device_ms=cuda_ms(build, 3), sort_kmers_ms=sort_kmers_ms, sort_nodes_ms=sort_nodes_ms)
    profile_build(dev, codes)


def recorder(launches: dict, card: str):
    """The per-kernel results of the JSON line, and the function that checks
    and adds one."""
    results = {}

    def record(name, err, ms, plain_ms, moved, ops, **extra):
        """moved: the bytes the function must move at this shape (each input
        read once, each output written once; of a table read at random, the
        rows this run's data asks for). ops: its integer operations, counted
        from the shape. No single PyTorch call computes any of these
        functions, so library_ms is null."""
        check(err == 0, f"{name}: kernel differs from its plain version (max_abs_err {err})")
        src, replaces = ALL_KERNELS[name]
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3
        results[name] = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": launches[name], "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                         "library_ms": None}
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=results[name]["bound_ms"], bound_by=results[name]["bound_by"],
            bytes_moved=moved, card=repr(card), **extra)

    return results, record


def compare_kernels(dev, genome, sbwt, runs, record):
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
    k_km = lambda: ts.search_batch(di, km)
    record("kmer_search[plain-matrix]", max_abs_err(k_km(), ts.search_batch_plain(di, km)),
           cuda_ms(k_km, 5), cuda_ms(lambda: ts.search_batch_plain(di, km), 1),
           *search_work(di.size_in_bytes(), *km.shape), shape=tuple(km.shape))

    k_s1 = lambda: kernels.succ1(di.rank_tbl, di.n_words, di.sgs_tbl, di.C, di.n_nodes)
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
           + max_abs_err(k_sb(), turbo.seed_bits), cuda_ms(k_sb, 5),
           cuda_ms(lambda: tt.seed_bits_plain(di.precalc, p), 1),
           nbytes(di.precalc, turbo.seed_bits), 4 ** (p + 1) * 4, shape=tuple(turbo.seed_bits.shape))

    n_answers = None
    for mix, (codes_np, ans_np) in runs.items():
        codes = torch.from_numpy(codes_np).to(dev)
        lengths = torch.full((len(codes),), READ_LEN, dtype=torch.int32, device=dev)
        stream = lambda: tt.turbo_streaming_search(turbo, di, codes, lengths)
        out = stream()
        check(torch.equal(out.cpu(), torch.from_numpy(ans_np)), f"{mix}: rerun differs")
        checksum = int(torch.sum(out, dtype=torch.int64).item())
        check(checksum == int(ans_np.sum(dtype=np.int64)), f"{mix}: checksum")
        # the plain version on the whole batch; its one run is also its time
        plain, plain_ms = timed_ms(
            lambda: tt.turbo_streaming_search_plain(turbo, di, codes, lengths))
        err = max_abs_err(out, plain)
        del out, plain
        ms = cuda_ms(stream, 5)
        n_answers = ans_np.size
        extra = dict(mix=mix, reads=len(codes_np), checksum=checksum,
                     hit_fraction=float((ans_np >= 0).mean()),
                     answers_per_s=n_answers / (ms / 1e3),
                     plain_answers_per_s=n_answers / (plain_ms / 1e3))
        if mix == "hit98":
            record("turbo_stream", err, ms, plain_ms, *stream_work(len(codes_np), READ_LEN, K),
                   **extra)
        else:
            check(err == 0, f"turbo_stream {mix}: kernel differs from its plain version")
            say("kernel", name="turbo_stream", max_abs_err=err, ms=ms, plain_ms=plain_ms, **extra)
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
            extra = dict(variant=v, mix=mix, shape=tuple(sc.shape), full_batch_ms=ms_full,
                         answers_per_s=answers / (ms_full / 1e3),
                         plain_answers_per_s=plain.numel() / (plain_ms / 1e3))
            del got, plain
            if mix == "hit98":
                record(name, err, cuda_ms(sample, 3), plain_ms,
                       *stream_work(PLAIN_READS, READ_LEN, K), **extra)
            else:
                check(err == 0, f"{name} {mix}: kernel differs from its plain version")
                say("kernel", name=name, max_abs_err=err, ms=cuda_ms(sample, 3),
                    plain_ms=plain_ms, **extra)
        got = ts.streaming_search(di, *spiked)
        err = max_abs_err(got, ts.streaming_search_plain(di, *spiked))
        check(err == 0, f"{name} spiked batch: kernel differs from its plain version")
        say("kernel", name=name, batch="lowercase_N_short_lengths", reads=len(spiked_np),
            max_abs_err=err, hit_fraction=float((got >= 0).float().mean()))
        if v == "plain-matrix":
            continue
        k_km = lambda: ts.search_batch(di, km)
        plain, plain_ms = timed_ms(lambda: ts.search_batch_plain(di, km))
        record(f"kmer_search[{v}]", max_abs_err(k_km(), plain), cuda_ms(k_km, 5), plain_ms,
               *search_work(di.size_in_bytes(), *km.shape), shape=tuple(km.shape))
        desc = di.kernel_desc(dev)
        k_pre = lambda: kernels.precalc_fill(v, desc, di.C, di.n_nodes, 8)
        plain, plain_ms = timed_ms(lambda: tm.precalc_fill_plain(di, 8))
        err = max_abs_err(k_pre(), plain)
        ms12 = cuda_ms(lambda: kernels.precalc_fill(v, desc, di.C, di.n_nodes, GENERIC_P), 3)
        record(f"precalc_fill[{v}]", err, cuda_ms(k_pre, 5), plain_ms,
               *fill_work(di.size_in_bytes(), 8), shape=(4**8, 2),
               p12_ms=ms12, p12_shape=tuple(ref12.shape))
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
        index, rrr = tmp / "index.sbwt", tmp / "rrr-split.sbwt"
        cli = [sys.executable, "-m", "sbwt_tpu_torch"]
        for argv in (
            ["build", "-i", str(tmp / "inputs.txt"), "-o", str(index), "-k", "6",
             "--add-reverse-complements", "--temp-dir", str(tmp), "--precalc-length", "4"],
            ["search", "-i", str(index), "-q", str(tmp / "q.fna"), "-o", str(tmp / "o1.txt")],
            ["search", "-i", str(index), "-q", str(tmp / "q.fq"), "-o", str(tmp / "o2.txt")],
            ["build-variant", "-i", str(index), "-o", str(rrr), "--variant", "rrr-split"],
            ["search", "-i", str(rrr), "-q", str(tmp / "q.fq"), "-o", str(tmp / "o3.txt"),
             "--engine", "lf"],
        ):
            proc = subprocess.run(cli + argv + ["--device", device], cwd=REPO, env=env,
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"CLI {argv[0]} failed:\n{proc.stderr[-2000:]}")
        for name in ("o1.txt", "o2.txt", "o3.txt"):
            check((tmp / name).read_text() == GOLDEN, f"CLI output {name} differs from GOLDEN")
    say("cli", golden="byte-equal", files=3, variants="plain-matrix (turbo), rrr-split (lf)")


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

    t0 = time.perf_counter()
    lib, compile_s = kernels.build()
    regs = [line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
            if "registers" in line]
    say("build", library=lib.name, nvcc_seconds=round(compile_s, 3),
        seconds=round(time.perf_counter() - t0, 3))
    for line in regs:
        print(f"  ptxas: {line}")

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    genome, sbwt, runs = run_main_path(dev)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in KERNELS}
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

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    run_device_build_path(dev, genome, sbwt, runs)
    torch.cuda.synchronize()
    build_launches = {name: kernels.LAUNCHES[name] for name in BUILD_KERNELS}
    say("launches", path="device_build", seconds=round(time.perf_counter() - t0, 3),
        **build_launches)
    check(all(n > 0 for n in build_launches.values()),
          f"a build kernel of the device_build path never launched: {build_launches}")
    launches.update(build_launches)
    torch.cuda.empty_cache()
    say("memory", peak_bytes=torch.cuda.max_memory_allocated(dev))

    results, record = recorder(launches, card)
    compare_kernels(dev, genome, sbwt, runs, record)
    compare_lf_kernels(dev, genome, sbwt, runs, variants, record)
    del sbwt, runs, variants
    torch.cuda.empty_cache()
    compare_build_kernels(dev, genome, record)
    torch.cuda.empty_cache()
    run_cli(str(dev))

    check(set(results) == set(ALL_KERNELS), "a kernel was not compared")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sbwt_tpu"))
    check(not loaded, f"modules of JAX or of the JAX package were loaded: {loaded}")
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
