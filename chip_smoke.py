#!/usr/bin/env python3
"""Smoke test of sbwt_tpu_torch on one CUDA card: the port's main path at
the bench's real size, every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of the repository

Phases, one line each; any failure exits nonzero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles K1-K4 from sbwt_tpu_torch/csrc;
3. main path (launches counted): ``SBWT.build`` of a 4 Mbp uniform random
   genome (numpy seed 20260817, as bench.py) at k = 30 with precalc_k = 13
   (K1), ``enable_turbo(arity=3)`` (K2, K3), ``streaming_search_batch`` of
   1M reads of 100 bp at the hit98 and hit0 mixes (K4) and
   ``search_batch`` of their first k-mers (K1);
4. kernels against their plain versions on the card, at the main path's
   shapes (K4 on each whole 1M-read batch), with times;
5. the CLI (``python -m sbwt_tpu_torch build`` / ``search``) on the
   reference's golden inputs, byte-equal to the golden output.

It prints one JSON line of per-kernel results, the card's nvidia-smi line,
and last ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
2 and prints no result. Every output is an integer, so each comparison is
exact (max_abs_err must be 0).
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

# kernel entry point -> (source, the XLA program it replaces)
KERNELS = {
    "precalc_fill": ("sbwt_tpu_torch/csrc/lf_interval.cu", "sbwt_tpu/models/matrix.py:267"),
    "kmer_search": ("sbwt_tpu_torch/csrc/lf_interval.cu", "sbwt_tpu/ops/search.py:83"),
    "succ1": ("sbwt_tpu_torch/csrc/succ_table.cu", "sbwt_tpu/ops/turbo.py:294"),
    "succ_compose": ("sbwt_tpu_torch/csrc/succ_table.cu", "sbwt_tpu/ops/turbo.py:342"),
    "seed_bits": ("sbwt_tpu_torch/csrc/seed_bits.cu", "sbwt_tpu/ops/turbo.py:271"),
    "turbo_stream": ("sbwt_tpu_torch/csrc/turbo_stream.cu", "sbwt_tpu/ops/turbo.py:610"),
}


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


def compare_kernels(dev, genome, sbwt, runs, launches, card: str):
    """Each kernel against its plain version on the main path's shapes."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.models import matrix as tm
    from sbwt_tpu_torch.ops import search as ts
    from sbwt_tpu_torch.ops import turbo as tt

    di, turbo = sbwt.device_index, sbwt._turbo
    results = {}

    def record(name, err, ms, plain_ms, **extra):
        check(err == 0, f"{name}: kernel differs from its plain version (max_abs_err {err})")
        src, replaces = KERNELS[name]
        results[name] = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": launches[name], "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms}
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, card=repr(card), **extra)

    p = di.precalc_k
    k_pre = lambda: kernels.precalc_fill(di.rank_tbl, di.n_words, di.C, di.n_nodes, p)
    plain = tm.precalc_fill_plain(di, p)
    record("precalc_fill", max_abs_err(k_pre(), plain) + max_abs_err(di.precalc, plain),
           cuda_ms(k_pre, 3), cuda_ms(lambda: tm.precalc_fill_plain(di, p), 1),
           shape=tuple(plain.shape))
    del plain

    km = torch.from_numpy(np.ascontiguousarray(runs["hit98"][0][:, :K])).to(dev)
    k_km = lambda: ts.search_batch(di, km)
    record("kmer_search", max_abs_err(k_km(), ts.search_batch_plain(di, km)),
           cuda_ms(k_km, 5), cuda_ms(lambda: ts.search_batch_plain(di, km), 1),
           shape=tuple(km.shape))

    k_s1 = lambda: kernels.succ1(di.rank_tbl, di.n_words, di.sgs_tbl, di.C, di.n_nodes)
    succ = k_s1()
    record("succ1", max_abs_err(succ, tt.succ1_plain(di)), cuda_ms(k_s1, 5),
           cuda_ms(lambda: tt.succ1_plain(di), 1), shape=tuple(succ.shape))

    err = max_abs_err(turbo.tbl, tt.compose_plain(succ, ARITY))
    plain_ms = cuda_ms(lambda: tt.compose_plain(succ, ARITY), 1)
    record("succ_compose", err, cuda_ms(lambda: kernels.succ_compose(succ, ARITY), 3), plain_ms,
           shape=tuple(turbo.tbl.shape))
    del succ

    k_sb = lambda: kernels.seed_bits(di.precalc, p)
    record("seed_bits", max_abs_err(turbo.seed_bits, tt.seed_bits_plain(di.precalc, p))
           + max_abs_err(k_sb(), turbo.seed_bits), cuda_ms(k_sb, 5),
           cuda_ms(lambda: tt.seed_bits_plain(di.precalc, p), 1), shape=tuple(turbo.seed_bits.shape))

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
            record("turbo_stream", err, ms, plain_ms, **extra)
        else:
            check(err == 0, f"turbo_stream {mix}: kernel differs from its plain version")
            say("kernel", name="turbo_stream", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                card=repr(card), **extra)
        del codes, lengths

    codes_np, lengths_np = spiked_reads(genome, 4096, 11)
    codes, lengths = torch.from_numpy(codes_np).to(dev), torch.from_numpy(lengths_np).to(dev)
    got = tt.turbo_streaming_search(turbo, di, codes, lengths)
    err = max_abs_err(got, tt.turbo_streaming_search_plain(turbo, di, codes, lengths))
    check(err == 0, "turbo_stream spiked batch: kernel differs from its plain version")
    say("kernel", name="turbo_stream", batch="lowercase_N_short_lengths", reads=len(codes_np),
        max_abs_err=err, hit_fraction=float((got >= 0).float().mean()))
    return [results[name] for name in KERNELS]


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
        index = tmp / "index.sbwt"
        cli = [sys.executable, "-m", "sbwt_tpu_torch"]
        for argv in (
            ["build", "-i", str(tmp / "inputs.txt"), "-o", str(index), "-k", "6",
             "--add-reverse-complements", "--temp-dir", str(tmp), "--precalc-length", "4",
             "--device", device],
            ["search", "-i", str(index), "-q", str(tmp / "q.fna"), "-o", str(tmp / "o1.txt"),
             "--device", device],
            ["search", "-i", str(index), "-q", str(tmp / "q.fq"), "-o", str(tmp / "o2.txt"),
             "--device", device],
        ):
            proc = subprocess.run(cli + argv, cwd=REPO, env=env, capture_output=True, text=True,
                                  timeout=600)
            check(proc.returncode == 0, f"CLI {argv[0]} failed:\n{proc.stderr[-2000:]}")
        for name in ("o1.txt", "o2.txt"):
            check((tmp / name).read_text() == GOLDEN, f"CLI output {name} differs from GOLDEN")
    say("cli", golden="byte-equal", files=2)


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
    launches = dict(kernels.LAUNCHES)
    say("launches", **launches)
    check(all(launches[name] > 0 for name in KERNELS), f"a kernel of the path never launched: {launches}")
    say("memory", peak_main_path_bytes=torch.cuda.max_memory_allocated(dev))

    results = compare_kernels(dev, genome, sbwt, runs, launches, card)
    del sbwt, runs
    torch.cuda.empty_cache()
    run_cli(str(dev))

    print(json.dumps({"kernels": results}))
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
