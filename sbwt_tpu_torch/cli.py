"""Command-line interface of the port: ``build``, ``search`` and
``build-variant``, with the flags and output bytes of sbwt_tpu/cli.py,
for all ten variants.

Each takes ``--device`` (default ``cuda``): on a CUDA device the index and
queries run the hand-written kernels; ``--device cpu`` runs their plain
PyTorch versions. Search runs the turbo successor engine on any index that
can have its table (built from the index's own ranks, whatever the
variant; an index of 2^31 columns or more has the arity-1 tier only), and
the LF engine otherwise (``--engine lf``, no streaming support, or a table
that does not fit). ``ascii-export`` is not yet ported.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .utils.logging import LogLevel, set_log_level, write_log

MAX_KMER_LENGTH = 255  # the reference's compile-time ceiling (CMakeLists.txt:71-81)
NOT_PORTED_COMMANDS = ("ascii-export",)


def _readlines(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _input_file_list(arg: str) -> list[str]:
    if arg.endswith(".txt"):
        return _readlines(arg)
    return [arg]


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false "
            "(use --device cpu for the plain PyTorch versions)"
        )
    return device


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and queries (default: cuda)")


def build_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu-torch build",
                                description="Construct an SBWT variant.")
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("-k", "--kmer-length", type=int, required=True)
    p.add_argument("-p", "--precalc-length", type=int, default=8)
    p.add_argument("--variant", default="plain-matrix")
    p.add_argument("--add-reverse-complements", action="store_true")
    p.add_argument("--no-streaming-support", action="store_true")
    p.add_argument("-t", "--n-threads", type=int, default=1)
    p.add_argument("-a", "--min-abundance", type=int, default=1)
    p.add_argument("-b", "--max-abundance", type=int, default=1000000000)
    p.add_argument("-m", "--ram-gigas", type=int, default=2)
    p.add_argument("-d", "--temp-dir", default=".")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--format", choices=["cpp", "native"], default="cpp")
    _add_device_flag(p)
    args = p.parse_args(argv)

    from .io import seqio
    from .io.serialize import save
    from .models.sbwt import SBWT, require_known_variant

    if args.verbose:
        set_log_level(LogLevel.MINOR)
    require_known_variant(args.variant)
    device = _device(args.device)
    k = args.kmer_length
    if k > MAX_KMER_LENGTH:
        sys.stderr.write(f"Error: k = {k} exceeds MAX_KMER_LENGTH = {MAX_KMER_LENGTH}\n")
        return 1
    precalc = min(args.precalc_length, k)
    if precalc != args.precalc_length:
        write_log(f"Warning: precalc length {args.precalc_length} is longer than k = {k}")
        write_log(f"Setting precalc length to {k}")

    input_files = _input_file_list(args.in_file)
    fmts = [seqio.figure_out_file_format(f) for f in input_files]
    if len({(f.format, f.gzipped) for f in fmts}) > 1:
        sys.stderr.write("Error: not all input files have the same format\n")
        return 1
    # decompressed-size estimate for the build-method heuristic only
    # (gzip of DNA text compresses ~4x)
    input_bases = sum(
        os.path.getsize(f) * (4 if f.endswith(".gz") else 1) for f in input_files
    )

    write_log("Building SBWT subset sequence")
    sbwt = SBWT.build(
        seqio.stream_build_codes(input_files),
        k,
        device,
        streaming_support=not args.no_streaming_support,
        precalc_k=precalc,
        min_abundance=args.min_abundance,
        max_abundance=args.max_abundance if args.max_abundance < 10**9 else None,
        add_reverse_complements=args.add_reverse_complements,
        ram_bytes=args.ram_gigas << 30,
        n_threads=args.n_threads,
        temp_dir=args.temp_dir,
        input_bases=input_bases,
        variant=args.variant,
    )
    write_log(f"Built SBWT for {sbwt.number_of_kmers()} distinct k-mers")
    write_log(f"SBWT has {sbwt.number_of_subsets()} subsets")

    bytes_written = save(args.out_file, sbwt, args.format)
    write_log(f"Built variant {args.variant} to file {args.out_file}")
    write_log(
        "Space on disk: "
        f"{bytes_written * 8.0 / sbwt.number_of_subsets()} bits per column, "
        f"{bytes_written * 8.0 / max(1, sbwt.number_of_kmers())} bits per k-mer"
    )
    return 0


def search_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu-torch search",
                                description="Query all k-mers of all input reads.")
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("-i", "--index-file", required=True)
    p.add_argument("-q", "--query-file", required=True)
    p.add_argument("-z", "--gzip-output", action="store_true")
    p.add_argument("--engine", choices=["auto", "lf", "turbo", "turbo1", "turbo2", "turbo3"],
                   default="auto",
                   help="lf: the LF rank engine over the variant's own structure; "
                        "turbo1/2/3: successor table of that arity (16 B, 128 B, "
                        "1 KiB of device memory per column), built from any "
                        "variant's ranks; turbo/auto: the largest arity that fits "
                        "free device memory, degrading 3 -> 2 -> 1 -> LF.")
    _add_device_flag(p)
    args = p.parse_args(argv)

    t_start = time.perf_counter()
    set_log_level(LogLevel.MINOR)
    device = _device(args.device)

    from .io.query_runner import run_query_files
    from .io.serialize import load
    from .ops.turbo import TurboUnavailable

    multi = args.query_file.endswith(".txt")
    in_files = _readlines(args.query_file) if multi else [args.query_file]
    out_files = _readlines(args.out_file) if multi else [args.out_file]
    if len(in_files) != len(out_files):
        raise RuntimeError(
            f"Number of input and output files does not match ({len(in_files)} vs {len(out_files)})"
        )

    sbwt = load(args.index_file, device)
    write_log(f"Loaded the index variant {sbwt.variant}")
    # without streaming support the query runner answers each k-mer by full
    # search, so auto tries no table
    want_turbo = args.engine.startswith("turbo") or (
        args.engine == "auto" and sbwt.has_streaming_query_support())
    if want_turbo:
        # as sbwt_tpu/cli.py:159-173, an index that cannot have a table runs
        # LF; a failure to build or launch a kernel still ends the run
        try:
            chosen = sbwt.enable_turbo(arity={"turbo1": 1, "turbo2": 2, "turbo3": 3}.get(args.engine))
            if chosen is None:
                write_log("Turbo table exceeds free device memory; using LF engine")
            else:
                write_log(f"Turbo successor engine enabled (arity {chosen})")
        except TurboUnavailable as e:
            write_log(f"Turbo engine unavailable ({e}); using LF engine")
    n = run_query_files(sbwt, in_files, out_files, args.gzip_output)
    total = time.perf_counter() - t_start
    if n:
        write_log(f"us/query end-to-end: {total * 1e6 / n}")
    return 0


def build_variant_main(argv) -> int:
    p = argparse.ArgumentParser(prog="sbwt-tpu-torch build-variant",
                                description="Re-encode a plain-matrix index into another variant.")
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("--variant", default="plain-matrix")
    p.add_argument("--format", choices=["cpp", "native"], default="cpp")
    _add_device_flag(p)
    args = p.parse_args(argv)

    from .io.serialize import load, save
    from .models.sbwt import VARIANT_NAMES

    if args.variant not in VARIANT_NAMES:
        sys.stderr.write(f"Error: unknown variant: {args.variant}\n")
        return 1
    device = _device(args.device)
    write_log("Reading input.")
    sbwt = load(args.in_file, device)
    if sbwt.variant != "plain-matrix":
        sys.stderr.write("Error: input index is not a plain-matrix SBWT\n")
        return 1
    write_log(f"Building variant {args.variant}")
    sbwt = sbwt.to_variant(args.variant)
    bytes_written = save(args.out_file, sbwt, args.format)
    write_log(f"Built variant {args.variant} to file {args.out_file}")
    write_log(
        "Space on disk: "
        f"{bytes_written * 8.0 / sbwt.number_of_subsets()} bits per column, "
        f"{bytes_written * 8.0 / max(1, sbwt.number_of_kmers())} bits per k-mer"
    )
    return 0


COMMANDS = {"build": build_main, "search": search_main, "build-variant": build_variant_main}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    write_log(f"Maximum k-mer length is set to {MAX_KMER_LENGTH}")
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("Available commands:\n")
        for c in COMMANDS:
            sys.stderr.write(f"   sbwt-tpu-torch {c}\n")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in NOT_PORTED_COMMANDS:
        sys.stderr.write(f"Error: {cmd} is not yet ported to sbwt_tpu_torch\n")
        return 1
    if cmd not in COMMANDS:
        sys.stderr.write(f"Invalid command: {cmd}\n")
        return 1
    try:
        return COMMANDS[cmd](rest)
    except Exception as e:  # mirror the reference's top-level catch (sbwt.cpp:51-57)
        sys.stderr.write(f"Error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
