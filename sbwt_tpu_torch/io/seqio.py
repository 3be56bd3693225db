"""FASTA/FASTQ sequence I/O (plain or gzipped).

Host-side equivalent of the SeqIO submodule used by the reference
(format sniffing by extension as in seq_io::figure_out_file_format, used
at src/CLI/sbwt_build.cpp:107; readers/writers as used at
src/CLI/sbwt_search.cpp:46-65 and tests/test_CLI.hh:27-34).  Multi-line
FASTA is supported; multi-line FASTQ is not (same restriction as the
reference).  Parsing is bulk/vectorized: the whole stream is split once
instead of a per-character scanner loop.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from ..utils.dna import reverse_complement_bytes

FASTA_EXTS = {".fna", ".fa", ".fasta", ".ffn", ".faa", ".frn"}
FASTQ_EXTS = {".fq", ".fastq"}


@dataclass
class FileFormat:
    format: str  # "fasta" | "fastq"
    gzipped: bool
    extension: str


def figure_out_file_format(path: str) -> FileFormat:
    p = path
    gz = False
    if p.endswith(".gz"):
        gz = True
        p = p[: -len(".gz")]
    for ext in FASTA_EXTS:
        if p.endswith(ext):
            return FileFormat("fasta", gz, ext + (".gz" if gz else ""))
    for ext in FASTQ_EXTS:
        if p.endswith(ext):
            return FileFormat("fastq", gz, ext + (".gz" if gz else ""))
    raise ValueError(f"cannot determine sequence file format of {path!r}")


def _open_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_sequences(path: str) -> list[bytes]:
    """Read all sequences of a FASTA/FASTQ(.gz) file as raw byte strings."""
    fmt = figure_out_file_format(path)
    data = _open_bytes(path)
    if fmt.format == "fasta":
        seqs = []
        for block in data.split(b">")[1:]:
            nl = block.find(b"\n")
            if nl < 0:
                continue
            seqs.append(block[nl + 1 :].replace(b"\n", b"").replace(b"\r", b""))
        return seqs
    lines = data.split(b"\n")
    return [lines[i].rstrip(b"\r") for i in range(1, len(lines), 4) if lines[i]]


class SequenceWriter:
    """Sequence writer mirroring seq_io::Writer::write_sequence."""

    def __init__(self, path: str, fmt: str | None = None):
        self.fmt = fmt or figure_out_file_format(path).format
        self.f = gzip.open(path, "wb") if path.endswith(".gz") else open(path, "wb")

    def write_sequence(self, seq: bytes | str):
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        if self.fmt == "fasta":
            self.f.write(b">\n" + seq + b"\n")
        else:
            self.f.write(b"@\n" + seq + b"\n+\n" + b"I" * len(seq) + b"\n")

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def create_reverse_complement_files(in_paths: list[str], out_paths: list[str]):
    """Write reverse-complemented copies of sequence files
    (seq_io::create_reverse_complement_files, used at sbwt_build.cpp:115-122)."""
    for src, dst in zip(in_paths, out_paths):
        fmt = figure_out_file_format(src)
        with SequenceWriter(dst, fmt.format) as w:
            for seq in read_sequences(src):
                w.write_sequence(reverse_complement_bytes(seq))


def stream_build_codes(paths: list[str]):
    """Stream input files as encoded int8 code arrays, one sequence at a
    time, in bounded memory — the CLI build's input side (the reference
    likewise streams files through KMC from disk, kmc_construct.hh:206-238,
    never holding the corpus).  Uses the native C reader when available,
    the pure-Python batcher otherwise."""
    from ..utils.dna import encode

    for path in paths:
        try:
            from .. import native

            # bounded 16 MB batches: the reader's defaults are sized for
            # the QUERY runner's million-read device dispatches; the
            # build side must stay inside `-m` RAM-gigas-class budgets
            reader = (
                native.NativeSequenceReader(path, batch_bases=1 << 24)
                if native.available()
                else None
            )
        except Exception:
            reader = None
        if reader is not None:
            with reader:
                for codes, offs in reader:
                    # query codes -> build codes: lowercase (4..7) is not
                    # a valid k-mer character (SBWT.hh:426-427)
                    codes = np.where(codes > 3, np.int8(-1), codes)
                    for i in range(len(offs) - 1):
                        yield codes[offs[i] : offs[i + 1]]
        else:
            for batch in iter_sequence_batches(path):
                for s in batch:
                    yield encode(s)


def read_batches(
    paths: list[str], max_batch_reads: int = 1 << 16
):
    """Yield (reads, path_index) groups of raw byte reads per input file."""
    for pi, path in enumerate(paths):
        for batch in iter_sequence_batches(path, max_reads=max_batch_reads):
            yield batch, pi


def iter_sequence_batches(
    path: str, max_reads: int = 1 << 14, max_bases: int = 1 << 25
):
    """Stream a FASTA/FASTQ(.gz) file as bounded batches of raw reads.

    The pure-Python counterpart of the native streaming reader
    (native/seqio.c): peak memory is one batch, never the whole file —
    the same incremental contract as seq_io::Reader's
    get_next_read_to_buffer loop (used at sbwt_search.cpp:51-55)."""
    fmt = figure_out_file_format(path)
    opener = gzip.open if path.endswith(".gz") else open
    batch: list[bytes] = []
    bases = 0
    with opener(path, "rb") as f:
        if fmt.format == "fasta":
            cur: list[bytes] = []
            started = False
            for line in f:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if started:
                        seq = b"".join(cur)
                        batch.append(seq)
                        bases += len(seq)
                        cur.clear()
                        if len(batch) >= max_reads or bases >= max_bases:
                            yield batch
                            batch, bases = [], 0
                    started = True
                elif started:
                    cur.append(line)
            if started:
                batch.append(b"".join(cur))
        else:
            while True:
                header = f.readline()
                if not header:
                    break
                seq = f.readline().rstrip(b"\r\n")
                f.readline()  # '+'
                f.readline()  # quality
                batch.append(seq)
                bases += len(seq)
                if len(batch) >= max_reads or bases >= max_bases:
                    yield batch
                    batch, bases = [], 0
    if batch:
        yield batch
