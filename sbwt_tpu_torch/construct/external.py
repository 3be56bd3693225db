"""Out-of-core SBWT construction for inputs larger than RAM.

Replaces the reference's KMC + EM-sort pipeline (include/sbwt/
kmc_construct.hh:206-238, src/run_kmc.cpp:655-735, src/EM_sort/): the
k-mer multiset is spilled to disk as packed uint64 records (word order ==
colex order, utils/kmers.py), sorted by the native multithreaded
external-memory sorter (native/emsort.c), deduplicated with abundance
cutoffs in one streaming pass, and the bit matrix is emitted directly
from the sorted distinct file in bounded chunks (construct/streaming.py,
the build_bit_vectors_from_sorted_streams equivalent).

Peak RAM is O(chunk) + the output bit rows themselves — matching the
reference's O(1)-memory stream-merge guarantee (kmc_construct.hh:43-99),
not merely the distinct-set size.  tests/test_streaming_build.py enforces
this under a hard RLIMIT_AS.
"""
from __future__ import annotations

import os

import numpy as np

from .. import native
from ..utils import kmers as km
from ..utils.dna import encode
from ..utils.logging import write_log
from ..utils.tempfiles import get_temp_file_manager
from .inmemory import BuiltSBWT, build_from_kmers


def _iter_code_chunks(seqs, add_reverse_complements=False):
    from .inmemory import encode_rc

    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode(s)
        yield codes
        if add_reverse_complements:
            yield encode_rc(codes)


def build_sbwt_external(
    seqs,
    k: int,
    streaming_support: bool = True,
    min_abundance: int = 1,
    max_abundance: int | None = None,
    add_reverse_complements: bool = False,
    ram_bytes: int = 2 << 30,
    n_threads: int = 4,
    temp_dir: str | None = None,
) -> BuiltSBWT:
    """Disk-backed construction; same result as construct.inmemory.build_sbwt."""
    tfm = get_temp_file_manager()
    if temp_dir is not None:
        tfm.set_dir(temp_dir)
    raw = tfm.create_filename("kmers_", ".bin")
    sorted_f = tfm.create_filename("kmers_sorted_", ".bin")
    distinct_f = tfm.create_filename("kmers_distinct_", ".bin")

    wide = k > km.MAX_K
    if wide:
        from ..utils import kmers_wide as kw

        W = kw.n_words(k)
    else:
        W = 1

    from ..utils.logging import LogLevel, get_log_level
    from ..utils.profiling import ProgressPrinter

    n_seqs = (2 if add_reverse_complements else 1) * (
        len(seqs) if hasattr(seqs, "__len__") else 0
    )
    progress = (
        ProgressPrinter(n_seqs)
        if n_seqs and get_log_level() >= LogLevel.MAJOR
        else None
    )
    n_windows = 0
    use_native_spill = not wide and native.available()
    if use_native_spill:
        # one native rolling pass per chunk packs + filters + appends:
        # the numpy packer is k shifted full-array passes (O(n*k)) and
        # was ~70% of the whole external build at k=30
        open(raw, "wb").close()
        for codes in _iter_code_chunks(seqs, add_reverse_complements):
            codes = codes if isinstance(codes, np.ndarray) else encode(codes)
            n_windows += native.spill_windows_u64(codes, k, raw, n_threads=n_threads)
            if progress is not None:
                progress.job_done()
    else:
        with open(raw, "wb") as f:
            for codes in _iter_code_chunks(seqs, add_reverse_complements):
                if wide:
                    vals, valid = kw.pack_windows(codes, k)
                else:
                    vals, valid = km.pack_windows(codes, k)
                if vals.size:
                    kept = np.ascontiguousarray(vals[valid])
                    kept.tofile(f)
                    n_windows += len(kept)
                if progress is not None:
                    progress.job_done()
    write_log(f"external build: spilled {n_windows} k-mer records")

    # fused sort+dedup: in-RAM inputs never round-trip a sorted file
    n_distinct = native.em_sort_dedup_records_file(
        raw, distinct_f, tfm.get_dir(), W,
        ram_bytes=ram_bytes, n_threads=n_threads,
        min_abund=min_abundance,
        max_abund=max_abundance if max_abundance is not None else 2**62,
    )
    tfm.delete_file(raw)
    write_log(f"external build: {n_distinct} distinct k-mers after cutoffs")

    from .streaming import build_streaming

    built = build_streaming(
        distinct_f,
        int(n_distinct),
        k,
        streaming_support,
        ram_bytes=ram_bytes,
        n_threads=n_threads,
        tfm=tfm,
    )
    tfm.delete_file(distinct_f)
    return built
