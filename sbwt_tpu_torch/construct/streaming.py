"""Streaming bit-matrix construction from a sorted distinct k-mer file.

Bounded-memory counterpart of `build_bit_vectors_from_sorted_streams`
(reference include/sbwt/kmc_construct.hh:43-99) and the char-cursor edge
detection of `write_nodes_and_dummies` (kmc_construct.hh:102-203), re-cast
as chunked numpy array passes so peak RAM is O(chunk) + O(output bits)
instead of O(distinct-kmer records):

  phase 1 (one pass + one block-restricted pass of the sorted file):
    the main cursor streams sorted k-mers in chunks, detects suffix-group
    starts, and probes `suffix . c` against four per-last-character block
    cursors (the colex order is partitioned by last character, which is
    why the reference clones four DB cursors, kmc_construct_helper_classes
    .hh:97-166).  Probe hits become the group's out-edge bits (spilled to
    an edge-flags sidecar file); records a block cursor passes over
    without ever being probed have no predecessor, and emit their k dummy
    prefixes — (value, length, edge) records — to a dummy spill file
    (add_prefixes, kmc_construct.hh:30-40).

  phase 2: the dummy records are EM-sorted by (value, length) via the
    native multithreaded sorter (word-lexicographic (W+1)-word records).

  phase 3 (one pass over both files): sorted deduped dummies (edge sets
    OR-merged, like the reference's dummy dedup in
    build_bit_vectors_from_sorted_streams) are merge-joined with the
    k-mers + edge flags, emitting the four indicator rows and the
    suffix-group-starts vector chunk by chunk.

The result is bit-for-bit identical to construct.inmemory.build_from_kmers
(differential tests in tests/test_external_build.py), but an input whose
distinct set exceeds RAM builds fine — tests/test_streaming_build.py
enforces this under a hard RLIMIT_AS in a subprocess.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import native
from ..utils import kmers as km
from ..utils import kmers_wide as kw
from .inmemory import BuiltSBWT

_U64 = np.uint64
_NO_EDGE = 0xFF  # edge byte for the root dummy (no outgoing label)


class _PackedAccum:
    """Incremental byte-packer for a stream of bool chunks.

    The reference appends construction output into 1-bit sdsl vectors
    (kmc_construct.hh:43-99, ~5 bits/column total); accumulating numpy
    bool chunks and concatenating at the end would instead cost
    1 byte/column/row plus a 2x transient — 40-80x the reference's memory
    for the dominant O(n) term.  This packer keeps everything at
    1 bit/entry across chunk boundaries: peak RAM = packed bytes so far
    + one chunk."""

    def __init__(self):
        self.parts: list[np.ndarray] = []
        self.rem = np.zeros(0, dtype=bool)
        self.n_bits = 0

    def add(self, bits: np.ndarray):
        self.n_bits += len(bits)
        b = np.concatenate([self.rem, bits]) if len(self.rem) else bits
        nfull = (len(b) // 8) * 8
        if nfull:
            self.parts.append(np.packbits(b[:nfull], bitorder="little"))
        self.rem = b[nfull:].copy()

    @property
    def n_bytes(self) -> int:
        return (self.n_bits + 7) // 8

    def finish_into(self, out: np.ndarray) -> None:
        """Drain the packed parts into a preallocated byte buffer —
        no concatenate transient (at 100M+ columns the 2x copy is real)."""
        if len(self.rem):
            self.parts.append(np.packbits(self.rem, bitorder="little"))
            self.rem = np.zeros(0, dtype=bool)
        o = 0
        for part in self.parts:
            out[o : o + len(part)] = part
            o += len(part)
        self.parts = []

    def finish(self) -> np.ndarray:
        out = np.empty(self.n_bytes, dtype=np.uint8)
        self.finish_into(out)
        return out


@dataclass
class PackedBuilt:
    """Streaming-build result with byte-packed rows (1 bit/entry).

    Feeds SBWT.from_packed directly; the bool views unpack on demand for
    the differential tests and the legacy BuiltSBWT consumers."""

    bits_packed: np.ndarray  # [4, ceil(n/8)] uint8, little bit order
    sgs_packed: np.ndarray | None  # [ceil(n/8)] uint8 or None
    n_cols: int
    k: int
    n_kmers: int

    @property
    def bits(self) -> np.ndarray:
        return np.unpackbits(
            self.bits_packed, axis=1, bitorder="little", count=self.n_cols
        ).astype(bool)

    @property
    def suffix_group_starts(self) -> np.ndarray:
        if self.sgs_packed is None:
            return np.empty(0, dtype=bool)
        return np.unpackbits(
            self.sgs_packed, bitorder="little", count=self.n_cols
        ).astype(bool)

    # legacy BuiltSBWT surface (labels are not materialized when streaming)
    @property
    def node_vals(self) -> np.ndarray:
        return np.empty(0, dtype=_U64)

    @property
    def node_lens(self) -> np.ndarray:
        return np.zeros(0, dtype=np.uint8)


class _Prims:
    """Width-generic record primitives: 1-D uint64 arrays for k <= 32,
    [n, W] rows for the wide path — same algorithm either way."""

    def __init__(self, k: int):
        self.k = k
        self.wide = k > km.MAX_K
        self.W = kw.n_words(k) if self.wide else 1

    def read(self, f, n_records: int):
        arr = np.fromfile(f, dtype=_U64, count=n_records * self.W)
        if self.wide:
            return arr.reshape(-1, self.W)
        return arr

    def empty(self):
        return np.empty((0, self.W), dtype=_U64) if self.wide else np.empty(0, dtype=_U64)

    def drop_first(self, vals):
        return kw.drop_first(vals, self.k) if self.wide else km.drop_first(vals, self.k)

    def append_last(self, vals, c):
        return kw.append_last(vals, c) if self.wide else km.append_last(vals, c)

    def append_last_base(self, vals):
        return kw.append_last_base(vals) if self.wide else km.append_last_base(vals)

    def append_from_base(self, base, c):
        return kw.append_from_base(base, c) if self.wide else km.append_from_base(base, c)

    def neq(self, a, b):
        return ~kw.rows_equal(a, b) if self.wide else a != b

    def searchsorted(self, sorted_vals, queries, side="left"):
        if not self.wide:
            return np.searchsorted(sorted_vals, queries, side=side)
        return kw.searchsorted_rows(sorted_vals, queries, side=side)

    def isin_sorted(self, sorted_vals, queries):
        if not self.wide:
            n = len(sorted_vals)
            if n == 0:
                return np.zeros(len(queries), dtype=bool)
            idx = np.searchsorted(sorted_vals, queries)
            return (idx < n) & (sorted_vals[np.minimum(idx, n - 1)] == queries)
        return kw.isin_sorted(sorted_vals, queries)

    def last_char(self, vals):
        return kw.last_char(vals) if self.wide else km.last_char(vals)

    def source_dummies(self, sources):
        """(vals, lens, edges) of all k dummy prefixes per source
        (lengths k-1..0, edge = the character following the prefix)."""
        m = len(sources)
        k = self.k
        pref_lens = np.arange(k - 1, -1, -1, dtype=np.int64)
        if self.wide:
            pvals = kw.prefix_of_length(sources[:, None, :], k, pref_lens[None, :])
            pedges = kw.char_at_distance(
                np.broadcast_to(sources[:, None, :], (m, k, self.W)),
                (k - 1 - pref_lens)[None, :],
            )
            d_vals = pvals.reshape(-1, self.W)
        else:
            pvals = km.prefix_of_length(sources[:, None], k, pref_lens[None, :])
            pedges = km.char_at_distance(sources[:, None], (k - 1 - pref_lens)[None, :])
            d_vals = pvals.ravel()
        d_lens = np.broadcast_to(pref_lens, (m, k)).ravel()
        return d_vals, d_lens, pedges.ravel().astype(np.int64)

    def as_rows(self, vals):
        return vals if self.wide else vals[:, None]


class _Reader:
    """Sequential chunked reader over a record range of a sorted file."""

    def __init__(self, path: str, prims: _Prims, start: int, end: int, chunk: int):
        self.f = open(path, "rb")
        self.f.seek(start * prims.W * 8)
        self.remaining = end - start
        self.prims = prims
        self.chunk = chunk

    def read(self):
        n = min(self.chunk, self.remaining)
        if n <= 0:
            return None
        arr = self.prims.read(self.f, n)
        self.remaining -= len(arr)
        if len(arr) == 0:
            return None
        return arr

    def close(self):
        self.f.close()


def _merge_probe(p, buf, q, covered):
    """Membership of sorted queries q in the sorted buffer + coverage
    marks on matched buffer entries.  Narrow records use one native
    O(n+m) linear merge (pack.c pk_merge_probe); the numpy fallback (and
    the wide path) binary-searches per query."""
    from .. import native

    if not p.wide:
        lib = native.get_lib()
        if lib is not None:
            bufc = np.ascontiguousarray(buf)
            qc = np.ascontiguousarray(q)
            found = np.empty(len(q), dtype=np.uint8)
            cov = np.zeros(len(buf), dtype=np.uint8)
            lib.pk_merge_probe(
                bufc.ctypes.data, len(bufc), qc.ctypes.data, len(qc),
                found.ctypes.data, cov.ctypes.data,
            )
            covered |= cov.astype(bool)
            return found.astype(bool)
    idx = p.searchsorted(buf, q)
    idxc = np.minimum(idx, len(buf) - 1)
    hit = p.neq(buf[idxc], q) == False  # noqa: E712
    covered[idxc[hit]] = True
    return hit


class _ProbeCursor:
    """Block cursor: membership probes with monotonically increasing keys;
    records passed over without a probe hit are sources (no predecessor)."""

    def __init__(self, reader: _Reader, on_sources):
        self.reader = reader
        self.on_sources = on_sources
        self.buf = None
        self.covered = None
        self.done = False

    def _advance(self):
        if self.buf is not None:
            miss = self.buf[~self.covered]
            if len(miss):
                self.on_sources(miss)
        nxt = self.reader.read()
        if nxt is None:
            self.buf = None
            self.done = True
        else:
            self.buf = nxt
            self.covered = np.zeros(len(nxt), dtype=bool)

    def probe(self, y) -> np.ndarray:
        p = self.reader.prims
        found = np.zeros(len(y), dtype=bool)
        i = 0
        while i < len(y):
            if self.buf is None:
                if self.done:
                    break
                self._advance()
                continue
            last = self.buf[-1]
            # queries <= buffer tail are answerable from this buffer
            tail_q = last[None, :] if p.wide else np.array([last], dtype=_U64)
            j = i + int(p.searchsorted(y[i:], tail_q, side="right")[0])
            if j > i:
                hit = _merge_probe(p, self.buf, y[i:j], self.covered)
                found[i:j] = hit
                i = j
            if i < len(y):
                self._advance()
                if self.done:
                    break
        return found

    def finalize(self):
        while not self.done:
            self._advance()
        self.reader.close()


def _block_starts(path: str, n_records: int, prims: _Prims) -> list[int]:
    """First record index whose last character is >= c, via O(log n) seeks
    (the reference stores per-character block offsets in its sorted DB
    copy, kmc_construct_helper_classes.hh:97-166)."""
    rec_bytes = prims.W * 8
    out = [0]
    with open(path, "rb") as f:

        def last_char_at(i: int) -> int:
            f.seek(i * rec_bytes)
            word0 = np.frombuffer(f.read(8), dtype=_U64)[0]
            return int(word0 >> _U64(62))

        for c in range(1, 4):
            lo, hi = out[-1], n_records
            while lo < hi:
                mid = (lo + hi) // 2
                if last_char_at(mid) < c:
                    lo = mid + 1
                else:
                    hi = mid
            out.append(lo)
    out.append(n_records)
    return out


class _DummySpill:
    """Buffered writer of (value, length<<8|edge) dummy records."""

    def __init__(self, path: str, prims: _Prims, flush_records: int):
        self.f = open(path, "wb")
        self.prims = prims
        self.flush = flush_records
        self.parts = []
        self.count = 0

    def add(self, vals, lens, edges):
        rows = self.prims.as_rows(vals).astype(_U64)
        meta = ((lens.astype(np.int64) << 8) | (edges & 0xFF)).astype(_U64)
        rec = np.concatenate([rows, meta[:, None]], axis=1)
        self.parts.append(rec)
        self.count += len(rec)
        if self.count >= self.flush:
            self._drain()

    def _drain(self):
        if self.parts:
            np.concatenate(self.parts).tofile(self.f)
            self.parts = []
            self.count = 0

    def close(self):
        self._drain()
        self.f.close()


class _DedupedDummyStream:
    """Read sorted dummy records, merging duplicate (value, length) groups
    by OR-ing their edge sets (kmc_construct.hh:64-79 analog)."""

    def __init__(self, path: str, prims: _Prims, chunk: int):
        self.prims = prims
        self.W = prims.W
        self.f = open(path, "rb")
        self.chunk = chunk
        self.carry = None  # (val_row, len, mask) open group
        self.eof = False

    def read(self):
        """Returns (vals, lens, masks) or None at EOF."""
        p = self.prims
        while True:
            if self.eof:
                if self.carry is None:
                    return None
                val, ln, mask = self.carry
                self.carry = None
                vals = val[None, :] if p.wide else np.array([val], dtype=_U64)
                return vals, np.array([ln], dtype=np.int64), np.array([mask], dtype=np.uint8)
            raw = np.fromfile(self.f, dtype=_U64, count=self.chunk * (self.W + 1))
            if raw.size == 0:
                self.eof = True
                self.f.close()
                continue
            rec = raw.reshape(-1, self.W + 1)
            vals = rec[:, : self.W] if p.wide else rec[:, 0]
            lens = (rec[:, self.W] >> _U64(8)).astype(np.int64)
            edges = (rec[:, self.W] & _U64(0xFF)).astype(np.int64)
            emask = np.where(edges < 4, (1 << (edges & 3)).astype(np.uint8), 0).astype(np.uint8)
            # group by (val, len) within the chunk
            new = np.empty(len(rec), dtype=bool)
            new[0] = True
            new[1:] = p.neq(vals[1:], vals[:-1]) | (lens[1:] != lens[:-1])
            gid = np.cumsum(new) - 1
            g_vals = vals[new]
            g_lens = lens[new]
            g_mask = np.zeros(int(gid[-1]) + 1, dtype=np.uint8)
            np.bitwise_or.at(g_mask, gid, emask)
            if self.carry is not None:
                cval, cln, cmask = self.carry
                first_val = g_vals[0]
                same = (
                    bool(np.all(first_val == cval)) if p.wide else bool(first_val == cval)
                ) and int(g_lens[0]) == cln
                if same:
                    g_mask[0] |= cmask
                else:
                    g_vals = np.concatenate(
                        [cval[None, :] if p.wide else np.array([cval], dtype=_U64), g_vals]
                    )
                    g_lens = np.concatenate([[cln], g_lens])
                    g_mask = np.concatenate([[cmask], g_mask]).astype(np.uint8)
            # hold the last group open: it may continue in the next chunk
            self.carry = (g_vals[-1], int(g_lens[-1]), np.uint8(g_mask[-1]))
            if len(g_vals) > 1:
                return g_vals[:-1], g_lens[:-1].astype(np.int64), g_mask[:-1]
            # single open group: keep accumulating


def build_streaming(
    distinct_path: str,
    n_records: int,
    k: int,
    streaming_support: bool,
    ram_bytes: int,
    n_threads: int,
    tfm,
    chunk_records: int | None = None,
) -> PackedBuilt:
    """Build the plain-matrix SBWT from an on-disk sorted distinct k-mer
    file in bounded memory.  `tfm` is the temp-file manager for spills.
    `chunk_records` overrides the RAM-derived chunk size (tests use tiny
    chunks to exercise every cross-chunk carry path).

    Output rows are emitted byte-PACKED chunk by chunk (PackedBuilt →
    SBWT.from_packed), so peak host RAM for the O(n) term is ~5 bits per
    column like the reference's sdsl append loop (kmc_construct.hh:43-99),
    not bool bytes."""
    p = _Prims(k)
    W = p.W
    if n_records == 0:
        return PackedBuilt(
            bits_packed=np.zeros((4, 1), dtype=np.uint8),
            sgs_packed=np.ones(1, dtype=np.uint8) if streaming_support else None,
            n_cols=1,
            k=k,
            n_kmers=0,
        )

    # chunk sizing: main + 4 block cursors + dummy spill + merge buffers
    chunk = chunk_records or int(max(4096, min(1 << 21, ram_bytes // (24 * W * 8))))

    edges_path = tfm.create_filename("edges_", ".bin")
    dummy_raw = tfm.create_filename("dummies_", ".bin")
    dummy_sorted = tfm.create_filename("dummies_sorted_", ".bin")

    blocks = _block_starts(distinct_path, n_records, p)
    spill = _DummySpill(dummy_raw, p, flush_records=chunk)

    def on_sources(src):
        # source_dummies expands each source into k prefix records; cap
        # the expansion per call to ~chunk records so peak transient RAM
        # stays O(chunk), not O(chunk * k).
        step = max(1, chunk // p.k)
        for i in range(0, len(src), step):
            spill.add(*p.source_dummies(src[i : i + step]))

    cursors = [
        _ProbeCursor(_Reader(distinct_path, p, blocks[c], blocks[c + 1], chunk), on_sources)
        for c in range(4)
    ]

    # ---- phase 1: edges + sources ------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    probe_pool = ThreadPoolExecutor(max_workers=4) if n_threads > 1 else None
    main = _Reader(distinct_path, p, 0, n_records, chunk)
    prev_suffix = None
    try:
        with open(edges_path, "wb") as ef:
            while True:
                X = main.read()
                if X is None:
                    break
                S = p.drop_first(X)
                starts = np.empty(len(X), dtype=bool)
                if prev_suffix is None:
                    starts[0] = True
                else:
                    starts[0] = bool(np.any(p.neq(S[0:1], prev_suffix)[0:1])) if p.wide else bool(
                        S[0] != prev_suffix
                    )
                starts[1:] = p.neq(S[1:], S[:-1])
                rep_pos = np.flatnonzero(starts)
                S_rep = S[rep_pos]
                edge_bytes = np.zeros(len(X), dtype=np.uint8)
                # the >>2 shift is char-independent: one pass for all 4 chars
                y_base = p.append_last_base(S_rep)

                def _probe_c(c):
                    # scalar c: a full-length char array costs an extra 8x
                    # broadcast temp per block (both append_last variants
                    # accept scalars).  The 4 probes run on a thread pool:
                    # each cursor owns its file region, and the big numpy
                    # ops + the native merge release the GIL (the
                    # reference's KMC stage is likewise multithreaded,
                    # run_kmc.cpp:655-721).
                    return c, cursors[c].probe(p.append_from_base(y_base, c))

                if probe_pool is not None:
                    results = list(probe_pool.map(_probe_c, range(4)))
                else:
                    results = [_probe_c(c) for c in range(4)]
                for c, found in results:
                    edge_bytes[rep_pos[found]] |= np.uint8(1 << c)
                edge_bytes.tofile(ef)
                prev_suffix = S[-1]
    finally:
        # also on an exception of the loop: no idle probe threads are left behind
        main.close()
        if probe_pool is not None:
            probe_pool.shutdown()
    for c in range(4):
        cursors[c].finalize()
    # the root node always exists (kmc_construct.hh:47-51)
    root_val = np.zeros((1, W), dtype=_U64) if p.wide else np.zeros(1, dtype=_U64)
    spill.add(root_val, np.zeros(1, dtype=np.int64), np.full(1, _NO_EDGE, dtype=np.int64))
    spill.close()

    # ---- phase 2: sort dummies by (value, length) --------------------
    native.em_sort_records_file(
        dummy_raw, dummy_sorted, tfm.get_dir(), W + 1, ram_bytes=ram_bytes, n_threads=n_threads
    )
    tfm.delete_file(dummy_raw)

    # ---- phase 3: merge-join into bit rows ----------------------------
    dummies = _DedupedDummyStream(dummy_sorted, p, chunk)
    kmer_r = _Reader(distinct_path, p, 0, n_records, chunk)
    edges_f = open(edges_path, "rb")

    row_acc = [_PackedAccum() for _ in range(4)]
    sgs_acc = _PackedAccum() if streaming_support else None
    prev_key = None  # (val_row_or_scalar, len) of the previous node's suffix group

    dv = dl = dm = None
    kv = ke = None
    d_done = k_done = False

    def refill_d():
        nonlocal dv, dl, dm, d_done
        got = dummies.read()
        if got is None:
            d_done = True
            dv = dl = dm = None
        else:
            dv, dl, dm = got

    def refill_k():
        nonlocal kv, ke, k_done
        kv = kmer_r.read()
        if kv is None:
            k_done = True
            ke = None
        else:
            ke = np.fromfile(edges_f, dtype=np.uint8, count=len(kv))

    def emit(vals, lens, masks):
        nonlocal prev_key
        for c in range(4):
            row_acc[c].add((masks & (1 << c)) != 0)
        if streaming_support:
            is_full = lens == k
            sh_vals = vals.copy()
            if is_full.any():
                sh_vals[is_full] = p.drop_first(vals[is_full])
            sh_lens = np.where(is_full, k - 1, lens)
            sgs = np.empty(len(lens), dtype=bool)
            if prev_key is None:
                sgs[0] = True
            else:
                pv, pl = prev_key
                diff = p.neq(sh_vals[0:1], pv[None, :] if p.wide else pv)
                sgs[0] = bool(diff[0]) or int(sh_lens[0]) != pl
            sgs[1:] = p.neq(sh_vals[1:], sh_vals[:-1]) | (sh_lens[1:] != sh_lens[:-1])
            sgs_acc.add(sgs)
            prev_key = (sh_vals[-1], int(sh_lens[-1]))

    refill_d()
    refill_k()
    while not (d_done and k_done):
        if dv is None and not d_done:
            refill_d()
            continue
        if kv is None and not k_done:
            refill_k()
            continue
        if d_done and kv is not None:
            emit(kv, np.full(len(kv), k, dtype=np.int64), ke)
            kv = None
            refill_k()
            continue
        if k_done and dv is not None:
            emit(dv, dl, dm)
            dv = None
            refill_d()
            continue
        if dv is None or kv is None:
            continue
        # process everything with value <= bound = min of the two tails.
        # When the bound comes from the DUMMY side, k-mers with value ==
        # bound must be deferred: dummy groups of the same value (longer
        # prefixes, still sorted before any equal-valued k-mer by length)
        # may remain in the stream — including inside the dedup carry.
        d_last, k_last = dv[-1], kv[-1]
        if p.wide:
            d_le = not bool(kw.rows_less(k_last[None, :], d_last[None, :])[0])
        else:
            d_le = bool(d_last <= k_last)
        bound = d_last if d_le else k_last
        bnd = bound[None, :] if p.wide else np.array([bound], dtype=_U64)
        if d_le:
            nd = len(dv)
            nk = int(p.searchsorted(kv, bnd, side="left")[0])
        else:
            nd = int(p.searchsorted(dv, bnd, side="right")[0])
            nk = int(p.searchsorted(kv, bnd, side="right")[0])
        td_v, td_l, td_m = dv[:nd], dl[:nd], dm[:nd]
        tk_v, tk_e = kv[:nk], ke[:nk]
        # merged positions: dummy i precedes kmers from searchsorted-left
        # (equal values order dummies first: shorter length sorts first)
        ins = p.searchsorted(tk_v, td_v, side="left")
        total = nd + nk
        pos_d = ins + np.arange(nd)
        is_d = np.zeros(total, dtype=bool)
        is_d[pos_d] = True
        vals = (
            np.empty((total, W), dtype=_U64) if p.wide else np.empty(total, dtype=_U64)
        )
        lens = np.empty(total, dtype=np.int64)
        masks = np.empty(total, dtype=np.uint8)
        vals[pos_d] = td_v
        lens[pos_d] = td_l
        masks[pos_d] = td_m
        vals[~is_d] = tk_v
        lens[~is_d] = k
        masks[~is_d] = tk_e
        emit(vals, lens, masks)
        dv, dl, dm = (dv[nd:], dl[nd:], dm[nd:]) if nd < len(dv) else (None, None, None)
        kv, ke = (kv[nk:], ke[nk:]) if nk < len(kv) else (None, None)
        if dv is None:
            refill_d()
        if kv is None:
            refill_k()

    kmer_r.close()
    edges_f.close()
    tfm.delete_file(dummy_sorted)
    tfm.delete_file(edges_path)

    n_cols = row_acc[0].n_bits
    bits_packed = np.empty((4, row_acc[0].n_bytes), dtype=np.uint8)
    for c in range(4):
        row_acc[c].finish_into(bits_packed[c])
    return PackedBuilt(
        bits_packed=bits_packed,
        sgs_packed=sgs_acc.finish() if streaming_support else None,
        n_cols=n_cols,
        k=k,
        n_kmers=n_records,
    )
