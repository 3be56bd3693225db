"""Vectorized SBWT construction from sequences.

Produces bit-for-bit the same plain-matrix SBWT as the reference's two
construction pipelines (include/sbwt/NodeBOSSInMemoryConstructor.hh:98-213
and include/sbwt/kmc_construct.hh:102-238), but as a sort/searchsorted/merge
program over packed k-mer arrays instead of cursor streams:

  1. pack every valid k-length window of the input into a top-aligned
     uint64 (word order == colex order, see utils/kmers.py), dedup
     (optionally with abundance filtering, replacing KMC's cutoffs);
  2. suffix groups = maximal runs of k-mers sharing the drop-first value;
     out-edges of a group are found by searchsorted membership of
     suffix·c in the k-mer set (replacing the reference's four
     character-block cursor streams, kmc_construct.hh:146-198);
  3. k-mers with no predecessor (drop-last value not among the distinct
     drop-first values) are "sources"; each source contributes its proper
     prefixes as dummy nodes, each carrying one out-edge toward the next
     character of the source (add_prefixes, kmc_construct.hh:30-40);
     dummies are dedup-merged by OR-ing edge sets, and the empty root node
     always exists (kmc_construct.hh:47-51);
  4. the merged colex-sorted node list yields the four indicator bit rows
     and the suffix-group-starts vector (kmc_construct.hh:43-99; groups
     compare nodes after dropping the first char iff the node is a full
     k-mer, kmc_construct.hh:68-75).

Everything is numpy; device upload happens in models/matrix.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import kmers as km
from ..utils.dna import encode

_U64 = np.uint64


@dataclass
class BuiltSBWT:
    """Host-side plain-matrix SBWT produced by construction."""

    bits: np.ndarray  # bool [4, n_nodes] indicator rows A,C,G,T
    suffix_group_starts: np.ndarray  # bool [n_nodes] (empty if not built)
    k: int
    n_kmers: int
    # Node labels (for reconstruction/debug; not required for queries):
    node_vals: np.ndarray  # uint64 [n_nodes] top-aligned packed labels
    node_lens: np.ndarray  # uint8 [n_nodes]

    @property
    def n_nodes(self) -> int:
        return self.bits.shape[1]

    @property
    def C(self) -> np.ndarray:
        """Cumulative count array; C[0]=1 for the ghost dollar (SBWT.hh:344-350)."""
        counts = self.bits.sum(axis=1, dtype=np.int64)
        C = np.empty(4, dtype=np.int64)
        C[0] = 1
        C[1] = C[0] + counts[0]
        C[2] = C[1] + counts[1]
        C[3] = C[2] + counts[2]
        return C


def _distinct_kmers(
    seqs, k: int, min_abundance: int = 1, max_abundance: int | None = None
) -> np.ndarray:
    """Colex-sorted distinct packed k-mers of all valid windows of seqs.

    Abundance filtering counts occurrences across all windows (the
    reference delegates this to KMC's cutoffs, run_kmc.cpp:673-694; note a
    k-mer is distinct from its reverse complement in both systems).
    """
    from .. import native

    chunks = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode(s)
        packed = native.pack_windows_u64(codes, k)  # one rolling C pass
        if packed is None:
            packed = km.pack_windows(codes, k)  # O(n*k) numpy fallback
        vals, valid = packed
        if vals.size:
            chunks.append(vals[valid])
    if not chunks:
        return np.empty(0, dtype=_U64)
    allv = np.concatenate(chunks)
    if min_abundance <= 1 and max_abundance is None:
        return np.unique(allv)  # sorted ascending == colex order
    allv.sort()
    uniq, counts = np.unique(allv, return_counts=True)
    keep = counts >= min_abundance
    if max_abundance is not None:
        keep &= counts <= max_abundance
    return uniq[keep]


def _isin_sorted(sorted_vals: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Membership of queries in a sorted unique array."""
    idx = np.searchsorted(sorted_vals, queries)
    idx_c = np.minimum(idx, len(sorted_vals) - 1) if len(sorted_vals) else idx
    if len(sorted_vals) == 0:
        return np.zeros(len(queries), dtype=bool)
    return (idx < len(sorted_vals)) & (sorted_vals[idx_c] == queries)


def build_from_kmers(kmer_vals: np.ndarray, k: int, streaming_support: bool = True) -> BuiltSBWT:
    """Build the plain-matrix SBWT from colex-sorted distinct packed k-mers."""
    kmer_vals = np.asarray(kmer_vals, dtype=_U64)
    n = len(kmer_vals)

    if n == 0:
        # Only the root node.
        bits = np.zeros((4, 1), dtype=bool)
        sgs = np.ones(1, dtype=bool) if streaming_support else np.empty(0, dtype=bool)
        return BuiltSBWT(
            bits=bits,
            suffix_group_starts=sgs,
            k=k,
            n_kmers=0,
            node_vals=np.zeros(1, dtype=_U64),
            node_lens=np.zeros(1, dtype=np.uint8),
        )

    # --- suffix groups among the k-mers -------------------------------
    suffixes = km.drop_first(kmer_vals, k)  # non-decreasing since input sorted
    group_start = np.empty(n, dtype=bool)
    group_start[0] = True
    group_start[1:] = suffixes[1:] != suffixes[:-1]
    rep_idx = np.flatnonzero(group_start)
    S = suffixes[rep_idx]  # strictly increasing distinct (k-1)-suffixes

    # --- out-edges per group ------------------------------------------
    # y_c = S . c as a full k-mer; edge exists iff y_c is an indexed k-mer.
    kmer_bits = np.zeros((4, n), dtype=bool)
    from .. import native

    for c in range(4):
        # scalar c (a full-length char array costs an 8x broadcast temp);
        # y is sorted (S strictly increasing, same top char appended), so
        # membership is one native O(n+m) merge instead of per-query
        # binary search
        y = km.append_last(S, c)
        hit = native.merge_isin_u64(kmer_vals, y)
        if hit is None:
            hit = _isin_sorted(kmer_vals, y)
        kmer_bits[c, rep_idx] = hit

    # --- sources and dummies ------------------------------------------
    preds = km.drop_last(kmer_vals)  # drop-last value, length k-1
    # colex order groups k-mers by LAST char (the top 2 bits), and
    # within one group drop_last (<< 2) is monotone — preds is 4 sorted
    # runs, so membership is 4 O(n+m) merges instead of n binary
    # searches over S (the searchsorted path measured ~3.4 s of the
    # 16 Mbp build)
    has_pred = np.empty(n, dtype=bool)
    edges = [0] + list(
        np.searchsorted(kmer_vals, [_U64(c) << _U64(62) for c in (1, 2, 3)])
    ) + [n]
    for g in range(4):
        lo, hi = int(edges[g]), int(edges[g + 1])
        if hi > lo:
            hit = native.merge_isin_u64(S, preds[lo:hi])
            if hit is None:
                hit = _isin_sorted(S, preds[lo:hi])
            has_pred[lo:hi] = hit
    sources = kmer_vals[~has_pred]
    m = len(sources)

    # Each source contributes prefixes of lengths k-1 .. 0; the prefix of
    # length l carries an out-edge labeled with the source's (l+1)-th char.
    pref_lens = np.arange(k - 1, -1, -1, dtype=np.int64)  # [k]
    pvals = km.prefix_of_length(sources[:, None], k, pref_lens[None, :])  # [m, k]
    # char at index l of the source = distance k-1-l from the end
    pedges = km.char_at_distance(sources[:, None], (k - 1 - pref_lens)[None, :])  # [m, k]
    d_vals = pvals.ravel()
    d_lens = np.broadcast_to(pref_lens, (m, k)).ravel().astype(np.int64)
    d_edge = pedges.ravel()

    # Root node always exists with an (initially) empty edge set.
    d_vals = np.concatenate([d_vals, [_U64(0)]])
    d_lens = np.concatenate([d_lens, [0]])
    d_edge = np.concatenate([d_edge, [-1]]).astype(np.int64)

    # Dedup dummies by (val, len), OR-ing their edge sets.
    order = np.lexsort((d_lens, d_vals))
    d_vals, d_lens, d_edge = d_vals[order], d_lens[order], d_edge[order]
    new = np.empty(len(d_vals), dtype=bool)
    new[0] = True
    new[1:] = (d_vals[1:] != d_vals[:-1]) | (d_lens[1:] != d_lens[:-1])
    gid = np.cumsum(new) - 1
    n_d = int(gid[-1]) + 1
    dummy_vals = d_vals[new]
    dummy_lens = d_lens[new].astype(np.uint8)
    dummy_bits = np.zeros((4, n_d), dtype=bool)
    for c in range(4):
        np.logical_or.at(dummy_bits[c], gid, d_edge == c)

    # --- merge dummies + k-mers in colex order ------------------------
    # Dummies (len < k) and k-mers (len k) never coincide, so a plain
    # two-way merge by (val, len) suffices.  Total colex order is
    # (val, len) lexicographic.
    all_vals = np.concatenate([dummy_vals, kmer_vals])
    all_lens = np.concatenate([dummy_lens, np.full(n, k, dtype=np.uint8)])
    all_bits = np.concatenate([dummy_bits, kmer_bits], axis=1)
    order = np.lexsort((all_lens, all_vals))
    node_vals = all_vals[order]
    node_lens = all_lens[order]
    bits = all_bits[:, order]

    # --- streaming support (suffix-group starts over all nodes) -------
    if streaming_support:
        sh_vals = node_vals.copy()
        sh_lens = node_lens.astype(np.int64).copy()
        is_full = sh_lens == k
        sh_vals[is_full] = km.drop_first(sh_vals[is_full], k)
        sh_lens[is_full] = k - 1
        sgs = np.empty(len(node_vals), dtype=bool)
        sgs[0] = True
        sgs[1:] = (sh_vals[1:] != sh_vals[:-1]) | (sh_lens[1:] != sh_lens[:-1])
    else:
        sgs = np.empty(0, dtype=bool)

    return BuiltSBWT(
        bits=bits,
        suffix_group_starts=sgs,
        k=k,
        n_kmers=n,
        node_vals=node_vals,
        node_lens=node_lens,
    )


def _distinct_kmers_wide(
    seqs, k: int, min_abundance: int = 1, max_abundance: int | None = None
) -> np.ndarray:
    """Wide (k > 32) variant of _distinct_kmers: [n, W] uint64 rows."""
    from ..utils import kmers_wide as kw

    chunks = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode(s)
        vals, valid = kw.pack_windows(codes, k)
        if vals.size:
            chunks.append(vals[valid])
    if not chunks:
        return np.empty((0, kw.n_words(k)), dtype=_U64)
    allv = np.concatenate(chunks)
    uniq, counts = kw.unique_rows_sorted(allv)
    keep = counts >= min_abundance
    if max_abundance is not None:
        keep &= counts <= max_abundance
    return uniq[keep]


def build_from_kmers_wide(
    kmer_vals: np.ndarray, k: int, streaming_support: bool = True
) -> BuiltSBWT:
    """Wide (k > 32) build_from_kmers: same algorithm over [n, W] rows.

    Mirrors kmc_construct.hh:102-238 exactly like the single-word path;
    only the packed representation and its compare/search primitives
    change (utils/kmers_wide.py)."""
    from ..utils import kmers_wide as kw

    W = kw.n_words(k)
    kmer_vals = np.asarray(kmer_vals, dtype=_U64).reshape(-1, W)
    n = len(kmer_vals)

    if n == 0:
        bits = np.zeros((4, 1), dtype=bool)
        sgs = np.ones(1, dtype=bool) if streaming_support else np.empty(0, dtype=bool)
        return BuiltSBWT(
            bits=bits,
            suffix_group_starts=sgs,
            k=k,
            n_kmers=0,
            node_vals=np.zeros((1, W), dtype=_U64),
            node_lens=np.zeros(1, dtype=np.uint8),
        )

    # --- suffix groups among the k-mers -------------------------------
    suffixes = kw.drop_first(kmer_vals, k)
    group_start = np.empty(n, dtype=bool)
    group_start[0] = True
    group_start[1:] = ~kw.rows_equal(suffixes[1:], suffixes[:-1])
    rep_idx = np.flatnonzero(group_start)
    S = suffixes[rep_idx]

    # --- out-edges per group ------------------------------------------
    kmer_bits = np.zeros((4, n), dtype=bool)
    for c in range(4):
        y = kw.append_last(S, np.full(len(S), c, dtype=np.uint8))
        kmer_bits[c, rep_idx] = kw.isin_sorted(kmer_vals, y)

    # --- sources and dummies ------------------------------------------
    preds = kw.drop_last(kmer_vals)
    has_pred = kw.isin_sorted(S, preds)
    sources = kmer_vals[~has_pred]
    m = len(sources)

    pref_lens = np.arange(k - 1, -1, -1, dtype=np.int64)  # [k]
    pvals = kw.prefix_of_length(sources[:, None, :], k, pref_lens[None, :])  # [m, k, W]
    pedges = kw.char_at_distance(
        np.broadcast_to(sources[:, None, :], (m, k, W)), (k - 1 - pref_lens)[None, :]
    )  # [m, k]
    d_vals = pvals.reshape(-1, W)
    d_lens = np.broadcast_to(pref_lens, (m, k)).ravel().astype(np.int64)
    d_edge = pedges.ravel().astype(np.int64)

    d_vals = np.concatenate([d_vals, np.zeros((1, W), dtype=_U64)])
    d_lens = np.concatenate([d_lens, [0]])
    d_edge = np.concatenate([d_edge, [-1]]).astype(np.int64)

    order = kw.colex_argsort(d_vals, d_lens)
    d_vals, d_lens, d_edge = d_vals[order], d_lens[order], d_edge[order]
    new = np.empty(len(d_vals), dtype=bool)
    new[0] = True
    new[1:] = ~kw.rows_equal(d_vals[1:], d_vals[:-1]) | (d_lens[1:] != d_lens[:-1])
    gid = np.cumsum(new) - 1
    n_d = int(gid[-1]) + 1
    dummy_vals = d_vals[new]
    dummy_lens = d_lens[new].astype(np.uint8)
    dummy_bits = np.zeros((4, n_d), dtype=bool)
    for c in range(4):
        np.logical_or.at(dummy_bits[c], gid, d_edge == c)

    # --- merge dummies + k-mers in colex order ------------------------
    all_vals = np.concatenate([dummy_vals, kmer_vals])
    all_lens = np.concatenate([dummy_lens, np.full(n, k, dtype=np.uint8)])
    all_bits = np.concatenate([dummy_bits, kmer_bits], axis=1)
    order = kw.colex_argsort(all_vals, all_lens)
    node_vals = all_vals[order]
    node_lens = all_lens[order]
    bits = all_bits[:, order]

    # --- streaming support ---------------------------------------------
    if streaming_support:
        sh_vals = node_vals.copy()
        sh_lens = node_lens.astype(np.int64).copy()
        is_full = sh_lens == k
        sh_vals[is_full] = kw.drop_first(sh_vals[is_full], k)
        sh_lens[is_full] = k - 1
        sgs = np.empty(len(node_vals), dtype=bool)
        sgs[0] = True
        sgs[1:] = ~kw.rows_equal(sh_vals[1:], sh_vals[:-1]) | (
            sh_lens[1:] != sh_lens[:-1]
        )
    else:
        sgs = np.empty(0, dtype=bool)

    return BuiltSBWT(
        bits=bits,
        suffix_group_starts=sgs,
        k=k,
        n_kmers=n,
        node_vals=node_vals,
        node_lens=node_lens,
    )


def build_sbwt(
    seqs,
    k: int,
    streaming_support: bool = True,
    min_abundance: int = 1,
    max_abundance: int | None = None,
    add_reverse_complements: bool = False,
) -> BuiltSBWT:
    """Build a plain-matrix SBWT from DNA sequences (strings or code arrays).

    k up to 32 uses single-word packing; 33..255 (the reference's
    MAX_KMER_LENGTH ceiling) uses the multi-word path."""
    if add_reverse_complements:
        from ..utils.dna import reverse_complement

        seqs = list(seqs)
        seqs = seqs + [
            reverse_complement(s) if isinstance(s, str) else encode_rc(s) for s in seqs
        ]
    if k > km.MAX_K:
        kv = _distinct_kmers_wide(seqs, k, min_abundance, max_abundance)
        return build_from_kmers_wide(kv, k, streaming_support)
    kv = _distinct_kmers(seqs, k, min_abundance, max_abundance)
    return build_from_kmers(kv, k, streaming_support)


def encode_rc(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an int8 code array (3 - code, invalid stays invalid)."""
    out = (3 - codes[::-1]).astype(np.int8)
    out[codes[::-1] < 0] = -1
    return out


def mark_suffix_groups(bits: np.ndarray, k: int) -> np.ndarray:
    """Recompute suffix-group starts from the bit matrix alone.

    Vectorized equivalent of the k-1 rounds of label propagation in
    src/suffix_group_optimization.cpp:66-121.
    """
    n = bits.shape[1]
    C = np.empty(4, dtype=np.int64)
    counts = bits.sum(axis=1, dtype=np.int64)
    C[0] = 1
    C[1:] = 1 + np.cumsum(counts[:-1])

    last = np.full(n, -1, dtype=np.int8)  # -1 is '$'
    for c in range(4):
        last[C[c] : C[c] + counts[c]] = c

    sgs = np.zeros(n, dtype=bool)
    for _ in range(k - 1):
        sgs[0] = True
        sgs[1:] |= last[1:] != last[:-1]
        propagated = np.full(n, -1, dtype=np.int8)
        for c in range(4):
            src = np.flatnonzero(bits[c])
            propagated[C[c] : C[c] + len(src)] = last[src]
        last = propagated
    return sgs
