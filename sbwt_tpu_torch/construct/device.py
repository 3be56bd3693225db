"""On-device SBWT construction: the whole build on a torch device.

The counterpart of sbwt_tpu/construct/device.py (``_build_device_jit``,
``prepare_device_codes``, ``build_sbwt_device``): window packing, colex
sort, dedup, out-edge probes, dummy-prefix emission and rank-table packing
all run on the device, any k <= 255. The host build of construct/inmemory.py
is the oracle it is tested against.

k-mers are keys of W = ceil(k / 16) uint32 words, top-aligned (the char at
distance d from the END at bits [30 - 2 (d % 16), 32 - 2 (d % 16)) of word
d // 16, word 0 most significant), so unsigned word-sequence order is
colex order. A key tensor is int32 [n, W] holding those bits.

Not carried over from the JAX program, whose shape follows XLA's limits:

* sizes are exact. A count is read back and the next tensor sized from it,
  so there is no padded input length, no static source budget and no
  padding word: the tables equal ``models.matrix.from_host_arrays`` of the
  host build word for word. ``src_pad`` only keeps the JAX package's
  ``ValueError`` for callers that set a budget.
* membership in the sorted distinct k-mer list is not five
  concatenate-and-sort passes: the ``edge_src_probe`` kernel merges the
  k-mers' predecessor keys, four sorted runs by last char, against the
  list of (k-1)-suffixes once, and one lower bound a k-mer gives its
  source bit and its group's edge bit (csrc/build_sbwt.cu); its plain
  version runs a W-word binary search per query.
* the build works in ranges of consecutive keys (``_build_ranged``: a
  survey pass for the sources and the ranges' sizes, then one
  ``pack_range`` pass a range; one range where the device's free memory
  holds all windows), so an input past that memory gives the same tables;
  from 2^31 columns on, the wide tier's int64 tables (a
  ``WideMatrixIndex``), which the JAX program's int32 tables do not reach.

Five stages are hand-written CUDA kernels (csrc/build_sbwt.cu), each with
its plain PyTorch version here: ``pack_windows``, ``pack_range``,
``edge_src_probe``, ``emit_dummies``, ``finalize_tables``. On a CUDA device
the kernels run or raise; the plain versions run on the CPU only. The sorts
(``torch.sort``), prefix sums (``torch.cumsum``) and stream compaction
(boolean-mask indexing) between them are PyTorch's, as ``lax.sort`` and
``jnp.cumsum`` are XLA's in the JAX program. PyTorch sorts no unsigned
words on CUDA, so ``colex_order`` sorts int64 columns of two words each
with the sign bit flipped, least significant column first.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..models.matrix import MatrixIndex, needs_wide_index, with_precalc
from ..models.wide import wide_from_device_tables
from ..ops import bitvector as bv
from ..utils.dna import encode
from ..utils.logging import write_log
from ..utils.profiling import annotate

_LOW32 = 0xFFFFFFFF
_INT64_MIN = -(1 << 63)


def _as_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 holding the same bits."""
    return ((values ^ 0x80000000) - 0x80000000).int()


def _first_char(k: int) -> tuple[int, int]:
    """(word, bit offset) of a length-k key's first char (distance k - 1)."""
    return (k - 1) >> 4, 30 - 2 * ((k - 1) & 15)


def _drop_first(ws: torch.Tensor, k: int) -> torch.Tensor:
    """Unsigned key words [n, W] with the first char of length k cleared."""
    wi, sh = _first_char(k)
    out = ws.clone()
    out[:, wi] &= ~(3 << sh) & _LOW32
    return out


def _differs_from_left(*columns: torch.Tensor) -> torch.Tensor:
    """bool [n]: row i differs from row i - 1 in any column; row 0 does."""
    n = columns[0].shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=columns[0].device)
    out[:1] = True
    for col in columns:
        d = col[1:] != col[:-1]
        out[1:] |= d.any(dim=1) if d.dim() > 1 else d
    return out


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b of unsigned key words [q, W], word 0 most significant."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    equal = torch.ones_like(less)
    for j in range(a.shape[1]):
        less |= equal & (a[:, j] < b[:, j])
        equal &= a[:, j] == b[:, j]
    return less


def _member(sorted_ws: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bool [q]: each query row is among the sorted rows (a lower bound by
    binary search, then an equality test), on unsigned key words."""
    n = sorted_ws.shape[0]
    if n == 0:
        return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    lo = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = _lex_less(sorted_ws[mid.clamp(max=n - 1)], q)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return (lo < n) & (sorted_ws[lo.clamp(max=n - 1)] == q).all(dim=1)


# ---------------------------------------------------------------------------
# The four stages: plain versions, and the dispatch to the kernels
# ---------------------------------------------------------------------------


def pack_windows_plain(codes: torch.Tensor, k: int):
    """Plain version of the pack_windows kernel."""
    m, W = codes.shape[0] - k + 1, kernels.key_words(k)
    u = (codes & 3).long()
    words = torch.zeros((m, W), dtype=torch.long, device=codes.device)
    for j in range(k):
        d = k - 1 - j
        words[:, d >> 4] |= u[j : j + m] << (30 - 2 * (d & 15))
    bad = torch.zeros(codes.shape[0] + 1, dtype=torch.long, device=codes.device)
    bad[1:] = torch.cumsum((codes < 0).long(), dim=0)
    valid = (bad[k:] - bad[:-k]) == 0
    words[~valid] = _LOW32
    return _as_i32(words), valid


def _shift_left2(ws: torch.Tensor) -> torch.Tensor:
    """Unsigned key words [n, W] shifted left by one char: the (k-1)-prefix,
    its last char dropped."""
    pred = (ws << 2) & _LOW32
    pred[:, :-1] |= ws[:, 1:] >> 30
    return pred


def pack_range_plain(codes: torch.Tensor, k: int, lo: int, hi: int, bits: int):
    """Plain version of the pack_range kernel, the selected keys in window
    order."""
    keys, valid = pack_windows_plain(codes, k)
    keys = keys[valid]
    node_b, edge_b = _buckets(keys, bits)
    return (keys[(node_b >= lo) & (node_b < hi)], keys[(edge_b >= lo) & (edge_b < hi)])


def edge_src_probe_plain(keys: torch.Tensor, k: int, queries: torch.Tensor):
    """Plain version of the edge_src_probe kernel."""
    dv = bv.word_u32(keys)
    qv = bv.word_u32(queries)
    n = dv.shape[0]
    sf = _drop_first(dv, k)
    gstart = _differs_from_left(sf)
    edges = torch.zeros(n, dtype=torch.uint8, device=keys.device)
    reps = sf[gstart]
    for c in range(4):
        # suffix . c: one char to the right, c at the end
        y = reps >> 2
        y[:, 0] |= c << 30
        y[:, 1:] |= (reps[:, :-1] & 3) << 30
        edges[gstart] += _member(qv, y).to(torch.uint8) * (1 << c)
    # the (k-1)-prefix among the k-mers' (k-1)-suffixes
    return edges, gstart, ~_member(sf, _shift_left2(qv))


def emit_dummies_plain(src: torch.Tensor, k: int):
    """Plain version of the emit_dummies kernel."""
    n_src, W = src.shape[0], kernels.key_words(k)
    dev = src.device
    rows = bv.word_u32(src).repeat_interleave(k, dim=0)
    l = torch.arange(k, device=dev).repeat(n_src)
    shift = 2 * (k - l)
    ws, b = (shift >> 5)[:, None], (shift & 31)[:, None]
    col = torch.arange(W, device=dev)[None, :] + ws

    def take(idx):
        return torch.where(idx < W, rows.gather(1, idx.clamp(max=W - 1)), 0)

    out = ((take(col) << b) & _LOW32) | (take(col + 1) >> (32 - b))
    d = k - 1 - l
    edge = (rows.gather(1, (d >> 4)[:, None])[:, 0] >> (30 - 2 * (d & 15))) & 3
    root = torch.zeros((1, W), dtype=torch.long, device=dev)
    return (
        _as_i32(torch.cat([out, root])),
        torch.cat([l, root[0, :1]]).int(),
        torch.cat([edge, root[0, :1] - 1]).int(),
    )


def finalize_tables_plain(keys: torch.Tensor, lengths: torch.Tensor, edges: torch.Tensor,
                          k: int, streaming: bool, lead: int = 0, n_words: int | None = None):
    """Plain version of the finalize_tables kernel."""
    T = keys.shape[0]
    if n_words is None:
        n_words = T // 32 + 1
    dev = keys.device
    weights = torch.arange(32, device=dev)

    def pack(bits):  # bool [..., T] -> unsigned words [..., n_words]
        padded = torch.zeros((*bits.shape[:-1], n_words * 32), dtype=torch.long, device=dev)
        padded[..., lead : lead + T] = bits
        return (padded.reshape(*bits.shape[:-1], n_words, 32) << weights).sum(dim=-1)

    rank_words = pack(torch.stack([(edges >> c) & 1 for c in range(4)]))
    pops = bv.popcount32(rank_words)
    sgs_words = None
    if streaming:
        nm = bv.word_u32(keys)
        full = lengths == k
        sh = torch.where(full[:, None], _drop_first(nm, k), nm)
        sh_len = torch.where(full, k - 1, lengths)
        sgs_words = _as_i32(pack(_differs_from_left(sh, sh_len)))
    return _as_i32(rank_words).reshape(-1), pops.int().reshape(-1), sgs_words


def pack_windows(codes: torch.Tensor, k: int):
    """Every length-k window of the int8 codes [Ntot] as a key: int32 [m, W]
    (m = Ntot - k + 1) and bool [m] validity. A window holding a code < 0
    is invalid and its key all ones, the bits a valid all-T window of
    k = 16 j has too: filter by the mask, never by the key."""
    if codes.device.type == "cuda":
        return kernels.pack_windows(codes, k)
    return pack_windows_plain(codes, k)


def pack_range(codes: torch.Tensor, k: int, lo: int, hi: int, bits: int, cap_nodes: int,
               cap_edges: int):
    """The valid windows of the codes whose key lies in buckets [lo, hi) of
    its top ``bits`` bits (the range's nodes) and those whose (k-1)-prefix
    does (its out-edges), as int32 key rows in no fixed order. The
    capacities are the survey's exact counts; any other count raises."""
    if codes.device.type == "cuda":
        nodes, edges, count = kernels.pack_range(codes, k, lo, hi, bits, cap_nodes, cap_edges)
        got = tuple(count.tolist())
    else:
        nodes, edges = pack_range_plain(codes, k, lo, hi, bits)
        got = nodes.shape[0], edges.shape[0]
    if got != (cap_nodes, cap_edges):
        raise RuntimeError(f"pack_range: {got} windows in [{lo}, {hi}), "
                           f"expected {(cap_nodes, cap_edges)}")
    return nodes, edges


def edge_src_probe(keys: torch.Tensor, k: int, queries: torch.Tensor):
    """Over the n sorted distinct k-mer keys (the list) and the sorted
    distinct query keys: uint8 [n] edge nibble
    (bit c: out-edge c of the suffix group among the queries, on the
    group's first column only), bool [n] suffix-group start, bool [nq]
    source (no list key's (k-1)-suffix is its (k-1)-prefix)."""
    if keys.device.type == "cuda":
        return kernels.edge_src_probe(keys, k, queries)
    return edge_src_probe_plain(keys, k, queries)


def emit_dummies(src: torch.Tensor, k: int):
    """The dummy prefixes of the source keys [n_src, W]: row s * k + l is
    source s's l-char prefix with its length l and edge char (the source's
    char at index l); the last row is the root (zeros, 0, -1). Returns
    int32 [n_src * k + 1, W] keys, int32 lengths, int32 edges."""
    if src.device.type == "cuda":
        return kernels.emit_dummies(src, k)
    return emit_dummies_plain(src, k)


def finalize_tables(keys: torch.Tensor, lengths: torch.Tensor, edges: torch.Tensor, k: int,
                    streaming: bool, lead: int = 0, n_words: int | None = None):
    """Over the T nodes sorted by (key, length): the packed edge rows int32
    [4 * n_words] (char-major, n_words = T // 32 + 1 unless given), their
    per-word popcounts, and the packed streaming marks int32 [n_words]
    (None without streaming support); column t at bit ``lead`` + t. A node
    starts a suffix group when its key and length, with a full k-mer's
    first char dropped, differ from its left neighbour's (the first node
    always does)."""
    if keys.device.type == "cuda":
        return kernels.finalize_tables(keys, lengths, edges, k, streaming, lead, n_words)
    return finalize_tables_plain(keys, lengths, edges, k, streaming, lead, n_words)


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def colex_order(keys: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The permutation that sorts key rows int32 [n, W] in unsigned
    word-sequence (colex) order, ties by ``lengths``. Stable sorts of int64
    columns, least significant first: the lengths, then two words a column
    with the sign bit flipped so that signed order is the unsigned order
    (a lone last word is widened instead)."""
    W = keys.shape[1]
    columns = [] if lengths is None else [lengths.long()]
    if W % 2:
        columns.append(bv.word_u32(keys[:, W - 1]))
    for i in range(W - W % 2 - 2, -1, -2):
        columns.append(((keys[:, i].long() << 32) | bv.word_u32(keys[:, i + 1])) ^ _INT64_MIN)
    perm = torch.sort(columns[0], stable=True).indices
    for col in columns[1:]:
        perm = perm[torch.sort(col[perm], stable=True).indices]
    return perm


def prepare_device_codes(seqs, k: int, device) -> torch.Tensor:
    """Flatten the sequences (str or int8 code arrays) into one int8 code
    array with -1 after each (and -1 up to k codes), on ``device``.
    Reusable across repeat builds through ``build_sbwt_device(...,
    prepared=)``. The codes go up through one host staging buffer of
    UPLOAD_CHUNK codes (or the longest sequence), pinned where the device
    is CUDA, so the host never holds a second copy of them all."""
    if k > 255:
        raise ValueError("k > 255 exceeds the reference's MAX_KMER_LENGTH ceiling")
    parts = [np.asarray(s, dtype=np.int8) if isinstance(s, np.ndarray) else encode(s)
             for s in seqs]
    total = sum(len(p) + 1 for p in parts)
    out = torch.full((max(total, k),), -1, dtype=torch.int8, device=device)
    size = min(total, max(UPLOAD_CHUNK, max((len(p) + 1 for p in parts), default=0)))
    stage = torch.empty(size, dtype=torch.int8,
                        pin_memory=torch.device(device).type == "cuda")
    buf = stage.numpy()
    at = fill = 0
    for part in parts:
        if fill + len(part) + 1 > size:
            out[at : at + fill].copy_(stage[:fill])
            at, fill = at + fill, 0
        buf[fill : fill + len(part)] = part
        buf[fill + len(part)] = -1
        fill += len(part) + 1
    out[at : at + fill].copy_(stage[:fill])
    return out


def sorted_distinct_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The distinct valid k-mers of the int8 codes as sorted key rows."""
    keys, valid = pack_windows(codes, k)
    return sorted_distinct_rows(keys[valid])


def dummy_nodes(src: torch.Tensor, k: int):
    """The dummy nodes of the source keys: every prefix of every source and
    the root, sorted and deduplicated by (key, length), the edges of equal
    rows OR-ed into one nibble. Returns (keys, int32 lengths, uint8 edges)."""
    dd, dd_len, dd_edge = emit_dummies(src, k)
    order = colex_order(dd, dd_len)
    dd, dd_len, dd_edge = dd[order], dd_len[order], dd_edge[order]
    head = _differs_from_left(dd, dd_len)
    group = torch.cumsum(head, dim=0) - 1
    du, du_len = dd[head], dd_len[head]
    du_edges = torch.zeros(du.shape[0], dtype=torch.uint8, device=src.device)
    for c in range(4):  # the root's edge of -1 sets nothing
        has_c = torch.zeros(du.shape[0], dtype=torch.bool, device=src.device)
        has_c[group[dd_edge == c]] = True
        du_edges += has_c.to(torch.uint8) * (1 << c)
    return du, du_len, du_edges


def merged_nodes(dummies, dv: torch.Tensor, kmer_edges: torch.Tensor, k: int):
    """All nodes, dummies and k-mers, in (key, length) order: (keys, int32
    lengths, uint8 edges)."""
    du, du_len, du_edges = dummies
    keys = torch.cat([du, dv])
    lengths = torch.cat([du_len, torch.full((dv.shape[0],), k, dtype=torch.int32,
                                            device=dv.device)])
    edges = torch.cat([du_edges, kmer_edges])
    order = colex_order(keys, lengths)
    return keys[order], lengths[order], edges[order]


def tables_from_words(rank_words: torch.Tensor, pops: torch.Tensor,
                      sgs_words: torch.Tensor | None):
    """(rank_tbl [4 * n_words, 2], sgs_tbl [n_words, 2] or [1, 2] zeros, C
    [4]) from finalize_tables' words: the exclusive prefix sums of the
    popcounts, each marks word beside its predecessor, and the char counts."""
    dev = rank_words.device
    pops = pops.view(4, -1).long()
    cum = (torch.cumsum(pops, dim=1) - pops).int().reshape(-1)
    C = torch.ones(4, dtype=torch.int32, device=dev)
    C[1:] += torch.cumsum(pops.sum(dim=1), dim=0)[:3].int()
    if sgs_words is None:
        sgs_tbl = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    else:
        prev = torch.zeros_like(sgs_words)
        prev[1:] = sgs_words[:-1]
        sgs_tbl = torch.stack([sgs_words, prev], dim=1)
    return torch.stack([rank_words, cum], dim=1), sgs_tbl, C


def tables_from_words_wide(rank_words: torch.Tensor, pops: torch.Tensor,
                           sgs_words: torch.Tensor | None):
    """tables_from_words at int64 counts, the wide tier's layout
    (models/wide.py): rank_tbl int32 [4 * n_words, 3] (word, low and high
    half of the exclusive cum popcount), sgs_tbl as narrow, C int64 [4].
    One char row at a time, so the int64 transients stay at one row's."""
    dev = rank_words.device
    nw = rank_words.shape[0] // 4
    tbl = torch.empty((4 * nw, 3), dtype=torch.int32, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    for c in range(4):
        rows = slice(c * nw, (c + 1) * nw)
        p = pops[rows].long()
        cum = torch.cumsum(p, dim=0) - p
        tbl[rows, 0] = rank_words[rows]
        tbl[rows, 1] = _as_i32(cum & _LOW32)
        tbl[rows, 2] = (cum >> 32).int()
        counts[c] = p.sum()
        del p, cum
    C = torch.ones(4, dtype=torch.int64, device=dev)
    C[1:] += torch.cumsum(counts, dim=0)[:3]
    if sgs_words is None:
        sgs_tbl = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    else:
        sgs_tbl = torch.empty((nw, 2), dtype=torch.int32, device=dev)
        sgs_tbl[:, 0] = sgs_words
        sgs_tbl[0, 1] = 0
        sgs_tbl[1:, 1] = sgs_words[:-1]
    return tbl, sgs_tbl, C


# ---------------------------------------------------------------------------
# The ranged build: key ranges, one pass over the codes each
# ---------------------------------------------------------------------------

# A range is a run of buckets of the top RANGE_BITS bits of a key's word 0
# (its last chars; fewer at k <= 8, so that the first char is never among
# them and a range never splits a suffix group).
RANGE_BITS = 16
# Device bytes a window of a range takes while its keys are packed, sorted
# and deduplicated: a per-key-word and a fixed part (the keys, torch.unique's
# or the stable sorts' buffers, the distinct keys kept beside the other side).
RANGE_BYTES_PER_WORD, RANGE_BYTES_FIXED = 6, 16
# Share of the free device memory that one range's windows may take.
RANGE_MEMORY_SHARE = 0.6
# Windows of one side of a range at most, so that no tensor op of the range
# takes 2^31 elements; windows a survey chunk; codes a staged upload.
MAX_RANGE_SIDE = 1 << 30
SURVEY_CHUNK = 1 << 27
UPLOAD_CHUNK = 1 << 26

# The record of the last build_sbwt_device call, kept as kernels.LAUNCHES
# is, for whoever measures the build: key_ranges, range_columns (each
# range's), bases (codes uploaded, 1 B each), bases_read (over all passes),
# columns, kmers, sources, table_bytes
# (rank_tbl, sgs_tbl, C and precalc as written), peak_bytes (the device
# memory peak during the build, None off CUDA), index (its class's name).
LAST_BUILD: dict = {}


def range_bits(k: int) -> int:
    """Bits of a key's word 0 that name its bucket: 0 at k = 1 (one range)."""
    return min(RANGE_BITS, 2 * (k - 1))


def _buckets(keys: torch.Tensor, bits: int):
    """The bucket of each key row int32 [n, W] (its word 0's top ``bits``
    bits) and of its (k-1)-prefix (the key shifted left by one char: bits
    30 - bits .. 29 of word 0, as bits <= 16)."""
    low = (1 << bits) - 1
    return (keys[:, 0] >> (32 - bits)) & low, (keys[:, 0] >> (30 - bits)) & low


def _sortable64(keys: torch.Tensor) -> torch.Tensor:
    """Key rows int32 [n, W <= 2] (their first two words past that) as int64
    whose signed order is the keys' unsigned order."""
    if keys.shape[1] == 1:
        return bv.word_u32(keys[:, 0])
    return ((keys[:, 0].long() << 32) | bv.word_u32(keys[:, 1])) ^ _INT64_MIN


def _rows64(values: torch.Tensor, W: int) -> torch.Tensor:
    """The inverse of _sortable64 for W <= 2."""
    if W == 1:
        return _as_i32(values)[:, None]
    x = values ^ _INT64_MIN
    return torch.stack([_as_i32((x >> 32) & _LOW32), _as_i32(x & _LOW32)], dim=1)


def sorted_distinct_rows(keys: torch.Tensor) -> torch.Tensor:
    """Key rows int32 [n, W], sorted and deduplicated: torch.unique over one
    int64 column for W <= 2, colex_order's stable sorts past that."""
    W = keys.shape[1]
    if W <= 2:
        return _rows64(torch.unique(_sortable64(keys)), W)
    keys = keys[colex_order(keys)]
    return keys[_differs_from_left(keys)]


def _keys_of_rows(rows: torch.Tensor, k: int) -> torch.Tensor:
    """int32 key rows [c, W] of int8 code rows [c, k] (every code >= 0)."""
    u = (rows & 3).long()
    words = torch.zeros((rows.shape[0], kernels.key_words(k)), dtype=torch.long,
                        device=rows.device)
    for j in range(k):
        d = k - 1 - j
        words[:, d >> 4] |= u[:, j] << (30 - 2 * (d & 15))
    return _as_i32(words)


def _run_start_keys(codes: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """Sorted distinct keys of the valid windows that start a run of codes
    >= 0 (at 0 or after a code < 0): every other valid window's left
    neighbour is valid, so only these can be sources."""
    n = codes.shape[0]
    starts = [torch.zeros(1, dtype=torch.long, device=codes.device)]
    for c0 in range(0, n, chunk):
        starts.append(torch.nonzero(codes[c0 : c0 + chunk] < 0).squeeze(1) + (c0 + 1))
    starts = torch.cat(starts)
    starts = starts[starts <= n - k]
    rows = codes[starts[:, None] + torch.arange(k, device=codes.device)]
    return sorted_distinct_rows(_keys_of_rows(rows[(rows >= 0).all(dim=1)], k))


def _drop_first_rows(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Key rows int32 [n, W] with the first char of length k cleared."""
    wi, sh = _first_char(k)
    if keys.shape[1] > 2:
        return _as_i32(_drop_first(bv.word_u32(keys), k))
    mask = ~(3 << sh) & _LOW32
    out = keys.clone()
    out[:, wi] &= mask - (1 << 32) if mask >> 31 else mask  # as a signed 32-bit value
    return out


def _found_among(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bool [p]: which of the sorted distinct key rows int32 [p, W] equal
    some query row (int32 [n, W]): a searchsorted over the first two
    words, each tie checked whole."""
    p, W = rows.shape
    out = torch.zeros(p, dtype=torch.bool, device=rows.device)
    if p == 0 or q.shape[0] == 0:
        return out
    head = _sortable64(rows[:, :2])
    qh = _sortable64(q[:, :2])
    lo = torch.searchsorted(head, qh)
    if W <= 2:
        i = lo.clamp(max=p - 1)
        out[i[head[i] == qh]] = True
        return out
    hi = torch.searchsorted(head, qh, right=True)
    for j in range(int((hi - lo).max())):
        i = lo + j
        act = i < hi
        ii = i[act]
        out[ii[(rows[ii] == q[act]).all(dim=1)]] = True
    return out


def survey(codes: torch.Tensor, k: int, bits: int, chunk: int = SURVEY_CHUNK):
    """One pass over the codes, in chunks of windows: the windows a bucket
    of 2^bits holds as nodes (its key's top bits) and as out-edges (its
    (k-1)-prefix's), int64 [2^bits] each, and the sources, sorted key rows.
    A source is a run-start window whose (k-1)-prefix is no valid window's
    (k-1)-suffix."""
    m = codes.shape[0] - k + 1
    dev = codes.device
    cand = _run_start_keys(codes, k, chunk)
    preds = sorted_distinct_rows(_as_i32(_shift_left2(bv.word_u32(cand))))
    found = torch.zeros(preds.shape[0], dtype=torch.bool, device=dev)
    hist_nodes = torch.zeros(1 << bits, dtype=torch.int64, device=dev)
    hist_edges = torch.zeros_like(hist_nodes)
    for w0 in range(0, m, chunk):
        keys, valid = pack_windows(codes[w0 : min(w0 + chunk, m) + k - 1], k)
        keys = keys[valid]
        del valid
        node_b, edge_b = _buckets(keys, bits)
        hist_nodes += torch.bincount(node_b, minlength=1 << bits)
        hist_edges += torch.bincount(edge_b, minlength=1 << bits)
        found |= _found_among(preds, _drop_first_rows(keys, k))
        del keys, node_b, edge_b
    has_pred = _member(bv.word_u32(preds[found]), _shift_left2(bv.word_u32(cand)))
    return hist_nodes, hist_edges, cand[~has_pred]


def plan_ranges(hist_nodes, hist_edges, budget: int) -> list:
    """Runs of consecutive buckets, (lo, hi, node windows, edge windows)
    each, whose windows of both sides stay within ``budget`` and each side
    within MAX_RANGE_SIDE, but where one bucket alone is over."""
    hn = hist_nodes.tolist()
    he = hist_edges.tolist()
    out, lo, cn, ce = [], 0, 0, 0
    for b, (a, e) in enumerate(zip(hn, he)):
        if b > lo and (cn + ce + a + e > budget or max(cn + a, ce + e) > MAX_RANGE_SIDE):
            out.append((lo, b, cn, ce))
            lo, cn, ce = b, 0, 0
        cn += a
        ce += e
    out.append((lo, len(hn), cn, ce))
    return out


def range_budget(device, k: int) -> int:
    """Windows of both sides that one range may hold in the free memory of
    ``device`` (none measurable: no cut)."""
    from ..utils.memory import device_free_bytes

    free = device_free_bytes(device)
    if free is None:
        return 1 << 62
    per = RANGE_BYTES_PER_WORD * kernels.key_words(k) + RANGE_BYTES_FIXED
    return max(1, int(free * RANGE_MEMORY_SHARE) // per)


def _merge_dummies(dummies, dv: torch.Tensor, kmer_edges: torch.Tensor, k: int):
    """merged_nodes of a range's few dummies and its many k-mers: each dummy
    goes before the k-mers of its key and above (a searchsorted), the rest
    in order, without a sort of the k-mers (W <= 2; merged_nodes past)."""
    du, du_len, du_edges = dummies
    nd, nk, W = du.shape[0], dv.shape[0], dv.shape[1]
    dev = dv.device
    if nd == 0:
        return dv, torch.full((nk,), k, dtype=torch.int32, device=dev), kmer_edges
    if W > 2:
        return merged_nodes(dummies, dv, kmer_edges, k)
    at = torch.searchsorted(_sortable64(dv), _sortable64(du)) + torch.arange(nd, device=dev)
    is_kmer = torch.ones(nd + nk, dtype=torch.bool, device=dev)
    is_kmer[at] = False
    keys = torch.empty((nd + nk, W), dtype=torch.int32, device=dev)
    keys[at] = du
    keys[is_kmer] = dv
    lengths = torch.full((nd + nk,), k, dtype=torch.int32, device=dev)
    lengths[at] = du_len
    edges = torch.empty(nd + nk, dtype=torch.uint8, device=dev)
    edges[at] = du_edges
    edges[is_kmer] = kmer_edges
    return keys, lengths, edges


def _check_src_pad(src: torch.Tensor, src_pad: int | None) -> None:
    if src_pad is not None and src.shape[0] > src_pad:
        raise ValueError(f"device build source budget exceeded ({src.shape[0]} > {src_pad}); "
                         "use SBWT.build or raise src_pad")


class _MemoryPeak:
    """The device memory peak over a block of work, where PyTorch's own
    peak rose in it; else the most of the samples taken (a lower bound)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.before = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        self.seen = 0

    def sample(self) -> None:
        if self.cuda:
            self.seen = max(self.seen, torch.cuda.memory_allocated(self.device))

    def bytes(self) -> int | None:
        if not self.cuda:
            return None
        after = torch.cuda.max_memory_allocated(self.device)
        return after if after > self.before else self.seen


def _build_ranged(codes: torch.Tensor, k: int, streaming: bool, budget: int, src_pad,
                  peak: _MemoryPeak):
    """The nodes of the whole build, range by range: (rank_words int32
    [4 * n_words], pops, sgs_words or None, k-mers, sources, columns of
    each range). The sources and their dummies come first, from one survey
    pass; then each range takes its nodes and its out-edges from one pass
    over the codes (pack_range), deduplicates both, probes the edges
    (edge_src_probe of the nodes against the out-edges), merges its share
    of the dummies in and packs its columns at their global bit offset.
    The columns' count is known only after the last range, and the rows
    are char-major at a stride of n_words, so each range keeps its packed
    words (0.625 B a column) until the rows are laid out at the end."""
    bits = range_bits(k)
    with annotate("sbwt.build.sources"):
        hist_nodes, hist_edges, src = survey(codes, k, bits)
        _check_src_pad(src, src_pad)
        dummies = dummy_nodes(src, k)
        d_bucket = _buckets(dummies[0], bits)[0]
    peak.sample()
    plan = plan_ranges(hist_nodes, hist_edges, budget)
    pieces, col, n_kmers, columns = [], 0, 0, []
    for lo, hi, cap_nodes, cap_edges in plan:
        with annotate("sbwt.build.range"):
            nodes, edges = pack_range(codes, k, lo, hi, bits, cap_nodes, cap_edges)
            peak.sample()
            dv = sorted_distinct_rows(nodes)
            del nodes
            peak.sample()
            ev = sorted_distinct_rows(edges)
            del edges
            peak.sample()
            kmer_edges = edge_src_probe(dv, k, ev)[0]
            del ev
            sel = (d_bucket >= lo) & (d_bucket < hi)
            merged = _merge_dummies(tuple(d[sel] for d in dummies), dv, kmer_edges, k)
            n_kmers += dv.shape[0]
            del dv, kmer_edges
            T_r = merged[0].shape[0]
            if T_r:
                lead = col & 31
                nw = (lead + T_r + 31) // 32
                words, _, marks = finalize_tables(*merged, k, streaming, lead, nw)
                pieces.append((col >> 5, words.view(4, nw), marks))
                col += T_r
            columns.append(T_r)
            peak.sample()
            del merged
    n_words = col // 32 + 1
    rows = torch.zeros((4, n_words), dtype=torch.int32, device=codes.device)
    sgs_words = torch.zeros(n_words, dtype=torch.int32, device=codes.device) if streaming else None
    while pieces:  # a range's first word may hold the last columns of the range before
        w0, words, marks = pieces.pop(0)
        rows[:, w0 : w0 + words.shape[1]] |= words
        if streaming:
            sgs_words[w0 : w0 + marks.shape[0]] |= marks
    pops = torch.empty_like(rows)
    for c in range(4):
        pops[c] = bv.popcount32(bv.word_u32(rows[c])).int()
    peak.sample()
    return rows.view(-1), pops.view(-1), sgs_words, n_kmers, src.shape[0], columns


def build_sbwt_device(seqs, k: int, device, streaming_support: bool = True, precalc_k: int = 0,
                      src_pad: int | None = None, prepared: torch.Tensor | None = None
                      ) -> MatrixIndex:
    """Build a plain-matrix index on ``device`` from sequences (str or int8
    code arrays), any k <= 255: a MatrixIndex, or a WideMatrixIndex (int64
    positions) at 2^31 columns or more (``needs_wide_index``). On a CUDA
    device the stages run their kernels or raise; on the CPU their plain
    versions. ``prepared`` (from prepare_device_codes) skips the flatten
    and upload.

    The build works in ranges of consecutive keys (``_build_ranged``), as
    many as the free device memory asks for (``range_budget``): one where
    all windows, counted twice, fit. Any number of ranges gives the same
    tables, word for word.

    ``src_pad`` is the JAX package's source budget: None sizes the dummy
    buffer from the counted sources; a number the input exceeds raises the
    same ValueError, and nothing here falls back to the host build.
    ``LAST_BUILD`` records the build."""
    codes = prepared if prepared is not None else prepare_device_codes(seqs, k, device)
    peak = _MemoryPeak(codes.device)
    streaming = bool(streaming_support)
    *words, n, n_src, columns = _build_ranged(codes, k, streaming, range_budget(codes.device, k),
                                              src_pad, peak)
    T, passes = sum(columns), len(columns) + 1  # the survey, then one pass a range
    is_wide = needs_wide_index(T)
    if is_wide:
        rank_tbl, sgs_tbl, C = tables_from_words_wide(*words)
    else:
        rank_tbl, sgs_tbl, C = tables_from_words(*words)
    del words
    peak.sample()
    meta = dict(n_nodes=T, n_kmers=n, k=k, n_words=T // 32 + 1, has_streaming=streaming)
    if is_wide:
        index = wide_from_device_tables(rank_tbl, sgs_tbl, C, precalc_k=precalc_k, **meta)
    else:
        index = MatrixIndex(rank_tbl, sgs_tbl, C,
                            torch.zeros((1, 2), dtype=torch.int32, device=codes.device),
                            precalc_k=0, **meta)
        if precalc_k > 0:
            with_precalc(index, precalc_k)
    LAST_BUILD.clear()
    LAST_BUILD.update(
        key_ranges=len(columns), range_columns=columns, bases=codes.shape[0],
        bases_read=codes.shape[0] * passes,
        columns=T, kmers=n, sources=n_src,
        table_bytes=sum(t.numel() * t.element_size()
                        for t in (index.rank_tbl, index.sgs_tbl, index.C, index.precalc)),
        peak_bytes=peak.bytes(), index=type(index).__name__,
    )
    if len(columns) > 1:
        write_log(f"device build: {T} columns, {n} k-mers in {len(columns)} key ranges "
                  f"({type(index).__name__})")
    return index
