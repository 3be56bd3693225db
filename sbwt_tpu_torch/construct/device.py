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

Four stages are hand-written CUDA kernels (csrc/build_sbwt.cu), each with
its plain PyTorch version here: ``pack_windows``, ``edge_src_probe``,
``emit_dummies``, ``finalize_tables``. On a CUDA device the kernels run
or raise; the plain versions run on the CPU only. The sorts
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
from ..models.matrix import MatrixIndex, with_precalc
from ..ops import bitvector as bv
from ..utils.dna import encode

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


def edge_src_probe_plain(keys: torch.Tensor, k: int):
    """Plain version of the edge_src_probe kernel."""
    dv = bv.word_u32(keys)
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
        edges[gstart] += _member(dv, y).to(torch.uint8) * (1 << c)
    # the (k-1)-prefix among the k-mers' (k-1)-suffixes
    pred = (dv << 2) & _LOW32
    pred[:, :-1] |= dv[:, 1:] >> 30
    return edges, gstart, ~_member(sf, pred)


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
                          k: int, streaming: bool):
    """Plain version of the finalize_tables kernel."""
    T = keys.shape[0]
    n_words = T // 32 + 1
    dev = keys.device
    weights = torch.arange(32, device=dev)

    def pack(bits):  # bool [..., T] -> unsigned words [..., n_words]
        padded = torch.zeros((*bits.shape[:-1], n_words * 32), dtype=torch.long, device=dev)
        padded[..., :T] = bits
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


def edge_src_probe(keys: torch.Tensor, k: int):
    """Over the n sorted distinct k-mer keys: uint8 [n] edge nibble (bit c:
    out-edge c of the suffix group, on the group's first column only),
    bool [n] suffix-group start, bool [n] source (no predecessor)."""
    if keys.device.type == "cuda":
        return kernels.edge_src_probe(keys, k)
    return edge_src_probe_plain(keys, k)


def emit_dummies(src: torch.Tensor, k: int):
    """The dummy prefixes of the source keys [n_src, W]: row s * k + l is
    source s's l-char prefix with its length l and edge char (the source's
    char at index l); the last row is the root (zeros, 0, -1). Returns
    int32 [n_src * k + 1, W] keys, int32 lengths, int32 edges."""
    if src.device.type == "cuda":
        return kernels.emit_dummies(src, k)
    return emit_dummies_plain(src, k)


def finalize_tables(keys: torch.Tensor, lengths: torch.Tensor, edges: torch.Tensor, k: int,
                    streaming: bool):
    """Over the T nodes sorted by (key, length): the packed edge rows int32
    [4 * n_words] (char-major, n_words = T // 32 + 1), their per-word
    popcounts, and the packed streaming marks int32 [n_words] (None
    without streaming support). A node starts a suffix group when its key
    and length, with a full k-mer's first char dropped, differ from its
    left neighbour's."""
    if keys.device.type == "cuda":
        return kernels.finalize_tables(keys, lengths, edges, k, streaming)
    return finalize_tables_plain(keys, lengths, edges, k, streaming)


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
    array with -1 after each, and upload it once. Reusable across repeat
    builds through ``build_sbwt_device(..., prepared=)``."""
    if k > 255:
        raise ValueError("k > 255 exceeds the reference's MAX_KMER_LENGTH ceiling")
    sep = np.full(1, -1, dtype=np.int8)
    parts = []
    for s in seqs:
        parts.append((s if isinstance(s, np.ndarray) else encode(s)).astype(np.int8))
        parts.append(sep)
    parts.append(np.full(max(0, k - sum(len(p) for p in parts)), -1, dtype=np.int8))
    return torch.from_numpy(np.concatenate(parts)).to(device)


def sorted_distinct_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The distinct valid k-mers of the int8 codes as sorted key rows."""
    keys, valid = pack_windows(codes, k)
    keys = keys[valid]
    keys = keys[colex_order(keys)]
    return keys[_differs_from_left(keys)]


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


def build_sbwt_device(seqs, k: int, device, streaming_support: bool = True, precalc_k: int = 0,
                      src_pad: int | None = None, prepared: torch.Tensor | None = None
                      ) -> MatrixIndex:
    """Build a plain-matrix MatrixIndex on ``device`` from sequences (str or
    int8 code arrays), any k <= 255. On a CUDA device the four stages run
    their kernels or raise; on the CPU their plain versions. ``prepared``
    (from prepare_device_codes) skips the flatten and upload.

    ``src_pad`` is the JAX package's source budget: None sizes the dummy
    buffer from the counted sources; a number the input exceeds raises the
    same ValueError, and nothing here falls back to the host build."""
    codes = prepared if prepared is not None else prepare_device_codes(seqs, k, device)
    dv = sorted_distinct_kmers(codes, k)
    # out-edges of every suffix group; the sources (k-mers without a predecessor)
    kmer_edges, _, is_src = edge_src_probe(dv, k)
    src = dv[is_src]
    if src_pad is not None and src.shape[0] > src_pad:
        raise ValueError(f"device build source budget exceeded ({src.shape[0]} > {src_pad}); "
                         "use SBWT.build or raise src_pad")
    n = dv.shape[0]
    nodes = merged_nodes(dummy_nodes(src, k), dv, kmer_edges, k)
    del dv, kmer_edges, is_src, src
    T = nodes[0].shape[0]
    if T >= 2**31:
        raise ValueError(f"{T} columns need the int64 (wide) engine, which the device build "
                         "does not reach (its tables are int32, as in the JAX package); "
                         "use SBWT.build")
    rank_tbl, sgs_tbl, C = tables_from_words(
        *finalize_tables(*nodes, k, bool(streaming_support)))
    del nodes
    index = MatrixIndex(
        rank_tbl, sgs_tbl, C, torch.zeros((1, 2), dtype=torch.int32, device=codes.device),
        n_nodes=T, n_kmers=n, k=k, precalc_k=0, n_words=T // 32 + 1,
        has_streaming=bool(streaming_support),
    )
    if precalc_k > 0:
        with_precalc(index, precalc_k)
    return index
