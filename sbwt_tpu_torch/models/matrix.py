"""Plain-matrix SBWT index as an ``nn.Module`` of int32 buffers.

The port of sbwt_tpu/models/matrix.py. The four indicator bit vectors are
one flat interleaved (word, cum popcount) table, so each rank is one
8-byte row, and the suffix-group-start bit vector keeps each word beside
its predecessor, so the left walk of SBWT.hh:563 is one row too:

    rank_tbl int32 [4 * n_words, 2]  char-major (word, exclusive cum)
    sgs_tbl  int32 [n_words, 2]      (word w, word w - 1); [1, 2] zeros without streaming support
    C        int32 [4]               cumulative char counts, C[0] = 1
    precalc  int32 [4^p, 2]          intervals of all p-mers; [1, 2] zeros when p = 0

``rank_c``, ``extend_rank`` and ``sg_start`` are the plain PyTorch
versions of the device helpers in csrc/sbwt_common.cuh. An index of 2^31
columns or more is a ``WideMatrixIndex`` (models/wide.py), to which
``from_packed_rows`` routes by itself.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..ops import bitvector as bv
from ..ops.search import update_interval_batch

MAX_PRECALC_K = 13


class MatrixIndex(nn.Module):
    """Device representation of the plain-matrix SBWT (narrow engine:
    n < 2^31 columns, int32 positions)."""

    variant = "plain-matrix"
    max_precalc_k = MAX_PRECALC_K
    pos_dtype = torch.int32  # of C, precalc and every answer

    def __init__(self, rank_tbl, sgs_tbl, C, precalc, *, n_nodes: int, n_kmers: int,
                 k: int, precalc_k: int, n_words: int, has_streaming: bool):
        super().__init__()
        self.register_buffer("rank_tbl", rank_tbl)
        self.register_buffer("sgs_tbl", sgs_tbl)
        self.register_buffer("C", C)
        self.register_buffer("precalc", precalc)
        self.n_nodes = int(n_nodes)
        self.n_kmers = int(n_kmers)
        self.k = int(k)
        self.precalc_k = int(precalc_k)
        self.n_words = int(n_words)
        self.has_streaming = bool(has_streaming)

    @property
    def device(self) -> torch.device:
        return self.rank_tbl.device

    def rank_c(self, c, pos):
        """Count of character c in subsets 0..pos-1 (SubsetMatrixRank.hh:31-37); int64."""
        return self.extend_rank(c, pos)[0]

    def extend_rank(self, c, pos):
        """(rank_c(c, pos), bit of row c at pos) from one row; int64."""
        pos = torch.as_tensor(pos, device=self.device)
        c = torch.as_tensor(c, device=self.device).long()
        return bv.rank_get(self.rank_tbl, pos, row0=c * self.n_words)

    def sg_start(self, col):
        return sg_start(self.sgs_tbl, col)

    def kernel_desc(self, dev):
        """The plain-matrix rank descriptor of the kernels."""
        return kernels.PlainMatrixDesc(kernels.ptr(self.rank_tbl, "rank_tbl", dev, 8),
                                       self.n_words)

    def size_in_bytes(self) -> int:
        """Bytes of the rank structure: the fused rank table."""
        return self.rank_tbl.numel() * 4


def sg_start(sgs_tbl, col):
    """Greatest marked column <= col (SBWT.hh:563); int64."""
    col = torch.as_tensor(col, device=sgs_tbl.device).long()
    return sg_start_in(sgs_tbl[col >> 5], col)


def sg_start_in(row, col):
    """sg_start from row col >> 5 of the suffix-group table: the mark is
    within 3 columns, inside the (word w, word w - 1) row read as one 64-bit
    window whose bit 32 + o is bit o of word w; int64."""
    win = (bv.word_u32(row[..., 0]) << 32) | bv.word_u32(row[..., 1])
    j = 32 + (col & 31)
    delta = torch.full_like(col, 3)
    for d in (2, 1, 0):
        delta = torch.where(((win >> (j - d)) & 1) == 1, d, delta)
    return col - delta


def from_numpy_state(state: dict, device) -> MatrixIndex:
    """A MatrixIndex from the fields of a JAX MatrixIndex as numpy arrays
    (rank_tbl, sgs_tbl, C, precalc) and its metadata (n_nodes, n_kmers, k,
    precalc_k, n_words, has_streaming)."""
    def t(name):
        return torch.as_tensor(np.array(state[name], dtype=np.int32), device=device)

    return MatrixIndex(
        t("rank_tbl"), t("sgs_tbl"), t("C"), t("precalc"),
        n_nodes=state["n_nodes"], n_kmers=state["n_kmers"], k=state["k"],
        precalc_k=state["precalc_k"], n_words=state["n_words"],
        has_streaming=state["has_streaming"],
    )


def sgs_pair_table(sgs_words: np.ndarray | None, W: int) -> np.ndarray:
    """(word, previous word) int32 rows of suffix_group_starts."""
    if sgs_words is None:
        return np.zeros((1, 2), dtype=np.int32)
    sw = sgs_words.view(np.int32)
    tbl = np.empty((W, 2), dtype=np.int32)
    tbl[:, 0] = sw
    tbl[0, 1] = 0
    tbl[1:, 1] = sw[:-1]
    return tbl


def c_array_from_rows(row_words: np.ndarray, dtype) -> np.ndarray:
    """C[0] = 1 (ghost-dollar root edge), then running totals per character
    (SBWT.hh:344-350)."""
    counts = [int(bv.popcount_words_host(row_words[c]).sum()) for c in range(4)]
    C = np.empty(4, dtype=dtype)
    C[0] = 1
    C[1] = C[0] + counts[0]
    C[2] = C[1] + counts[1]
    C[3] = C[2] + counts[2]
    return C


def needs_wide_index(n: int) -> bool:
    """Whether n columns are past int32 positions (the wide tier's)."""
    return n >= 2**31


def from_packed_rows(row_words: np.ndarray, n: int, sgs_words: np.ndarray | None,
                     k: int, n_kmers: int, device, precalc_k: int = 0,
                     precalc_table: np.ndarray | None = None) -> MatrixIndex:
    """Index from packed uint32 rows [4, n // 32 + 1] (and the packed
    suffix-group starts, or None) without bool arrays. Fills the precalc
    table on the device (K1) unless ``precalc_table`` is given. With 2^31
    columns or more the index is a WideMatrixIndex."""
    if needs_wide_index(n):
        from .wide import from_packed_rows_wide

        return from_packed_rows_wide(row_words, n, sgs_words, k, n_kmers, device, precalc_k,
                                     precalc_table)
    W = n // 32 + 1
    if row_words.shape != (4, W):
        raise ValueError(f"row_words shape {row_words.shape}, expected {(4, W)}")
    rank_tbl = np.concatenate([bv.rank_table_from_words(row_words[c]) for c in range(4)])
    index = MatrixIndex(
        torch.as_tensor(rank_tbl, device=device),
        torch.as_tensor(sgs_pair_table(sgs_words, W), device=device),
        torch.as_tensor(c_array_from_rows(row_words, np.int32), device=device),
        torch.zeros((1, 2), dtype=torch.int32, device=device),
        n_nodes=n, n_kmers=n_kmers, k=k, precalc_k=0, n_words=W,
        has_streaming=sgs_words is not None,
    )
    if precalc_table is not None:
        index.precalc = torch.as_tensor(np.array(precalc_table, dtype=np.int32), device=device)
        index.precalc_k = int(precalc_k)
    elif precalc_k > 0:
        with_precalc(index, precalc_k)
    return index


def from_host_arrays(bits: np.ndarray, suffix_group_starts: np.ndarray | None, k: int,
                     n_kmers: int, device, precalc_k: int = 0,
                     precalc_table: np.ndarray | None = None) -> MatrixIndex:
    """Index from the bool rows [4, n] and suffix-group starts [n] (empty or
    None without streaming support)."""
    n = bits.shape[1]
    row_words = np.stack([bv.pack_bits_host(bits[c]) for c in range(4)])
    has_streaming = suffix_group_starts is not None and len(suffix_group_starts) > 0
    sgs_words = bv.pack_bits_host(suffix_group_starts) if has_streaming else None
    return from_packed_rows(row_words, n, sgs_words, k, n_kmers, device,
                            precalc_k, precalc_table)


def build_device_index(built, device, precalc_k: int = 0) -> MatrixIndex:
    """Upload a host BuiltSBWT (construct/inmemory.py)."""
    return from_host_arrays(built.bits, built.suffix_group_starts, built.k,
                            built.n_kmers, device, precalc_k)


def precalc_fill_plain(index, p: int, chunk: int = 1 << 22) -> torch.Tensor:
    """Plain version of K1's precalc fill: [4^p, 2] intervals of all
    p-mers in the index's position type, lane i spelling chars
    (i >> 2j) & 3, (-1, -1) when empty."""
    n_entries = 4**p
    out = torch.empty((n_entries, 2), dtype=index.pos_dtype, device=index.device)
    for s in range(0, n_entries, chunk):
        ids = torch.arange(s, min(s + chunk, n_entries), device=index.device)
        codes = torch.stack([(ids >> (2 * j)) & 3 for j in range(p)], dim=1)
        l0 = torch.zeros_like(ids)
        r0 = torch.full_like(ids, index.n_nodes - 1)
        l, r, alive = update_interval_batch(index, codes, l0, r0)
        out[s : s + len(ids), 0] = torch.where(alive, l, -1)
        out[s : s + len(ids), 1] = torch.where(alive, r, -1)
    return out


def with_precalc(index, precalc_k: int):
    """Fill the table of the SBWT intervals of all 4^p strings
    (SBWT.hh:617-645), indexed colex-reversed: idx = sum_i code[i] << 2i,
    over the ranks of any index (a MatrixIndex, a WideMatrixIndex or a
    variant's GenericIndex), in its position type. On a CUDA index this launches the variant's K1 fill; on
    a CPU index it runs the plain version. Updates ``index`` in place and
    returns it."""
    p = int(precalc_k)
    cap = index.max_precalc_k
    if p > cap:
        raise ValueError(f"precalc_k > {cap} not supported "
                         f"(table would exceed {8 << (2 * cap - 20)} MiB)")
    if p > index.k:
        raise ValueError(f"precalc_k {p} > k {index.k}")
    if p == 0:
        tbl = torch.zeros((1, 2), dtype=index.pos_dtype, device=index.device)
    elif index.device.type == "cuda":
        tbl = kernels.precalc_fill(index.variant, index.kernel_desc(index.device), index.C,
                                   index.n_nodes, p)
    else:
        tbl = precalc_fill_plain(index, p)
    index.precalc = tbl
    index.precalc_k = p
    return index
