"""Plain-matrix SBWT index of 2^31 columns or more: the wide (int64) tier.

The port of sbwt_tpu/models/wide.py. Positions, interval bounds, C and the
precalc table are int64; the rank table keeps the fused one-row layout by
splitting each word's exclusive cumulative popcount into its halves:

    rank_tbl int32 [4 * n_words, 3]  char-major (word, cum low 32, cum high 32)
    sgs_tbl  int32 [n_words, 2]      as in MatrixIndex
    C        int64 [4]
    precalc  int64 [4^p, 2]          [1, 2] zeros when p = 0

The row layout is the JAX package's, so state carries across byte for
byte. On a CUDA device the queries launch the WideMatrix instances of the
kernels (csrc/lf_wide.cu), the same templates as the narrow tier's at a
64-bit position type; int64 is native there, so there is no counterpart to
the JAX package's process-wide x64 switch. ``models.matrix.from_packed_rows``
routes here by itself at n >= 2^31; a smaller index can be forced here.
The JAX package has no wide compressed variant, and neither has the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops import bitvector as bv
from .matrix import MatrixIndex, c_array_from_rows, sgs_pair_table, with_precalc


class WideMatrixIndex(MatrixIndex):
    """Device representation of the plain-matrix SBWT with int64 positions."""

    variant = kernels.WIDE
    pos_dtype = torch.int64

    def extend_rank(self, c, pos):
        """(rank_c(c, pos), bit of row c at pos) from one 12-byte row; int64."""
        pos = torch.as_tensor(pos, device=self.device)
        c = torch.as_tensor(c, device=self.device).long()
        return bv.rank_get_wide(self.rank_tbl, pos, row0=c * self.n_words)

    def kernel_desc(self, dev):
        """The WideMatrix rank descriptor of the kernels."""
        return kernels.WideMatrixDesc(kernels.ptr(self.rank_tbl, "rank_tbl", dev), self.n_words)


def wide_from_numpy_state(state: dict, device) -> WideMatrixIndex:
    """A WideMatrixIndex from the fields of a JAX WideMatrixIndex as numpy
    arrays (rank_tbl int32 [4W, 3], sgs_tbl, C and precalc int64) and its
    metadata (n_nodes, n_kmers, k, precalc_k, n_words, has_streaming)."""
    def t(name, dtype):
        return torch.as_tensor(np.array(state[name], dtype=dtype), device=device)

    return WideMatrixIndex(
        t("rank_tbl", np.int32), t("sgs_tbl", np.int32), t("C", np.int64), t("precalc", np.int64),
        n_nodes=state["n_nodes"], n_kmers=state["n_kmers"], k=state["k"],
        precalc_k=state["precalc_k"], n_words=state["n_words"],
        has_streaming=state["has_streaming"],
    )


def from_packed_rows_wide(row_words: np.ndarray, n: int, sgs_words: np.ndarray | None, k: int,
                          n_kmers: int, device, precalc_k: int = 0,
                          precalc_table: np.ndarray | None = None) -> WideMatrixIndex:
    """Wide index from packed uint32 rows [4, n // 32 + 1] (and the packed
    suffix-group starts, or None). The fused table is filled band by band:
    a concatenate of four per-character tables would for a while double
    the 6.4 GB that 4.3 billion columns take. Fills the precalc table on
    the device (K1) unless ``precalc_table`` is given."""
    W = n // 32 + 1
    if row_words.shape != (4, W):
        raise ValueError(f"row_words shape {row_words.shape}, expected {(4, W)}")
    rank_tbl = np.empty((4 * W, 3), dtype=np.int32)
    for c in range(4):
        rank_tbl[c * W : (c + 1) * W] = bv.rank_table_from_words_wide(row_words[c])
    sgs_tbl = sgs_pair_table(sgs_words, W)
    C = c_array_from_rows(row_words, np.int64)
    index = WideMatrixIndex(
        torch.as_tensor(rank_tbl, device=device),
        torch.as_tensor(sgs_tbl, device=device),
        torch.as_tensor(C, device=device),
        torch.zeros((1, 2), dtype=torch.int64, device=device),
        n_nodes=n, n_kmers=n_kmers, k=k, precalc_k=0, n_words=W,
        has_streaming=sgs_words is not None,
    )
    if precalc_table is not None:
        index.precalc = torch.as_tensor(np.array(precalc_table, dtype=np.int64), device=device)
        index.precalc_k = int(precalc_k)
    elif precalc_k > 0:
        wide_with_precalc(index, precalc_k)
    return index


def wide_with_precalc(index: WideMatrixIndex, precalc_k: int) -> WideMatrixIndex:
    """The precalc table at int64 intervals (SBWT.hh:617-645): ``with_precalc``
    of models/matrix.py, which takes the index's position type."""
    return with_precalc(index, precalc_k)
