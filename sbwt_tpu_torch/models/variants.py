"""Device index of the nine compressed variants.

The port of sbwt_tpu/models/variants.py. ``GenericIndex`` joins a
subset-rank structure (models/subsetrank.py) with the state every variant
shares: the suffix-group-start rows, C and the precalc table. It offers
the engine interface of ops/search.py (``rank_c``, ``extend_rank``,
``sg_start``), so the LF engines run unchanged on every variant, as the
reference's ``SBWT<subset_rank_t>`` template does (SBWT.hh:31-46).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import bitvector as bv
from .matrix import c_array_from_rows, sg_start, sgs_pair_table, with_precalc
from .subsetrank import build_struct

# the JAX package's cap for a variant's own precalc fill (variants.py:135)
MAX_GENERIC_PRECALC_K = 12


class GenericIndex(nn.Module):
    """A compressed variant's index: struct plus sgs_tbl int32 [W, 2] (as in
    MatrixIndex), C int32 [4] and precalc int32 [max(1, 4^p), 2]."""

    max_precalc_k = MAX_GENERIC_PRECALC_K
    pos_dtype = torch.int32

    def __init__(self, struct: nn.Module, sgs_tbl, C, precalc, *, variant: str, n_nodes: int,
                 n_kmers: int, k: int, precalc_k: int, has_streaming: bool):
        super().__init__()
        self.struct = struct
        self.register_buffer("sgs_tbl", sgs_tbl)
        self.register_buffer("C", C)
        self.register_buffer("precalc", precalc)
        self.variant = variant
        self.n_nodes, self.n_kmers, self.k = int(n_nodes), int(n_kmers), int(k)
        self.precalc_k = int(precalc_k)
        self.has_streaming = bool(has_streaming)

    @property
    def device(self) -> torch.device:
        return self.C.device

    def rank_c(self, c, pos):
        return self.struct.rank(c, pos)

    def extend_rank(self, c, pos):
        """(rank_c(c, pos), bit c at pos) from the structure's rank_pair."""
        r1, r2 = self.struct.rank_pair(c, pos)
        return r1, r2 - r1

    def sg_start(self, col):
        return sg_start(self.sgs_tbl, col)

    def kernel_desc(self, dev):
        """The structure's rank descriptor of the kernels."""
        return self.struct.desc(dev)

    def size_in_bytes(self) -> int:
        return self.struct.size_in_bytes()

    def device_bytes(self) -> int:
        """The structure's bytes as the device holds it: its size, except
        for the subset wavelet trees' device form (models/subsetrank.py)."""
        return getattr(self.struct, "device_bytes", self.struct.size_in_bytes)()


def build_generic_index(variant: str, bits: np.ndarray, suffix_group_starts, k: int,
                        n_kmers: int, device, precalc_k: int = 0, precalc_table=None,
                        struct=None) -> GenericIndex:
    """Index of a compressed variant from the bool rows [4, n] and the
    suffix-group starts (None or empty without streaming support). The
    precalc table is carried over when given (a tensor or an array), and
    otherwise filled over the variant's own ranks."""
    n = bits.shape[1]
    if n >= 2**31:
        raise ValueError(f"n = {n} columns needs the int64 (wide) engine, which has no "
                         f"compressed variant (plain-matrix only)")
    if struct is None:
        struct = build_struct(variant, bits, device)
    has_streaming = suffix_group_starts is not None and len(suffix_group_starts) > 0
    sgs_words = bv.pack_bits_host(suffix_group_starts) if has_streaming else None
    row_words = np.stack([bv.pack_bits_host(bits[c]) for c in range(4)])
    index = GenericIndex(
        struct,
        torch.as_tensor(sgs_pair_table(sgs_words, n // 32 + 1), device=device),
        torch.as_tensor(c_array_from_rows(row_words, np.int32), device=device),
        torch.zeros((1, 2), dtype=torch.int32, device=device),
        variant=variant, n_nodes=n, n_kmers=n_kmers, k=k, precalc_k=0,
        has_streaming=has_streaming,
    )
    if precalc_table is not None and precalc_k > 0:
        index.precalc = torch.as_tensor(precalc_table, device=device).to(torch.int32)
        index.precalc_k = int(precalc_k)
    elif precalc_k > 0:
        with_precalc(index, precalc_k)
    return index

