"""Turbo query engine: de Bruijn successor tables of arity 1, 2 or 3.

The port of sbwt_tpu/ops/turbo.py: the narrow (int32) engine over a
plain-matrix index or any compressed variant's, and the wide (int64)
arity-1 tier. The successor table gives, per column and per string of A chars, the columns
reached after 1..A out-edges (SBWT.hh:566-577), with -1 propagated:

    arity 1: tbl int32 [n, 4]       row col: its 4 successors
    arity 2: tbl int32 [n * 16, 2]  row col * 16 + c1 * 4 + c2: (s1, s2)
    arity 3: tbl int32 [n * 64, 4]  row col * 64 + c1 * 16 + c2 * 4 + c3: (s1, s2, s3, 0)

(The JAX tables for arity 2 and 3 carry pad rows past n * 4^A that no
query reads; these tables have none.) The table is built from the index's
own ranks and does not depend on the variant. A wide index has arity 1
only, as in the JAX package, and holds its successors as one int64 [n, 4]
table: the JAX package's pair of int32 tables (low and high words) and its
low-word-only path exist because the TPU has no 64-bit lanes. ``seed_bits`` packs, for every
(p+1)-mer m, bit0 = precalc row m mod 4^p non-empty and bit1 = precalc
row m >> 2 non-empty, 16 two-bit entries per 32-bit word, stored as int32.

On CUDA tensors the table build launches K2 (succ1 of the index's rank
type, csrc/succ_table.cuh, then csrc/succ_table.cu), the seed table K3
(csrc/seed_bits.cu), the streaming search K4 of the index's rank type
(csrc/turbo_stream.cuh) and the singleton-seed k-mer search fast_search
(csrc/fast_search.cu); CPU tensors run the plain versions below.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from .search import extend_from_column, search_batch_plain


class TurboIndex(nn.Module):
    """Successor table, precalc seeds and seed-liveness bits of an index."""

    def __init__(self, tbl, precalc, C, seed_bits, *, n_nodes: int, k: int,
                 precalc_k: int, arity: int):
        super().__init__()
        self.register_buffer("tbl", tbl)
        self.register_buffer("precalc", precalc)
        self.register_buffer("C", C)
        self.register_buffer("seed_bits", seed_bits)  # None when p > 14
        self.n_nodes = int(n_nodes)
        self.k = int(k)
        self.precalc_k = int(precalc_k)
        self.arity = int(arity)

    @property
    def pos_dtype(self) -> torch.dtype:
        return self.tbl.dtype

    def row(self, col, sub=0):
        """The table row of column col (>= 0) and, for arity >= 2, of the
        string of chars packed in sub (the row's offset inside the column)."""
        if self.arity == 1:
            return self.tbl[col]
        return self.tbl[col * 4**self.arity + sub]


class WideTurboIndex(TurboIndex):
    """The arity-1 tier of a wide index: tbl int64 [n, 4] (32 B a column),
    precalc int64 [4^p, 2], C int64 [4]."""


def turbo_from_numpy_state(state: dict, device) -> TurboIndex:
    """A TurboIndex from the fields of a JAX TurboIndex as numpy arrays
    (tbl, precalc, C, seed_bits or None) and its metadata (n_nodes, k,
    precalc_k, arity). The JAX table's pad rows are dropped."""
    n, A = state["n_nodes"], state["arity"]
    tbl = np.array(np.asarray(state["tbl"])[: n * 4**A], dtype=np.int32)
    sb = state.get("seed_bits")
    return TurboIndex(
        torch.as_tensor(tbl, device=device),
        torch.as_tensor(np.array(state["precalc"], dtype=np.int32), device=device),
        torch.as_tensor(np.array(state["C"], dtype=np.int32), device=device),
        None if sb is None else torch.as_tensor(np.array(sb).view(np.int32), device=device),
        n_nodes=n, k=state["k"], precalc_k=state["precalc_k"], arity=A,
    )


def wide_turbo_from_numpy_state(state: dict, device) -> WideTurboIndex:
    """A WideTurboIndex from the fields of a JAX WideTurboIndex as numpy
    arrays (tbl and tbl_hi, the low and high int32 words of the
    successors, padded past n_nodes rows; precalc, C, seed_bits or None)
    and its metadata (n_nodes, k, precalc_k)."""
    n = state["n_nodes"]
    lo = np.asarray(state["tbl"])[:n].view(np.uint32).astype(np.int64)
    hi = np.asarray(state["tbl_hi"])[:n].astype(np.int64)
    sb = state.get("seed_bits")
    return WideTurboIndex(
        torch.as_tensor((hi << 32) | lo, device=device),
        torch.as_tensor(np.array(state["precalc"], dtype=np.int64), device=device),
        torch.as_tensor(np.array(state["C"], dtype=np.int64), device=device),
        None if sb is None else torch.as_tensor(np.array(sb).view(np.int32), device=device),
        n_nodes=n, k=state["k"], precalc_k=state["precalc_k"], arity=1,
    )


class TurboUnavailable(ValueError):
    """The index cannot have a turbo table: no streaming support, or an
    arity whose rows overflow int32 indexing. The LF engine answers instead."""


def check_turbo_index_range(n_nodes: int, arity: int, what: str = "turbo table"):
    """Raise TurboUnavailable unless every flat row index col * 4^arity +
    sub of an arity>=2 table fits int32 (2^27 columns at arity 2, 2^25 at
    arity 3), as the JAX engine does; past it use arity 1."""
    if arity >= 2 and n_nodes * (4**arity) >= 2**31:
        raise TurboUnavailable(
            f"{what}: n_nodes={n_nodes} * 4^{arity} exceeds int32 row indexing "
            f"(limit {2**31 // 4**arity} columns at arity {arity}); use arity 1"
        )


# ---------------------------------------------------------------------------
# table build: plain versions of K2 and K3
# ---------------------------------------------------------------------------


def succ1_plain(index, cols=None) -> torch.Tensor:
    """[4, B] in the index's position type: succ[c, i] = successor of
    column i's suffix group by c, or -1, over ``cols`` or all columns."""
    if cols is None:
        cols = torch.arange(index.n_nodes, device=index.device)
    return torch.stack([extend_from_column(index, cols, c)
                        for c in range(4)]).to(index.pos_dtype)


def compose_plain(succ: torch.Tensor, arity: int, chunk: int = 1 << 18, col0: int = 0,
                  n_cols: int | None = None) -> torch.Tensor:
    """The arity-A table from succ [4, n], built column chunk by chunk; with
    n_cols, the rows of columns col0 .. col0 + n_cols - 1 only (one model
    shard's), columns past n as zero rows."""
    n = succ.shape[1]
    n_cols = n - col0 if n_cols is None else n_cols
    real = max(0, min(n, col0 + n_cols) - col0)
    if arity == 1:
        out = torch.zeros((n_cols, 4), dtype=succ.dtype, device=succ.device)
        out[:real] = succ[:, col0 : col0 + real].t()
        return out
    width = 2 if arity == 2 else 4
    rows = 4**arity
    out = torch.empty((n_cols * rows, width), dtype=torch.int32, device=succ.device)
    out[real * rows :] = 0
    for s in range(col0, col0 + real, chunk):
        m = min(chunk, col0 + real - s)
        n1 = succ[:, s : s + m]  # [c1, m]
        n2 = torch.where(n1[None] >= 0, succ[:, n1.clamp(min=0)], -1)  # [c2, c1, m]
        if arity == 2:
            parts = [n1[None].expand(4, 4, m), n2]  # [c2, c1, m] each
            part = torch.stack(parts, dim=-1).permute(2, 1, 0, 3)  # [m, c1, c2, 2]
        else:
            n3 = torch.where(n2[None] >= 0, succ[:, n2.clamp(min=0)], -1)  # [c3, c2, c1, m]
            parts = [n1[None, None].expand(4, 4, 4, m), n2[None].expand(4, 4, 4, m), n3,
                     torch.zeros_like(n3)]
            part = torch.stack(parts, dim=-1).permute(3, 2, 1, 0, 4)  # [m, c1, c2, c3, 4]
        out[(s - col0) * rows : (s - col0 + m) * rows] = part.reshape(m * rows, width)
    return out


def seed_bits_plain(precalc: torch.Tensor, p: int, chunk: int = 1 << 24) -> torch.Tensor:
    """int32 [4^(p+1) / 16]: the packed 2-bit seed-liveness pair entries."""
    live = (precalc[:, 0] >= 0).long()
    q = 4**p
    n = 4 * q
    shifts = 2 * torch.arange(16, device=precalc.device)
    words = []
    for s in range(0, n, chunk):
        m = torch.arange(s, min(s + chunk, n), device=precalc.device)
        v = live[m & (q - 1)] | (live[m >> 2] << 1)
        words.append((v.view(-1, 16) << shifts).sum(dim=1))
    w = torch.cat(words)
    return torch.where(w >= 2**31, w - 2**32, w).int()


def build_seed_bits(precalc: torch.Tensor, p: int) -> torch.Tensor:
    if precalc.device.type == "cuda":
        return kernels.seed_bits(precalc, p)
    return seed_bits_plain(precalc, p)


def succ1(index, cols=None, row_major: bool = False) -> torch.Tensor:
    """K2's succ1 over the index's own ranks: the kernel of its rank type
    on a CUDA index, the plain version on a CPU one."""
    if index.device.type == "cuda":
        return kernels.succ1(index.variant, index.kernel_desc(index.device), index.sgs_tbl,
                             index.C, index.n_nodes, cols, row_major)
    succ = succ1_plain(index, cols)
    return succ.t().contiguous() if row_major else succ


def _check_can_have_turbo(index) -> None:
    if not index.has_streaming:
        raise TurboUnavailable("turbo engine requires streaming support (suffix group marks)")
    if index.precalc_k <= 0:
        # the singleton-seed fast path is the whole engine
        raise ValueError("turbo engine requires a precalc table (precalc_k > 0)")


def build_turbo_wide(index) -> WideTurboIndex:
    """The arity-1 successor table of a wide index (K2's succ1 at int64,
    written row by row) and its seed bits (K3): 32 B of device memory a
    column."""
    _check_can_have_turbo(index)
    p = index.precalc_k
    return WideTurboIndex(succ1(index, row_major=True), index.precalc, index.C,
                          build_seed_bits(index.precalc, p) if p <= 14 else None,
                          n_nodes=index.n_nodes, k=index.k, precalc_k=p, arity=1)


def build_turbo(index, arity: int = 2) -> TurboIndex:
    """Build the successor table (K2) and seed bits (K3) of an index from
    its own ranks: a plain-matrix index or any compressed variant's (the
    table is the same). Memory per column: 16 B (arity 1), 128 B (2),
    1 KiB (3). A wide index has the arity-1 tier only, whatever arity is
    asked (sbwt_tpu/ops/turbo.py:406-409)."""
    _check_can_have_turbo(index)
    if arity not in (1, 2, 3):
        raise ValueError("turbo arity must be 1, 2 or 3")
    if index.pos_dtype == torch.int64:
        return build_turbo_wide(index)
    check_turbo_index_range(index.n_nodes, arity)
    succ = succ1(index)
    tbl = kernels.succ_compose(succ, arity) if succ.device.type == "cuda" \
        else compose_plain(succ, arity)
    p = index.precalc_k
    # p <= 14 keeps the (p+1)-mer pair index inside int32 (4^15 = 2^30)
    seed_bits = build_seed_bits(index.precalc, p) if p <= 14 else None
    return TurboIndex(tbl, index.precalc, index.C, seed_bits, n_nodes=index.n_nodes,
                      k=index.k, precalc_k=p, arity=arity)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def _succ_step(turbo: TurboIndex, col, c):
    """The successor of each column col >= 0 by char c (0..3), from the
    first entry of its table row; -1 stays -1."""
    safe = col.clamp(min=0)
    if turbo.arity == 1:
        nxt = turbo.row(safe).gather(-1, c.long()[..., None])[..., 0]
    else:
        nxt = turbo.row(safe, c * 4 ** (turbo.arity - 1))[..., 0]
    return torch.where(col >= 0, nxt.long(), -1)


def fast_search_plain(turbo: TurboIndex, codes):
    """Plain version of the fast_search kernel: singleton-seed search of
    k-mer rows codes [..., k]. Returns (ans in the table's type,
    needs_slow): ans is the colex rank or -1 where needs_slow is False;
    needs_slow marks live non-singleton seeds, which only exact LF steps
    can answer. Only codes 0..3 are valid."""
    k, p = turbo.k, turbo.precalc_k
    shape = codes.shape[:-1]
    codes = codes.reshape(-1, k).long()
    valid = ((codes >= 0) & (codes < 4)).all(dim=1)
    cc = codes.clamp(min=0) & 3
    pidx = (cc[:, :p] << (2 * torch.arange(p, device=codes.device))).sum(dim=1)
    seed = turbo.precalc[pidx].long()
    l, r = seed[:, 0], seed[:, 1]
    dead = (l < 0) | ~valid
    needs_slow = ~dead & (l != r)
    col = torch.where(dead, -1, l)
    for j in range(p, k):
        col = _succ_step(turbo, col, cc[:, j])
    ans = torch.where(needs_slow, -1, col).to(turbo.pos_dtype)
    return ans.reshape(shape), needs_slow.reshape(shape)


def fast_search(turbo: TurboIndex, codes):
    """Singleton-seed search of k-mer rows codes [..., k], equal to the JAX
    package's fast_search: (ans in the table's type, needs_slow bool), ans
    the colex rank, or -1 where the row is absent, holds a char other than
    uppercase ACGT, or needs_slow (a live seed wider than one column, which
    only exact LF steps can answer). CUDA codes must be int8 and launch the
    fast_search kernel (csrc/fast_search.cu); CPU codes run the plain
    version."""
    if codes.shape[-1] != turbo.k:
        raise ValueError(f"query length {codes.shape[-1]} != index k {turbo.k}")
    if codes.device.type != "cuda":
        return fast_search_plain(turbo, codes)
    shape = codes.shape[:-1]
    ans, needs_slow = kernels.fast_search(turbo.tbl, turbo.arity, turbo.precalc, turbo.precalc_k,
                                          codes.reshape(-1, turbo.k).contiguous(), turbo.n_nodes)
    return ans.reshape(shape), needs_slow.reshape(shape)


def turbo_streaming_search_plain(turbo: TurboIndex, index, codes, lengths):
    """Plain version of K4: a lockstep loop over positions over all lanes.

    A lane whose previous answer is live extends it by one table entry
    (lowercase codes extend as their base until the lane's first -1, as the
    JAX engine's chain does; after it only 0..3 extend, because the JAX
    engine answers those positions by full search); any other position is
    answered by an exact LF search of its window. K4 answers those by the
    seed-bits test, the precalc seed and a table walk or LF steps, which
    must come to the same answer."""
    B, L = codes.shape
    k = turbo.k
    P = L - k + 1
    ans = torch.full((B, P), -1, dtype=turbo.pos_dtype, device=codes.device)
    prev = torch.full((B,), -1, dtype=torch.long, device=codes.device)
    lenient = torch.ones(B, dtype=torch.bool, device=codes.device)
    for i in range(P):
        c = codes[:, i + k - 1].long()
        ext = (prev >= 0) & (c >= 0) & (lenient | (c < 4))
        cur = torch.where(ext, _succ_step(turbo, prev, c.clamp(min=0) & 3), -1)
        lanes = (prev < 0).nonzero().squeeze(1)
        if len(lanes):
            cur[lanes] = search_batch_plain(index, codes[lanes, i : i + k]).long()
        lenient &= cur >= 0
        ans[:, i] = cur
        prev = cur
    pos_ok = torch.arange(P, device=codes.device)[None, :] <= (lengths.long()[:, None] - k)
    return torch.where(pos_ok, ans, -1)


def turbo_streaming_search(turbo: TurboIndex, index, codes, lengths=None):
    """Exact streaming search of codes [B, L] (padded with -1; ACGT = 0..3,
    acgt = 4..7, other = -1) with valid lengths [B]. Returns
    [B, L - k + 1] in the index's position type, equal to the JAX engine's
    turbo_streaming_search; positions past a read's length are -1.
    ``index`` is the index the table was built from (plain-matrix, wide or
    a compressed variant's), whose ranks take the exact LF steps of
    non-singleton seeds.

    CUDA codes must be int8, are read in place, and launch K4 of the
    index's rank type."""
    B, L = codes.shape
    if L < turbo.k:
        raise ValueError(f"read length {L} < k = {turbo.k}")
    if lengths is None:
        lengths = torch.full((B,), L, dtype=torch.int32, device=codes.device)
    if codes.device.type == "cuda":
        return kernels.turbo_stream(
            index.variant, index.kernel_desc(codes.device), turbo.tbl, turbo.arity, turbo.C,
            turbo.precalc, turbo.precalc_k, turbo.seed_bits, codes,
            lengths.to(device=codes.device, dtype=torch.int32), turbo.k, turbo.n_nodes,
        )
    return turbo_streaming_search_plain(turbo, index, codes, lengths)
