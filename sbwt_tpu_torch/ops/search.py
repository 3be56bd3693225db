"""Batched LF search on the plain-matrix index.

The port of the LF core of sbwt_tpu/ops/search.py (``lf_step``,
``update_interval_batch``, ``search_batch``, ``extend_from_column``,
``forward_batch``) as plain PyTorch over int64 lanes. ``search_batch`` on a
CUDA index launches kernel K1 (csrc/lf_interval.cu) instead; the plain
version serves CPU tensors and is what the kernel is checked against.
"""
from __future__ import annotations

import torch

from .. import kernels


def lf_step(index, l, r, c, alive):
    """One LF iteration on intervals [l, r] for char codes c (SBWT.hh:430-433).
    Dead lanes keep their interval."""
    Cc = index.C.long()[c]
    l2 = Cc + index.rank_c(c, l)
    r2 = Cc + index.rank_c(c, r + 1) - 1
    alive2 = alive & (l2 <= r2)
    return torch.where(alive2, l2, l), torch.where(alive2, r2, r), alive2


def update_interval_batch(index, codes, l0, r0):
    """LF iterations over each lane's codes [B, m] from (l0, r0). A code < 0
    or an emptied interval kills the lane; lowercase codes 4..7 count as
    their base (toupper semantics). Returns int64 (l, r) and alive."""
    codes = codes.long()
    l, r = l0.long(), r0.long()
    alive = torch.ones_like(l, dtype=torch.bool)
    for j in range(codes.shape[1]):
        ct = codes[:, j]
        l, r, alive = lf_step(index, l, r, ct.clamp(min=0) & 3, alive & (ct >= 0))
    return l, r, alive


def search_batch_plain(index, codes):
    """Plain version of K1's k-mer search: int32 [B] colex ranks or -1.
    Only codes 0..3 are valid characters (SBWT.hh:426-427)."""
    B, k = codes.shape
    codes = codes.long()
    p = index.precalc_k
    valid = ((codes >= 0) & (codes < 4)).all(dim=1)
    cc = codes.clamp(min=0) & 3
    if p > 0:
        weights = 4 ** torch.arange(p, device=codes.device)
        seed = index.precalc[(cc[:, :p] * weights).sum(dim=1)].long()
        alive = seed[:, 0] >= 0
        l = torch.where(alive, seed[:, 0], 0)
        r = torch.where(alive, seed[:, 1], 0)
    else:
        l = torch.zeros(B, dtype=torch.long, device=codes.device)
        r = torch.full_like(l, index.n_nodes - 1)
        alive = torch.ones(B, dtype=torch.bool, device=codes.device)
    for j in range(p, k):
        l, r, alive = lf_step(index, l, r, cc[:, j], alive)
    # a found k-mer interval is always a singleton (SBWT.hh:410-414)
    return torch.where(valid & alive, l, -1).int()


def search_batch(index, codes):
    """Vectorized SBWT::search over k-mer rows codes [B, k]: the colex rank
    of each, or -1 if absent or holding a char other than uppercase ACGT.
    A CUDA batch must be int8 and launches K1."""
    B, k = codes.shape
    if k != index.k:
        raise ValueError(f"query length {k} != index k {index.k}")
    if codes.device.type == "cuda":
        return kernels.kmer_search(index.rank_tbl, index.n_words, index.C, index.n_nodes,
                                   index.precalc, index.precalc_k, codes)
    return search_batch_plain(index, codes)


def extend_from_column(index, col, c):
    """Successor of col's suffix group by edge c, or -1 (SBWT.hh:566-577)."""
    r1, bit = index.extend_rank(c, index.sg_start(col))
    return torch.where(bit == 1, index.C.long()[c] + r1, -1)


def forward_batch(index, nodes, c):
    """Vectorized SBWT::forward (SBWT.hh:369-381)."""
    return extend_from_column(index, nodes, c)
