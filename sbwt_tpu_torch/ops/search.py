"""Batched LF search over any variant's index.

The port of sbwt_tpu/ops/search.py (``lf_step``, ``update_interval_batch``,
``search_batch``, ``extend_from_column``, ``forward_batch``,
``streaming_chain``, ``streaming_search`` and ``partial_search_batch``) as
plain PyTorch over int64 lanes, written against the rank interface
(``rank_c``, ``extend_rank``, ``sg_start``) that the plain-matrix
``MatrixIndex``, the wide ``WideMatrixIndex`` and the compressed variants'
``GenericIndex`` share. Results take the index's position type
(``pos_dtype``: int32, or int64 on the wide tier). On a CUDA index,
``search_batch`` launches K1, ``streaming_search`` K14,
``partial_search_batch`` the partial_search kernel and ``forward_batch``
the forward kernel (one char a column), each the instance of the index's rank
type (csrc/rank_ops.cuh); the plain versions serve CPU tensors and are
what the kernels are checked against.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import annotate


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
    """Plain version of K1's k-mer search: [B] colex ranks or -1.
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
    return torch.where(valid & alive, l, -1).to(index.pos_dtype)


def search_batch(index, codes):
    """Vectorized SBWT::search over k-mer rows codes [B, k]: the colex rank
    of each, or -1 if absent or holding a char other than uppercase ACGT.
    A CUDA batch must be int8 and launches the variant's K1 search."""
    B, k = codes.shape
    if k != index.k:
        raise ValueError(f"query length {k} != index k {index.k}")
    if codes.device.type != "cuda":
        return search_batch_plain(index, codes)
    return kernels.kmer_search(index.variant, index.kernel_desc(codes.device), index.C,
                               index.n_nodes, index.precalc, index.precalc_k, codes)


def extend_from_column(index, col, c):
    """Successor of col's suffix group by edge c, or -1 (SBWT.hh:566-577)."""
    r1, bit = index.extend_rank(c, index.sg_start(col))
    return torch.where(bit == 1, index.C.long()[c] + r1, -1)


def forward_batch(index, nodes, c):
    """Vectorized SBWT::forward (SBWT.hh:369-381): the successor of each
    node by its char c (0..3), or -1. CUDA nodes launch the rank type's
    forward kernel: one rank pair a node."""
    if nodes.device.type != "cuda":
        return extend_from_column(index, nodes, c.long()).to(index.pos_dtype)
    return kernels.forward(index.variant, index.kernel_desc(nodes.device), index.sgs_tbl, index.C,
                           index.n_nodes, nodes.to(index.pos_dtype).contiguous(),
                           c.to(torch.int8).contiguous())


def streaming_search_plain(index, codes, lengths, chunk: int = 1 << 20):
    """Plain version of K14: the chain, then the patch.

    The chain answers position 0 by full search and extends each later
    position from the previous answer by one out-edge (lowercase extends as
    its base), until the lane's first -1. Every later position is answered
    by a full search of its window, where only 0..3 are valid. The JAX
    engine splits that patch into a seed-only stage and a full search of
    the survivors; the full search checks the seed itself, so one stage
    gives the same answers."""
    B, L = codes.shape
    k = index.k
    P = L - k + 1
    codes = codes.long()
    col = search_batch_plain(index, codes[:, :k]).long()
    cols = [col]
    for i in range(1, P):
        ct = codes[:, i + k - 1]
        nxt = extend_from_column(index, col.clamp(min=0), ct.clamp(min=0) & 3)
        col = torch.where((col >= 0) & (ct >= 0), nxt, -1)
        cols.append(col)
    ans = torch.stack(cols, dim=1)
    pos_ok = torch.arange(P, device=codes.device)[None, :] <= (lengths.long()[:, None] - k)
    unresolved = torch.zeros_like(pos_ok)
    unresolved[:, 1:] = ans[:, :-1] == -1
    lane, pos = (unresolved & pos_ok).nonzero(as_tuple=True)
    window = torch.arange(k, device=codes.device)
    for s in range(0, len(lane), chunk):
        ln, ps = lane[s : s + chunk], pos[s : s + chunk]
        ans[ln, ps] = search_batch_plain(index, codes[ln[:, None], ps[:, None] + window]).long()
    return torch.where(pos_ok, ans, -1).to(index.pos_dtype)


def streaming_search(index, codes, lengths=None):
    """Exact LF streaming search of codes [B, L] (padded with -1; ACGT =
    0..3, acgt = 4..7, other = -1) with valid lengths [B]:
    [B, L - k + 1] in the index's position type, equal at every position to the JAX engine's
    streaming_search (SBWT.hh:545-581); positions past a read's length
    are -1. The index needs streaming support. CUDA codes must be int8,
    are read in place, and launch K14. Spans ``sbwt.engine`` and, on a
    card, ``sbwt.engine.desc`` (utils/profiling.py annotate)."""
    with annotate("sbwt.engine"):
        B, L = codes.shape
        if L < index.k:
            raise ValueError(f"read length {L} < k = {index.k}")
        if not index.has_streaming:
            raise ValueError("streaming search needs streaming support (suffix group marks)")
        if lengths is None:
            lengths = torch.full((B,), L, dtype=torch.int32, device=codes.device)
        if codes.device.type != "cuda":
            return streaming_search_plain(index, codes, lengths)
        with annotate("sbwt.engine.desc"):
            desc = index.kernel_desc(codes.device)
        return kernels.lf_stream(index.variant, desc, index.sgs_tbl, index.C, index.precalc,
                                 index.precalc_k, index.k, index.n_nodes, codes,
                                 lengths.to(device=codes.device, dtype=torch.int32))


def partial_search_plain(index, codes, lengths, start=None):
    """Plain version of the partial_search kernel: a lockstep loop of LF
    steps over all lanes. Returns (l, r) in the index's position type and
    the matched length int32."""
    B, L = codes.shape
    codes = codes.long()
    if start is None:
        l = torch.zeros(B, dtype=torch.long, device=codes.device)
        r = torch.full_like(l, index.n_nodes - 1)
    else:
        l, r = start[:, 0].long(), start[:, 1].long()
    alive = torch.ones(B, dtype=torch.bool, device=codes.device)
    mlen = torch.zeros(B, dtype=torch.int32, device=codes.device)
    for t in range(L):
        ct = codes[:, t]
        l, r, alive = lf_step(index, l, r, ct.clamp(min=0) & 3,
                              alive & (ct >= 0) & (t < lengths))
        mlen = torch.where(alive, t + 1, mlen)
    return l.to(index.pos_dtype), r.to(index.pos_dtype), mlen


def partial_search_batch(index, codes, lengths=None, start=None):
    """Vectorized SBWT::partial_search (SBWT.hh:526-537): the interval of
    the longest prefix of each lane's codes [B, L] (lowercase as its base)
    that the index matches, as (l, r, matched length). ``start`` [B, 2]
    gives each lane an interval to go on from instead of the full one
    (SBWT::update_sbwt_interval, SBWT.hh:423-437). CUDA codes must be int8
    and launch the partial_search kernel of the index's rank type."""
    B, L = codes.shape
    if lengths is None:
        lengths = torch.full((B,), L, dtype=torch.int32, device=codes.device)
    lengths = lengths.to(device=codes.device, dtype=torch.int32)
    if start is not None:
        start = start.to(device=codes.device, dtype=index.pos_dtype).contiguous()
    if codes.device.type != "cuda":
        return partial_search_plain(index, codes, lengths, start)
    return kernels.partial_search(index.variant, index.kernel_desc(codes.device), index.C,
                                  index.n_nodes, codes, lengths, start)
