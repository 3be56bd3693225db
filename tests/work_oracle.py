"""Host oracle of K14's and K4's work counters (kernels.WORK_COUNTERS).

Walks the reads' positions in lockstep, each lane as the kernels walk one
read (csrc/lf_stream.cuh lf_stream_kernel, csrc/turbo_stream.cuh
turbo_stream_kernel), with the port's plain operations: a live previous
answer is extended by one out-edge (K4 reads a table row every ``arity``
such positions); otherwise a window of k ACGT chars restarts from the
precalc row of its first p chars, then takes exact LF steps (K14, and K4
from a seed wider than one column) or table rows (K4 from a singleton
seed), each counted up to the one that finds nothing. K14 first probes
ahead, by the kernel's rule in the kernel's tiles: a probe that dies
answers -1 for the windows that hold its dead substring ("skipped"), one
that hits keeps its column for its window. The answers come back beside
the counts, so a test can hold the walk to the engines' plain versions
and to tests/oracle.py (string_answers). It runs where the index and the
codes lie, the CPU or a card. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from sbwt_tpu_torch.kernels import WORK_COUNTERS
from sbwt_tpu_torch.ops.search import extend_from_column, lf_step
from sbwt_tpu_torch.ops.turbo import _succ_step
from sbwt_tpu_torch.utils.dna import encode_query

# K14's tile on the narrow rank types (csrc/lf_stream.cuh LFShape): a probe
# looks no further than its tile's last position
LF_TILE = 16


def _lf_steps(index, l, r, chars):
    """Exact LF steps from the intervals (l, r) by chars [n, m]: (column or
    -1, steps taken) of each lane."""
    alive = torch.ones_like(l, dtype=torch.bool)
    steps = torch.zeros_like(l)
    for j in range(chars.shape[1]):
        steps += alive
        l, r, alive = lf_step(index, l, r, chars[:, j], alive)
    return torch.where(alive, l, -1), steps


def _walk(turbo, col, chars):
    """walk_singleton from the columns col by chars [n, m]: (column or -1,
    table rows read), a row each ``arity`` chars while the column lives."""
    rows = torch.zeros_like(col)
    for j in range(chars.shape[1]):
        if j % turbo.arity == 0:
            rows += col >= 0
        col = _succ_step(turbo, col, chars[:, j])
    return col, rows


def _restart(index, turbo, windows):
    """K4's full searches of the windows [n, k] (all 0..3): (answers, LF
    steps, table rows) of each."""
    n, dev = windows.shape[0], windows.device
    p = index.precalc_k
    if p > 0:
        pidx = (windows[:, :p] << (2 * torch.arange(p, device=dev))).sum(dim=1)
        seed = index.precalc[pidx].long()
        l, r = seed[:, 0], seed[:, 1]
    else:
        l = torch.zeros(n, dtype=torch.long, device=dev)
        r = torch.full((n,), index.n_nodes - 1, dtype=torch.long, device=dev)
    ans = torch.full((n,), -1, dtype=torch.long, device=dev)
    steps, rows = torch.zeros_like(ans), torch.zeros_like(ans)
    rest = windows[:, p:]
    wide = (l >= 0) & (l != r)
    if wide.any():
        ans[wide], steps[wide] = _lf_steps(index, l[wide], r[wide], rest[wide])
    single = (l >= 0) & (l == r)
    if single.any():
        ans[single], rows[single] = _walk(turbo, l[single], rest[single])
    return ans, steps, rows


def _probe(index, windows):
    """K14's searches of the windows [n, k] (csrc/lf_stream.cuh
    probe_from_seed), which check their chars as they go: (answers, the
    offset of the char where each died (k where it hit), LF steps)."""
    n, k = windows.shape
    dev = windows.device
    p = index.precalc_k
    valid = (windows >= 0) & (windows < 4)
    bad = torch.where(valid.all(dim=1), k, (~valid).long().argmax(dim=1))  # first non-ACGT
    chars = windows.clamp(0, 3)
    if p > 0:
        pidx = (chars[:, :p] << (2 * torch.arange(p, device=dev))).sum(dim=1)
        seed = index.precalc[pidx].long()
        alive = (bad >= p) & (seed[:, 0] >= 0)
        die = torch.where(bad < p, bad, torch.where(alive, k, p - 1))
        l, r = torch.where(alive, seed[:, 0], 0), torch.where(alive, seed[:, 1], 0)
    else:
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        die = torch.full((n,), k, dtype=torch.long, device=dev)
        l = torch.zeros(n, dtype=torch.long, device=dev)
        r = torch.full((n,), index.n_nodes - 1, dtype=torch.long, device=dev)
    steps = torch.zeros(n, dtype=torch.long, device=dev)
    for j in range(p, k):
        step = alive & (bad > j)
        steps += step
        l, r, live = lf_step(index, l, r, chars[:, j], step)
        die = torch.where(alive & ~live, j, die)
        alive = live
    return torch.where(alive, l, -1), die, steps


def first_die(index) -> int:
    """The die offset a K14 lane assumes before its first probe:
    ceil(log4 n) + 1, at most k - 1."""
    return min(index.k - 1, (int(index.n_nodes - 1).bit_length() + 1) // 2 + 1)


def _k14_restarts(index, codes, lanes, pos, end, st, counts):
    """K14's restarts at position pos of the lanes (prev -1, a window of k
    ACGT chars, not answered ahead): probe until pos is answered, as
    lf_stream_kernel does, updating the probe state st in place. Returns
    pos's answers."""
    k = index.k
    ar = torch.arange(k, device=codes.device)
    ahead = torch.where(st["cov_lo"][lanes] > pos, st["cov_lo"][lanes] - 1, end[lanes] - 1)
    q = torch.minimum(ahead, pos + k - 1 - st["die"][lanes]).clamp(min=pos)
    q = torch.where(st["hit_q"][lanes] > pos, pos, q)
    v = torch.full_like(lanes, -1)
    todo = torch.arange(len(lanes), device=codes.device)
    while len(todo):
        ln, qq = lanes[todo], q[todo]
        col, e, steps = _probe(index, codes[ln[:, None], qq[:, None] + ar])
        counts["restarts"] += len(todo)
        counts["restart_hits"] += int((col >= 0).sum())
        counts["lf_steps"] += int(steps.sum())
        serial = qq == pos
        v[todo[serial]] = col[serial]
        hit = ~serial & (col >= 0)
        st["hit_q"][ln[hit]], st["hit_v"][ln[hit]] = qq[hit], col[hit]
        lower = st["lenient"][ln] & (codes[ln, qq + e.clamp(max=k - 1)] > 3)
        cover = ~serial & ~hit & ~lower
        lo = qq + e - k + 1
        joins = st["cov_lo"][ln] == qq + 1
        st["cov_hi"][ln[cover]] = torch.where(joins, st["cov_hi"][ln], qq)[cover]
        st["cov_lo"][ln[cover]] = lo[cover]
        st["die"][ln[cover]] = e[cover]
        done = cover & (lo <= pos)
        counts["skipped"] += int(done.sum())
        nq = torch.minimum(lo - 1, pos + k - 1 - e).clamp(min=pos)
        q[todo] = torch.where(cover, nq, pos)
        todo = todo[~serial & ~done]
    return v


def work_oracle(index, codes, lengths, turbo=None):
    """(answers int64 [B, L - k + 1], {counter: count}) of K14 over
    ``index`` (a narrow rank type: tiles of LF_TILE), or with ``turbo`` of
    K4 over that table and ``index``, for the codes [B, L] with valid
    lengths [B]."""
    codes, dev = codes.long(), codes.device
    B, L = codes.shape
    k = index.k
    P = L - k + 1
    n_pos = (lengths.long() - k + 1).clamp(0, P)
    base = ((codes >= 0) & (codes < 4)).long()
    ends = torch.cat([torch.zeros_like(base[:, :1]), base.cumsum(dim=1)], dim=1)
    window_ok = (ends[:, k:] - ends[:, :P]) == k  # k ACGT chars: run >= k
    counts = dict.fromkeys(WORK_COUNTERS, 0)
    counts["positions"] = int(n_pos.sum())
    ans = torch.full((B, P), -1, dtype=torch.long, device=dev)
    prev = torch.full((B,), -1, dtype=torch.long, device=dev)
    lenient = torch.ones(B, dtype=torch.bool, device=dev)
    left = torch.zeros_like(prev)  # K4: components of the last row not yet consumed
    st = {"die": torch.full_like(prev, first_die(index)), "cov_lo": torch.zeros_like(prev),
          "cov_hi": torch.full_like(prev, -1), "hit_q": torch.full_like(prev, -1),
          "hit_v": torch.full_like(prev, -1), "lenient": lenient}
    for pos in range(P):
        act = pos < n_pos
        c = codes[:, pos + k - 1]
        if turbo is None:
            at_hit = act & (st["hit_q"] == pos)
            covered = act & ~at_hit & (st["cov_lo"] <= pos) & (pos <= st["cov_hi"])
            counts["skipped"] += int((covered & window_ok[:, pos]).sum())
            act_own = act & ~at_hit & ~covered
            ext = act_own & (prev >= 0)
            nxt = extend_from_column(index, prev.clamp(min=0), c.clamp(min=0) & 3)
        else:
            act_own, ext = act, act & (prev >= 0)
            new_row = ext & (left == 0)
            counts["table_rows"] += int(new_row.sum())
            left = torch.where(new_row, (n_pos - pos).clamp(max=turbo.arity), left) - ext.long()
            nxt = _succ_step(turbo, prev, c.clamp(min=0) & 3)
        v = torch.where(ext & (c >= 0) & (lenient | (c < 4)), nxt, -1)
        restart = act_own & (prev < 0) & window_ok[:, pos]
        if restart.any():
            lanes = restart.nonzero()[:, 0]
            if turbo is None:
                t0 = pos - pos % LF_TILE
                end = n_pos.clamp(max=min(t0 + LF_TILE, P))
                got = _k14_restarts(index, codes, lanes, pos, end, st, counts)
            else:
                got, steps, rows = _restart(index, turbo, codes[lanes, pos : pos + k])
                counts["restarts"] += len(lanes)
                counts["restart_hits"] += int((got >= 0).sum())
                counts["lf_steps"] += int(steps.sum())
                counts["table_rows"] += int(rows.sum())
            v[lanes] = got
        if turbo is None:
            v = torch.where(at_hit, st["hit_v"], v)
        dead = act & (v < 0)
        lenient &= ~dead
        left = torch.where(dead, 0, left)
        prev = torch.where(act, v, prev)
        ans[:, pos] = torch.where(act, v, -1)
    return ans, counts


def counts_from_answers(answers, codes, lengths, k):
    """(positions, restarts, restart_hits) as they follow from streaming
    answers [B, P] alone: a restart is a real position whose previous
    answer is -1 (or which is a read's first) and whose window is k ACGT
    chars; it hits where its answer is >= 0."""
    codes, answers = codes.long(), answers.long()
    B, P = answers.shape
    n_pos = (lengths.long() - k + 1).clamp(0, P)
    real = torch.arange(P, device=codes.device)[None, :] < n_pos[:, None]
    base = ((codes >= 0) & (codes < 4)).long()
    ends = torch.cat([torch.zeros_like(base[:, :1]), base.cumsum(dim=1)], dim=1)
    window_ok = (ends[:, k:] - ends[:, :P]) == k
    prev_dead = torch.cat([torch.ones_like(real[:, :1]), answers[:, :-1] < 0], dim=1)
    restart = real & prev_dead & window_ok
    return int(n_pos.sum()), int(restart.sum()), int((restart & (answers >= 0)).sum())


def string_answers(oracle, codes, lengths):
    """Streaming answers of tests/oracle.py's index: the colex rank of each
    window's k-mer, or -1. Position 0 and every position after a read's
    first -1 are full searches (ACGT only); between them an extension takes
    lowercase as its base; N ends every window that holds it."""
    k = oracle.k
    col = {x: i for i, x in enumerate(oracle.nodes) if len(x) == k}
    codes, lengths = codes.cpu().numpy(), lengths.cpu().numpy()
    out = np.full((len(codes), codes.shape[1] - k + 1), -1, np.int64)
    for b, row in enumerate(codes):
        lenient = True
        for i in range(max(0, min(out.shape[1], int(lengths[b]) - k + 1))):
            w = row[i : i + k]
            ok = (w >= 0).all() if lenient and i > 0 else ((w >= 0) & (w < 4)).all()
            out[b, i] = col.get("".join("ACGT"[c & 3] for c in w), -1) if ok else -1
            lenient &= out[b, i] >= 0
    return torch.from_numpy(out)


def work_reads(g, rng, B, L, k):
    """B reads of L codes from the sequence g and a numpy generator:
    forward genomic, reverse-complement genomic (absent from a one-strand
    index: a restart at every position), genomic with substitutions,
    random, lowercase and N spikes, and lengths of L, below L and below k.
    Returns (codes int8 [B, L], lengths int32 [B]) on the CPU."""
    enc = encode_query(g)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    for i in range(B):
        s = int(rng.integers(0, len(enc) - L))
        if i % 4 == 0:
            codes[i] = enc[s : s + L]
        elif i % 4 == 1:
            codes[i] = 3 - enc[s : s + L][::-1]
        elif i % 4 == 2:
            codes[i] = enc[s : s + L]
            hit = rng.random(L) < 0.05
            codes[i, hit] = (codes[i, hit] + 1) % 4
    codes[3::5, rng.integers(0, L, size=len(codes[3::5]))] = -1
    codes[6::9, : min(L, 7)] |= 4
    lengths = np.full(B, L, np.int32)
    lengths[::7] = rng.integers(0, L + 1, size=len(lengths[::7]))
    lengths[5::11] = rng.integers(0, k, size=len(lengths[5::11]))
    return torch.from_numpy(codes), torch.from_numpy(lengths)
