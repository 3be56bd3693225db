"""Plain reference of the SBWT's k-mer answers, worked out bucket by bucket,
so that its device memory does not grow with the indexed bases.

The answers are those of ``sbwt_ref.ReferenceIndex`` (its docstring defines
the nodes and the keys): the column of a k-mer is the number of distinct
k-mers with a smaller key plus the number of dummy nodes whose key is at
most its own, and -1 where the k-mer is not indexed or holds a code other
than ACGT. Keys, counts and columns are int64.

**Buckets.** A key's last char is its most significant, so a range of
consecutive keys is a run of k-mers in colex order, led by their last
chars. The key space [0, 4^k) is cut into such ranges, the buckets, one
pass over the sequences each. A pass reads the sequences in chunks of at
most ``chunk_bases`` codes (sequences joined by a -1, a longer one cut with
k - 1 codes of overlap), deduplicates each chunk's keys that fall in the
bucket. Whenever the bucket's keys and those waiting pass ``max_keys``,
they are merged (sorted and deduplicated), and if more than ``max_keys`` //
2 remain, the bucket is cut short: it keeps the lowest ``max_keys`` // 2
and ends at the next key, which the next pass starts from. So no bucket
holds more than ``max_keys`` keys, however the keys are spread (a run of
one char cannot overflow one); each pass starts from the width at which the
last one would have held ``max_keys`` // 2 keys.
The number of buckets follows from ``max_keys``: one where every distinct
k-mer fits.

**Columns.** A bucket's k-mers have the columns of the buckets before it,
plus their rank in the bucket (a searchsorted), plus the dummies at or
below them. The queries' answers are written bucket by bucket, at the end
of each pass; the dummies are added once the last pass has found them.

**Sources** (k-mers whose (k-1)-prefix is no k-mer's (k-1)-suffix) are
among the first window of each run of ACGT codes in a chunk; the first pass
collects those candidates, and every pass looks up, in its bucket, the four
keys whose (k-1)-suffix is a candidate's (k-1)-prefix: they lie in other
buckets than the candidate. The dummies of the sources are found as in
``sbwt_ref``. Candidates, sources and dummies grow with the runs of ACGT
codes in the sequences (and the chunks), not with their bases.

**Memory beside the sequences and the queries' answers** (int64, 8 B a
key): a chunk's codes and its keys, about 5 x 8 B x ``chunk_bases`` while
they are worked out; the bucket (at most ``max_keys`` keys), the chunks'
distinct keys waiting to join it (at most ``max_keys`` + ``chunk_bases``),
and their union's sort, about 4 x 8 B x (``max_keys`` + ``chunk_bases``)
at once; a block of ``ROW_BLOCK`` query rows, about 5 x 8 B x its windows
(and with the control's ``key_bits``, the found k-mer's key beside each
answer, 8 B).
That is set by ``chunk_bases``, ``max_keys`` and ``ROW_BLOCK``, and not by
the indexed bases: 12.0 to 14.1 GB at the defaults on an H100 beside one
batch of 2^20 reads, 17.7 GB beside eight, on generated pangenomes of 2.1
to 36.8 Gbp. No tensor op takes more than ``max_keys`` +
``chunk_bases`` < 2^31 elements.

Plain PyTorch on any device. It imports nothing of the program under test
and takes none of its tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

CHUNK_BASES = 1 << 27
MAX_KEYS = 1 << 28
# (B, P) key blocks of this many query rows at a time
ROW_BLOCK = 1 << 18


def window_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Keys int64 [..., L - k + 1] of every length-k window of codes [..., L],
    -1 where a window holds a code other than 0..3. The key of a window is
    put together from those of windows of 1, 2, 4, ... chars, so it takes
    about log2(k) passes over the codes."""
    if not 1 <= k <= 31:
        raise ValueError("keys of 2k bits need k <= 31")
    L = codes.shape[-1]
    good = (codes >= 0) & (codes < 4)
    bad = torch.cumsum((~good).int(), -1, dtype=torch.int32)
    bad = torch.cat([torch.zeros_like(bad[..., :1]), bad], -1)
    window_bad = bad[..., k:] - bad[..., : L - k + 1]
    del bad
    # part[..., i]: the key of chars i .. i + width - 1, built up in place
    part = codes.to(torch.int64, copy=True).masked_fill_(~good, 0)
    del good
    keys, got, width = None, 0, 1  # keys[..., i]: the key of chars i .. i + got - 1
    rest = k
    while True:
        if rest & 1:
            n = L - got - width + 1
            if keys is None:
                keys = part[..., :n].clone()
            else:
                keys = keys[..., :n]
                keys |= part[..., got : got + n] << (2 * got)
            got += width
        rest >>= 1
        if not rest:
            break
        n = part.shape[-1] - width
        shifted = part[..., width : width + n] << (2 * width)
        part = part[..., :n]
        part |= shifted
        del shifted
        width *= 2
    del part
    return keys.masked_fill_(window_bad != 0, -1)


def _chunk_plan(seqs, k: int, chunk_bases: int) -> list:
    """Chunks as lists of (sequence, start, end): pieces of at most
    chunk_bases - 1 codes, each followed by a -1, that hold every length-k
    window of ``seqs`` once (a sequence longer than a piece is cut with
    k - 1 codes of overlap)."""
    if chunk_bases <= k:
        raise ValueError(f"chunks of {chunk_bases} codes cannot hold a window of {k} and a -1")
    plan, chunk, used = [], [], 0
    for i, s in enumerate(seqs):
        n, start = int(s.shape[0]), 0
        while start + k <= n:
            end = min(n, start + chunk_bases - 1)
            if used + end - start + 1 > chunk_bases:
                plan.append(chunk)
                chunk, used = [], 0
            chunk.append((i, start, end))
            used += end - start + 1
            if end == n:
                break
            start = end - (k - 1)
    if chunk:
        plan.append(chunk)
    return plan


def _codes(seqs, chunk) -> torch.Tensor:
    parts = []
    for i, start, end in chunk:
        s = seqs[i]
        parts += [s[start:end], torch.full((1,), -1, dtype=s.dtype, device=s.device)]
    return torch.cat(parts)


@dataclass
class Answers:
    answers: list             # int64 [B, L - k + 1] of each query batch
    n_kmers: int = 0
    n_nodes: int = 0
    n_sources: int = 0
    buckets: list = field(default_factory=list)  # (first key, end key, distinct k-mers)


def _union(held: torch.Tensor, waiting: list) -> torch.Tensor:
    return torch.unique(torch.cat([held, *waiting])) if waiting else held


def _query_keys(codes: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """Keys of a block of reads, -1 at a window past its read's end."""
    keys = window_keys(codes, k)
    pos = torch.arange(keys.shape[-1], device=codes.device)
    return keys.masked_fill_(pos[None, :] > (lengths.long()[:, None] - k), -1)


def streaming_answers(seqs, k: int, batches, chunk_bases: int = CHUNK_BASES,
                      max_keys: int = MAX_KEYS, key_bits: int | None = None) -> Answers:
    """The answers int64 [B, L - k + 1] of every k-mer of each batch
    (codes [B, L] padded with -1, lengths [B]) against the SBWT of ``seqs``
    (1-D code tensors), -1 past a read's end; worked out in buckets of at
    most ``max_keys`` distinct keys, reading ``chunk_bases`` codes at a time.
    With ``key_bits``, a k-mer answers the first indexed k-mer whose top
    ``key_bits`` bits of 2k are its own: the control's lower precision, as
    ``sbwt_ref.ReferenceIndex.columns`` gives it."""
    if max_keys < 2 or max_keys + chunk_bases >= 1 << 31:
        raise ValueError("need 2 <= max_keys and max_keys + chunk_bases < 2^31")
    drop = None if key_bits is None else 2 * k - key_bits
    for codes, _ in batches:
        if codes.shape[1] < k:
            raise ValueError(f"read length {codes.shape[1]} < k = {k}")
    plan = _chunk_plan(seqs, k, chunk_bases)
    dev = seqs[0].device if seqs else batches[0][0].device
    out = Answers([torch.full((c.shape[0], c.shape[1] - k + 1), -1, dtype=torch.long,
                              device=c.device) for c, _ in batches])
    # with key_bits: the key of the k-mer each answer found, -1 while none
    found_keys = [] if drop is None else [torch.full_like(a, -1) for a in out.answers]
    space, keep = 1 << (2 * k), max_keys // 2
    prefix_mask = (1 << (2 * (k - 1))) - 1
    candidates, prefixes, found = [], None, None
    lo, width, before = 0, space, 0
    while lo < space:
        hi = min(space, lo + width)
        held, waiting, n_waiting = torch.empty(0, dtype=torch.long, device=dev), [], 0
        for chunk in plan:
            keys = window_keys(_codes(seqs, chunk), k)
            if not out.buckets:  # the first window of each run of ACGT codes
                ok = keys >= 0
                first = ok.clone()
                first[1:] &= ~ok[:-1]
                candidates.append(keys[first])
            mine = torch.unique(keys[(keys >= lo) & (keys < hi)])
            del keys
            waiting.append(mine)
            n_waiting += mine.shape[0]
            if held.shape[0] + n_waiting > max_keys:
                held, waiting, n_waiting = _union(held, waiting), [], 0
                if held.shape[0] > keep:  # the bucket ends at its first key past keep
                    hi = int(held[keep])
                    held = held[:keep].clone()
        held = _union(held, waiting)  # at most max_keys keys
        del waiting
        n = held.shape[0]
        if prefixes is None:
            candidates = torch.unique(torch.cat(candidates)) if candidates else held[:0]
            prefixes, of = torch.unique(candidates & prefix_mask, return_inverse=True)
            found = torch.zeros(prefixes.shape, dtype=torch.bool, device=dev)
        if n:
            # does a k-mer of this bucket have a candidate's (k-1)-prefix as its (k-1)-suffix
            lowest = prefixes << 2
            at = torch.searchsorted(held, lowest).clamp(max=n - 1)
            found |= (held[at] >= lowest) & (held[at] <= lowest | 3)
            for b, ((codes, lengths), ans) in enumerate(zip(batches, out.answers)):
                for s in range(0, codes.shape[0], ROW_BLOCK):
                    q = _query_keys(codes[s : s + ROW_BLOCK], lengths[s : s + ROW_BLOCK], k)
                    if drop is None:
                        mine = (q >= lo) & (q < hi)
                        q = q[mine]
                        at = torch.searchsorted(held, q).clamp(max=n - 1)
                        col = torch.where(held[at] == q, at + before, -1)
                        ans[s : s + ROW_BLOCK][mine] = col
                        continue
                    # the k-mers sharing q's top bits are the keys [first, end); the
                    # first of them may lie in a bucket after the one where they start
                    fk = found_keys[b][s : s + ROW_BLOCK]
                    first, end = (q >> drop) << drop, ((q >> drop) + 1) << drop
                    mine = (q >= 0) & (fk < 0) & (first < hi) & (end > lo)
                    first, end = first[mine].clamp(min=lo), end[mine]
                    at = torch.searchsorted(held, first)
                    key = held[at.clamp(max=n - 1)]
                    hit = (at < n) & (key < end)
                    ans[s : s + ROW_BLOCK][mine] = torch.where(hit, at + before, -1)
                    fk[mine] = torch.where(hit, key, -1)
        out.buckets.append((lo, hi, n))
        before += n
        width = (hi - lo) * keep // n if n else (hi - lo) * 4
        lo = hi
        del held
    # the dummy nodes of the sources, as in sbwt_ref.ReferenceIndex
    sources = candidates[~found[of]]
    d_keys = [torch.zeros(1, dtype=torch.long, device=dev)]  # the root $^k
    d_lens = [torch.zeros(1, dtype=torch.long, device=dev)]
    for l in range(k):
        d_keys.append((sources & ((1 << (2 * l)) - 1)) << (2 * (k - l)))
        d_lens.append(torch.full_like(sources, l))
    dummies = torch.unique(torch.stack([torch.cat(d_keys), torch.cat(d_lens)], dim=1), dim=0)
    dummy_keys = dummies[:, 0].contiguous()
    for b, ((codes, lengths), ans) in enumerate(zip(batches, out.answers)):
        for s in range(0, codes.shape[0], ROW_BLOCK):
            a = ans[s : s + ROW_BLOCK]
            hit = a >= 0
            if drop is None:
                q = _query_keys(codes[s : s + ROW_BLOCK], lengths[s : s + ROW_BLOCK], k)[hit]
            else:
                q = found_keys[b][s : s + ROW_BLOCK][hit]
            a[hit] += torch.searchsorted(dummy_keys, q, right=True)
    out.n_kmers, out.n_sources = before, int(sources.shape[0])
    out.n_nodes = before + int(dummy_keys.shape[0])
    return out
