"""Plain reference of the SBWT's k-mer answers, worked out from the sequences alone.

The answer to a k-mer is its column in the SBWT of the indexed sequences, or
-1 where the k-mer is not indexed or holds a character other than ACGT.
The SBWT's columns are its nodes in colex order: every distinct k-mer of the
sequences, and the dummy nodes, the prefixes $^(k-l) x[0:l] (l = 0 .. k-1)
of each source k-mer x, one whose (k-1)-prefix is no k-mer's (k-1)-suffix
(Alanko, Puglisi, Vuohtoniemi, "Small Searchable k-Spectra via Subset Rank
Queries on the Spectral Burrows-Wheeler Transform", 2023, section 3), and
the root $^k.

A string is keyed by the integer sum_j c_j 4^j over its chars (A, C, G, T =
0..3, $ taken as 0), so its last char is the most significant and integer
order is colex order. Two nodes with one key differ only in how many of the
first chars are $, and the one with more $ comes first. A k-mer has no $, so
its column is the number of k-mers with a smaller key plus the number of
dummy nodes whose key is at most its own.

Plain PyTorch on any device. It imports nothing of the program under test
and takes none of its tables: the sorted k-mers, the sources and the
dummies are worked out here again. It holds every distinct k-mer at once
(about 40 B of device memory a base while it is built), so the check uses
``buckets.py``, which gives the same answers in bounded memory, and so
does the control; this whole table is the tests' oracle.
"""
from __future__ import annotations

import torch

# (B, P) key blocks of this many rows at a time bound the reference's memory
ROW_BLOCK = 1 << 18


def window_keys(codes: torch.Tensor, k: int):
    """Keys int64 [..., P] of every length-k window of codes [..., L] (P = L
    - k + 1), and bool [..., P]: the window holds only codes 0..3."""
    if not 1 <= k <= 31:
        raise ValueError("keys of 2k bits need k <= 31")
    P = codes.shape[-1] - k + 1
    c = codes.long()
    good = (c >= 0) & (c < 4)
    c = torch.where(good, c, 0)
    keys = torch.zeros(codes.shape[:-1] + (P,), dtype=torch.long, device=codes.device)
    bad = torch.zeros(keys.shape, dtype=torch.int32, device=codes.device)
    for j in range(k):
        keys |= c[..., j : j + P] << (2 * j)
        bad += (~good[..., j : j + P]).int()
    return keys, bad == 0


class ReferenceIndex:
    """The SBWT's node keys of a list of sequences (1-D code tensors, ACGT =
    0..3, any other code breaks a sequence), at k <= 31."""

    def __init__(self, seqs, k: int):
        self.k = k
        keys = []
        for s in seqs:
            if s.shape[0] >= k:
                kk, ok = window_keys(s, k)
                keys.append(kk[ok])
        self.kmers = torch.unique(torch.cat(keys))  # sorted, distinct
        dev = self.kmers.device
        # a k-mer is a source when its (k-1)-prefix is no k-mer's (k-1)-suffix
        suffixes = torch.unique(self.kmers >> 2)
        prefixes = self.kmers & ((1 << (2 * (k - 1))) - 1)
        at = torch.searchsorted(suffixes, prefixes).clamp(max=suffixes.shape[0] - 1)
        sources = self.kmers[suffixes[at] != prefixes]
        d_keys = [torch.zeros(1, dtype=torch.long, device=dev)]  # the root $^k
        d_lens = [torch.zeros(1, dtype=torch.long, device=dev)]
        for l in range(k):
            d_keys.append((sources & ((1 << (2 * l)) - 1)) << (2 * (k - l)))
            d_lens.append(torch.full_like(sources, l))
        dummies = torch.unique(torch.stack([torch.cat(d_keys), torch.cat(d_lens)], dim=1), dim=0)
        self.dummy_keys = dummies[:, 0].contiguous()  # sorted, one per dummy node
        self.n_sources = int(sources.shape[0])
        self.n_nodes = int(self.kmers.shape[0] + self.dummy_keys.shape[0])

    def columns(self, keys: torch.Tensor, key_bits: int | None = None) -> torch.Tensor:
        """Column int64 of each k-mer key, -1 where it is not indexed. With
        ``key_bits``, keys are compared by their top ``key_bits`` bits of
        2k (their last key_bits / 2 chars) only, and a key answers the first
        k-mer that shares them: the control's lower precision."""
        kmers = self.kmers
        q = keys
        if key_bits is not None:
            drop = 2 * self.k - key_bits
            kmers, q = kmers >> drop, keys >> drop
        at = torch.searchsorted(kmers, q).clamp(max=kmers.shape[0] - 1)
        hit = kmers[at] == q
        col = at + torch.searchsorted(self.dummy_keys, self.kmers[at], right=True)
        return torch.where(hit, col, -1)

    def streaming_answers(self, codes: torch.Tensor, lengths: torch.Tensor,
                          key_bits: int | None = None) -> torch.Tensor:
        """int64 [B, L - k + 1]: the answer of every k-mer of each read codes
        [B, L] (padded with -1) of length lengths [B]; -1 past a read's end."""
        B, L = codes.shape
        if L < self.k:
            raise ValueError(f"read length {L} < k = {self.k}")
        P = L - self.k + 1
        out = torch.empty((B, P), dtype=torch.long, device=codes.device)
        pos = torch.arange(P, device=codes.device)
        for s in range(0, B, ROW_BLOCK):
            c = codes[s : s + ROW_BLOCK]
            keys, ok = window_keys(c, self.k)
            ok &= pos[None, :] <= (lengths[s : s + ROW_BLOCK].long()[:, None] - self.k)
            cols = self.columns(keys.reshape(-1), key_bits).view(keys.shape)
            out[s : s + ROW_BLOCK] = torch.where(ok, cols, -1)
        return out

