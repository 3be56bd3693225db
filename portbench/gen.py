"""Generators of the indexed sequences and of the traffic, on the device,
from the run's seed.

One general generator reads every traffic mix's parameters; a new mix is a
new file under portbench/traffic/, never new code here. The read sampler's
idea (windows of the genome at uniform starts, a fixed number of rows, drawn
without replacement, replaced by uniform random sequence) is that of
bench.py ``sample_read_codes_device`` and chip_smoke.py ``sample_reads``,
rewritten here in PyTorch with strains, strands and substitution errors, so
that later changes to those files do not move the yardstick.

Every seed gives the same sizes and the same counts (reads a batch, reads
from the genomes, read lengths drawn from the same range); the seed moves
only which positions, strands, bases and errors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# streams of one seed, so that a change to one draw leaves the others alone
_GENOME, _READS = 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` for one stream of ``seed`` (any int)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63))
    return g


def reverse_complement(codes: torch.Tensor) -> torch.Tensor:
    """The reverse complement of ACGT codes 0..3 along the last axis."""
    return (3 - codes.flip(-1)).to(codes.dtype)


def substitute(codes: torch.Tensor, rate: float, g: torch.Generator) -> torch.Tensor:
    """Each code replaced, with odds ``rate``, by one of the three others."""
    hit = torch.rand(codes.shape, generator=g, device=codes.device) < rate
    shift = torch.randint(1, 4, codes.shape, generator=g, device=codes.device, dtype=codes.dtype)
    return torch.where(hit, (codes + shift) % 4, codes).to(codes.dtype)


def genome(params: dict, seed: int, device):
    """(strains int8 [S, G], indexed sequences): a base of G uniform random
    bases and S strains of it at independent substitutions; the indexed
    sequences are the strains and, with ``add_reverse_complements``, their
    reverse complements (the reference CLI's --add-reverse-complements)."""
    g = generator(seed, _GENOME, device)
    G, S = int(params["base_bases"]), int(params["strains"])
    base = torch.randint(0, 4, (G,), generator=g, device=device, dtype=torch.int8)
    strains = substitute(base.expand(S, G), float(params["strain_substitution_rate"]), g)
    seqs = list(strains)
    if params.get("add_reverse_complements", False):
        seqs += list(reverse_complement(strains))
    return strains, seqs


@dataclass
class Batch:
    codes: torch.Tensor    # int8 [B, L], -1 past each read's end
    lengths: torch.Tensor  # int32 [B]
    bases: int             # real bases in the batch
    answers: int           # real k-mer answers: sum of max(0, length - k + 1)


def read_batch(mix: dict, strains: torch.Tensor, k: int, g: torch.Generator) -> Batch:
    """One batch of ``mix``: ``batch_reads`` reads with lengths uniform in
    ``read_length`` [lo, hi], padded to a multiple of ``pad_quantum``;
    round(``source_share`` x B) of them from uniform positions of uniform
    strains, on the reverse strand with odds ``reverse_strand_share``, the
    rest uniform random (foreign) sequence; then substitution errors at
    ``substitution_rate`` on every read, in an order drawn from the seed."""
    dev = strains.device
    B = int(mix["batch_reads"])
    lo, hi = (int(x) for x in mix["read_length"])
    q = int(mix["pad_quantum"])
    L = -(-hi // q) * q
    S, G = strains.shape
    if hi > G:
        raise ValueError(f"reads of {hi} bases from strains of {G}")
    lengths = torch.randint(lo, hi + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    n_src = round(float(mix["source_share"]) * B)
    # source reads: a window of hi bases, cut to the read's length below
    strain = torch.randint(0, S, (B,), generator=g, device=dev)
    start = torch.randint(0, G - hi + 1, (B,), generator=g, device=dev)
    win = strains[strain[:, None], start[:, None] + torch.arange(hi, device=dev)]
    rev = torch.rand(B, generator=g, device=dev) < float(mix["reverse_strand_share"])
    # the reverse strand of the window's first `length` bases
    idx = (lengths.long()[:, None] - 1 - torch.arange(hi, device=dev)).clamp(min=0)
    win = torch.where(rev[:, None], 3 - win.gather(1, idx), win).to(torch.int8)
    foreign = torch.randint(0, 4, (B, hi), generator=g, device=dev, dtype=torch.int8)
    is_src = torch.zeros(B, dtype=torch.bool, device=dev)
    is_src[torch.randperm(B, generator=g, device=dev)[:n_src]] = True
    reads = substitute(torch.where(is_src[:, None], win, foreign),
                       float(mix["substitution_rate"]), g)
    codes = torch.full((B, L), -1, dtype=torch.int8, device=dev)
    inside = torch.arange(hi, device=dev)[None, :] < lengths.long()[:, None]
    codes[:, :hi] = torch.where(inside, reads, -1)
    bases = int(lengths.long().sum())
    answers = int((lengths.long() - k + 1).clamp(min=0).sum())
    return Batch(codes, lengths, bases, answers)


def read_pool(mix: dict, strains: torch.Tensor, k: int, seed: int) -> list[Batch]:
    """The ``pool_batches`` distinct batches that the window cycles through."""
    g = generator(seed, _READS, strains.device)
    return [read_batch(mix, strains, k, g) for _ in range(int(mix["pool_batches"]))]
