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

A configuration's ``genome`` keys choose one of two shapes of the indexed
sequences; every strain of either has the same length, so that reads are
windows of a strain matrix [S, G].

- **Strains of one base** (``base_bases`` G, ``strains`` S,
  ``strain_substitution_rate``, ``add_reverse_complements``): a base of G
  uniform random bases and S copies of it at independent substitutions of
  one base. All S x G draws are made at once, so its temporaries are
  O(S x G): a shape for a few strains.
- **A pangenome** (``core_bases`` C, ``strains`` S,
  ``strain_substitution_rate``, ``accessory_pool_blocks`` M,
  ``accessory_block_bases`` b, ``accessory_blocks_per_strain`` A,
  ``accessory_hotspots`` H, ``accessory_zipf_exponent`` s,
  ``add_reverse_complements``): a core of C uniform random bases that every
  strain carries, and a pool of M accessory blocks of b uniform random
  bases each (gene content that strains do not all share), both fixed by
  the seed. Each strain holds A distinct blocks of the pool, drawn without
  replacement with weights proportional to rank^-s (rank 1..M, the pool's
  order; torch.multinomial's successive draws), in H hotspots at evenly
  spaced points of the core, A // H or A // H + 1 blocks to a hotspot, in
  the order drawn. The whole strain (core and blocks, C + A x b bases) then
  takes independent substitutions at the strain rate. Strains are made one
  at a time, so the temporaries are O(C + A x b) besides the pool; the
  output is S x (C + A x b) bytes, twice that with reverse complements.
  Needs 1 <= H <= A <= M <= 2^24.
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
    """(strains int8 [S, G], indexed sequences) of either shape (above): the
    indexed sequences are the strains and, with ``add_reverse_complements``,
    their reverse complements (the reference CLI's
    --add-reverse-complements)."""
    if "core_bases" in params:
        return pangenome(params, seed, device)
    g = generator(seed, _GENOME, device)
    G, S = int(params["base_bases"]), int(params["strains"])
    base = torch.randint(0, 4, (G,), generator=g, device=device, dtype=torch.int8)
    strains = substitute(base.expand(S, G), float(params["strain_substitution_rate"]), g)
    seqs = list(strains)
    if params.get("add_reverse_complements", False):
        seqs += list(reverse_complement(strains))
    return strains, seqs


def pangenome(params: dict, seed: int, device):
    """(strains int8 [S, G], indexed sequences) of the pangenome shape, one
    strain at a time."""
    g = generator(seed, _GENOME, device)
    C, S = int(params["core_bases"]), int(params["strains"])
    M, b = int(params["accessory_pool_blocks"]), int(params["accessory_block_bases"])
    A, H = int(params["accessory_blocks_per_strain"]), int(params["accessory_hotspots"])
    if not 1 <= H <= A <= M <= 1 << 24:
        raise ValueError(f"need 1 <= hotspots {H} <= blocks a strain {A} <= pool {M} <= 2^24")
    rate = float(params["strain_substitution_rate"])
    source = torch.randint(0, 4, (C + M * b,), generator=g, device=device, dtype=torch.int8)
    weights = torch.arange(1, M + 1, device=device, dtype=torch.float64).pow(
        -float(params["accessory_zipf_exponent"]))
    # where each base of a strain comes from: core position, or block slot and offset
    spans, slots, at = [], [], 0
    for h in range(H):
        cut = (h + 1) * C // (H + 1)
        spans.append(torch.arange(at, cut, device=device))
        slots.append(torch.full((cut - at,), -1, device=device))
        n = (h + 1) * A // H - h * A // H
        off = torch.arange(n * b, device=device)
        spans.append(C + off % b)
        slots.append(h * A // H + off // b)
        at = cut
    spans.append(torch.arange(at, C, device=device))
    slots.append(torch.full((C - at,), -1, device=device))
    spans, slots = torch.cat(spans), torch.cat(slots)
    is_block, slots = slots >= 0, slots.clamp(min=0)
    G = C + A * b
    strains = torch.empty((S, G), dtype=torch.int8, device=device)
    rc = torch.empty_like(strains) if params.get("add_reverse_complements", False) else None
    for i in range(S):
        blocks = torch.multinomial(weights, A, replacement=False, generator=g)
        src = torch.where(is_block, spans + blocks[slots] * b, spans)
        strains[i] = substitute(source[src], rate, g)
        if rc is not None:
            rc[i] = reverse_complement(strains[i])
    seqs = list(strains) + ([] if rc is None else list(rc))
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
