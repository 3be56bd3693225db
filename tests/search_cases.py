"""Inputs of the k-mer search and partial search cases, made from numpy
seeds: the CPU tests hold the port's plain versions to the JAX package and
the oracle on them (test_torch_search.py), and the card tests send the same
inputs through the kernels (test_torch_cuda.py). Imports neither JAX nor
the JAX package.
"""
import numpy as np

from sbwt_tpu_torch.utils.dna import encode_query

K = 14
GENOME_BP = 1500
# a lane alone, a warp short of 32, one past a warp, one past a pool of 64
BATCHES = (1, 31, 33, 65)
SHORT_L, LONG_L = 40, 1000


def genome() -> str:
    rng = np.random.default_rng(43)
    return "".join(rng.choice(list("ACGT"), size=GENOME_BP))


def _genomic(enc, rng, n, L):
    """n rows of L chars read along the genome, wrapping at its end."""
    starts = rng.integers(0, len(enc), size=n)
    return enc[(starts[:, None] + np.arange(L)) % len(enc)].astype(np.int8)


def kmer_rows(g: str, B: int, seed: int) -> np.ndarray:
    """[B, K] k-mers: present and absent ones, all-lowercase, one lowercase
    char, one N (-1)."""
    rng = np.random.default_rng(seed)
    enc = encode_query(g)
    rows = np.where((np.arange(B) % 3 == 1)[:, None],
                    rng.integers(0, 4, size=(B, K)).astype(np.int8), _genomic(enc, rng, B, K))
    rows[4::9] |= 4
    rows[np.arange(5, B, 9), rng.integers(0, K, size=len(range(5, B, 9)))] |= 4
    rows[np.arange(7, B, 9), rng.integers(0, K, size=len(range(7, B, 9)))] = -1
    return rows


def partial_rows(g: str, B: int, L: int, seed: int):
    """[B, L] rows and lengths [B] for partial search: genomic rows (whose
    match runs on past k), random rows, lowercase stretches and N; lengths
    0, 1, L, past L, negative and random."""
    rng = np.random.default_rng(seed)
    enc = encode_query(g)
    codes = _genomic(enc, rng, B, L)
    codes[2::5] = rng.integers(0, 4, size=(len(codes[2::5]), L))
    codes[1::4, L // 3:] |= 4
    for i in range(3, B, 6):
        codes[i, int(rng.integers(0, L))] = -1
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    for i, n in zip(range(0, B, 7), (0, 1, L, L + 5, -2, L, 1, 0, L, L)):
        lengths[i] = n
    lengths[B - 1] = L
    return codes, lengths


def kmer_cases(g: str) -> dict:
    """name -> k-mer rows, one case a batch size."""
    return {f"B{B}": kmer_rows(g, B, 100 + B) for B in BATCHES}


def partial_cases(g: str) -> dict:
    """name -> (codes, lengths): each batch size at L = 40, and rows of
    L = 1000 (a pool and one lane past it)."""
    out = {f"B{B}_L{SHORT_L}": partial_rows(g, B, SHORT_L, 200 + B) for B in BATCHES}
    out[f"B65_L{LONG_L}"] = partial_rows(g, 65, LONG_L, 300)
    return out


def start_intervals(l, r, n_nodes: int, seed: int):
    """Start intervals [B, 2] from the intervals (l, r) that a partial search
    of a row's first chars reached: each lane's own, its left bound alone as
    a singleton, or the full interval (0, n - 1), in turns."""
    l, r = np.asarray(l, np.int64), np.asarray(r, np.int64)
    pick = np.random.default_rng(seed).integers(0, 3, size=len(l))
    sl = np.where(pick == 2, 0, l)
    sr = np.where(pick == 0, r, np.where(pick == 1, l, n_nodes - 1))
    return np.stack([sl, sr], axis=1)
