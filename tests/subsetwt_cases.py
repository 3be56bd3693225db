"""Bit patterns [4, n] for the tests of SubsetWTRank's device forms (numpy
only, so that the card tests take the same). Every n is off a multiple of
15, 32 and 240, so that the vectors end inside an RRR block, a plain word
and a superblock.

* unary: one char a column, with 0.5% empty columns, 0.5% with an A/C and
  a G/T char, 0.25% with all four: the few empty and two-sided columns of
  a genome's graph, so the sparse vectors are small;
* sets_1_4: sets of one char, of all four and empty ones, a sixth each;
* random: each char at 0.45;
* sparse: each char at 0.04 (most columns empty);
* dense: every set of four.

SPLIT_CASES adds, for SplitRank, all_unary: one char a column, so that Z
is empty (n_b = 0) and Y holds every column, 19 rows of 64 exactly.
"""
import numpy as np

CASES = {"unary": 2003, "sets_1_4": 1999, "random": 4093, "sparse": 901, "dense": 257}
SPLIT_CASES = {**CASES, "all_unary": 1216}


def case_bits(case: str) -> np.ndarray:
    n = SPLIT_CASES[case]
    rng = np.random.default_rng(n)
    bits = np.zeros((4, n), dtype=bool)
    if case == "all_unary":
        bits[rng.integers(0, 4, size=n), np.arange(n)] = True
    elif case == "unary":
        bits[rng.integers(0, 4, size=n), np.arange(n)] = True
        u = rng.random(n)
        bits[:, u < 0.005] = False
        two = np.flatnonzero((u >= 0.005) & (u < 0.01))
        bits[:, two] = False
        bits[rng.integers(0, 2, size=len(two)), two] = True
        bits[rng.integers(2, 4, size=len(two)), two] = True
        bits[:, (u >= 0.01) & (u < 0.0125)] = True
    elif case == "sets_1_4":
        kind = rng.integers(0, 6, size=n)  # 0-3 one char, 4 all four, 5 empty
        bits[kind[kind < 4], np.flatnonzero(kind < 4)] = True
        bits[:, kind == 4] = True
    elif case in ("random", "sparse"):
        bits = rng.random((4, n)) < (0.45 if case == "random" else 0.04)
    else:
        bits[:] = True
    return bits


def edge_positions(n: int) -> np.ndarray:
    """Positions in [0, n) at and beside the edges of plain words (32), RRR
    blocks (15) and superblocks (240)."""
    at = np.concatenate([np.arange(0, n, m) for m in (15, 32, 240)])
    return np.unique(np.clip(np.concatenate([at - 1, at, at + 1, [0, n - 1]]), 0, n - 1))
