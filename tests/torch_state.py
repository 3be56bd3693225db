"""JAX index state as numpy, for carrying it into sbwt_tpu_torch, and the
numpy-seeded read corpora the port's tests share.

Importing it limits torch to one thread: the tests run in several worker
processes at once, and a torch thread pool in each of them oversubscribes
the cores (one CLI test took 190 s in each of four concurrent workers with
the default pool, 42 s with one thread).
"""
import functools

import numpy as np
import torch

from sbwt_tpu.utils.dna import encode_query

torch.set_num_threads(1)


def matrix_state(di) -> dict:
    """The fields of a JAX MatrixIndex as numpy arrays, with its metadata."""
    state = {f: np.asarray(getattr(di, f)) for f in ("rank_tbl", "sgs_tbl", "C", "precalc")}
    state.update({f: getattr(di, f) for f in (
        "n_nodes", "n_kmers", "k", "precalc_k", "n_words", "has_streaming")})
    return state


def turbo_state(jt) -> dict:
    """The fields of a JAX TurboIndex as numpy arrays, with its metadata."""
    state = {f: np.asarray(getattr(jt, f)) for f in ("tbl", "precalc", "C")}
    state["seed_bits"] = None if jt.seed_bits is None else np.asarray(jt.seed_bits)
    state.update({f: getattr(jt, f) for f in ("n_nodes", "k", "precalc_k", "arity")})
    return state


def bv_from_jax(jbv, device="cpu"):
    """The port's bit vector from a JAX PlainBV / RRRBV / MEFBV payload."""
    from sbwt_tpu_torch.ops.bv import BV_CLASSES

    kind = {"PlainBV": "plain", "RRRBV": "rrr", "MEFBV": "mef"}[type(jbv).__name__]
    return BV_CLASSES[kind].from_payload(jbv.payload(), device)


def wavelet_from_jax(jwt, device="cpu"):
    """The port's wavelet tree from a JAX WaveletTree payload."""
    from sbwt_tpu_torch.ops.wavelet import WaveletTree

    return WaveletTree.from_payload(jwt.payload(), jwt.bv_kind, device)


def generic_from_jax(jgi, device="cpu"):
    """The port's GenericIndex from a JAX GenericIndex: its structure from
    the structure's payload, the shared state from its numpy fields."""
    import torch

    from sbwt_tpu_torch.models.subsetrank import struct_from_payload
    from sbwt_tpu_torch.models.variants import GenericIndex

    def t(name):
        return torch.as_tensor(np.array(getattr(jgi, name), dtype=np.int32), device=device)

    return GenericIndex(
        struct_from_payload(jgi.variant, jgi.struct.payload(), device), t("sgs_tbl"), t("C"),
        t("precalc"), variant=jgi.variant, n_nodes=jgi.n_nodes, n_kmers=jgi.n_kmers, k=jgi.k,
        precalc_k=jgi.precalc_k, has_streaming=jgi.has_streaming,
    )


def _genomic(enc, rng, n, L):
    starts = rng.integers(0, len(enc) - L, size=n)
    return enc[starts[:, None] + np.arange(L)]


def _full(codes):
    return codes, np.full(len(codes), codes.shape[1], dtype=np.int32)


def main_corpora(g, k, rng, L=40, n=96):
    enc = encode_query(g)
    all_hit = _genomic(enc, rng, n, L)
    all_miss = rng.integers(0, 4, size=(n, L)).astype(np.int8)
    # alternating genomic and random stretches inside each read
    alt = _genomic(enc, rng, n, L)
    for i in range(n):
        for s in range(int(rng.integers(3, 12)), L, 24):
            e = s + int(rng.integers(1, 4))
            alt[i, s:e] = (alt[i, s:e] + int(rng.integers(1, 4))) % 4
    # lowercase spans and N: extension accepts lowercase only until the
    # first -1 (the chain), restarts reject it
    low = _genomic(enc, rng, n, L)
    low[0::4, 10:15] |= 4
    low[1::4, 5] = -1
    low[1::4, 5 + k + 3] |= 4  # lowercase after a restart: the quirk
    low[2::4, :] |= 4
    low[3::4, int(rng.integers(0, L))] = -1
    low[3::4, 25:] |= 4
    # padded reads: -1 past a short length, some shorter than k
    pad = np.concatenate([_genomic(enc, rng, n // 2, L),
                          rng.integers(0, 4, size=(n - n // 2, L)).astype(np.int8)])
    plen = rng.integers(0, L + 1, size=n).astype(np.int32)
    plen[:4] = [0, k - 1, k, L]
    for i, ln in enumerate(plen):
        pad[i, ln:] = -1
    return {"all_hit": _full(all_hit), "all_miss": _full(all_miss), "alternating": _full(alt),
            "lowercase_n": _full(low), "padded": (pad, plen)}


def chimeric_corpora(enc, k, rng, L, n=96):
    """Genomic, chimeric (random prefix, genomic suffix: restarts must
    resolve real k-mers) and random reads."""
    gen = _genomic(enc, rng, n, L)
    chim = rng.integers(0, 4, size=(n, L)).astype(np.int8)
    src = _genomic(enc, rng, n, L)
    for i in range(n):
        cut = int(rng.integers(1, L - k))
        chim[i, cut:] = src[i, : L - cut]
    rand = rng.integers(0, 4, size=(n, L)).astype(np.int8)
    return {"genomic": _full(gen), "chimeric": _full(chim), "random": _full(rand)}


@functools.lru_cache(maxsize=None)
def search_answer_sets() -> dict:
    """The JAX package's answers to the inputs of tests/search_cases.py,
    computed once a process with one JAX call for each kind of case over
    all cases at once (no engine compiled per case). Keys: "state" (the
    index at p = 0 as numpy state), "kmer" {p: {case: answers}} for p = 0
    and 4 with "state4", "partial" {case: (l, r, matched)}, and "start"
    {case: (start [B, 2], l, r, alive)}: update_interval from start
    intervals over each row's chars after its first three, cut at its
    length by -1s."""
    import jax.numpy as jnp
    from jax import jit

    import search_cases as sc
    from sbwt_tpu.models.matrix import with_precalc
    from sbwt_tpu.models.sbwt import SBWT
    from sbwt_tpu.ops.search import partial_search_batch, search_jit, update_interval_jit

    g = sc.genome()
    js = SBWT.build([g], sc.K, precalc_k=0)
    di0 = js.device_index
    di4 = with_precalc(di0, 4)
    out = {"state": matrix_state(di0), "state4": matrix_state(di4), "kmer": {}, "partial": {},
           "start": {}}
    kcases = sc.kmer_cases(g)
    rows = np.concatenate(list(kcases.values()))
    for p, di in ((0, di0), (4, di4)):
        ans = np.asarray(search_jit(di, jnp.asarray(rows)))
        out["kmer"][p] = _split(kcases, ans)
    # every partial case padded to the longest rows with -1s
    pcases = sc.partial_cases(g)
    codes = np.concatenate([np.pad(c, ((0, 0), (0, sc.LONG_L - c.shape[1])), constant_values=-1)
                            for c, _ in pcases.values()])
    lengths = np.concatenate([n for _, n in pcases.values()])
    res = [np.asarray(a) for a in jit(partial_search_batch)(di0, jnp.asarray(codes),
                                                            jnp.asarray(lengths))]
    for name, part in _split(pcases, np.stack(res, axis=1)).items():
        out["partial"][name] = tuple(part.T)
    # from start intervals: the head's intervals, as they are, as singletons or full
    head = [np.asarray(a) for a in jit(partial_search_batch)(
        di0, jnp.asarray(codes[:, :3]), jnp.asarray(np.clip(lengths, 0, 3)))]
    start = sc.start_intervals(head[0], head[1], di0.n_nodes, 7)
    tail = np.where(np.arange(3, sc.LONG_L)[None, :] < lengths[:, None], codes[:, 3:], -1)
    res = [np.asarray(a) for a in update_interval_jit(
        di0, jnp.asarray(tail.astype(np.int8)), jnp.asarray(start[:, 0].astype(np.int32)),
        jnp.asarray(start[:, 1].astype(np.int32)))]
    for name, part in _split(pcases, np.concatenate([start, np.stack(res, axis=1)], axis=1)).items():
        out["start"][name] = (part[:, :2], part[:, 2], part[:, 3], part[:, 4].astype(bool))
    return out


def _split(cases: dict, rows: np.ndarray) -> dict:
    """The rows of a concatenation of the cases, back by case."""
    out, at = {}, 0
    for name, case in cases.items():
        n = len(case[0] if isinstance(case, tuple) else case)
        out[name] = rows[at:at + n]
        at += n
    return out


# ConcatRank indexes of the one-walk rank_pair tests: (columns, density of
# the [4, n] bits). Sparse columns are mostly empty sets (one '$' each); the
# dense one has every set of 4 symbols (F1, where the JAX answer is wrong).
CONCAT_CASES = {"random": (700, 0.45), "sparse": (900, 0.04), "dense": (256, 1.0)}


def concat_case_bits(case: str) -> np.ndarray:
    n, density = CONCAT_CASES[case]
    return np.random.default_rng(n).random((4, n)) < density


@functools.lru_cache(maxsize=None)
def concat_rank_pair_answers(case: str, wt_kind: str):
    """The JAX ConcatRank's rank_pair at every (char, column) of a case,
    char-major, as two numpy arrays: one JAX program a case and tree kind."""
    import jax
    import jax.numpy as jnp

    from sbwt_tpu.models.subsetrank import build_struct

    bits = concat_case_bits(case)
    n = bits.shape[1]
    jst = build_struct("plain-concat" if wt_kind == "plain" else "mef-concat", bits)
    c = np.repeat(np.arange(4, dtype=np.int32), n)
    pos = np.tile(np.arange(n, dtype=np.int32), 4)
    r1, r2 = jax.jit(jst.rank_pair)(jnp.asarray(c), jnp.asarray(pos))
    return np.asarray(r1), np.asarray(r2)


@functools.lru_cache(maxsize=None)
def subsetwt_rank_answers(case: str, kind: str):
    """The JAX SubsetWTRank's rank at every (char, position 0..n) and
    rank_pair at every (char, column), char-major, of a case of
    tests/subsetwt_cases.py: (rank, rank_pair first, rank_pair second) as
    numpy arrays, one JAX program a case and bit-vector kind."""
    import jax
    import jax.numpy as jnp

    from sbwt_tpu.models.subsetrank import build_struct
    from subsetwt_cases import case_bits

    bits = case_bits(case)
    n = bits.shape[1]
    jst = build_struct(f"{kind}-subsetwt", bits)
    c = np.repeat(np.arange(4, dtype=np.int32), n + 1)
    pos = np.tile(np.arange(n + 1, dtype=np.int32), 4)
    prog = jax.jit(lambda c, pos: (jst.rank(c, pos), *jst.rank_pair(c, jnp.minimum(pos, n - 1))))
    r, r1, r2 = (np.asarray(a) for a in prog(jnp.asarray(c), jnp.asarray(pos)))
    return r, r1[pos < n], r2[pos < n]


@functools.lru_cache(maxsize=None)
def split_rank_answers(case: str, x_kind: str):
    """The JAX SplitRank's rank at every (char, position 0..n) and rank_pair
    at every (char, column), char-major, of a case of
    tests/subsetwt_cases.py SPLIT_CASES: (rank, rank_pair first, rank_pair
    second) as numpy arrays, one JAX program a case and X kind."""
    import jax
    import jax.numpy as jnp

    from sbwt_tpu.models.subsetrank import build_struct
    from subsetwt_cases import case_bits

    bits = case_bits(case)
    n = bits.shape[1]
    jst = build_struct(f"{x_kind}-split", bits)
    c = np.repeat(np.arange(4, dtype=np.int32), n + 1)
    pos = np.tile(np.arange(n + 1, dtype=np.int32), 4)
    prog = jax.jit(lambda c, pos: (jst.rank(c, pos), *jst.rank_pair(c, jnp.minimum(pos, n - 1))))
    r, r1, r2 = (np.asarray(a) for a in prog(jnp.asarray(c), jnp.asarray(pos)))
    return r, r1[pos < n], r2[pos < n]
