"""Port parity: the precalc table (K1's plain version) and k-mer search.

The JAX package and the port run on the same index (carried over as numpy
state) and the same numpy-seeded k-mers; answers must be equal exactly and
must agree with the independent string oracle (tests/oracle.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import search_cases as sc
from oracle import OracleIndex
from sbwt_tpu.models.matrix import with_precalc as jax_with_precalc
from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.ops.search import forward_jit, search_jit, update_interval_jit
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.ops import search as ts
from torch_state import matrix_state, search_answer_sets

K = 14


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(41)
    return "".join(rng.choice(list("ACGT"), size=1500))


@pytest.fixture(scope="module")
def js(genome):
    return SBWT.build([genome], K, precalc_k=0)


@pytest.fixture(scope="module")
def oracle(genome):
    return OracleIndex([genome], K)


@pytest.mark.parametrize("p", [1, 4, 6])
def test_precalc_table_matches_jax(js, p):
    ref = np.asarray(jax_with_precalc(js.device_index, p).precalc)
    ti = tm.from_numpy_state(matrix_state(js.device_index), "cpu")
    tm.with_precalc(ti, p)
    assert ti.precalc_k == p
    assert ti.precalc.dtype == torch.int32
    np.testing.assert_array_equal(ti.precalc.numpy(), ref)
    # the kernel's plain version, called directly, gives the same table
    np.testing.assert_array_equal(tm.precalc_fill_plain(ti, p, chunk=64).numpy(), ref)


def test_precalc_limits(js):
    ti = tm.from_numpy_state(matrix_state(js.device_index), "cpu")
    with pytest.raises(ValueError, match="precalc_k > 13"):
        tm.with_precalc(ti, 14)
    small = SBWT.build(["ACGTTGCA"], 3)
    ts_small = tm.from_numpy_state(matrix_state(small.device_index), "cpu")
    with pytest.raises(ValueError, match="> k"):
        tm.with_precalc(ts_small, 4)
    tm.with_precalc(ti, 0)
    assert ti.precalc_k == 0 and tuple(ti.precalc.shape) == (1, 2)


def _kmer_batch(genome, rng):
    """Present, absent, lowercase and N-holding k-mers, as query codes."""
    enc = encode_query(genome)
    starts = rng.integers(0, len(genome) - K, size=200)
    present = enc[starts[:, None] + np.arange(K)]
    absent = rng.integers(0, 4, size=(200, K)).astype(np.int8)
    lower = present[:50] | 4
    one_lower = present[50:100].copy()
    one_lower[np.arange(50), rng.integers(0, K, 50)] |= 4
    with_n = present[100:150].copy()
    with_n[np.arange(50), rng.integers(0, K, 50)] = -1
    return np.concatenate([present, absent, lower, one_lower, with_n]).astype(np.int8)


@pytest.mark.parametrize("p", [0, 4])
def test_search_batch_matches_jax_and_oracle(js, oracle, genome, p):
    codes = _kmer_batch(genome, np.random.default_rng(7 + p))
    di = jax_with_precalc(js.device_index, p) if p else js.device_index
    ref = np.asarray(search_jit(di, jnp.asarray(codes)))
    ti = tm.from_numpy_state(matrix_state(di), "cpu")
    got = ts.search_batch(ti, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    assert (got[:200] >= 0).all() and (got[200 + 200 :] == -1).all()
    for row, a in zip(codes[:400:3], got[:400:3]):
        text = "".join("ACGT"[c] for c in row)
        assert a == oracle.search(text), text


def test_search_batch_rejects_wrong_k(js):
    ti = tm.from_numpy_state(matrix_state(js.device_index), "cpu")
    with pytest.raises(ValueError, match="query length"):
        ts.search_batch(ti, torch.zeros((2, K + 1), dtype=torch.int8))


def test_update_interval_and_forward_match_jax(js, genome):
    rng = np.random.default_rng(9)
    di = js.device_index
    ti = tm.from_numpy_state(matrix_state(di), "cpu")
    codes = _kmer_batch(genome, rng)[:, :6]  # lowercase extends here (toupper)
    n = di.n_nodes
    l0 = np.zeros(len(codes), np.int32)
    r0 = np.full(len(codes), n - 1, np.int32)
    rl, rr, ra = (np.asarray(a) for a in update_interval_jit(
        di, jnp.asarray(codes), jnp.asarray(l0), jnp.asarray(r0)))
    gl, gr, ga = ts.update_interval_batch(ti, torch.from_numpy(codes), torch.from_numpy(l0),
                                          torch.from_numpy(r0))
    np.testing.assert_array_equal(ga.numpy(), ra)
    np.testing.assert_array_equal(gl.numpy(), rl)
    np.testing.assert_array_equal(gr.numpy(), rr)

    nodes = rng.integers(0, n, size=500).astype(np.int32)
    chars = rng.integers(0, 4, size=500).astype(np.int32)
    ref = np.asarray(forward_jit(di, jnp.asarray(nodes), jnp.asarray(chars)))
    got = ts.forward_batch(ti, torch.from_numpy(nodes), torch.from_numpy(chars))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k,p", [(14, 0), (14, 6), (8, 8)], ids=["p0", "p_lt_k", "p_eq_k"])
def test_lf_streaming_matches_jax_and_oracle(k, p):
    """K14's plain version on plain-matrix against the JAX LF engine, on
    all-hit, all-miss, alternating, lowercase/N and padded reads."""
    from sbwt_tpu.ops.search import streaming_search_jit
    from torch_state import main_corpora

    rng = np.random.default_rng(30 + k + p)
    g = "".join(rng.choice(list("ACGT"), size=2000))
    js = SBWT.build([g], k, precalc_k=p)
    parts = main_corpora(g, k, rng, L=k + 26, n=64)
    codes = np.concatenate([c for c, _ in parts.values()]).astype(np.int8)
    lengths = np.concatenate([n for _, n in parts.values()]).astype(np.int32)
    ref = np.asarray(streaming_search_jit(js.device_index, jnp.asarray(codes), jnp.asarray(lengths)))
    ti = tm.from_numpy_state(matrix_state(js.device_index), "cpu")
    got = ts.streaming_search(ti, torch.from_numpy(codes), torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and 0.2 < (got >= 0).mean() < 0.9
    orc = OracleIndex([g], k)
    for i in range(0, 64, 9):  # all-hit reads: plain uppercase
        want = orc.streaming_search("".join("ACGT"[c] for c in codes[i]))
        assert got[i].tolist() == want


def test_lf_streaming_needs_streaming_support():
    js = SBWT.build(["ACGTTGCAAGGCT"], 5, streaming_support=False)
    ti = tm.from_numpy_state(matrix_state(js.device_index), "cpu")
    with pytest.raises(ValueError, match="streaming support"):
        ts.streaming_search(ti, torch.zeros((1, 8), dtype=torch.int8))


# The cases of tests/search_cases.py (the kernels take the same inputs in
# test_torch_cuda.py): the JAX answers are computed once a process
# (torch_state.search_answer_sets), the port's plain versions per case.
KMER_CASES = [f"B{B}" for B in sc.BATCHES]
PARTIAL_CASES = [f"B{B}_L{sc.SHORT_L}" for B in sc.BATCHES] + [f"B65_L{sc.LONG_L}"]


@pytest.fixture(scope="module")
def answer_sets():
    return search_answer_sets()


@pytest.fixture(scope="module")
def case_oracle():
    return OracleIndex([sc.genome()], sc.K)


def _text(row) -> str:
    return "".join("ACGT"[c] if 0 <= c < 4 else "N" for c in row)


def _oracle_partial(orc, row, length, l, r):
    """SBWT::partial_search by the oracle: lowercase as its base, stop at
    the first char < 0 or the first step that empties the interval."""
    n = max(0, min(len(row), int(length)))
    for t in range(n):
        c = int(row[t])
        if c < 0:
            return l, r, t
        nl, nr = orc.update_interval("ACGT"[c & 3], l, r)
        if nl == -1:
            return l, r, t
        l, r = nl, nr
    return l, r, n


@pytest.mark.parametrize("p", [0, 4])
@pytest.mark.parametrize("case", KMER_CASES)
def test_kmer_search_cases_match_jax_and_oracle(answer_sets, case_oracle, p, case):
    rows = sc.kmer_cases(sc.genome())[case]
    ti = tm.from_numpy_state(answer_sets["state4" if p else "state"], "cpu")
    got = ts.search_batch(ti, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, answer_sets["kmer"][p][case])
    for row, a in zip(rows, got):
        assert a == case_oracle.search(_text(row)), _text(row)
    if len(rows) > 31:  # hits, misses, lowercase and N all present
        assert (got >= 0).any() and (got < 0).any()
        assert ((rows >= 4).any(axis=1) & (got < 0)).any() and (rows < 0).any()


@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_partial_search_cases_match_jax_and_oracle(answer_sets, case_oracle, case):
    codes, lengths = sc.partial_cases(sc.genome())[case]
    ti = tm.from_numpy_state(answer_sets["state"], "cpu")
    assert case_oracle.n == ti.n_nodes
    got = [t.numpy() for t in ts.partial_search_batch(ti, torch.from_numpy(codes),
                                                      torch.from_numpy(lengths))]
    for g, w in zip(got, answer_sets["partial"][case]):
        np.testing.assert_array_equal(g, w)
    for i in range(len(codes)):
        assert tuple(int(g[i]) for g in got) == _oracle_partial(
            case_oracle, codes[i], lengths[i], 0, ti.n_nodes - 1), i
    l, r, m = got
    L = codes.shape[1]
    assert {0, 1, L} <= set(np.clip(lengths, 0, L).tolist()) or len(codes) == 1
    if len(codes) > 31:  # whole rows matched, stops short, a match run on past k
        assert (m == np.clip(lengths, 0, L)).any() and (m < np.clip(lengths, 0, L)).any()
        assert m.max() > sc.K


@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_partial_search_from_start_intervals_matches_jax_and_oracle(answer_sets, case_oracle,
                                                                    case):
    """update_sbwt_interval's path: singleton, own and full start intervals
    over each row's chars after its first three."""
    codes, lengths = sc.partial_cases(sc.genome())[case]
    start, jl, jr, alive = answer_sets["start"][case]
    ti = tm.from_numpy_state(answer_sets["state"], "cpu")
    tail, tlen = codes[:, 3:], lengths - 3
    l, r, m = (t.numpy() for t in ts.partial_search_batch(
        ti, torch.from_numpy(np.ascontiguousarray(tail)), torch.from_numpy(tlen),
        torch.from_numpy(start)))
    np.testing.assert_array_equal(l, jl)
    np.testing.assert_array_equal(r, jr)
    assert (m[alive] == np.clip(tlen[alive], 0, tail.shape[1])).all()
    for i in range(len(codes)):
        assert (int(l[i]), int(r[i]), int(m[i])) == _oracle_partial(
            case_oracle, tail[i], tlen[i], int(start[i, 0]), int(start[i, 1])), i
    if len(codes) > 31:
        assert (start[:, 0] == start[:, 1]).any() and (start[:, 1] - start[:, 0] > 1000).any()
