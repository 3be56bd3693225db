"""Port parity: turbo tables (K2, K3), streaming search (K4) and the stats
programs over its answers (K13), plain versions.

Each index is built once by the JAX package and carried into the port as
numpy state. The port builds its own successor tables and seed bits, which
must equal the JAX ones byte for byte (the JAX arity-2/3 tables carry pad
rows past n * 4^A that no query reads; the port's have none). Streaming
answers must equal ``turbo_streaming_jit`` exactly on every corpus, and
the plain-uppercase reads of each corpus must also agree with the
independent string oracle (tests/oracle.py). One batch per index and arity
holds all of its corpora, so JAX compiles one program per pair.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from oracle import OracleIndex
from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.ops.turbo import build_turbo as jax_build_turbo
from sbwt_tpu.ops.turbo import fast_search_jit, turbo_streaming_jit
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu.utils.memory import select_turbo_arity as jax_select_turbo_arity
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.utils.memory import select_turbo_arity, turbo_table_bytes
from torch_state import chimeric_corpora, main_corpora, matrix_state, turbo_state


class Case:
    """A JAX index, its port, and one batch of named corpora (lane slices)."""

    def __init__(self, seqs, k, p, corpora, L):
        self.k, self.p = k, p
        self.seqs = seqs
        self.js = SBWT.build(seqs, k, precalc_k=p)
        self.ti = tm.from_numpy_state(matrix_state(self.js.device_index), "cpu")
        parts, self.slices, start = [], {}, 0
        for name, (codes, lengths) in corpora.items():
            parts.append((codes, lengths))
            self.slices[name] = slice(start, start + len(codes))
            start += len(codes)
        self.codes = np.concatenate([c for c, _ in parts]).astype(np.int8)
        self.lengths = np.concatenate([n for _, n in parts]).astype(np.int32)
        assert self.codes.shape[1] == L
        self._runs = {}
        self._oracle = None

    def run(self, arity):
        """(jax answers, port answers, jax turbo, port turbo) at one arity."""
        if arity not in self._runs:
            jt = jax_build_turbo(self.js.device_index, arity=arity)
            ref = np.asarray(turbo_streaming_jit(
                jt, self.js.device_index, jnp.asarray(self.codes), jnp.asarray(self.lengths)))
            pt = tt.build_turbo(self.ti, arity=arity)
            got = tt.turbo_streaming_search(pt, self.ti, torch.from_numpy(self.codes),
                                            torch.from_numpy(self.lengths)).numpy()
            self._runs[arity] = (ref, got, jt, pt)
        return self._runs[arity]

    def oracle(self):
        if self._oracle is None:
            self._oracle = OracleIndex(self.seqs, self.k)
        return self._oracle


@pytest.fixture(scope="module")
def main_case():
    rng = np.random.default_rng(5)
    g = "".join(rng.choice(list("ACGT"), size=4000))
    return Case([g], 14, 6, main_corpora(g, 14, rng), 40)


def _repeat_case():
    # 8 mutated copies of one base, short precalc: most live seeds are
    # non-singleton, so restarts take the exact LF steps
    rng = np.random.default_rng(21)
    base = rng.choice(list("ACGT"), size=1500)
    parts = []
    for i in range(8):
        c = base.copy()
        pos = rng.choice(len(base), size=15 * (i + 1), replace=False)
        c[pos] = rng.choice(list("ACGT"), size=len(pos))
        parts.append("".join(c))
    return Case(parts, 14, 4, chimeric_corpora(encode_query(parts[0]), 14, rng, 40), 40)


def _long_case(k, p):
    # k - p > 32: the JAX engine's wide-window path
    rng = np.random.default_rng(k)
    g = "".join(rng.choice(list("ACGT"), size=6000))
    return Case([g], k, p, chimeric_corpora(encode_query(g), k, rng, 70), 70)


def _k_eq_p_case():
    rng = np.random.default_rng(8)
    g = "".join(rng.choice(list("ACGT"), size=2000))
    return Case([g], 8, 8, chimeric_corpora(encode_query(g), 8, rng, 32), 32)


_OTHER = {"repeat_dense": _repeat_case, "k36_p3": lambda: _long_case(36, 3),
          "k45_p12": lambda: _long_case(45, 12), "k8_eq_p": _k_eq_p_case}
_OTHER_ARITIES = {"repeat_dense": (1, 3), "k36_p3": (3,), "k45_p12": (2,), "k8_eq_p": (1,)}


@pytest.fixture(scope="module")
def other_cases():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _OTHER[name]()
        return cache[name]

    return get


def _check_oracle(case, name, arity, n_reads=4):
    """Sampled plain-uppercase reads of a corpus against the string oracle."""
    sl = case.slices[name]
    codes, lengths = case.codes[sl], case.lengths[sl]
    got = case.run(arity)[1][sl]
    upper = [i for i in range(len(codes)) if ((codes[i, : lengths[i]] >= 0)
                                               & (codes[i, : lengths[i]] < 4)).all()]
    assert upper, name
    orc = case.oracle()
    for i in upper[:: max(1, len(upper) // n_reads)][:n_reads]:
        text = "".join("ACGT"[c] for c in codes[i, : lengths[i]])
        want = orc.streaming_search(text)
        assert got[i, : len(want)].tolist() == want, (name, i)
        assert (got[i, len(want):] == -1).all()


@pytest.mark.parametrize("arity", [1, 2, 3])
def test_tables_byte_equal(main_case, arity):
    _, _, jt, pt = main_case.run(arity)
    n = main_case.ti.n_nodes
    ref = np.asarray(jt.tbl)[: n * 4**arity]
    assert pt.tbl.numpy().dtype == ref.dtype and pt.tbl.numpy().tobytes() == ref.tobytes()
    assert pt.seed_bits.numpy().tobytes() == np.asarray(jt.seed_bits).tobytes()
    assert pt.precalc.numpy().tobytes() == np.asarray(jt.precalc).tobytes()


@pytest.mark.parametrize("p", [1, 2, 3, 5, 6])
def test_seed_bits_equal(main_case, p):
    from sbwt_tpu.ops.turbo import _pack_seed_pair_bits

    ti = tm.from_numpy_state(matrix_state(main_case.js.device_index), "cpu")
    tm.with_precalc(ti, p)
    ref = np.asarray(_pack_seed_pair_bits(jnp.asarray(ti.precalc.numpy()[:, 0] >= 0)))
    got = tt.seed_bits_plain(ti.precalc, p, chunk=256)
    assert got.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("corpus", ["all_hit", "all_miss", "alternating", "lowercase_n", "padded"])
@pytest.mark.parametrize("arity", [1, 2, 3])
def test_streaming_main_corpora(main_case, arity, corpus):
    ref, got, _, _ = main_case.run(arity)
    sl = main_case.slices[corpus]
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[sl], ref[sl])


@pytest.mark.parametrize("corpus", ["all_hit", "all_miss", "alternating", "padded"])
def test_streaming_main_corpora_oracle(main_case, corpus):
    _check_oracle(main_case, corpus, arity=3)


def test_corpora_reach_their_regimes(main_case):
    ref, _, _, _ = main_case.run(3)
    hit = {name: (ref[sl] >= 0).mean() for name, sl in main_case.slices.items()}
    assert hit["all_hit"] == 1.0 and hit["all_miss"] < 0.02
    assert 0.1 < hit["alternating"] < 0.9
    # the quirk lanes: a restart hit followed by a lowercase char is -1
    low = main_case.slices["lowercase_n"]
    q = ref[low][1::4]
    assert (q[:, 6] >= 0).all() and (q[:, 6 + 3] == -1).all()


@pytest.mark.parametrize("name,arity", [(n, a) for n, arities in _OTHER_ARITIES.items()
                                        for a in arities])
def test_streaming_adversarial_indexes(other_cases, name, arity):
    case = other_cases(name)
    ref, got, _, _ = case.run(arity)
    np.testing.assert_array_equal(got, ref)
    _check_oracle(case, "chimeric", arity, n_reads=3)


def test_repeat_corpus_is_non_singleton_dense(other_cases):
    case = other_cases("repeat_dense")
    pre = case.ti.precalc.numpy()
    live = pre[:, 0] >= 0
    assert (pre[live, 0] != pre[live, 1]).mean() > 0.5


def test_turbo_from_numpy_state(main_case):
    ref, _, jt, pt = main_case.run(2)
    carried = tt.turbo_from_numpy_state(turbo_state(jt), "cpu")
    assert carried.tbl.numpy().tobytes() == pt.tbl.numpy().tobytes()
    got = tt.turbo_streaming_search(carried, main_case.ti, torch.from_numpy(main_case.codes),
                                    torch.from_numpy(main_case.lengths)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_succ1_layouts_and_columns(main_case):
    """succ1's plain version: [4, n] as the JAX _succ1, [n, 4] row by row,
    and over a list of columns (what forward asks for)."""
    import jax

    from sbwt_tpu.ops.turbo import _succ1

    ref = np.asarray(jax.jit(_succ1)(main_case.js.device_index))
    ti = main_case.ti
    succ = tt.succ1(ti)
    assert succ.dtype == torch.int32
    np.testing.assert_array_equal(succ.numpy(), ref)
    np.testing.assert_array_equal(tt.succ1(ti, row_major=True).numpy(), ref.T)
    cols = torch.from_numpy(np.random.default_rng(6).integers(0, ti.n_nodes, size=300))
    np.testing.assert_array_equal(tt.succ1(ti, cols).numpy(), ref[:, cols.numpy()])
    np.testing.assert_array_equal(tt.succ1(ti, cols, row_major=True).numpy(), ref[:, cols.numpy()].T)
    # the arity-1 table is succ row by row
    assert torch.equal(main_case.run(1)[3].tbl, tt.succ1(ti, row_major=True))


def test_fast_search_matches_jax(main_case):
    _, _, jt, pt = main_case.run(3)
    wins = np.lib.stride_tricks.sliding_window_view(main_case.codes, 14, axis=1)
    wins = np.ascontiguousarray(wins[::5, ::3].reshape(-1, 14))
    ra, rs = (np.asarray(a) for a in fast_search_jit(jt, jnp.asarray(wins)))
    ga, gs = tt.fast_search(pt, torch.from_numpy(wins))
    np.testing.assert_array_equal(gs.numpy(), rs)
    np.testing.assert_array_equal(ga.numpy(), ra)


def test_build_turbo_preconditions(main_case):
    ti = main_case.ti
    with pytest.raises(ValueError, match="arity"):
        tt.build_turbo(ti, arity=4)
    with pytest.raises(ValueError, match="exceeds int32"):
        tt.check_turbo_index_range(2**25, 3)
    tt.check_turbo_index_range(2**25 - 1, 3)
    no_pre = tm.from_numpy_state(matrix_state(main_case.js.device_index), "cpu")
    tm.with_precalc(no_pre, 0)
    with pytest.raises(ValueError, match="precalc"):
        tt.build_turbo(no_pre)
    no_sgs = SBWT.build(main_case.seqs, 14, streaming_support=False, precalc_k=4)
    with pytest.raises(ValueError, match="streaming"):
        tt.build_turbo(tm.from_numpy_state(matrix_state(no_sgs.device_index), "cpu"))


def test_arity_selection_matches_jax():
    from sbwt_tpu.utils.memory import turbo_table_bytes as jax_table_bytes

    for n in (1000, 4_000_000, 20_000_000, 2**25, 300_000_000, 10**9):
        for free in (1 << 20, 8 << 30, 80 << 30):
            for p in (0, 8, 13):
                assert select_turbo_arity(n, free, p) == jax_select_turbo_arity(n, free, p)
        for a in (1, 2, 3):
            assert turbo_table_bytes(n, a, 13) == jax_table_bytes(n, a, 13)
    # unmeasurable free memory: the JAX engine's fixed thresholds
    assert [select_turbo_arity(n, None) for n in (6_000_000, 16_000_000, 400_000_000, 10**9)] == [
        3, 2, 1, None]


# ---------------------------------------------------------------------------
# the stats programs (_turbo_with_stats, _turbo_reduced_stats): the port
# returns int64 checksum and hits; the JAX package sums in int32, which
# wraps, so its checksum is the low 32 bits of the port's. Exact equality.
# ---------------------------------------------------------------------------


def _low32(x: int) -> int:
    return int(np.array(x, dtype=np.int64).astype(np.int32))


@pytest.fixture(scope="module")
def jax_reduced_stats(main_case):
    """The JAX package's _turbo_reduced_stats itself, once, over the whole
    main batch at arity 2: (checksum, hits) as numpy scalars."""
    from sbwt_tpu.ops.turbo import _turbo_reduced_stats as jax_reduced

    _, _, jt, _ = main_case.run(2)
    checksum, hits = jax_reduced(jt, main_case.js.device_index, jnp.asarray(main_case.codes),
                                 jnp.asarray(main_case.lengths), None)
    return np.asarray(checksum), np.asarray(hits)


def test_reduced_stats_match_jax_program(main_case, jax_reduced_stats):
    ref, _, _, pt = main_case.run(2)
    jax_checksum, jax_hits = jax_reduced_stats
    assert jax_checksum.dtype == np.int32 and jax_hits.dtype == np.int32
    checksum, hits = tt._turbo_reduced_stats(pt, main_case.ti, torch.from_numpy(main_case.codes),
                                             torch.from_numpy(main_case.lengths))
    assert checksum.dtype == torch.int64 and hits.dtype == torch.int64
    assert int(hits) == int(jax_hits)
    assert _low32(int(checksum)) == int(jax_checksum)
    assert int(checksum) == int(ref.sum(dtype=np.int64))


@pytest.mark.parametrize("corpus", ["all_hit", "all_miss", "alternating", "lowercase_n", "padded"])
@pytest.mark.parametrize("arity", [1, 2, 3])
def test_stats_programs_match_jax_answers(main_case, arity, corpus):
    """Both stats programs on one corpus, against the JAX engine's answers
    reduced as the JAX programs reduce them (int32 sums)."""
    ref, _, _, pt = main_case.run(arity)
    sl = main_case.slices[corpus]
    codes, lengths = torch.from_numpy(main_case.codes[sl]), torch.from_numpy(main_case.lengths[sl])
    want = ref[sl]
    jax_checksum, jax_hits = want.sum(dtype=np.int32), (want >= 0).sum(dtype=np.int32)
    out, hits = tt._turbo_with_stats(pt, main_case.ti, codes, lengths)
    np.testing.assert_array_equal(out.numpy(), want)
    assert hits.dtype == torch.int64 and int(hits) == int(jax_hits)
    checksum, hits = tt._turbo_reduced_stats(pt, main_case.ti, codes, lengths)
    assert int(hits) == int(jax_hits)
    assert _low32(int(checksum)) == int(jax_checksum)
    assert int(checksum) == int(want.sum(dtype=np.int64))


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (1000, 71)])
def test_answer_stats_plain_int64(shape):
    """The wide tier's int64 answers: a checksum past 2^31, equal to numpy's
    int64 sum and count."""
    rng = np.random.default_rng(shape[0])
    ans = rng.integers(2**33, 2**40, size=shape, dtype=np.int64)
    ans[rng.random(shape) < 0.3] = -1
    got = tt.answer_stats(torch.from_numpy(ans))
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert got.tolist() == [int(ans.sum(dtype=np.int64)), int((ans >= 0).sum())]
    assert got.tolist()[0] > 2**31
    assert torch.equal(tt.answer_stats_plain(torch.from_numpy(ans)), got)
