"""Port parity: the nine compressed variants (K17's plain versions), their
precalc fill and k-mer search (K1's variant instances), the LF streaming
engine on every variant (K14's plain version), the turbo engine built from
each variant's own ranks (K2's succ1 and K4 over a variant), the facade's
partial_search / forward / update_sbwt_interval, and their index files.

One JAX plain-matrix index of a numpy-seeded genome (k = 14) is re-encoded
into each variant by both packages; every comparison is of integers and
exact. The port's structures are built by its own host code and must give
byte-equal payloads; they are also carried over from the JAX payloads.
Where the JAX package is wrong (ConcatRank.rank_pair on a fully dense
window, ROADMAP Queue 3 F1) the test holds the port to the oracle.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oracle import OracleIndex
from sbwt_tpu.io import serialize as jax_io
from sbwt_tpu.models.matrix import with_precalc as jax_with_precalc
from sbwt_tpu.models.sbwt import SBWT as JaxSBWT
from sbwt_tpu.models.subsetrank import build_struct as jax_build_struct
from sbwt_tpu.ops.search import search_jit, streaming_search_jit
from sbwt_tpu.ops.turbo import _succ1 as jax_succ1
from sbwt_tpu.ops.turbo import build_turbo as jax_build_turbo
from sbwt_tpu.ops.turbo import turbo_streaming_jit
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch.io import serialize as port_io
from sbwt_tpu_torch.models import subsetrank as tsr
from sbwt_tpu_torch.models.matrix import from_host_arrays, with_precalc
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu_torch.models.variants import build_generic_index
from sbwt_tpu_torch.ops import turbo as tt
from test_torch_bv import assert_payload_equal
from torch_state import (CONCAT_CASES, concat_case_bits, concat_rank_pair_answers,
                         generic_from_jax, main_corpora)

K = 14
P = 6
COMPRESSED = VARIANT_NAMES[1:]


@pytest.fixture(scope="module")
def genome():
    return "".join(np.random.default_rng(11).choice(list("ACGT"), size=2500))


@pytest.fixture(scope="module")
def jax_plain(genome):
    return JaxSBWT.build([genome], K, precalc_k=P)


@pytest.fixture(scope="module")
def port_plain(jax_plain):
    return SBWT.from_bits(jax_plain.bits, jax_plain.suffix_group_starts, K,
                          jax_plain.number_of_kmers(), "cpu", P)


@pytest.fixture(scope="module")
def oracle(genome):
    return OracleIndex([genome], K)


@pytest.fixture(scope="module")
def variants(jax_plain, port_plain):
    """variant -> (JAX SBWT, the port's own SBWT), built on first use."""
    cache = {}

    def get(v):
        if v not in cache:
            cache[v] = (jax_plain.to_variant(v), port_plain.to_variant(v))
        return cache[v]

    return get


@pytest.fixture(scope="module")
def corpora(genome):
    parts = main_corpora(genome, K, np.random.default_rng(12))
    codes = np.concatenate([c for c, _ in parts.values()]).astype(np.int8)
    lengths = np.concatenate([n for _, n in parts.values()]).astype(np.int32)
    return codes, lengths


@pytest.fixture(scope="module")
def jax_answers(jax_plain, corpora):
    """The JAX LF engine's answers on the corpora. They do not depend on the
    variant (tests/test_variants.py), so one compiled engine serves all."""
    codes, lengths = corpora
    return np.asarray(streaming_search_jit(jax_plain.device_index, jnp.asarray(codes),
                                           jnp.asarray(lengths)))


@pytest.fixture(scope="module")
def answers(variants, corpora):
    """variant -> the port's LF streaming answers on the corpora, computed once."""
    cache = {}

    def get(v):
        if v not in cache:
            cache[v] = variants(v)[1].streaming_search_batch(*corpora)
        return cache[v]

    return get


def _kmer_batch(genome, rng, n=150):
    """Present, absent, lowercase and N-holding k-mers, as query codes."""
    enc = encode_query(genome)
    present = enc[rng.integers(0, len(genome) - K, size=n)[:, None] + np.arange(K)]
    absent = rng.integers(0, 4, size=(n, K)).astype(np.int8)
    lower = present[: n // 3].copy()
    lower[np.arange(n // 3), rng.integers(0, K, n // 3)] |= 4
    with_n = present[n // 3 : 2 * n // 3].copy()
    with_n[np.arange(len(with_n)), rng.integers(0, K, len(with_n))] = -1
    return np.concatenate([present, absent, lower, with_n]).astype(np.int8)


@pytest.mark.parametrize("variant", COMPRESSED)
def test_struct_matches_jax(variants, jax_plain, variant):
    js, ps = variants(variant)
    jst, pst = js.device_index.struct, ps.device_index.struct
    assert_payload_equal(pst.payload(), jst.payload())
    assert pst.size_in_bytes() == jst.size_in_bytes()
    np.testing.assert_array_equal(pst.to_bits(), jax_plain.bits)
    n = js.number_of_subsets()
    c = np.repeat(np.arange(4, dtype=np.int32), n + 1)
    pos = np.tile(np.arange(n + 1, dtype=np.int32), 4)
    # one JAX program for both: rank at 0..n, rank_pair at 0..n-1
    ranks = jax.jit(lambda c, pos: (jst.rank(c, pos), *jst.rank_pair(c, jnp.minimum(pos, n - 1))))
    want, w1, w2 = (np.asarray(a) for a in ranks(jnp.asarray(c), jnp.asarray(pos)))
    pc, pp = c[pos < n], pos[pos < n]
    w1, w2 = w1[pos < n], w2[pos < n]
    carried = generic_from_jax(js.device_index)
    for st in (pst, carried.struct):
        np.testing.assert_array_equal(st.rank(torch.from_numpy(c), torch.from_numpy(pos)).numpy(),
                                      want)
        r1, r2 = st.rank_pair(torch.from_numpy(pc), torch.from_numpy(pp))
        np.testing.assert_array_equal(r1.numpy(), w1)
        np.testing.assert_array_equal(r2.numpy(), w2)
    rows = np.concatenate([np.zeros((4, 1), np.int64), np.cumsum(jax_plain.bits, axis=1)], axis=1)
    np.testing.assert_array_equal(want, rows.ravel())
    for f in ("sgs_tbl", "C", "precalc"):
        np.testing.assert_array_equal(getattr(ps.device_index, f).numpy(),
                                      np.asarray(getattr(js.device_index, f)))


@pytest.mark.parametrize("p", [1, 4, 6])
@pytest.mark.parametrize("variant", COMPRESSED)
def test_generic_precalc_matches_jax(variants, jax_plain, variant, p):
    """The table is the variant's own LF fill; it equals the JAX one, which
    does not depend on the variant."""
    ref = np.asarray(jax_with_precalc(jax_plain.device_index, p).precalc)
    di = generic_from_jax(variants(variant)[0].device_index)
    with_precalc(di, p)
    assert di.precalc_k == p and di.precalc.dtype == torch.int32
    np.testing.assert_array_equal(di.precalc.numpy(), ref)


def test_generic_precalc_limits(variants):
    di = variants("rrr-split")[1].device_index
    with pytest.raises(ValueError, match="precalc_k > 12"):
        with_precalc(di, 13)


@pytest.fixture(scope="module")
def kmer_batch(genome, jax_plain):
    """k-mer query codes and the JAX engine's answers, which do not depend
    on the variant."""
    codes = _kmer_batch(genome, np.random.default_rng(13))
    return codes, np.asarray(search_jit(jax_plain.device_index, jnp.asarray(codes)))


@pytest.mark.parametrize("variant", COMPRESSED)
def test_search_batch_matches_jax(variants, kmer_batch, oracle, variant):
    ps = variants(variant)[1]
    codes, ref = kmer_batch
    got = ps.search_batch(codes)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and (got[:150] >= 0).all()
    for row, a in zip(codes[:300:7], got[:300:7]):
        assert a == oracle.search("".join("ACGT"[c] for c in row))


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_lf_streaming_matches_jax(answers, jax_answers, corpora, oracle, variant):
    codes, lengths = corpora
    got = answers(variant)
    np.testing.assert_array_equal(got, jax_answers)
    assert got.dtype == np.int32
    upper = [i for i in range(len(codes)) if ((codes[i, : lengths[i]] >= 0)
                                               & (codes[i, : lengths[i]] < 4)).all()]
    for i in upper[::40]:
        want = oracle.streaming_search("".join("ACGT"[c] for c in codes[i, : lengths[i]]))
        assert got[i, : len(want)].tolist() == want


@pytest.fixture(scope="module")
def k_eq_p(genome):
    """A k = p = 8 index (the patch is one stage: the seed is the whole
    window), its reads, and the JAX plain-matrix engine's answers."""
    k = 8
    js = JaxSBWT.build([genome], k, precalc_k=k)
    parts = main_corpora(genome, k, np.random.default_rng(14), L=k + 20, n=48)
    codes = np.concatenate([c for c, _ in parts.values()]).astype(np.int8)
    lengths = np.concatenate([n for _, n in parts.values()]).astype(np.int32)
    ref = np.asarray(streaming_search_jit(js.device_index, jnp.asarray(codes),
                                          jnp.asarray(lengths)))
    port = SBWT.from_bits(js.bits, js.suffix_group_starts, k, js.number_of_kmers(), "cpu", k)
    return port, codes, lengths, ref


@pytest.mark.parametrize("variant", COMPRESSED)
def test_lf_streaming_k_equals_p(k_eq_p, variant):
    """The answers do not depend on the variant (tests/test_variants.py),
    so every variant is held to the JAX plain-matrix engine's."""
    port, codes, lengths, ref = k_eq_p
    vs = port.to_variant(variant)
    assert vs.get_precalc_k() == 8
    np.testing.assert_array_equal(vs.streaming_search_batch(codes, lengths), ref)
    assert 0.1 < (ref >= 0).mean() < 0.9


def test_variant_answers_equal_each_other(answers):
    for v in VARIANT_NAMES:
        np.testing.assert_array_equal(answers(v), answers(VARIANT_NAMES[0]), err_msg=v)


@pytest.mark.parametrize("fmt", ["cpp", "native"])
@pytest.mark.parametrize("variant", COMPRESSED)
def test_index_files_both_directions(variants, corpora, answers, tmp_path, variant, fmt):
    js, ps = variants(variant)
    codes, lengths = corpora
    want = answers(variant)
    jax_file, port_file = tmp_path / "jax.sbwt", tmp_path / "port.sbwt"
    jax_io.save(str(jax_file), js, fmt)
    port_io.save(str(port_file), ps, fmt)
    assert port_file.read_bytes() == jax_file.read_bytes()
    from_jax = port_io.load(str(jax_file), "cpu")
    assert from_jax.variant == variant and from_jax.get_precalc_k() == P
    assert_payload_equal(from_jax.device_index.struct.payload(), js.device_index.struct.payload())
    np.testing.assert_array_equal(from_jax.streaming_search_batch(codes, lengths), want)
    from_port = jax_io.load(str(port_file))
    assert from_port.variant == variant
    np.testing.assert_array_equal(from_port.bits, js.bits)
    np.testing.assert_array_equal(from_port.get_precalc(), js.get_precalc())


def test_dense_concat_rank_pair_agrees_with_oracle():
    """F1: a fully dense 256-column plain-concat. Every set holds 4
    symbols, so each sampled zero is word-aligned and the ninth zero of
    its window sits 32 bits on, in the high word."""
    n = 256
    bits = np.ones((4, n), dtype=bool)
    orc = OracleIndex.__new__(OracleIndex)
    orc.bits = {ch: [True] * n for ch in "ACGT"}
    st = tsr.ConcatRank.from_bits(bits, "plain")
    plain = from_host_arrays(bits, None, 3, 0, "cpu")
    pos = torch.arange(n)
    for c in range(4):
        r1, r2 = st.rank_pair(torch.full_like(pos, c), pos)
        p1, bit = plain.extend_rank(torch.full_like(pos, c), pos)
        np.testing.assert_array_equal(r1.numpy(), p1.numpy())
        np.testing.assert_array_equal(r2.numpy(), (p1 + bit).numpy())
        assert r1.tolist() == [orc.rank(i, "ACGT"[c]) for i in range(n)]
        assert r2.tolist() == [orc.rank(i + 1, "ACGT"[c]) for i in range(n)]
    # the JAX package's answer differs here, which is F1
    jst = jax_build_struct("plain-concat", bits)
    _, j2 = jst.rank_pair(jnp.zeros(n, jnp.int32), jnp.arange(n, dtype=jnp.int32))
    assert (np.asarray(j2) != r2.numpy()).any()


def _rank_span(wt, sym, pos, length):
    """WaveletTree::rank_span of csrc/wavelet.cuh, transcribed: one walk
    from the span [pos, pos + length), at each level one run of the level's
    bits from p, whose popcount gives rank(q) = rank(p) + popc(run). The
    identity is checked against the level's own rank at q on every level."""
    p, q = pos.clone(), pos + length
    for d in range(wt.depth):
        valid = wt.path_valid[sym, d].bool()
        node = wt.path_node[sym, d]
        base, nrank = wt.node_base[node], wt.node_rank[node]
        lvl = wt.levels[d]
        r = lvl.rank(base + p)
        span = q - p
        run = torch.zeros_like(p)
        for j in range(32):
            at = torch.clamp(base + p + j, 0, lvl.n_bits - 1)
            run += torch.where(j < span, lvl.get(at).long(), 0)
        assert torch.equal(torch.where(valid, lvl.rank(base + q), 0),
                           torch.where(valid, r + run, 0)), d
        rp, rq = r - nrank, r - nrank + run
        right = wt.path_bit[sym, d].bool()
        p, q = (torch.where(valid, torch.where(right, rp, p - rp), p),
                torch.where(valid, torch.where(right, rq, q - rq), q))
    return p, q


@pytest.mark.parametrize("wt_kind", ["plain", "rrr"])
@pytest.mark.parametrize("case", list(CONCAT_CASES))
def test_concat_one_walk_rank_pair(case, wt_kind):
    """ConcatRank::rank_pair of csrc/subset_rank.cuh as the card runs it:
    both set starts from one window of L, then one walk of the tree over
    the span between them (1-4 symbols). Held to the port's plain
    rank_pair, to the cumulative counts, and to the JAX answers, except on
    the dense index (F1), where it is held to the string oracle."""
    bits = concat_case_bits(case)
    n = bits.shape[1]
    st = tsr.ConcatRank.from_bits(bits, wt_kind)
    c = torch.arange(4).repeat_interleave(n)
    pos = torch.arange(n).repeat(4)
    x, y = st.select0_pair(pos)
    assert int((y - x).min()) >= 1 and int((y - x).max()) <= 4
    p, q = _rank_span(st.wt, c + 1, x, y - x)
    r1, r2 = st.rank_pair(c, pos)
    np.testing.assert_array_equal(p.numpy(), r1.numpy())
    np.testing.assert_array_equal(q.numpy(), r2.numpy())
    cum = np.concatenate([np.zeros((4, 1), np.int64), np.cumsum(bits, axis=1)], axis=1)
    np.testing.assert_array_equal(p.numpy(), cum[c, pos])
    np.testing.assert_array_equal(q.numpy(), cum[c, pos + 1])
    if case == "dense":
        orc = OracleIndex.__new__(OracleIndex)
        orc.bits = {ch: list(bits[i]) for i, ch in enumerate("ACGT")}
        assert p.tolist() == [orc.rank(i, "ACGT"[ci]) for ci in range(4) for i in range(n)]
        assert q.tolist() == [orc.rank(i + 1, "ACGT"[ci]) for ci in range(4) for i in range(n)]
    else:
        j1, j2 = concat_rank_pair_answers(case, wt_kind)
        np.testing.assert_array_equal(p.numpy(), j1)
        np.testing.assert_array_equal(q.numpy(), j2)


@pytest.mark.parametrize("wt_kind", ["plain", "rrr"])
def test_wavelet_rank_span_any_length(wt_kind):
    """rank_span's walk at spans of 0-31 symbols from random positions of a
    ConcatRank's sigma-5 tree: both ends equal the tree's own ranks."""
    st = tsr.ConcatRank.from_bits(concat_case_bits("random"), wt_kind)
    wt = st.wt
    rng = np.random.default_rng(31)
    pos = torch.from_numpy(rng.integers(0, wt.n + 1, size=2000))
    length = torch.minimum(torch.from_numpy(rng.integers(0, 32, size=2000)), wt.n - pos)
    sym = torch.from_numpy(rng.integers(0, 5, size=2000))
    p, q = _rank_span(wt, sym, pos, length)
    np.testing.assert_array_equal(p.numpy(), wt.rank(sym, pos).numpy())
    np.testing.assert_array_equal(q.numpy(), wt.rank(sym, pos + length).numpy())


# ---------------------------------------------------------------------------
# turbo from a variant's own ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_turbo(jax_plain):
    """arity -> (the JAX table without its pad rows, its seed bits). The JAX
    table does not depend on the variant it was built from
    (tests/test_variant_turbo.py, and test_jax_table_from_a_variant below),
    so the plain-matrix one serves all nine."""
    cache = {}

    def get(arity):
        if arity not in cache:
            jt = jax_build_turbo(jax_plain.device_index, arity=arity)
            rows = jax_plain.number_of_subsets() * 4**arity
            cache[arity] = (jt, np.asarray(jt.tbl)[:rows], np.asarray(jt.seed_bits))
        return cache[arity]

    return get


@pytest.mark.parametrize("arity", [1, 2, 3])
@pytest.mark.parametrize("variant", COMPRESSED)
def test_variant_turbo_matches_jax(variants, jax_turbo, jax_answers, corpora, variant, arity):
    """The table built from the variant's ranks is the JAX table byte for
    byte, and K4's plain version over the variant gives the JAX streaming
    answers on the adversarial corpora."""
    ps = variants(variant)[1]
    _, ref_tbl, ref_bits = jax_turbo(arity)
    try:
        assert ps.enable_turbo(arity) == arity
        turbo = ps._turbo
        assert type(turbo) is tt.TurboIndex and turbo.tbl.dtype == torch.int32
        assert turbo.tbl.numpy().tobytes() == ref_tbl.tobytes()
        assert turbo.seed_bits.numpy().tobytes() == ref_bits.tobytes()
        got = ps.streaming_search_batch(*corpora)
    finally:
        ps._turbo = None  # the LF tests share this index
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_answers)


def test_jax_turbo_answers_equal_jax_lf_answers(jax_plain, jax_turbo, jax_answers, corpora):
    """What ties the reference of the test above to the JAX turbo engine."""
    codes, lengths = corpora
    got = np.asarray(turbo_streaming_jit(jax_turbo(2)[0], jax_plain.device_index,
                                         jnp.asarray(codes), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got, jax_answers)


def test_jax_table_from_a_variant(variants, jax_turbo):
    """The JAX build over a variant's GenericIndex gives the plain-matrix table."""
    jt = jax_build_turbo(variants("rrr-matrix")[0].device_index, arity=1)
    np.testing.assert_array_equal(np.asarray(jt.tbl), jax_turbo(1)[1])


@pytest.mark.parametrize("variant", COMPRESSED)
def test_variant_succ1_matches_jax(variants, jax_plain, variant):
    """succ1's plain version over the variant's ranks, both layouts and over
    a list of columns, against the JAX _succ1 of the plain-matrix index."""
    ref = np.asarray(jax.jit(jax_succ1)(jax_plain.device_index))
    di = variants(variant)[1].device_index
    succ = tt.succ1(di)
    assert succ.dtype == torch.int32 and tuple(succ.shape) == ref.shape
    np.testing.assert_array_equal(succ.numpy(), ref)
    np.testing.assert_array_equal(tt.succ1(di, row_major=True).numpy(), ref.T)
    cols = torch.from_numpy(np.random.default_rng(15).integers(0, di.n_nodes, size=200))
    np.testing.assert_array_equal(tt.succ1(di, cols).numpy(), ref[:, cols.numpy()])


def test_variant_turbo_auto_and_preconditions(variants, port_plain):
    ps = variants("mef-split")[1]
    try:
        assert ps.enable_turbo(None, free_bytes=1 << 10) is None and ps._turbo is None
        assert ps.enable_turbo(None, free_bytes=1 << 40) == 3
        assert torch.equal(ps._turbo.tbl, tt.build_turbo(port_plain.device_index, 3).tbl)
    finally:
        ps._turbo = None
    bare = SBWT.from_bits(port_plain.bits, None, K, port_plain.number_of_kmers(), "cpu", P,
                          "rrr-matrix")
    with pytest.raises(tt.TurboUnavailable, match="streaming support"):
        bare.enable_turbo(2)


def test_variant_turbo_fills_a_missing_precalc(port_plain):
    """Without a precalc table, enable_turbo fills one over the variant's ranks."""
    vs = SBWT.from_bits(port_plain.bits, port_plain.suffix_group_starts, K,
                        port_plain.number_of_kmers(), "cpu", 0, "plain-subsetwt")
    assert vs.get_precalc_k() == 0 and vs.enable_turbo(1) == 1
    assert vs.get_precalc_k() == 8
    ref = SBWT.from_bits(port_plain.bits, port_plain.suffix_group_starts, K,
                         port_plain.number_of_kmers(), "cpu", 8)
    assert torch.equal(vs.device_index.precalc, ref.device_index.precalc)


def test_dense_concat_successors_agree_with_oracle():
    """F1 again, one level up: succ1 over a fully dense plain-concat (every
    column its own suffix group) is held to the string oracle's ranks, where
    the JAX package's rank_pair, and so its _succ1, is wrong."""
    n = 256
    bits = np.ones((4, n), dtype=bool)
    orc = OracleIndex.__new__(OracleIndex)
    orc.bits = {ch: [True] * n for ch in "ACGT"}
    di = build_generic_index("plain-concat", bits, np.ones(n, dtype=bool), 3, 0, "cpu")
    succ = tt.succ1(di)
    C = di.C.tolist()
    for c, ch in enumerate("ACGT"):
        assert succ[c].tolist() == [C[c] + orc.rank(i, ch) for i in range(n)]
    plain = from_host_arrays(bits, np.ones(n, dtype=bool), 3, 0, "cpu")
    assert torch.equal(succ, tt.succ1(plain))


# ---------------------------------------------------------------------------
# the facade's partial_search, forward and update_sbwt_interval
# ---------------------------------------------------------------------------

FACADE_VARIANTS = ["plain-matrix", "rrr-split", "mef-concat"]


def _facade_texts(genome):
    """Texts of one length (one JAX program per variant): genomic, genomic
    with a mismatch, lowercase inside, an N inside, random."""
    g = genome[300:324]
    rnd = "".join(np.random.default_rng(16).choice(list("ACGT"), size=24))
    return [g, g[:9] + ("A" if g[9] != "A" else "C") + g[10:], g[:5] + g[5:9].lower() + g[9:],
            g[:13] + "N" + g[14:], rnd]


@pytest.mark.parametrize("variant", FACADE_VARIANTS)
def test_facade_partial_search_matches_jax(variants, jax_plain, port_plain, genome, variant):
    js, ps = (jax_plain, port_plain) if variant == "plain-matrix" else variants(variant)
    seen = set()
    for text in _facade_texts(genome):
        want = js.partial_search(text)
        assert ps.partial_search(text) == want, text
        seen.add(want[1])
    assert len(seen) >= 3 and 24 in seen


@pytest.mark.parametrize("variant", FACADE_VARIANTS)
def test_facade_update_sbwt_interval_matches_jax(variants, jax_plain, port_plain, genome, variant):
    js, ps = (jax_plain, port_plain) if variant == "plain-matrix" else variants(variant)
    n = js.number_of_subsets()
    outcomes = set()
    for s in (genome[500:506], genome[500:503] + "n" + genome[504:506], "ACGTAC", "acgtac"):
        for interval in ((0, n - 1), (n // 3, 2 * n // 3), (-1, -1)):
            want = js.update_sbwt_interval(s, interval)
            assert ps.update_sbwt_interval(s, interval) == want, (s, interval)
            outcomes.add(want[0] == -1)
    assert outcomes == {True, False}


@pytest.mark.parametrize("variant", FACADE_VARIANTS)
def test_facade_forward_matches_jax(variants, jax_plain, port_plain, variant):
    js, ps = (jax_plain, port_plain) if variant == "plain-matrix" else variants(variant)
    n = js.number_of_subsets()
    hits = 0
    for node in (0, 1, 7, n // 2, n - 2, n - 1):
        for c in "ACGTNa":
            want = js.forward(node, c)
            assert ps.forward(node, c) == want, (node, c)
            hits += want >= 0
    assert hits >= 4
    nodes = np.random.default_rng(17).integers(0, n, size=300)
    chars = np.random.default_rng(18).integers(0, 4, size=300)
    np.testing.assert_array_equal(ps.forward_batch(nodes, chars),
                                  port_plain.forward_batch(nodes, chars))


def test_facade_partial_search_batch_agrees_across_variants(variants, port_plain, corpora):
    codes, lengths = corpora
    ref = port_plain.partial_search_batch(codes, lengths)
    assert ref[0].dtype == ref[1].dtype == ref[2].dtype == np.int32
    assert len(set(ref[2].tolist())) > 10
    for v in COMPRESSED:
        got = variants(v)[1].partial_search_batch(codes, lengths)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=v)
