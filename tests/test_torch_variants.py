"""Port parity: the nine compressed variants (K17's plain versions), their
precalc fill and k-mer search (K1's variant instances), the LF streaming
engine on every variant (K14's plain version), and their index files.

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
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch.io import serialize as port_io
from sbwt_tpu_torch.models import subsetrank as tsr
from sbwt_tpu_torch.models.matrix import from_host_arrays, with_precalc
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from test_torch_bv import assert_payload_equal
from torch_state import generic_from_jax, main_corpora

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
