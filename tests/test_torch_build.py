"""The port's on-device build (sbwt_tpu_torch/construct/device.py) on the
CPU, where its four stages run their plain PyTorch versions.

Held against the port's own host build, the JAX package's device build
(sbwt_tpu/construct/device.py) and the independent string oracle
(tests/oracle.py). Inputs come from numpy seeds; every output is an
integer, so each comparison is exact (tolerance 0).
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_state  # noqa: F401  (one torch thread in each test worker)
from oracle import OracleIndex
from test_device_build import CASES

from sbwt_tpu.construct import device as jd
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.construct import device as td
from sbwt_tpu_torch.construct.inmemory import build_sbwt
from sbwt_tpu_torch.io.serialize import load, save
from sbwt_tpu_torch.models.matrix import from_host_arrays
from sbwt_tpu_torch.models.sbwt import SBWT
from sbwt_tpu_torch.utils.dna import encode, encode_query


def _seqs(case):
    mk, k = CASES[case]
    return mk(np.random.default_rng(100 + case)), k


def _assert_equals_host_build(dev, seqs, k, streaming=True):
    built = build_sbwt(seqs, k, streaming_support=streaming)
    host = from_host_arrays(built.bits, built.suffix_group_starts, k, built.n_kmers, "cpu")
    assert (dev.n_nodes, dev.n_kmers, dev.n_words, dev.k) == (
        host.n_nodes, host.n_kmers, host.n_words, k)
    assert dev.has_streaming == host.has_streaming == streaming
    for name in ("rank_tbl", "sgs_tbl", "C", "precalc"):
        a, b = getattr(dev, name), getattr(host, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("case", range(len(CASES)))
def test_device_build_matches_host_jax_and_oracle(case):
    seqs, k = _seqs(case)
    before = dict(kernels.LAUNCHES)
    dev = td.build_sbwt_device(seqs, k, "cpu")
    assert kernels.LAUNCHES == before  # plain versions only
    _assert_equals_host_build(dev, seqs, k)
    # the JAX device build: equal on every real word, its padding words zero
    ref = jd.build_sbwt_device(seqs, k, pad_quantum=256)
    assert (ref.n_nodes, ref.n_kmers) == (dev.n_nodes, dev.n_kmers)
    np.testing.assert_array_equal(np.asarray(ref.C), dev.C.numpy())
    W = dev.n_words
    jr = np.asarray(ref.rank_tbl).reshape(4, ref.n_words, 2)
    np.testing.assert_array_equal(jr[:, :W], dev.rank_tbl.numpy().reshape(4, W, 2))
    assert not jr[:, W:, 0].any()
    np.testing.assert_array_equal(np.asarray(ref.sgs_tbl)[:W], dev.sgs_tbl.numpy())
    # the oracle, on k-mers of the input and random ones
    oracle = OracleIndex(seqs, k)
    rng = np.random.default_rng(case)
    texts = ["".join(rng.choice(list("ACGT"), size=k)) for _ in range(8)]
    for s in seqs:
        for st in rng.integers(0, max(1, len(s) - k + 1), size=8):
            if len(s[st : st + k]) == k:
                texts.append(s[st : st + k])
    sb = SBWT(dev, np.zeros((4, 0), np.uint8), dev.n_nodes, None)
    got = sb.search_batch(np.stack([encode_query(t) for t in texts]))
    assert got.tolist() == [oracle.search(t) for t in texts]
    assert (got >= 0).any()


@pytest.mark.parametrize("case", [0, 5, 9])
def test_device_build_without_streaming_support(case):
    seqs, k = _seqs(case)
    dev = td.build_sbwt_device(seqs, k, "cpu", streaming_support=False)
    _assert_equals_host_build(dev, seqs, k, streaming=False)
    assert tuple(dev.sgs_tbl.shape) == (1, 2)


@pytest.mark.parametrize("seqs", [[], ["ACG"], ["NNNNNNNNNN", "ACNGT"]],
                         ids=["no_sequences", "shorter_than_k", "no_valid_window"])
def test_device_build_of_no_kmers_is_the_root_alone(seqs):
    dev = td.build_sbwt_device(seqs, 5, "cpu")
    _assert_equals_host_build(dev, seqs, 5)
    assert (dev.n_nodes, dev.n_kmers) == (1, 0)


@pytest.mark.parametrize("k", [16, 32])
def test_all_T_kmer_is_kept(k):
    """An all-T k-mer of k = 16 j has the sentinel's bits in every word."""
    seqs = ["T" * (k + 3), "ACGTTGCA" * 6 + "T" * k]
    keys, valid = td.pack_windows(td.prepare_device_codes(seqs, k, "cpu"), k)
    all_ones = (keys == -1).all(dim=1)
    assert (all_ones & valid).any() and (all_ones & ~valid).any()
    dev = td.build_sbwt_device(seqs, k, "cpu")
    _assert_equals_host_build(dev, seqs, k)
    sb = SBWT(dev, np.zeros((4, 0), np.uint8), dev.n_nodes, None)
    assert sb.search("T" * k) == OracleIndex(seqs, k).search("T" * k) >= 0


def test_source_budget_error():
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), size=20)) for _ in range(50)]
    with pytest.raises(ValueError, match="source budget"):
        td.build_sbwt_device(seqs, 8, "cpu", src_pad=4)
    with pytest.raises(ValueError, match="source budget"):
        SBWT.build_on_device(seqs, 8, "cpu", src_pad=4)
    td.build_sbwt_device(seqs, 8, "cpu", src_pad=1 << 20)  # a budget that holds


def test_k_above_255_is_refused():
    with pytest.raises(ValueError, match="MAX_KMER_LENGTH"):
        td.build_sbwt_device(["A" * 300], 256, "cpu")


def test_prepared_codes_are_reusable():
    seqs, k = _seqs(1)
    codes = td.prepare_device_codes(seqs, k, "cpu")
    assert codes.dtype == torch.int8 and int((codes < 0).sum()) == len(seqs)
    a = td.build_sbwt_device(None, k, "cpu", prepared=codes)
    b = td.build_sbwt_device([encode(s) for s in seqs], k, "cpu")
    assert torch.equal(a.rank_tbl, b.rank_tbl) and torch.equal(a.sgs_tbl, b.sgs_tbl)


# ---- each plain version alone against the matching JAX helper -------------


def _numpy_windows(codes, k):
    """Keys of every window by plain loops: uint32 [m, W], bool [m]."""
    m, W = len(codes) - k + 1, -(-k // 16)
    keys = np.zeros((m, W), dtype=np.uint32)
    valid = np.ones(m, dtype=bool)
    for i in range(m):
        win = codes[i : i + k]
        if (win < 0).any():
            keys[i], valid[i] = 0xFFFFFFFF, False
            continue
        for j, c in enumerate(win):
            d = k - 1 - j
            keys[i, d // 16] |= np.uint32(int(c) << (30 - 2 * (d % 16)))
    return keys, valid


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [3, 16, 17, 32, 33, 70])
def test_pack_windows_plain_matches_numpy(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=3 * k + 40).astype(np.int8)
    codes[rng.integers(0, len(codes), size=3)] = -1
    codes[5 : 5 + k] = 3
    keys, valid = td.pack_windows_plain(torch.from_numpy(codes), k)
    want_keys, want_valid = _numpy_windows(codes, k)
    np.testing.assert_array_equal(_u32(keys), want_keys)
    np.testing.assert_array_equal(valid.numpy(), want_valid)


def _sorted_distinct(rng, n, k):
    """n random k-mers as sorted distinct key rows, int32 tensor [n', W]."""
    codes = rng.integers(0, 4, size=(n, k)).astype(np.int8)
    flat = np.concatenate([np.append(row, -1) for row in codes]).astype(np.int8)
    keys, valid = td.pack_windows_plain(torch.from_numpy(flat), k)
    keys = keys[valid]
    keys = keys[td.colex_order(keys)]
    return keys[td._differs_from_left(keys)]


def _jax_words(t):
    u = _u32(t)
    return [jnp.asarray(u[:, j]) for j in range(u.shape[1])]


@pytest.mark.parametrize("k", [5, 16, 31, 32, 40])
def test_membership_matches_jax_member_sorted(k):
    rng = np.random.default_rng(50 + k)
    dv = _sorted_distinct(rng, 200, k)
    n = len(dv)
    # queries: members, non-members, and repeats of both
    q = torch.cat([dv[rng.integers(0, n, size=60)], _sorted_distinct(rng, 60, k)])
    q = torch.cat([q, q[:30]])
    got = td._member(td.bv.word_u32(dv), td.bv.word_u32(q))
    want = jd._member_sorted(_jax_words(dv), n, _jax_words(q), jnp.ones(len(q), dtype=bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:60].all() and not got.all()


def _probe_input(k):
    """Sorted distinct k-mers of a de Bruijn-like set with shared suffixes."""
    rng = np.random.default_rng(70 + k)
    text = "".join(rng.choice(list("AC" if k < 8 else "ACGT"), size=400))
    codes = td.prepare_device_codes([text, text[50:120] + "G" + text[121:180]], k, "cpu")
    keys, valid = td.pack_windows_plain(codes, k)
    keys = keys[valid]
    keys = keys[td.colex_order(keys)]
    return keys[td._differs_from_left(keys)]


def _merge_identity(dv, k):
    """edge_src_probe's outputs as the kernel's sorted merge derives them,
    each key an integer (word 0 most significant): the lower bound of
    pred(j) = the key without its last char, shifted up one char, in the
    list with every key's first char cleared. Checks on the way that pred
    is strictly increasing within each run of equal last char and that a
    lower bound that equals pred(j) is a suffix-group start. Returns uint8
    edges, bool group starts, bool sources, as numpy arrays."""
    W = dv.shape[1]
    bits = 32 * W
    first = 32 * (W - 1 - ((k - 1) >> 4)) + 30 - 2 * ((k - 1) & 15)
    vals = [sum(int(w) << (32 * (W - 1 - j)) for j, w in enumerate(row)) for row in _u32(dv)]
    masked = [v & ~(3 << first) for v in vals]
    pred = [(v << 2) & ((1 << bits) - 1) for v in vals]
    last = [v >> (bits - 2) for v in vals]
    n = len(vals)
    assert all(last[j] < last[j + 1] or pred[j] < pred[j + 1] for j in range(n - 1))
    gstart = np.array([i == 0 or masked[i] != masked[i - 1] for i in range(n)])
    edges = np.zeros(n, dtype=np.uint8)
    is_src = np.ones(n, dtype=bool)
    for j in range(n):
        lb = bisect.bisect_left(masked, pred[j])
        if lb < n and masked[lb] == pred[j]:
            assert gstart[lb]
            edges[lb] |= 1 << last[j]
            is_src[j] = False
    return edges, gstart, is_src


@pytest.mark.parametrize("k", [4, 16, 17, 30, 33, 64, 255])
def test_edge_src_merge_identity(k):
    """The identity the edge_src_probe kernel's merge rests on: one lower
    bound a k-mer gives the edges, group starts and sources of the plain
    version (held to the JAX stages in the test below)."""
    dv = _probe_input(k)
    edges, gstart, is_src = _merge_identity(dv, k)
    want = td.edge_src_probe_plain(dv, k)
    np.testing.assert_array_equal(edges, want[0].numpy())
    np.testing.assert_array_equal(gstart, want[1].numpy())
    np.testing.assert_array_equal(is_src, want[2].numpy())
    assert edges.any() and not is_src.all()


@pytest.mark.parametrize("k", [4, 9, 16, 31, 32, 33, 64])
def test_edge_src_probe_plain_matches_jax_stages(k):
    """Suffix-group starts, edges and sources as stages :221-245 of the JAX
    program compute them, on a de Bruijn-like set with shared suffixes; the
    kernel's merge identity gives the same."""
    dv = _probe_input(k)
    edges, gstart, is_src = td.edge_src_probe_plain(dv, k)
    for got, want in zip(_merge_identity(dv, k), (edges, gstart, is_src)):
        np.testing.assert_array_equal(got, want.numpy())
    n = len(dv)
    ws = _jax_words(dv)
    sf = jd._drop_first(ws, k)
    idx = jnp.arange(n)
    j_gstart = (idx == 0) | jd._neq_prev(sf)
    np.testing.assert_array_equal(gstart.numpy(), np.asarray(j_gstart))
    for c in range(4):
        present = jd._member_sorted(ws, n, jd._append_last(sf, jnp.uint32(c)), j_gstart)
        np.testing.assert_array_equal(((edges >> c) & 1).bool().numpy(),
                                      np.asarray(present & j_gstart))
    reps = [w[np.asarray(j_gstart)] for w in sf]
    has_pred = jd._member_sorted(reps, len(reps[0]), jd._shift_left2(ws),
                                 jnp.ones(n, dtype=bool))
    np.testing.assert_array_equal(is_src.numpy(), ~np.asarray(has_pred))
    assert not is_src.all() and (k < 8 or is_src.any())


@pytest.mark.parametrize("k", [1, 7, 16, 17, 32, 33, 48, 255])
def test_emit_dummies_plain_matches_jax_prefix_and_char_at(k):
    rng = np.random.default_rng(90 + k)
    src = _sorted_distinct(rng, 9, k)
    keys, lengths, edges = td.emit_dummies_plain(src, k)
    n_src = len(src)
    assert keys.shape == (n_src * k + 1, -(-k // 16))
    ws = _jax_words(src)
    got = _u32(keys)
    for l in range(k):
        rows = slice(l, n_src * k, k)
        np.testing.assert_array_equal(got[rows], np.stack(jd._prefix(ws, k, l), axis=1))
        np.testing.assert_array_equal(edges[rows].numpy(), np.asarray(jd._char_at(ws, k - 1 - l)))
        assert (lengths[rows] == l).all()
    assert not got[-1].any() and lengths[-1] == 0 and edges[-1] == -1


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 64, 100])
def test_finalize_tables_plain_matches_jax_packing(T, streaming):
    """Bit packing and popcounts against _pack_bits_words and _rank_rows;
    one extra word when 32 divides T."""
    k = 20
    rng = np.random.default_rng(T)
    keys = _sorted_distinct(rng, 3 * T, k)[:T]
    lengths = torch.full((T,), k, dtype=torch.int32)
    edges = torch.from_numpy(rng.integers(0, 16, size=T).astype(np.uint8))
    rank_words, pops, sgs_words = td.finalize_tables_plain(keys, lengths, edges, k, streaming)
    n_words = T // 32 + 1
    assert rank_words.shape == pops.shape == (4 * n_words,)
    for c in range(4):
        words = jd._pack_bits_words(jnp.asarray(((edges >> c) & 1).bool().numpy()), n_words)
        rows = np.asarray(jd._rank_rows(words))
        part = slice(c * n_words, (c + 1) * n_words)
        np.testing.assert_array_equal(rank_words[part].numpy(), rows[:, 0])
        cum = torch.cumsum(pops[part], 0) - pops[part]
        np.testing.assert_array_equal(cum.numpy(), rows[:, 1])
    if not streaming:
        assert sgs_words is None
        return
    sf = jd._drop_first(_jax_words(keys), k)
    marks = (jnp.arange(T) == 0) | jd._neq_prev(sf)
    np.testing.assert_array_equal(_u32(sgs_words),
                                  np.asarray(jd._pack_bits_words(marks, n_words)))


@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_colex_order_is_unsigned_with_length_ties(W):
    rng = np.random.default_rng(W)
    vals = rng.integers(0, 2**32, size=(300, W), dtype=np.uint64).astype(np.uint32)
    vals[:40] = 0xFFFFFFFF  # the sentinel sorts last
    vals[40:80, 0] = 0x80000000  # sign bit set: after every smaller word
    vals[80:120] = vals[120:160]  # ties, broken by length
    lengths = rng.integers(0, 50, size=300).astype(np.int32)
    keys = torch.from_numpy(vals.view(np.int32))
    perm = td.colex_order(keys, torch.from_numpy(lengths)).numpy()
    rows = [tuple(int(x) for x in vals[i]) + (int(lengths[i]),) for i in range(300)]
    assert [rows[i] for i in perm] == sorted(rows)
    perm = td.colex_order(keys).numpy()
    assert [rows[i][:W] for i in perm] == sorted(r[:W] for r in rows)


@pytest.mark.parametrize("call", [
    lambda t: kernels.pack_windows(t["codes"], 5),
    lambda t: kernels.edge_src_probe(t["keys"], 5),
    lambda t: kernels.emit_dummies(t["keys"], 5),
    lambda t: kernels.finalize_tables(t["keys"], t["len"], t["edges"], 5, True),
], ids=list(kernels.BUILD_OPS))
def test_build_wrappers_refuse_cpu_tensors(call):
    tensors = {"codes": torch.zeros(20, dtype=torch.int8),
               "keys": torch.zeros((4, 1), dtype=torch.int32),
               "len": torch.zeros(4, dtype=torch.int32),
               "edges": torch.zeros(4, dtype=torch.uint8)}
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        call(tensors)
    assert kernels.LAUNCHES == before


# ---- the facade -------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list("ACGT"), size=1500)) for _ in range(2)]
    k = 11
    return (seqs, k, SBWT.build_on_device(seqs, k, "cpu", precalc_k=3),
            SBWT.build(seqs, k, "cpu", precalc_k=3))


def _reads(seqs, k, rng, n=48, L=40):
    enc = encode_query(seqs[0])
    starts = rng.integers(0, len(enc) - L, size=n)
    codes = enc[starts[:, None] + np.arange(L)]
    codes[::3] = rng.integers(0, 4, size=(len(codes[::3]), L))
    codes[1::4, L // 2 :] = rng.integers(0, 4, size=(len(codes[1::4]), L - L // 2))
    return codes


def test_build_on_device_facade_equals_build(pair, tmp_path):
    seqs, k, a, b = pair
    assert a.variant == "plain-matrix" and a.get_precalc_k() == 3
    assert a.number_of_subsets() == b.number_of_subsets()
    assert a.number_of_kmers() == b.number_of_kmers()
    np.testing.assert_array_equal(a._bits_packed, b._bits_packed)
    np.testing.assert_array_equal(a._sgs_packed, b._sgs_packed)
    np.testing.assert_array_equal(a.C, b.C)
    np.testing.assert_array_equal(a.get_precalc(), b.get_precalc())
    rng = np.random.default_rng(5)
    qs = rng.integers(0, 4, size=(200, k)).astype(np.int8)
    qs[:100] = _reads(seqs, k, rng, 100, k)
    want = b.search_batch(qs)
    np.testing.assert_array_equal(a.search_batch(qs), want)
    assert 30 <= (want >= 0).sum() < 200
    for fmt in ("cpp", "native"):
        path = str(tmp_path / f"dev.{fmt}")
        save(path, a, fmt)
        back = load(path, "cpu")
        np.testing.assert_array_equal(back.search_batch(qs), want)
    # the reference's format has one byte layout: both builds write it alike
    save(str(tmp_path / "host.cpp"), b, "cpp")
    assert (tmp_path / "dev.cpp").read_bytes() == (tmp_path / "host.cpp").read_bytes()


def test_build_on_device_takes_turbo_and_variants(pair):
    seqs, k, a, b = pair
    reads = _reads(seqs, k, np.random.default_rng(6))
    want = b.streaming_search_batch(reads)
    assert 0.2 < (want >= 0).mean() < 1.0
    np.testing.assert_array_equal(a.streaming_search_batch(reads), want)
    vs = a.to_variant("rrr-split")
    assert vs.get_precalc_k() == 3
    np.testing.assert_array_equal(vs.streaming_search_batch(reads), want)
    assert a.enable_turbo(2) == 2
    np.testing.assert_array_equal(a.streaming_search_batch(reads), want)
    a._turbo = None


def test_build_on_device_without_streaming_support():
    seqs, k = _seqs(2)
    a = SBWT.build_on_device(seqs, k, "cpu", streaming_support=False)
    b = SBWT.build(seqs, k, "cpu", streaming_support=False)
    assert not a.has_streaming_query_support()
    np.testing.assert_array_equal(a._bits_packed, b._bits_packed)
    assert a._n_sgs == b._n_sgs == 0 and len(a._sgs_packed) == 0
