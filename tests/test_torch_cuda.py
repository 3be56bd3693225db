"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one and no JAX, run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Inputs come
from numpy seeds; every output is an integer, so equality is exact.
"""
import numpy as np
import pytest
import torch

from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.construct import device as td
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu_torch.models.wide import WideMatrixIndex, from_packed_rows_wide
from sbwt_tpu_torch.ops import bitvector as bv
from sbwt_tpu_torch.ops import search as ts
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.utils.dna import encode_query

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _reads(g, rng, B, L, k):
    enc = encode_query(g)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    for i in range(0, B, 2):
        s = int(rng.integers(0, len(g) - L))
        codes[i] = enc[s : s + L]
    for i in range(1, B, 4):  # chimeric: restarts resolve real k-mers
        cut = int(rng.integers(1, L - k))
        s = int(rng.integers(0, len(g) - L))
        codes[i, cut:] = enc[s : s + L - cut]
    codes[3::5, int(rng.integers(0, L))] = -1
    codes[1::3, 5:9] |= 4
    lengths = np.full(B, L, np.int32)
    lengths[::7] = rng.integers(0, L + 1, size=len(lengths[::7]))
    return codes, lengths


@pytest.mark.parametrize("k,p", [(14, 6), (31, 13), (36, 3), (8, 8)])
def test_kernels_equal_plain_versions(cuda, k, p):
    rng = np.random.default_rng(k)
    g = "".join(rng.choice(list("ACGT"), size=5000))
    sb = SBWT.build([g], k, cuda)
    di = sb.device_index
    pre = kernels.precalc_fill("plain-matrix", di.kernel_desc(cuda), di.C, di.n_nodes, p)
    assert torch.equal(pre, tm.precalc_fill_plain(di, p))
    tm.with_precalc(di, p)
    codes, lengths = _reads(g, rng, 2048, k + 60, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    km = c[:, :k].contiguous()
    assert torch.equal(ts.search_batch(di, km), ts.search_batch_plain(di, km))
    succ = tt.succ1(di)
    assert torch.equal(succ, tt.succ1_plain(di))
    assert torch.equal(tt.build_seed_bits(di.precalc, p), tt.seed_bits_plain(di.precalc, p))
    for arity in (1, 2, 3):
        turbo = tt.build_turbo(di, arity)
        assert torch.equal(turbo.tbl, tt.compose_plain(succ, arity))
        got = tt.turbo_streaming_search(turbo, di, c, n)
        torch.cuda.synchronize()
        assert torch.equal(got, tt.turbo_streaming_search_plain(turbo, di, c, n))


@pytest.mark.parametrize("variant", VARIANT_NAMES)
@pytest.mark.parametrize("k,p", [(14, 6), (9, 9), (12, 0)])
def test_lf_kernels_equal_plain_versions(cuda, variant, k, p):
    """The variant's K14 and K1 instances against their plain versions."""
    rng = np.random.default_rng(100 + k + p)
    g = "".join(rng.choice(list("ACGT"), size=4000))
    sb = SBWT.build([g], k, cuda, precalc_k=p).to_variant(variant)
    di = sb.device_index
    codes, lengths = _reads(g, rng, 1024, k + 40, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    got = ts.streaming_search(di, c, n)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.streaming_search_plain(di, c, n))
    km = c[:, :k].contiguous()
    assert torch.equal(ts.search_batch(di, km), ts.search_batch_plain(di, km))
    q = min(k, 5)
    ref = tm.precalc_fill_plain(di, q)
    tm.with_precalc(di, q)
    assert torch.equal(di.precalc, ref)


def _rank_op_checks(di, c, n, rng):
    """partial_search (from the full interval and from given ones), succ1
    (all columns, a sample, both layouts) and forward against their plain
    versions on one index."""
    got = ts.partial_search_batch(di, c, n)
    want = ts.partial_search_plain(di, c, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    start = torch.stack(got[:2], dim=1)
    tail = c[:, 3:].contiguous()
    for g, w in zip(ts.partial_search_batch(di, tail, n, start),
                    ts.partial_search_plain(di, tail, n, start)):
        assert torch.equal(g, w)
    succ = tt.succ1(di)
    assert succ.dtype == di.pos_dtype and torch.equal(succ, tt.succ1_plain(di))
    assert torch.equal(tt.succ1(di, row_major=True), succ.t())
    cols = torch.from_numpy(rng.integers(0, di.n_nodes, size=999)).to(di.device)
    chars = torch.from_numpy(rng.integers(0, 4, size=999)).to(di.device)
    fwd = ts.forward_batch(di, cols, chars)
    assert fwd.dtype == di.pos_dtype
    assert torch.equal(fwd, ts.extend_from_column(di, cols, chars).to(di.pos_dtype))


@pytest.mark.parametrize("variant", VARIANT_NAMES)
@pytest.mark.parametrize("k,p", [(14, 6), (9, 9), (36, 3)])
def test_variant_turbo_kernels_equal_plain_versions(cuda, variant, k, p):
    """succ1, turbo_stream and partial_search of every variant's rank type
    against their plain versions, and the table against plain-matrix's."""
    rng = np.random.default_rng(500 + k + p)
    g = "".join(rng.choice(list("ACGT"), size=3000)) + "ACGT" * 60
    plain = SBWT.build([g], k, cuda, precalc_k=p)
    sb = plain.to_variant(variant)
    di = sb.device_index
    codes, lengths = _reads(g, rng, 1024, k + 40, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    _rank_op_checks(di, c, n, rng)
    lf = ts.streaming_search(di, c, n)
    for arity in (1, 2, 3):
        assert sb.enable_turbo(arity) == arity
        assert torch.equal(sb._turbo.tbl, tt.build_turbo(plain.device_index, arity).tbl)
        got = tt.turbo_streaming_search(sb._turbo, di, c, n)
        torch.cuda.synchronize()
        assert torch.equal(got, tt.turbo_streaming_search_plain(sb._turbo, di, c, n))
        assert torch.equal(got, lf)
    counters = [kernels.lf_counter(op, variant) for op in ("succ1", "turbo_stream", "partial_search")]
    assert all(kernels.LAUNCHES[name] > 0 for name in counters)


def _offset_counts(wide, offset):
    """The same index with every cumulative count raised by ``offset``: its
    ranks are the real ones plus the offset, past 32 bits."""
    tbl = wide.rank_tbl.clone()
    cum = ((tbl[:, 2].long() << 32) | (tbl[:, 1].long() & 0xFFFFFFFF)) + offset
    low = cum & 0xFFFFFFFF
    tbl[:, 1] = torch.where(low >= 2**31, low - 2**32, low).int()
    tbl[:, 2] = (cum >> 32).int()
    return WideMatrixIndex(tbl, wide.sgs_tbl, wide.C, wide.precalc, n_nodes=wide.n_nodes,
                           n_kmers=wide.n_kmers, k=wide.k, precalc_k=wide.precalc_k,
                           n_words=wide.n_words, has_streaming=wide.has_streaming)


@pytest.mark.parametrize("k,p", [(14, 6), (9, 9), (31, 13), (36, 3)])
def test_wide_kernels_equal_plain_versions_and_narrow(cuda, k, p):
    """The WideMatrix instances against their plain versions and against
    the narrow plain-matrix kernels on the same bits."""
    rng = np.random.default_rng(600 + k + p)
    g = "".join(rng.choice(list("ACGT"), size=5000)) + "ACGT" * 60
    sb = SBWT.build([g], k, cuda, precalc_k=p)
    narrow = sb.device_index
    words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
    wide = from_packed_rows_wide(words, narrow.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                 k, narrow.n_kmers, cuda, precalc_k=p)
    assert wide.precalc.dtype == torch.int64 and torch.equal(wide.precalc, narrow.precalc.long())
    assert torch.equal(wide.precalc, tm.precalc_fill_plain(wide, p))
    codes, lengths = _reads(g, rng, 2048, k + 60, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    km = c[:, :k].contiguous()
    got = ts.search_batch(wide, km)
    assert got.dtype == torch.int64 and torch.equal(got, ts.search_batch_plain(wide, km))
    assert torch.equal(got, ts.search_batch(narrow, km).long())
    lf = ts.streaming_search(wide, c, n)
    torch.cuda.synchronize()
    assert lf.dtype == torch.int64 and torch.equal(lf, ts.streaming_search_plain(wide, c, n))
    assert torch.equal(lf, ts.streaming_search(narrow, c, n).long())
    _rank_op_checks(wide, c, n, rng)
    turbo = tt.build_turbo(wide, 3)
    assert isinstance(turbo, tt.WideTurboIndex) and turbo.arity == 1
    assert torch.equal(turbo.tbl, tt.build_turbo(narrow, 1).tbl.long())
    assert torch.equal(turbo.seed_bits, tt.seed_bits_plain(wide.precalc, p))
    got = tt.turbo_streaming_search(turbo, wide, c, n)
    torch.cuda.synchronize()
    assert torch.equal(got, tt.turbo_streaming_search_plain(turbo, wide, c, n))
    assert torch.equal(got, lf)
    for offset in (2**31 - 3, 2**32 - 1, 2**33 + 2**31 + 9):
        shifted = _offset_counts(wide, offset)
        fill = kernels.precalc_fill(kernels.WIDE, shifted.kernel_desc(cuda), shifted.C,
                                    shifted.n_nodes, 1)
        assert torch.equal(fill, tm.precalc_fill_plain(shifted, 1)) and int(fill.max()) > 2**31


@pytest.mark.parametrize("k,p", [(14, 6), (9, 9), (10, 7), (12, 8), (31, 13)])
def test_fast_search_equals_plain_version(cuda, k, p):
    """fast_search on the narrow tables of arity 1-3 and the wide arity-1
    one, against its plain version (k - p = 0, 1, 2, 3 and 4, 8, 18 mod
    the arity); where needs_slow is false, ans is K1's search answer.
    compute_dummy_node_marks launches succ1 once a BFS level."""
    rng = np.random.default_rng(700 + k + p)
    g = "".join(rng.choice(list("ACGT"), size=4000)) + "ACGT" * 60
    sb = SBWT.build([g, g[500:900], g[2000:2040]], k, cuda, precalc_k=p)
    di = sb.device_index
    codes, _ = _reads(g, rng, 4096, k + 20, k)
    km = torch.from_numpy(np.ascontiguousarray(codes[:, :k])).to(cuda)
    want_search = ts.search_batch(di, km)
    words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
    wide = from_packed_rows_wide(words, di.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                 k, di.n_kmers, cuda, precalc_k=p)
    turbos = [tt.build_turbo(di, a) for a in (1, 2, 3)] + [tt.build_turbo(wide, 1)]
    for turbo in turbos:
        name = kernels.FAST_SEARCH[turbo.pos_dtype == torch.int64]
        before = kernels.LAUNCHES[name]
        ans, slow = tt.fast_search(turbo, km)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        want = tt.fast_search_plain(turbo, km)
        assert ans.dtype == turbo.pos_dtype and slow.dtype == torch.bool
        assert torch.equal(ans, want[0]) and torch.equal(slow, want[1])
        assert torch.equal(ans[~slow].long(), want_search[~slow].long())
        assert 0 < int((ans >= 0).sum()) and int((ans == -1).sum()) > 0
    before = kernels.LAUNCHES["succ1[plain-matrix]"]
    marks = sb.compute_dummy_node_marks()
    levels = kernels.LAUNCHES["succ1[plain-matrix]"] - before
    assert 1 <= levels <= k - 1
    assert int(marks.sum()) == sb.number_of_subsets() - sb.number_of_kmers()
    dump = sb.reconstruct_all_kmers()
    assert [dump[i * k] == "$" for i in range(sb.number_of_subsets())] == marks.tolist()
    wsb = SBWT(wide, sb._bits_packed, di.n_nodes, sb._sgs_packed)
    assert np.array_equal(wsb.compute_dummy_node_marks(), marks)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("k", [4, 16, 30, 32, 33, 51, 64, 255])
def test_build_kernels_equal_plain_versions(cuda, k):
    """K19's four kernels against their plain versions, on reads with N,
    an all-T stretch (a valid key of all ones at k = 16 j) and repeats."""
    rng = np.random.default_rng(300 + k)
    seqs = ["".join(rng.choice(list("ACGTN"), p=[0.245, 0.245, 0.245, 0.245, 0.02], size=700))
            for _ in range(6)] + ["T" * (k + 40), "ACGT" * (k // 2 + 5)]
    codes = td.prepare_device_codes(seqs, k, cuda)
    keys, valid = kernels.pack_windows(codes, k)
    _same((keys, valid), td.pack_windows_plain(codes, k))
    keys = keys[valid]
    keys = keys[td.colex_order(keys)]
    dv = keys[td._differs_from_left(keys)]
    probe = kernels.edge_src_probe(dv, k)
    _same(probe, td.edge_src_probe_plain(dv, k))
    src = dv[probe[2]]
    dummies = kernels.emit_dummies(src, k)
    _same(dummies, td.emit_dummies_plain(src, k))
    dd, dl, _ = dummies
    order = td.colex_order(dd, dl)
    dd, dl = dd[order], dl[order]
    head = td._differs_from_left(dd, dl)
    a_keys = torch.cat([dd[head], dv])
    a_len = torch.cat([dl[head], torch.full((len(dv),), k, dtype=torch.int32, device=cuda)])
    a_edges = torch.from_numpy(rng.integers(0, 16, size=len(a_len)).astype(np.uint8)).to(cuda)
    order = td.colex_order(a_keys, a_len)
    a_keys, a_len = a_keys[order], a_len[order]
    for streaming in (True, False):
        _same(kernels.finalize_tables(a_keys, a_len, a_edges, k, streaming),
              td.finalize_tables_plain(a_keys, a_len, a_edges, k, streaming))
    torch.cuda.synchronize()


@pytest.mark.parametrize("k,n_seqs,size", [(7, 1, 3000), (30, 3, 4000), (32, 40, 150),
                                           (33, 2, 2000), (255, 1, 900), (8, 300, 20)])
def test_device_build_equals_host_build(cuda, k, n_seqs, size):
    rng = np.random.default_rng(400 + k)
    seqs = ["".join(rng.choice(list("ACGT"), size=size)) for _ in range(n_seqs)]
    a = SBWT.build_on_device(seqs, k, cuda, precalc_k=min(k, 5))
    b = SBWT.build(seqs, k, cuda, precalc_k=min(k, 5))
    da, db = a.device_index, b.device_index
    assert (da.n_nodes, da.n_kmers, da.n_words) == (db.n_nodes, db.n_kmers, db.n_words)
    for name in ("rank_tbl", "sgs_tbl", "C", "precalc"):
        assert torch.equal(getattr(da, name), getattr(db, name)), name
    np.testing.assert_array_equal(a._bits_packed, b._bits_packed)
    np.testing.assert_array_equal(a._sgs_packed, b._sgs_packed)
    assert all(kernels.LAUNCHES[op] > 0 for op in kernels.BUILD_OPS)


# ---------------------------------------------------------------------------
# K20, the row-sharded (TP) kernels, and K21, the gather probe. Every model
# slot lies on the one card: shard selection and rebasing run for real,
# peer loads do not (a second card would add them).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_model", [1, 3, 4, 8])
def test_sharded_kernels_equal_plain_versions(cuda, n_model):
    from sbwt_tpu_torch.parallel import sharded

    rng = np.random.default_rng(500 + n_model)
    k, p = 14, 6
    g = "".join(rng.choice(list("ACGT"), size=5000))
    di = SBWT.build([g], k, cuda, precalc_k=p).device_index
    codes, lengths = _reads(g, rng, 1500, k + 60, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    km = c[:, :k].contiguous()
    mesh = sharded.make_mesh(2, n_model, [cuda])
    view = sharded.shard_index_rows(di, mesh).views[0]
    before = dict(kernels.LAUNCHES)
    got = ts.search_batch(view, km)
    assert torch.equal(got, ts.search_batch_plain(view, km))
    assert torch.equal(got, ts.search_batch(di, km))
    got = ts.streaming_search(view, c, n)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.streaming_search_plain(view, c, n))
    assert torch.equal(got, ts.streaming_search(di, c, n))
    for arity in (1, 2, 3):
        turbo = tt.build_turbo(di, arity)
        flat = tt.turbo_streaming_search(turbo, di, c, n)
        placed = sharded.shard_turbo_rows(turbo, mesh)
        got = sharded.tp_turbo_streaming_search(placed, di, c, n, mesh)
        torch.cuda.synchronize()
        assert torch.equal(got, flat)
        assert torch.equal(got[:750], tt.turbo_streaming_search_plain(placed.views[0], di, c[:750],
                                                                      n[:750]))
        if arity >= 2:
            built = sharded.build_turbo_sharded(di, mesh, arity)
            cols, rows = built.views[0].cols, 4**arity
            for m, shard in enumerate(built.views[0].tbl_shards):
                real = max(0, min(di.n_nodes, (m + 1) * cols) - m * cols)
                assert torch.equal(shard[: real * rows], turbo.tbl[m * cols * rows :][: real * rows])
                assert not shard[real * rows :].any()
                assert torch.equal(shard, tt.compose_plain(tt.succ1(di), arity, col0=m * cols,
                                                           n_cols=cols))
            assert torch.equal(sharded.tp_turbo_streaming_search(built, di, c, n, mesh), flat)
    for name in ("kmer_search[sharded-matrix]", "lf_stream[sharded-matrix]",
                 kernels.TURBO_SHARDED, kernels.COMPOSE_RANGE):
        assert kernels.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("width", [2, 8])
def test_gather_chain_equals_plain_version(cuda, width):
    from sbwt_tpu_torch.ops import gather_chain as gc

    rng = np.random.default_rng(width)
    tbl = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(40_000, width), dtype=np.int32)).to(cuda)
    idx0 = torch.from_numpy(rng.integers(0, 40_000, size=5000, dtype=np.int32)).to(cuda)
    before = kernels.LAUNCHES["gather_chain"]
    got = gc.gather_chain(tbl, idx0, 64)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_chain"] == before + 1
    assert torch.equal(got, gc.gather_chain_plain(tbl, idx0, 64))
    assert torch.equal(gc.gather_chain(tbl, idx0, 0), idx0)
