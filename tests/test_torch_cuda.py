"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one and no JAX, run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Inputs come
from numpy seeds; every output is an integer, so equality is exact.
"""
import itertools

import numpy as np
import pytest
import torch

from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.construct import device as td
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.models import subsetrank as tsr
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu_torch.models.variants import GenericIndex, build_generic_index
from sbwt_tpu_torch.models.wide import WideMatrixIndex, from_packed_rows_wide
from sbwt_tpu_torch.ops import bitvector as bv
from sbwt_tpu_torch.ops import search as ts
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.utils.dna import encode_query

import search_cases as sc
import subsetwt_cases as swc

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
    # forward: one char a node, nodes 0 and n - 1 by every char among them
    ends = np.repeat([0, di.n_nodes - 1], 4)
    cols = torch.from_numpy(np.concatenate([ends, rng.integers(0, di.n_nodes, size=999)])).to(di.device)
    chars = torch.from_numpy(np.concatenate([np.tile(np.arange(4), 2),
                                             rng.integers(0, 4, size=999)])).to(di.device)
    name = kernels.lf_counter("forward", di.variant)
    before = kernels.LAUNCHES[name]
    fwd = ts.forward_batch(di, cols, chars)
    assert kernels.LAUNCHES[name] == before + 1
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


@pytest.mark.parametrize("variant", VARIANT_NAMES[1:])
@pytest.mark.parametrize("size,k", [(12, 5), (9000, 7), (40000, 6)])
def test_succ1_spans_equal_plain_version(cuda, variant, size, k):
    """succ1 over all columns of each compressed variant, by warp over spans
    of 1024 columns 32 a step, against its plain version and plain-matrix's
    kernel: fewer than 32 columns; column counts off 32 and off the span;
    suffix groups that straddle a step's and a span's first column."""
    rng = np.random.default_rng(800 + size + k)
    g = "".join(rng.choice(list("ACGT"), size=size))
    plain = SBWT.build([g], k, cuda)
    di = plain.to_variant(variant).device_index
    n = di.n_nodes
    name = kernels.lf_counter("succ1", variant)
    before = kernels.LAUNCHES[name]
    succ = tt.succ1(di)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(succ, tt.succ1_plain(di))
    assert torch.equal(succ, tt.succ1(plain.device_index))
    if size == 12:
        assert n < 32
        return
    starts = np.asarray(plain.suffix_group_starts, dtype=bool)
    straddle = [b for b in range(32, n, 32) if not starts[b]]
    assert n % 32 and straddle
    if n > 1024:
        assert n % 1024 and any(b % 1024 == 0 for b in straddle)


@pytest.mark.parametrize("variant", ["plain-concat", "mef-concat"])
def test_dense_concat_succ1_agrees_with_oracle(cuda, variant):
    """F1 at the card's span decode: every column holds all four chars, so
    each is its own suffix group and rank(c, i) = i, as the string oracle
    counts; the JAX package's select0 loses the ninth zero of such a
    window."""
    n = 3000
    bits = np.ones((4, n), dtype=bool)
    di = build_generic_index(variant, bits, np.ones(n, dtype=bool), 3, 0, cuda)
    succ = tt.succ1(di)
    C = di.C.tolist()
    for c in range(4):
        assert succ[c].tolist() == [C[c] + i for i in range(n)]
    assert torch.equal(succ, tt.succ1_plain(di))


RANK_CASES = ("runs", "sets_1_4", "dense", "random")


def _rank_case_bits(case, rng):
    """[4, n] bits of one case, followed by empty columns up to n, the
    ones' count plus one, raised until neither 4n nor n is a multiple of
    15, so that the RRR vectors of every rank type end inside a block.
    runs: runs of 1-63 equal bits, so RRR blocks of class 0 and 15;
    sets_1_4: sets of one char, of all four and empty ones (one '$');
    dense: every set of 4."""
    n = {"runs": 2003, "sets_1_4": 1999, "dense": 3001, "random": 4093}[case]
    if case == "runs":
        bits = np.zeros((4, n), dtype=bool)
        for c in range(4):
            at, on = 0, bool(rng.integers(2))
            while at < n:
                run = int(rng.integers(1, 64))
                bits[c, at:at + run] = on
                at, on = at + run, not on
    elif case == "sets_1_4":
        kind = rng.integers(0, 6, size=n)  # 0-3 one char, 4 all four, 5 empty
        bits = np.zeros((4, n), dtype=bool)
        bits[kind[kind < 4], np.flatnonzero(kind < 4)] = True
        bits[:, kind == 4] = True
    elif case == "dense":
        bits = np.ones((4, n), dtype=bool)
    else:
        bits = rng.random((4, n)) < 0.4
    # empty columns after the case's own, so that the ones number fewer
    # than the columns: every LF interval then stays inside [0, n)
    m = int(bits.sum()) + 1
    while (4 * m) % 15 == 0 or m % 15 == 0:
        m += 1
    return np.concatenate([bits, np.zeros((4, max(0, m - n)), dtype=bool)], axis=1)


@pytest.mark.parametrize("variant", ["rrr-matrix", "rrr-split", "plain-concat", "mef-concat",
                                     "rrr-subsetwt"])
@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_cases_kernels_equal_plain_versions(cuda, variant, case):
    """The RRR and concat rank types' device ranks (the register decode of
    RRR15, ConcatRank's one-walk rank_pair) through every kernel that
    inlines them, against the plain versions, at bit patterns that reach
    their edges: RRR blocks of class 0 and 15, vectors that end inside a
    block, concat sets of 1 and 4 symbols at a sample edge of L, and sets
    that straddle a 15-bit block and a 240-bit superblock of the tree's
    first level. forward ranks every (column, char) pair. K14 is held on
    real indexes (test_lf_kernels_low_complexity_equal_plain_versions)."""
    rng = np.random.default_rng(RANK_CASES.index(case) + 77)
    bits = _rank_case_bits(case, rng)
    n = bits.shape[1]
    assert (4 * n) % 15 and n % 15 and int(bits.sum()) < n
    flat = np.concatenate([bits.ravel(), np.zeros(-(4 * n) % 15, dtype=bool)])
    ones = flat.reshape(-1, 15).sum(axis=1)
    if case in ("runs", "dense"):
        assert (ones == 15).any() and (case == "dense" or (ones == 0).any())
    sizes = np.maximum(bits.sum(axis=0), 1)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    if case == "sets_1_4":
        edge = sizes[(np.arange(n) % 8 == 0) | (np.arange(n) % 8 == 7)]
        assert (edge == 1).any() and (edge == 4).any()
    if case != "dense":
        assert ((starts % 15) + sizes > 15).any() and ((starts % 240) + sizes > 240).any()
    di = build_generic_index(variant, bits, np.ones(n, dtype=bool), 8, 0, cuda)

    def launched(op, fn):
        name = kernels.lf_counter(op, variant)
        before = kernels.LAUNCHES[name]
        out = fn()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] > before, name
        return out

    cols = torch.arange(n, device=cuda).repeat(4)
    chars = torch.arange(4, device=cuda).repeat_interleave(n)
    fwd = launched("forward", lambda: ts.forward_batch(di, cols, chars))
    assert torch.equal(fwd, ts.extend_from_column(di, cols, chars).to(di.pos_dtype))
    assert torch.equal(launched("succ1", lambda: tt.succ1(di)), tt.succ1_plain(di))
    pre = launched("precalc_fill", lambda: kernels.precalc_fill(
        variant, di.kernel_desc(cuda), di.C, di.n_nodes, 5))
    assert torch.equal(pre, tm.precalc_fill_plain(di, 5))
    km = torch.from_numpy(rng.integers(0, 4, size=(4096, 8)).astype(np.int8)).to(cuda)
    assert torch.equal(launched("kmer_search", lambda: ts.search_batch(di, km)),
                       ts.search_batch_plain(di, km))
    codes = torch.from_numpy(rng.integers(0, 4, size=(4096, 12)).astype(np.int8)).to(cuda)
    lengths = torch.from_numpy(rng.integers(0, 13, size=4096).astype(np.int32)).to(cuda)
    got = launched("partial_search", lambda: ts.partial_search_batch(di, codes, lengths))
    for g, w in zip(got, ts.partial_search_plain(di, codes, lengths)):
        assert torch.equal(g, w)


def _rrr_blocks(struct):
    """(length, classes of its blocks) of every RRR vector of a structure."""
    from sbwt_tpu_torch.ops.bv import RRRBV

    out = []
    for m in struct.modules():
        if isinstance(m, RRRBV):
            classes, _ = m._host_blocks()
            out.append((m.n_bits, classes[: (m.n_bits + 14) // 15]))
    return out


@pytest.mark.parametrize("variant", ["rrr-matrix", "rrr-split", "plain-concat", "mef-concat",
                                     "rrr-subsetwt"])
def test_lf_kernels_low_complexity_equal_plain_versions(cuda, variant):
    """K14, K1's fill and search and partial_search of the RRR and concat
    rank types on a real index of a genome with homopolymers and short
    tandem repeats beside random sequence, whose RRR vectors end inside a
    block and hold blocks of class 0 and 15. K14's chain needs an SBWT
    (on arbitrary bits an extension and a full search of the same k-mer
    may differ), hence a real index here and bit patterns in
    test_rank_cases_kernels_equal_plain_versions."""
    rng = np.random.default_rng(5)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    g = (rand(1500) + "A" * 200 + "ACGT" * 60 + rand(500) + "AC" * 100 + "GT" * 100 + rand(800)
         + "AAAAAAC" * 30 + rand(300))
    sb = SBWT.build([g], 12, cuda, precalc_k=4).to_variant(variant)
    indexes = [sb.device_index]
    if variant == "rrr-subsetwt":
        # a genome's index takes the sparse vectors, whose trees' RRR level
        # 0 holds no block of class 0 or 15 here; level 1 holds them, so
        # the kernels run that form too
        assert sb.device_index.struct.sparse
        indexes.append(_subsetwt_form(sb.device_index, "rrr-level1"))
    blocks = [b for di in indexes for b in _rrr_blocks(di.struct)]
    assert all(n % 15 for n, _ in blocks)
    classes = np.concatenate([c for _, c in blocks]) if blocks else np.zeros(0)
    assert (variant == "plain-concat") == (len(blocks) == 0)
    assert variant in ("plain-concat", "mef-concat") or (classes == 0).any()
    assert variant not in ("mef-concat", "rrr-subsetwt") or (classes == 15).any()
    codes, lengths = _reads(g, rng, 1024, 52, 12)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    for di in indexes:
        counters = {op: kernels.LAUNCHES[kernels.lf_counter(op, variant)]
                    for op in ("lf_stream", "precalc_fill", "kmer_search", "partial_search")}
        got = ts.streaming_search(di, c, n)
        torch.cuda.synchronize()
        assert torch.equal(got, ts.streaming_search_plain(di, c, n))
        km = c[:, :12].contiguous()
        assert torch.equal(ts.search_batch(di, km), ts.search_batch_plain(di, km))
        for g_, w in zip(ts.partial_search_batch(di, c, n), ts.partial_search_plain(di, c, n)):
            assert torch.equal(g_, w)
        ref = tm.precalc_fill_plain(di, 6)
        tm.with_precalc(di, 6)
        assert torch.equal(di.precalc, ref)
        assert all(kernels.LAUNCHES[kernels.lf_counter(op, variant)] > before
                   for op, before in counters.items())


# SubsetWTRank's device forms (csrc/subset_rank.cuh): (variant, sparse) of
# the plain rows, of rrr with the sparse vectors, of rrr with level 1 kept
SUBSETWT_FORMS = {"plain": ("plain-subsetwt", None), "rrr-sparse": ("rrr-subsetwt", True),
                  "rrr-level1": ("rrr-subsetwt", False)}


def _subsetwt_form(di, form):
    """The subset-WT index di with its structure rebuilt in a device form."""
    variant, sparse = SUBSETWT_FORMS[form]
    st = tsr.SubsetWTRank.from_bits(di.struct.to_bits(), variant.split("-")[0], di.device, sparse)
    return GenericIndex(st, di.sgs_tbl, di.C, di.precalc.clone(), variant=variant,
                        n_nodes=di.n_nodes, n_kmers=di.n_kmers, k=di.k, precalc_k=di.precalc_k,
                        has_streaming=di.has_streaming)


def _launched(op, variant, fn):
    """fn's output, checking that it launched the kernel op[variant]."""
    name = kernels.lf_counter(op, variant)
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] > before, name
    return out


@pytest.mark.parametrize("form", list(SUBSETWT_FORMS))
@pytest.mark.parametrize("case", list(swc.CASES))
def test_subsetwt_forms_rank_kernels_equal_plain_versions(cuda, form, case):
    """SubsetWTRank's device forms through the kernels that inline them, at
    bit patterns with empty sets, sets of four and vectors that end off a
    word, a block and a superblock (tests/subsetwt_cases.py, then empty
    columns so that every LF interval stays inside the columns): forward
    at every (column, char), succ1 by span, the p = 5 fill, kmer_search and
    partial_search, against their plain versions."""
    variant, sparse = SUBSETWT_FORMS[form]
    bits = swc.case_bits(case)
    m = int(bits.sum()) + 1
    while m % 15 == 0 or m % 32 == 0 or m % 240 == 0 or m < bits.shape[1]:
        m += 1
    bits = np.concatenate([bits, np.zeros((4, m - bits.shape[1]), dtype=bool)], axis=1)
    n = bits.shape[1]
    st = tsr.SubsetWTRank.from_bits(bits, variant.split("-")[0], cuda, sparse)
    di = build_generic_index(variant, bits, np.ones(n, dtype=bool), 8, 0, cuda, struct=st)
    rng = np.random.default_rng(n)
    cols = torch.arange(n, device=cuda).repeat(4)
    chars = torch.arange(4, device=cuda).repeat_interleave(n)
    fwd = _launched("forward", variant, lambda: ts.forward_batch(di, cols, chars))
    assert torch.equal(fwd, ts.extend_from_column(di, cols, chars).to(di.pos_dtype))
    assert torch.equal(_launched("succ1", variant, lambda: tt.succ1(di)), tt.succ1_plain(di))
    pre = _launched("precalc_fill", variant, lambda: kernels.precalc_fill(
        variant, di.kernel_desc(cuda), di.C, di.n_nodes, 5))
    assert torch.equal(pre, tm.precalc_fill_plain(di, 5))
    km = torch.from_numpy(rng.integers(0, 4, size=(4096, 8)).astype(np.int8)).to(cuda)
    assert torch.equal(_launched("kmer_search", variant, lambda: ts.search_batch(di, km)),
                       ts.search_batch_plain(di, km))
    codes = torch.from_numpy(rng.integers(0, 4, size=(4096, 12)).astype(np.int8)).to(cuda)
    lengths = torch.from_numpy(rng.integers(0, 13, size=4096).astype(np.int32)).to(cuda)
    got = _launched("partial_search", variant, lambda: ts.partial_search_batch(di, codes, lengths))
    for g, w in zip(got, ts.partial_search_plain(di, codes, lengths)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("form", list(SUBSETWT_FORMS))
@pytest.mark.parametrize("k,p", [(12, 4), (31, 8)])
def test_subsetwt_forms_stream_kernels_equal_plain_versions(cuda, form, k, p):
    """K14, K1's fill and search, partial_search, succ1, forward and K4
    over the variant's own tables, on a genome's index (homopolymers and
    tandem repeats beside random sequence) in each device form, against
    their plain versions and plain-matrix's answers."""
    variant, _ = SUBSETWT_FORMS[form]
    rng = np.random.default_rng(40 + k)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    g = rand(1200) + "A" * 150 + "ACGT" * 50 + rand(900) + "GT" * 80 + "AAAAAAC" * 20 + rand(700)
    plain = SBWT.build([g], k, cuda, precalc_k=p)
    sb = plain.to_variant(variant)
    if form == "rrr-level1":
        sb.device_index.struct = _subsetwt_form(sb.device_index, form).struct
    di = sb.device_index
    assert di.struct.sparse == (form == "rrr-sparse")
    codes, lengths = _reads(g, rng, 1024, k + 40, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    lf = _launched("lf_stream", variant, lambda: ts.streaming_search(di, c, n))
    assert torch.equal(lf, ts.streaming_search_plain(di, c, n))
    assert torch.equal(lf, ts.streaming_search(plain.device_index, c, n))
    km = c[:, :k].contiguous()
    assert torch.equal(_launched("kmer_search", variant, lambda: ts.search_batch(di, km)),
                       ts.search_batch_plain(di, km))
    ref = tm.precalc_fill_plain(di, p)
    _launched("precalc_fill", variant, lambda: tm.with_precalc(di, p))
    assert torch.equal(di.precalc, ref)
    counters = {op: kernels.LAUNCHES[kernels.lf_counter(op, variant)]
                for op in ("partial_search", "succ1", "forward", "turbo_stream")}
    _rank_op_checks(di, c, n, rng)
    for arity in (1, 2, 3):
        assert sb.enable_turbo(arity) == arity
        assert torch.equal(sb._turbo.tbl, tt.build_turbo(plain.device_index, arity).tbl)
        got = tt.turbo_streaming_search(sb._turbo, di, c, n)
        torch.cuda.synchronize()
        assert torch.equal(got, tt.turbo_streaming_search_plain(sb._turbo, di, c, n))
        assert torch.equal(got, lf)
    assert all(kernels.LAUNCHES[kernels.lf_counter(op, variant)] > before
               for op, before in counters.items())


SPLIT_VARIANTS = ("plain-split", "rrr-split", "mef-split")


@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
@pytest.mark.parametrize("case", list(swc.SPLIT_CASES))
def test_split_rank_kernels_equal_plain_versions(cuda, variant, case):
    """SplitRank's position-order Y through the kernels that inline it, at
    bit patterns with empty sets, sets of four, no unary column (dense),
    no branching one (all_unary) and Y lengths that are multiples of 64
    (tests/subsetwt_cases.py SPLIT_CASES, then empty columns so that every
    LF interval stays inside the columns): forward at every (column, char),
    succ1 by span, the p = 5 fill, kmer_search and partial_search, against
    their plain versions. forward and succ1 rank only below n, so they also
    run on the bits unpadded, where all_unary keeps Z empty (n_b = 0)."""
    bits = swc.case_bits(case)
    x_kind = variant.split("-")[0]
    m = int(bits.sum()) + 1
    while m % 15 == 0 or m % 32 == 0 or m % 240 == 0 or m < bits.shape[1]:
        m += 1
    padded = np.concatenate([bits, np.zeros((4, m - bits.shape[1]), dtype=bool)], axis=1)
    rng = np.random.default_rng(m)
    for b in (bits, padded):
        n = b.shape[1]
        st = tsr.SplitRank.from_bits(b, x_kind, "plain", cuda)
        assert st.n_b == int((b.sum(axis=0) != 1).sum())
        di = build_generic_index(variant, b, np.ones(n, dtype=bool), 8, 0, cuda, struct=st)
        cols = torch.arange(n, device=cuda).repeat(4)
        chars = torch.arange(4, device=cuda).repeat_interleave(n)
        fwd = _launched("forward", variant, lambda: ts.forward_batch(di, cols, chars))
        assert torch.equal(fwd, ts.extend_from_column(di, cols, chars).to(di.pos_dtype))
        assert torch.equal(_launched("succ1", variant, lambda: tt.succ1(di)), tt.succ1_plain(di))
    pre = _launched("precalc_fill", variant, lambda: kernels.precalc_fill(
        variant, di.kernel_desc(cuda), di.C, di.n_nodes, 5))
    assert torch.equal(pre, tm.precalc_fill_plain(di, 5))
    km = torch.from_numpy(rng.integers(0, 4, size=(4096, 8)).astype(np.int8)).to(cuda)
    assert torch.equal(_launched("kmer_search", variant, lambda: ts.search_batch(di, km)),
                       ts.search_batch_plain(di, km))
    codes = torch.from_numpy(rng.integers(0, 4, size=(4096, 12)).astype(np.int8)).to(cuda)
    lengths = torch.from_numpy(rng.integers(0, 13, size=4096).astype(np.int32)).to(cuda)
    got = _launched("partial_search", variant, lambda: ts.partial_search_batch(di, codes, lengths))
    for g, w in zip(got, ts.partial_search_plain(di, codes, lengths)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
@pytest.mark.parametrize("k,p", [(12, 4), (31, 8)])
def test_split_stream_kernels_equal_plain_versions(cuda, variant, k, p):
    """K14, K1's fill and search, partial_search, succ1, forward and K4's
    restarts over the variant's own tables, on a genome's index
    (homopolymers and tandem repeats beside random sequence) with Y in
    position order, against their plain versions and plain-matrix's
    answers; each kernel launched."""
    rng = np.random.default_rng(60 + k)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    g = rand(1200) + "A" * 150 + "ACGT" * 50 + rand(900) + "GT" * 80 + "AAAAAAC" * 20 + rand(700)
    plain = SBWT.build([g], k, cuda, precalc_k=p)
    sb = plain.to_variant(variant)
    di = sb.device_index
    assert di.struct.Y.data_ptr() % 32 == 0 and di.struct.n_y > 0
    codes, lengths = _reads(g, rng, 1024, k + 40, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    lf = _launched("lf_stream", variant, lambda: ts.streaming_search(di, c, n))
    assert torch.equal(lf, ts.streaming_search_plain(di, c, n))
    assert torch.equal(lf, ts.streaming_search(plain.device_index, c, n))
    km = c[:, :k].contiguous()
    assert torch.equal(_launched("kmer_search", variant, lambda: ts.search_batch(di, km)),
                       ts.search_batch_plain(di, km))
    ref = tm.precalc_fill_plain(di, p)
    _launched("precalc_fill", variant, lambda: tm.with_precalc(di, p))
    assert torch.equal(di.precalc, ref)
    counters = {op: kernels.LAUNCHES[kernels.lf_counter(op, variant)]
                for op in ("partial_search", "succ1", "forward", "turbo_stream")}
    _rank_op_checks(di, c, n, rng)
    for arity in (1, 2, 3):
        assert sb.enable_turbo(arity) == arity
        assert torch.equal(sb._turbo.tbl, tt.build_turbo(plain.device_index, arity).tbl)
        got = tt.turbo_streaming_search(sb._turbo, di, c, n)
        torch.cuda.synchronize()
        assert torch.equal(got, tt.turbo_streaming_search_plain(sb._turbo, di, c, n))
        assert torch.equal(got, lf)
    assert all(kernels.LAUNCHES[kernels.lf_counter(op, variant)] > before
               for op, before in counters.items())


@pytest.mark.parametrize("k,p", [(30, 6), (64, 6), (255, 8)])
def test_lf_stream_staged_patterns_equal_plain_version(cuda, k, p):
    """rrr-subsetwt's kernels that stage the RRR pattern table in shared
    memory (StagedRank): partial_search's lanes, 1,024 a block at most, and
    K1's fill at p = 12 (2^18 threads); K14, which decodes the patterns in
    registers, with no table beside its tiles, at short and long k."""
    rng = np.random.default_rng(900 + k)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    di = SBWT.build([g], k, cuda, precalc_k=p).to_variant("rrr-subsetwt").device_index
    assert kernels.lf_smem_bytes("rrr-subsetwt", k) == kernels.lf_smem_bytes("plain-matrix", k)
    codes, lengths = _reads(g, rng, 1100, k + 50, k)
    c, n = torch.from_numpy(codes).to(cuda), torch.from_numpy(lengths).to(cuda)
    name = kernels.lf_counter("lf_stream", "rrr-subsetwt")
    before = kernels.LAUNCHES[name]
    got = ts.streaming_search(di, c, n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got, ts.streaming_search_plain(di, c, n))
    part = _launched("partial_search", "rrr-subsetwt", lambda: ts.partial_search_batch(di, c, n))
    for g_, w in zip(part, ts.partial_search_plain(di, c, n)):
        assert torch.equal(g_, w)
    if k == 30:
        fill = _launched("precalc_fill", "rrr-subsetwt", lambda: kernels.precalc_fill(
            "rrr-subsetwt", di.kernel_desc(cuda), di.C, di.n_nodes, 12))
        assert torch.equal(fill, tm.precalc_fill_plain(di, 12))


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


@pytest.mark.parametrize("k,p", [(14, 6), (9, 9), (10, 7), (12, 8), (31, 13), (30, 13),
                                 (36, 12)])
def test_fast_search_equals_plain_version(cuda, k, p):
    """fast_search on the narrow tables of arity 1-3 and the wide arity-1
    one, against its plain version (k - p = 0, 1, 2, 3 and 4, 8, 17, 18, 24
    mod the arity; rows with N and lowercase); where needs_slow is false,
    ans is K1's search answer; and on codes 1-15 bytes past a 16-byte
    boundary, B not a multiple of 32. compute_dummy_node_marks launches
    succ1 once a BFS level."""
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
        for off in (1, 7, 15):
            rows = km[: 4096 - 7 * off]
            buf = torch.zeros(rows.numel() + 32, dtype=torch.int8, device=cuda)
            at = (off - buf.data_ptr()) % 16
            view = buf[at : at + rows.numel()].view(rows.shape)
            view.copy_(rows)
            assert view.data_ptr() % 16 == off and len(rows) % 32
            got = tt.fast_search(turbo, view)
            assert torch.equal(got[0], want[0][: len(rows)])
            assert torch.equal(got[1], want[1][: len(rows)])
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
    an all-T stretch (a valid key of all ones at k = 16 j) and repeats;
    then pack_windows and finalize_tables at and beside their tiles."""
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
    # pack_windows' tiles: a warp takes 128 or 256 windows, a block 512 or
    # 1024; N at the first and the last char of the windows that straddle
    # each, the codes a view 0-15 bytes past a 16-byte boundary
    for m in (1, 127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 4099):
        n = m + k - 1
        buf = torch.from_numpy(rng.integers(-1, 4, size=n + 32).astype(np.int8)).to(cuda)
        for off in (0, 1, 7, 15):
            at = (off - buf.data_ptr()) % 16
            view = buf[at : at + n]
            assert view.data_ptr() % 16 == off
            if off:
                view.clamp_(min=0)
                for edge in (128, 256, 512, 1024):
                    if edge < m:
                        view[edge - 1] = -1
                        view[min(edge + k - 2, n - 1)] = -1
            _same(kernels.pack_windows(view, k), td.pack_windows_plain(view, k))
    # finalize_tables' warps (128 columns) and blocks (512): T at and beside
    # them; each column equal to its left neighbour, different only in its
    # first char (both full k-mers: no mark), only in length, or anything
    for T in (1, 31, 32, 33, 127, 128, 129, 257, 511, 512, 513, 1025, 2049):
        case = [t.to(cuda) for t in _finalize_cases(rng, T, k)]
        for streaming in (True, False):
            _same(kernels.finalize_tables(*case, k, streaming),
                  td.finalize_tables_plain(*case, k, streaming))
    torch.cuda.synchronize()


def _finalize_cases(rng, T, k):
    """finalize_tables' inputs of T columns (int32 keys [T, W], lengths,
    edges, on the CPU): column t repeats its left neighbour, differs from it
    only in its first char with both at length k, only in length, or at
    random; the first column of every 32 takes the kind (t // 32) % 3, so
    that output words, warps (128 columns) and blocks (512) start on each."""
    W = kernels.key_words(k)
    keys = rng.integers(0, 2**32, size=(T, W), dtype=np.uint64).astype(np.int64)
    lens = rng.integers(0, k + 1, size=T).astype(np.int32)
    lens[rng.random(T) < 0.5] = k
    kind = rng.integers(0, 4, size=T)
    kind[::32] = (np.arange(0, T, 32) // 32) % 3
    wi, sh = (k - 1) >> 4, 30 - 2 * ((k - 1) & 15)
    for t in range(1, T):
        if kind[t] < 3:
            keys[t] = keys[t - 1]
        if kind[t] == 0:
            lens[t] = lens[t - 1]
        elif kind[t] == 1:
            lens[t - 1] = lens[t] = k
            keys[t, wi] ^= 1 << sh
        elif kind[t] == 2:
            lens[t] = (lens[t - 1] + 1) % (k + 1)
    keys = torch.from_numpy(((keys ^ 0x80000000) - 0x80000000).astype(np.int32))
    edges = torch.from_numpy(rng.integers(0, 16, size=T).astype(np.uint8))
    return keys, torch.from_numpy(lens), edges


def _random_kmer_keys(rng, n, k, dev, last=None):
    """n of the distinct k-mers of a random text, as sorted key rows int32
    [n, W] on dev: about half have their predecessor among them. With
    ``last``, a text mostly of G and the k-mers ending in G only."""
    size = 3 * n + k + 64
    if last is None:
        text = rng.integers(0, 4, size=size).astype(np.int8)
    else:
        text = rng.choice(np.array([0, 2], np.int8), p=[0.25, 0.75], size=size)
    keys, valid = td.pack_windows_plain(torch.from_numpy(text), k)
    keys = keys[valid]
    if last is not None:
        keys = keys[(bv.word_u32(keys[:, 0]) >> 30) == last]
    keys = keys[td.colex_order(keys)]
    keys = keys[td._differs_from_left(keys)]
    pick = np.sort(rng.choice(len(keys), size=n, replace=False))
    return keys[torch.from_numpy(pick)].to(dev)


@pytest.mark.parametrize("case", ["n1", "half_share", "half_share_plus_1", "share",
                                  "share_plus_1", "one_run", "complete_k4", "one_read",
                                  "off_16_bytes", "k255", "k255_share_plus_1"])
def test_edge_src_probe_merge_partitions(cuda, case):
    """The edge_src_probe kernel, one sorted merge of four query runs
    against the masked list in partitions of at most one block's share,
    against its plain version where the partition is stressed: one key;
    2n just at and past one share (one partition a run, then two), n at
    and past it; every k-mer ending in G (one run, three empty); the
    complete k = 4 graph (256 keys, no source, every group full); one long
    read (one source); keys 4 bytes off a 16-byte boundary (the window
    staged word by word); k = 255."""
    rng = np.random.default_rng(1200 + len(case))
    k = 255 if case.startswith("k255") else 4 if case == "complete_k4" else 30
    share = kernels.edge_src_share(k)
    if case == "complete_k4":
        dv = td.sorted_distinct_kmers(td.prepare_device_codes(
            ["".join(p) for p in itertools.product("ACGT", repeat=4)], 4, cuda), 4)
        assert len(dv) == 256
    elif case in ("one_read", "k255"):
        g = "".join(rng.choice(list("ACGT"), size=20000 if case == "one_read" else 3000))
        dv = td.sorted_distinct_kmers(td.prepare_device_codes([g], k, cuda), k)
    elif case == "off_16_bytes":
        dv = _random_kmer_keys(rng, share + 7, 16, cuda)[1:]
        k = 16
        assert dv.data_ptr() % 16 == 4
    else:
        n = {"n1": 1, "half_share": share // 2, "half_share_plus_1": share // 2 + 1,
             "share": share, "share_plus_1": share + 1, "one_run": 3 * share + 5,
             "k255_share_plus_1": share + 1}[case]
        dv = _random_kmer_keys(rng, n, k, cuda, last=2 if case == "one_run" else None)
    before = kernels.LAUNCHES["edge_src_probe"]
    got = kernels.edge_src_probe(dv, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edge_src_probe"] == before + 1
    want = td.edge_src_probe_plain(dv, k)
    _same(got, want)
    edges, gstart, is_src = want
    if case == "complete_k4":
        assert not is_src.any() and bool((edges[gstart] == 15).all()) and int(gstart.sum()) == 64
    if case == "one_read":
        assert int(is_src.sum()) == 1
    if case == "one_run":
        assert bool((edges[edges > 0] == 4).all()) and edges.any()


@pytest.fixture(scope="module")
def wide_succ_index(cuda):
    """A small index on the wide tier whose suffix groups straddle word
    boundaries, with its suffix-group starts."""
    rng = np.random.default_rng(1300)
    g = "".join(rng.choice(list("ACGT"), size=9000))
    sb = SBWT.build([g], 6, cuda)
    narrow = sb.device_index
    words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
    wide = from_packed_rows_wide(words, narrow.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                 6, narrow.n_kmers, cuda)
    return wide, np.asarray(sb.suffix_group_starts, dtype=bool)


@pytest.mark.parametrize("row_major", [True, False])
@pytest.mark.parametrize("cols", ["all", "reversed", "repeats", "word_start_straddles", "last",
                                  "odd_count"])
def test_succ1_wide_rounds_equal_plain_version(wide_succ_index, cols, row_major):
    """succ1 of the wide tier, a column's suffix-group row and rank rows in
    one round of loads, against its plain version: all columns, reversed,
    with repeats; columns 32m .. 32m + 2 whose group began in the word
    before (the previous word's rows loaded again); the last column alone;
    a count that is not a multiple of a block (padding lanes)."""
    wide, starts = wide_succ_index
    n = wide.n_nodes
    dev = wide.device
    rng = np.random.default_rng(1301)
    if cols == "all":
        c = None
    elif cols == "reversed":
        c = torch.arange(n - 1, -1, -1, device=dev)
    elif cols == "repeats":
        c = torch.from_numpy(rng.integers(0, n, size=3 * n)).to(dev)
    elif cols == "word_start_straddles":
        heads = [b for b in range(32, n, 32) if not starts[b]]
        assert len(heads) > 10
        c = torch.tensor([b + d for b in heads for d in range(3) if b + d < n], device=dev)
    elif cols == "last":
        c = torch.tensor([n - 1], device=dev)
    else:
        c = torch.from_numpy(rng.integers(0, n, size=1001)).to(dev)
    before = kernels.LAUNCHES[f"succ1[{kernels.WIDE}]"]
    got = tt.succ1(wide, c, row_major=row_major)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"succ1[{kernels.WIDE}]"] == before + 1
    want = tt.succ1_plain(wide, c)
    assert got.dtype == torch.int64
    assert torch.equal(got, want.t().contiguous() if row_major else want)


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


# ---------------------------------------------------------------------------
# K4's tiles (a warp of 32 reads, staged position tiles) and the compose's
# row mapping, at their edges: against the plain versions.
# ---------------------------------------------------------------------------


def _tile_reads(g, rng, B, L, k):
    """B reads of L codes: genomic, chimeric (a restart in the middle) and
    random rows, the lowercase and N spikes of _reads, and lengths of L,
    below L and below k."""
    enc = encode_query(g)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    for i in range(B):
        if i % 3 != 2:
            s = int(rng.integers(0, len(enc) - L))
            codes[i] = enc[s : s + L]
        if i % 3 == 1 and L > 2:
            cut = int(rng.integers(1, L - 1))
            s = int(rng.integers(0, len(enc) - L))
            codes[i, cut:] = enc[s : s + L - cut]
    codes[3::5, rng.integers(0, L, size=len(codes[3::5]))] = -1
    codes[1::3, : min(L, 9)] |= 4
    lengths = np.full(B, L, np.int32)
    lengths[::7] = rng.integers(0, L + 1, size=len(lengths[::7]))
    lengths[5::11] = rng.integers(0, k, size=len(lengths[5::11]))
    return codes, lengths


@pytest.fixture(scope="module")
def tile_indexes(cuda):
    """k = 14, p = 6: the plain-matrix index, its arity 1-3 tables, an
    rrr-split copy with its arity-3 table, the wide copy with its table and
    the arity-3 table cut into three row shards."""
    from sbwt_tpu_torch.parallel import sharded

    rng = np.random.default_rng(910)
    k, p = 14, 6
    g = "".join(rng.choice(list("ACGT"), size=6000)) + "ACGT" * 60
    sb = SBWT.build([g], k, cuda, precalc_k=p)
    di = sb.device_index
    turbos = {a: tt.build_turbo(di, a) for a in (1, 2, 3)}
    vdi = sb.to_variant("rrr-split").device_index
    words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
    wide = from_packed_rows_wide(words, di.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                 k, di.n_kmers, cuda, precalc_k=p)
    view = sharded.shard_turbo_rows(turbos[3], sharded.make_mesh(1, 3, [cuda])).views[0]
    return g, k, di, turbos, (vdi, tt.build_turbo(vdi, 3)), (wide, tt.build_turbo(wide, 1)), view


@pytest.mark.parametrize("B,L", [(1, 14), (31, 15), (33, 37), (1000, 100), (33, 257), (3, 3100)])
def test_turbo_stream_tiles_equal_plain_version(tile_indexes, B, L):
    """K4 over B reads of L codes (a warp's 32 reads and a ragged last warp;
    one tile, a tile's edge and many tiles) on plain-matrix at arity 1-3,
    rrr-split, the wide instance and K20b over three shards."""
    from sbwt_tpu_torch.parallel import sharded

    g, k, di, turbos, (vdi, vturbo), (wide, wturbo), view = tile_indexes
    rng = np.random.default_rng(B * 7 + L)
    codes, lengths = _tile_reads(g, rng, B, L, k)
    c, n = torch.from_numpy(codes).to(di.device), torch.from_numpy(lengths).to(di.device)
    before = dict(kernels.LAUNCHES)
    want = tt.turbo_streaming_search_plain(turbos[3], di, c, n)
    for arity, turbo in turbos.items():
        got = tt.turbo_streaming_search(turbo, di, c, n)
        torch.cuda.synchronize()
        assert torch.equal(got, tt.turbo_streaming_search_plain(turbo, di, c, n)), arity
        assert torch.equal(got, want)
    assert torch.equal(tt.turbo_streaming_search(vturbo, vdi, c, n), want)
    got = tt.turbo_streaming_search(wturbo, wide, c, n)
    assert got.dtype == torch.int64 and torch.equal(got, tt.turbo_streaming_search_plain(wturbo, wide, c, n))
    assert torch.equal(got, want.long())
    got = sharded.tp_turbo_block(view, di, c, n)
    torch.cuda.synchronize()
    assert torch.equal(got, tt.turbo_streaming_search_plain(view, di, c, n))
    assert torch.equal(got, want)
    for name in ("turbo_stream[plain-matrix]", "turbo_stream[rrr-split]",
                 f"turbo_stream[{kernels.WIDE}]", kernels.TURBO_SHARDED):
        assert kernels.LAUNCHES[name] > before[name], name


def test_turbo_stream_unaligned_codes_and_long_k(cuda):
    """K4 on codes that start at an odd address (the chunks that cross the
    buffer's ends are copied byte by byte), and at k = 255: narrow at
    arity 1 and 3, and wide, whose block needs more than 48 KB of shared
    memory."""
    rng = np.random.default_rng(255)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    for k, p, L in ((14, 6, 61), (255, 8, 400)):
        sb = SBWT.build([g], k, cuda, precalc_k=p)
        di = sb.device_index
        codes, lengths = _tile_reads(g, rng, 34, L, k)
        flat = torch.from_numpy(codes).to(cuda).reshape(-1)
        c = flat[5 : 5 + 33 * L].view(33, L)
        n = torch.from_numpy(lengths[:33]).to(cuda)
        assert c.data_ptr() % 16 == 5 % 16 and c.is_contiguous()
        words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
        wide = from_packed_rows_wide(words, di.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                     k, di.n_kmers, cuda, precalc_k=p)
        for index, arity in ((di, 1), (di, 3), (wide, 1)):
            turbo = tt.build_turbo(index, arity)
            got = tt.turbo_streaming_search(turbo, index, c, n)
            torch.cuda.synchronize()
            assert torch.equal(got, tt.turbo_streaming_search_plain(turbo, index, c, n)), (k, arity)
    assert kernels.turbo_smem_bytes(255, 1, 8) > 48 * 1024


@pytest.mark.parametrize("n", [1, 33, 1001, 4099])
def test_compose_equals_plain_version(cuda, n):
    """K2's compose of every arity over n columns (not a multiple of a
    warp's rows), whole and as column ranges: three shards, the last with
    zeroed pad rows, and ranges from an odd col0."""
    rng = np.random.default_rng(n)
    succ = torch.from_numpy(rng.integers(0, n, size=(4, n)).astype(np.int32))
    succ[torch.from_numpy(rng.random((4, n)) < 0.6)] = -1
    succ = succ.to(cuda)
    cols = -(-n // 3)
    ranges = [(0, None)] + ([(m * cols, cols) for m in range(3)] + [(1, n - 1), (3, 2)]
                            if n > 3 else [])
    before = dict(kernels.LAUNCHES)
    for arity in (1, 2, 3):
        for col0, n_cols in ranges:
            got = kernels.succ_compose(succ, arity, col0, n_cols)
            torch.cuda.synchronize()
            assert torch.equal(got, tt.compose_plain(succ, arity, col0=col0, n_cols=n_cols)), \
                (arity, col0, n_cols)
    assert kernels.LAUNCHES["succ_compose"] == before["succ_compose"] + 3
    assert kernels.LAUNCHES[kernels.COMPOSE_RANGE] == before[kernels.COMPOSE_RANGE] + 3 * (len(ranges) - 1)


# ---------------------------------------------------------------------------
# K14's tiles (the same warp of 32 reads and staged position tiles as K4)
# and K1's fill by subtrees, at their edges: against the plain versions.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lf_indexes(tile_indexes):
    """K14's instances over tile_indexes' index: plain-matrix, rrr-split,
    mef-concat, the wide copy and K20a over three row shards."""
    from sbwt_tpu_torch.parallel import sharded

    g, k, di, _, (vdi, _), (wide, _), _ = tile_indexes
    mdi = SBWT.build([g], k, di.device, precalc_k=di.precalc_k).to_variant("mef-concat").device_index
    view = sharded.shard_index_rows(di, sharded.make_mesh(1, 3, [di.device])).views[0]
    return {"plain-matrix": di, "rrr-split": vdi, "mef-concat": mdi, kernels.WIDE: wide,
            kernels.SHARDED: view}


@pytest.mark.parametrize("B,L", [(1, 14), (31, 15), (33, 37), (1000, 100), (33, 257), (3, 3100)])
def test_lf_stream_tiles_equal_plain_version(tile_indexes, lf_indexes, B, L):
    """K14 over B reads of L codes (a warp's 32 reads and a ragged last
    warp; one tile, a tile's edge and many tiles) on plain-matrix,
    rrr-split, mef-concat, the wide instance and K20a over three shards,
    each equal to its plain version and to plain-matrix K4's answers."""
    g, k, di, turbos, *_ = tile_indexes
    rng = np.random.default_rng(B * 11 + L)
    codes, lengths = _tile_reads(g, rng, B, L, k)
    c, n = torch.from_numpy(codes).to(di.device), torch.from_numpy(lengths).to(di.device)
    before = dict(kernels.LAUNCHES)
    want = tt.turbo_streaming_search(turbos[3], di, c, n)
    for name, index in lf_indexes.items():
        got = ts.streaming_search(index, c, n)
        torch.cuda.synchronize()
        assert got.dtype == kernels.pos_dtype(name)
        assert torch.equal(got, ts.streaming_search_plain(index, c, n)), name
        assert torch.equal(got.long(), want.long()), name
    for name in lf_indexes:
        counter = kernels.lf_counter("lf_stream", name)
        assert kernels.LAUNCHES[counter] > before[counter], counter


def test_lf_stream_unaligned_codes_and_long_k(cuda):
    """K14 on codes that start at an odd address (the chunks that cross the
    buffer's ends are copied byte by byte), and at k = 255: narrow and
    wide, the largest blocks K14 asks for (just under the 48 KB that a
    block may take without raising its limit)."""
    rng = np.random.default_rng(256)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    before = dict(kernels.LAUNCHES)
    for k, p, L in ((14, 6, 61), (255, 8, 400)):
        sb = SBWT.build([g], k, cuda, precalc_k=p)
        di = sb.device_index
        codes, lengths = _tile_reads(g, rng, 34, L, k)
        flat = torch.from_numpy(codes).to(cuda).reshape(-1)
        c = flat[5 : 5 + 33 * L].view(33, L)
        n = torch.from_numpy(lengths[:33]).to(cuda)
        assert c.data_ptr() % 16 == 5 % 16 and c.is_contiguous()
        words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
        wide = from_packed_rows_wide(words, di.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                     k, di.n_kmers, cuda, precalc_k=p)
        want = ts.streaming_search_plain(di, c, n)
        for index in (di, wide):
            got = ts.streaming_search(index, c, n)
            torch.cuda.synchronize()
            assert torch.equal(got, ts.streaming_search_plain(index, c, n)), (k, index.variant)
            assert torch.equal(got.long(), want.long()), (k, index.variant)
    assert kernels.lf_smem_bytes("plain-matrix", 255) == 46_080
    assert kernels.lf_smem_bytes(kernels.WIDE, 255) == 46_592
    for name in ("plain-matrix", kernels.WIDE):
        counter = kernels.lf_counter("lf_stream", name)
        assert kernels.LAUNCHES[counter] == before[counter] + 2, counter


@pytest.fixture(scope="module")
def fill_indexes(cuda):
    """k = 14 over 100,000 random bases: intervals stay live to about level
    8 and empty by level 12. Plain-matrix, one variant of each rank family
    (rrr-split, mef-matrix, rrr-subsetwt) and the wide copy."""
    rng = np.random.default_rng(1300)
    k = 14
    g = "".join(rng.choice(list("ACGT"), size=100_000))
    sb = SBWT.build([g], k, cuda, precalc_k=4)
    di = sb.device_index
    words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
    wide = from_packed_rows_wide(words, di.n_nodes, bv.pack_bits_host(sb.suffix_group_starts),
                                 k, di.n_kmers, cuda, precalc_k=4)
    narrow = {v: sb.to_variant(v).device_index for v in ("rrr-split", "mef-matrix", "rrr-subsetwt")}
    return {"plain-matrix": di, **narrow}, wide


@pytest.mark.parametrize("p", [1, 2, 3, 8, 9, 10, 12, 13])
def test_precalc_fill_equals_plain_version(fill_indexes, p):
    """K1's fill at every subtree depth: one thread an entry up to p = 8,
    then subtrees of depth 1, 2 and 3, on plain-matrix and one variant of
    each family for p < 13, and on the wide instance at p = 8 and 13 (the
    int64 table of 1.07 GB), each equal to its plain version."""
    narrow, wide = fill_indexes
    indexes = dict(narrow) if p < 13 else {}
    if p in (8, 13):
        indexes[kernels.WIDE] = wide
    before = dict(kernels.LAUNCHES)
    for name, index in indexes.items():
        got = kernels.precalc_fill(name, index.kernel_desc(index.device), index.C, index.n_nodes, p)
        torch.cuda.synchronize()
        assert got.dtype == kernels.pos_dtype(name) and got.shape == (4**p, 2)
        assert torch.equal(got, tm.precalc_fill_plain(index, p)), (name, p)
        del got
        counter = kernels.lf_counter("precalc_fill", name)
        assert kernels.LAUNCHES[counter] == before[counter] + 1, counter


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("p", [1, 2, 3, 5, 8, 12, 13])
def test_seed_bits_equals_plain_version(cuda, p, wide):
    """K3's two passes (the liveness bitmap, then the pair words) on a
    random table whose live share falls from all to none along its rows:
    p = 1 and 2 leave a bitmap word part full, p < 5 a warp's chunk part
    full; narrow (int32) and wide (int64) rows."""
    g = torch.Generator(device=cuda).manual_seed(900 + p)
    q = 4**p
    left = torch.randint(0, 1 << 30, (q,), device=cuda, generator=g)
    left[torch.rand(q, device=cuda, generator=g) < torch.linspace(0, 1, q, device=cuda)] = -1
    pre = torch.stack([left, left + 1], 1).to(torch.int64 if wide else torch.int32).contiguous()
    before = dict(kernels.LAUNCHES)
    got = kernels.seed_bits(pre, p)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (4 ** (p + 1) // 16,)
    assert torch.equal(got, tt.seed_bits_plain(pre, p))
    counter = f"seed_bits[{kernels.WIDE}]" if wide else "seed_bits"
    assert kernels.LAUNCHES[counter] == before[counter] + 1


# (B, P) of the answer matrices K13 is held at: one answer to 1M reads of
# 71, rows of up to 3,100 answers
STATS_SHAPES = [(1, 1), (1, 71), (3, 3100), (1000, 1), (1000, 71), (1000, 3100), (1 << 20, 1),
                (1 << 20, 71)]


@pytest.mark.parametrize("fill", ["mixed", "all_hit", "all_miss"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_answer_stats_equals_plain_version(cuda, dtype, fill):
    """K13 on ragged answer matrices whose base lies 0-3 elements into a
    larger tensor (a scalar head before the first 16-byte boundary, a tail
    after the last), against its plain version: checksums past 2^31."""
    g = torch.Generator(device=cuda).manual_seed(1300)
    n = max(b * p for b, p in STATS_SHAPES) + 3
    top = (1 << 31) - 1 if dtype == torch.int32 else 1 << 40
    buf = torch.randint(0, top, (n,), device=cuda, generator=g, dtype=dtype)
    if fill == "mixed":
        buf[torch.rand(n, device=cuda, generator=g) < 0.4] = -1
    elif fill == "all_miss":
        buf.fill_(-1)
    counter = f"answer_stats[{kernels.WIDE}]" if dtype == torch.int64 else "answer_stats"
    before = kernels.LAUNCHES[counter]
    for b, p in STATS_SHAPES:
        for off in range(4):
            out = buf[off : off + b * p].view(b, p)
            got = kernels.answer_stats(out)
            torch.cuda.synchronize()
            assert torch.equal(got, tt.answer_stats_plain(out)), (b, p, off)
            assert torch.equal(tt.answer_stats(out), got)
    assert int(got[1]) == {"all_hit": b * p, "all_miss": 0}.get(fill, int(got[1]))
    assert kernels.LAUNCHES[counter] == before + 2 * 4 * len(STATS_SHAPES)


# kmer_search and partial_search on the inputs of tests/search_cases.py,
# which the CPU tests hold to the JAX package and the oracle
# (test_torch_search.py): every rank type's kernel against its plain version.
@pytest.fixture(scope="module")
def case_index(cuda):
    """(rank type, p) -> the cases' index of that rank type on the card;
    the sharded one cut into four row shards on this card."""
    from sbwt_tpu_torch.parallel import sharded

    g, cache = sc.genome(), {}

    def get(rank_type, p):
        if (rank_type, p) not in cache:
            sb = SBWT.build([g], sc.K, cuda, precalc_k=p)
            if rank_type == kernels.WIDE:
                words = np.stack([bv.pack_bits_host(row) for row in sb.bits])
                index = from_packed_rows_wide(words, sb.device_index.n_nodes,
                                              bv.pack_bits_host(sb.suffix_group_starts), sc.K,
                                              sb.device_index.n_kmers, cuda, precalc_k=p)
            elif rank_type == kernels.SHARDED:
                mesh = sharded.make_mesh(1, 4, [cuda])
                index = sharded.shard_index_rows(sb.device_index, mesh).views[0]
            else:
                index = (sb if rank_type == "plain-matrix" else sb.to_variant(rank_type)).device_index
            cache[rank_type, p] = index
        return cache[rank_type, p]

    return get


def _start_and_tail(di, c, n):
    """Start intervals from each row's first three chars (its own interval,
    a singleton or the full one), and the rows' chars after them."""
    head = ts.partial_search_plain(di, c[:, :3].contiguous(), n.clamp(0, 3))
    start = sc.start_intervals(head[0].cpu().numpy(), head[1].cpu().numpy(), di.n_nodes, 7)
    return (torch.from_numpy(start).to(c.device, di.pos_dtype), c[:, 3:].contiguous(), n - 3)


def _partial_equal(di, c, n, start=None):
    got = ts.partial_search_batch(di, c, n, start)
    torch.cuda.synchronize()
    want = ts.partial_search_plain(di, c, n, start)
    return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("rank_type", kernels.RANK_TYPES)
@pytest.mark.parametrize("p", [0, 4])
def test_kmer_search_cases_equal_plain_version(case_index, rank_type, p):
    di = case_index(rank_type, p)
    counter = kernels.lf_counter("kmer_search", rank_type)
    before = kernels.LAUNCHES[counter]
    for case, rows in sc.kmer_cases(sc.genome()).items():
        km = torch.from_numpy(rows).to(di.device)
        got = ts.search_batch(di, km)
        torch.cuda.synchronize()
        assert got.dtype == di.pos_dtype and torch.equal(got, ts.search_batch_plain(di, km)), case
    assert kernels.LAUNCHES[counter] == before + len(sc.BATCHES)


@pytest.mark.parametrize("rank_type", [v for v in kernels.RANK_TYPES
                                       if "partial_search" in kernels.RANK_OPS[v]])
def test_partial_search_cases_equal_plain_version(case_index, rank_type):
    """From the full interval and from start intervals, rows of 40 and of
    1,000 chars."""
    di = case_index(rank_type, 0)
    for case, (codes, lengths) in sc.partial_cases(sc.genome()).items():
        c, n = torch.from_numpy(codes).to(di.device), torch.from_numpy(lengths).to(di.device)
        assert _partial_equal(di, c, n), case
        start, tail, tlen = _start_and_tail(di, c, n)
        assert _partial_equal(di, tail, tlen, start), case


@pytest.mark.parametrize("rank_type", ["plain-matrix", "rrr-subsetwt", kernels.WIDE,
                                       kernels.SHARDED])
def test_search_kernels_take_codes_off_16_bytes(case_index, rank_type):
    """Codes views whose base pointer is 1-15 bytes past a 16-byte boundary,
    inside a buffer of other bytes: the staged loads read no byte outside
    the view."""
    di = case_index(rank_type, 4)
    g = sc.genome()
    rows = torch.from_numpy(sc.kmer_cases(g)["B65"])
    codes, lengths = sc.partial_cases(g)[f"B33_L{sc.SHORT_L}"]
    rng = np.random.default_rng(11)
    for off in range(1, 16):
        buf = torch.from_numpy(rng.integers(-1, 8, size=4096).astype(np.int8)).to(di.device)
        at = (off - buf.data_ptr()) % 16
        km = buf[at:at + rows.numel()].view(rows.shape)
        km.copy_(rows)
        assert km.data_ptr() % 16 == off and km.is_contiguous()
        got = ts.search_batch(di, km)
        torch.cuda.synchronize()
        assert torch.equal(got, ts.search_batch_plain(di, km.contiguous())), off
        if "partial_search" not in kernels.RANK_OPS[rank_type]:
            continue
        c = buf[at:at + codes.size].view(codes.shape)
        c.copy_(torch.from_numpy(codes))
        n = torch.from_numpy(lengths).to(di.device)
        assert _partial_equal(di, c, n), off
