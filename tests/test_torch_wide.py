"""Port parity: the wide (int64) tier against the JAX package's, on the CPU.

x64 is a process-wide switch in JAX, so the JAX side runs once, in a
subprocess with x64 on (a module-scoped fixture), and writes its index
state, its successor tables and its answers into one ``.npz``. The port is
then held to that file in many small tests: its own wide index built from
the same packed rows must equal the JAX state byte for byte, and both its
own index and the one carried over by ``wide_from_numpy_state`` /
``wide_turbo_from_numpy_state`` must give the JAX answers exactly (all
integers, tolerance 0). Corpora are those of tests/test_wide_index.py
(``diff``: hits, misses, varied lengths) and tests/test_wide_turbo.py
(``rep``: a repetitive sequence with non-singleton seeds, an N mid-read,
lowercase). The port's kernels run their plain versions here.

Routing by n >= 2^31 cannot be reached at a size a CPU test can afford
(the smallest such index has a 3.2 GB table): the predicate is tested
alone and the route with the predicate forced; the real route is
chip_smoke.py's to prove on the card.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sbwt_tpu.utils.memory import select_turbo_arity as jax_select_turbo_arity
from sbwt_tpu.utils.memory import turbo_table_bytes as jax_table_bytes
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.io import serialize as port_io
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.models import wide as tw
from sbwt_tpu_torch.models.sbwt import SBWT
from sbwt_tpu_torch.models.variants import build_generic_index
from sbwt_tpu_torch.ops import bitvector as bv
from sbwt_tpu_torch.ops import search as ts
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.utils.memory import select_turbo_arity, turbo_table_bytes
import torch_state  # noqa: F401  (one torch thread per test worker)

REPO = Path(__file__).resolve().parents[1]
CASES = ("diff", "rep")
META = ("n_nodes", "n_kmers", "k", "precalc_k", "n_words", "has_streaming")

_JAX_SIDE = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from sbwt_tpu.construct.inmemory import build_sbwt
    from sbwt_tpu.models.wide import from_packed_rows_wide, wide_with_precalc
    from sbwt_tpu.ops import bitvector as bv
    from sbwt_tpu.ops import search as engines
    from sbwt_tpu.ops.turbo import (
        WideTurboIndex, build_turbo, fast_search_jit, turbo_streaming_jit,
    )
    from sbwt_tpu.utils.dna import encode_query

    out = {}

    def case(name, seed, seqs_of, k, p, n_reads, min_len, read_of):
        rng = np.random.default_rng(seed)
        seqs = seqs_of(rng)
        built = build_sbwt(seqs, k)
        n = built.bits.shape[1]
        words = np.stack([bv.pack_bits_host(built.bits[c]) for c in range(4)])
        sgs_w = bv.pack_bits_host(built.suffix_group_starts)
        wide = from_packed_rows_wide(words, n, sgs_w, k=k, n_kmers=built.n_kmers, precalc_k=p)
        out[f"{name}/words"], out[f"{name}/sgs_words"] = words, sgs_w
        for f in ("rank_tbl", "sgs_tbl", "C", "precalc"):
            out[f"{name}/{f}"] = np.asarray(getattr(wide, f))
        out[f"{name}/meta"] = np.array([wide.n_nodes, wide.n_kmers, wide.k, wide.precalc_k,
                                        wide.n_words, int(wide.has_streaming)], dtype=np.int64)
        for q in (0, 1, 2, 4):
            out[f"{name}/precalc_p{q}"] = np.asarray(wide_with_precalc(wide, q).precalc)

        L = 80
        reads = np.full((n_reads, L), -1, dtype=np.int8)
        lens = np.zeros(n_reads, dtype=np.int32)
        for i in range(n_reads):
            ln = int(rng.integers(min_len, L))
            s = read_of(rng, seqs, i, ln)
            reads[i, :ln] = encode_query(s)
            lens[i] = ln
        if name == "rep":
            reads[5, 10] = -1  # N mid-read
            reads[7, 20:24] = encode_query("acgt")  # lowercase: extend-valid only
        kmers = np.stack([encode_query("".join(rng.choice(list("ACGT"), size=k)))
                          for _ in range(256)])
        kmers[: 2 * n_reads : 2] = reads[:128, :k]  # real prefixes of reads among them
        nodes = rng.integers(0, n, size=256)
        out[f"{name}/reads"], out[f"{name}/lens"] = reads, lens
        out[f"{name}/kmers"], out[f"{name}/nodes"] = kmers, nodes

        jr, jl = jnp.asarray(reads), jnp.asarray(lens)
        ans = np.asarray(engines.search_jit(wide, jnp.asarray(kmers)))
        assert ans.dtype == np.int64
        out[f"{name}/search"] = ans
        out[f"{name}/stream"] = np.asarray(engines.streaming_search_jit(wide, jr, jl))
        l, r, m = engines.partial_search_batch(wide, jr, jl)
        out[f"{name}/partial_l"], out[f"{name}/partial_r"] = np.asarray(l), np.asarray(r)
        out[f"{name}/partial_m"] = np.asarray(m)
        out[f"{name}/forward"] = np.stack([np.asarray(engines.forward_jit(
            wide, jnp.asarray(nodes, dtype=jnp.int64), jnp.full(256, c, dtype=jnp.int32)))
            for c in range(4)])

        wt = build_turbo(wide, arity=1)
        assert isinstance(wt, WideTurboIndex)
        out[f"{name}/turbo_tbl"], out[f"{name}/turbo_tbl_hi"] = np.asarray(wt.tbl), np.asarray(wt.tbl_hi)
        out[f"{name}/turbo_seed_bits"] = np.asarray(wt.seed_bits)
        got = np.asarray(turbo_streaming_jit(wt, wide, jr, jl))
        assert got.dtype == np.int64
        out[f"{name}/turbo_stream"] = got
        fa, fs = fast_search_jit(wt, jnp.asarray(kmers))
        out[f"{name}/fast_ans"], out[f"{name}/fast_slow"] = np.asarray(fa), np.asarray(fs)

    def random_seqs(n_seqs, size, extra=()):
        return lambda rng: ["".join(rng.choice(list("ACGT"), size=size))
                            for _ in range(n_seqs)] + list(extra)

    def diff_read(rng, seqs, i, ln):
        if i % 2 == 0:
            st = int(rng.integers(0, 600 - ln))
            return seqs[0][st:st + ln]
        return "".join(rng.choice(list("ACGT"), size=ln))

    def rep_read(rng, seqs, i, ln):
        if i % 3 == 0:
            st = int(rng.integers(0, 900 - ln))
            return seqs[0][st:st + ln]
        if i % 3 == 1:
            return "".join(rng.choice(list("ACGT"), size=ln))
        return ("ACGT" * 40)[:ln]

    case("diff", 3, random_seqs(2, 600), 11, 3, 64, 15, diff_read)
    case("rep", 3, random_seqs(2, 900, ["ACGT" * 80]), 12, 6, 48, 16, rep_read)
    np.savez(sys.argv[1], **out)
    """
)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's wide tier, run once with x64 on: name -> array."""
    path = tmp_path_factory.mktemp("wide") / "jax_wide.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(path)], capture_output=True,
                          text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def _state(jax_side, case):
    state = {f: jax_side[f"{case}/{f}"] for f in ("rank_tbl", "sgs_tbl", "C", "precalc")}
    state.update(dict(zip(META, (int(x) for x in jax_side[f"{case}/meta"]))))
    state["has_streaming"] = bool(state["has_streaming"])
    return state


@pytest.fixture(scope="module")
def indexes(jax_side):
    """(case, source) -> the port's wide index: "built" by the port from the
    same packed rows, or "carried" over from the JAX state."""
    cache = {}

    def get(case, source):
        if (case, source) not in cache:
            st = _state(jax_side, case)
            if source == "carried":
                cache[case, source] = tw.wide_from_numpy_state(st, "cpu")
            else:
                cache[case, source] = tw.from_packed_rows_wide(
                    jax_side[f"{case}/words"], st["n_nodes"], jax_side[f"{case}/sgs_words"],
                    st["k"], st["n_kmers"], "cpu", precalc_k=st["precalc_k"])
        return cache[case, source]

    return get


@pytest.fixture(scope="module")
def turbos(jax_side, indexes):
    """(case, source) -> the port's WideTurboIndex: built by the port from
    its own index, or carried over from the JAX pair of int32 tables."""
    cache = {}

    def get(case, source):
        if (case, source) not in cache:
            if source == "built":
                cache[case, source] = tt.build_turbo(indexes(case, "built"), arity=1)
            else:
                st = _state(jax_side, case)
                cache[case, source] = tt.wide_turbo_from_numpy_state(
                    {"tbl": jax_side[f"{case}/turbo_tbl"], "tbl_hi": jax_side[f"{case}/turbo_tbl_hi"],
                     "precalc": st["precalc"], "C": st["C"],
                     "seed_bits": jax_side[f"{case}/turbo_seed_bits"], "n_nodes": st["n_nodes"],
                     "k": st["k"], "precalc_k": st["precalc_k"]}, "cpu")
        return cache[case, source]

    return get


def _reads(jax_side, case):
    return torch.from_numpy(jax_side[f"{case}/reads"]), torch.from_numpy(jax_side[f"{case}/lens"])


both = pytest.mark.parametrize("source", ["built", "carried"])
each_case = pytest.mark.parametrize("case", CASES)


@each_case
@pytest.mark.parametrize("field", ["rank_tbl", "sgs_tbl", "C", "precalc"])
def test_built_index_equals_jax_state(jax_side, indexes, case, field):
    got = getattr(indexes(case, "built"), field).numpy()
    want = jax_side[f"{case}/{field}"]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@each_case
def test_index_types_and_counts(jax_side, indexes, case):
    st = _state(jax_side, case)
    for source in ("built", "carried"):
        di = indexes(case, source)
        assert isinstance(di, tw.WideMatrixIndex) and di.variant == kernels.WIDE
        assert di.pos_dtype == torch.int64 == di.C.dtype == di.precalc.dtype
        assert di.rank_tbl.dtype == torch.int32 and di.rank_tbl.shape == (4 * st["n_words"], 3)
        assert {f: getattr(di, f) for f in META} == {f: st[f] for f in META}
        assert di.size_in_bytes() == 4 * st["n_words"] * 12


@each_case
@pytest.mark.parametrize("p", [0, 1, 2, 4])
def test_wide_precalc_fill_matches_jax(jax_side, case, p):
    di = tw.wide_from_numpy_state(_state(jax_side, case), "cpu")
    assert tw.wide_with_precalc(di, p) is di and di.precalc_k == p
    assert di.precalc.dtype == torch.int64
    np.testing.assert_array_equal(di.precalc.numpy(), jax_side[f"{case}/precalc_p{p}"])


@each_case
@both
def test_wide_search_batch_matches_jax(jax_side, indexes, case, source):
    got = ts.search_batch(indexes(case, source), torch.from_numpy(jax_side[f"{case}/kmers"]))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_side[f"{case}/search"])
    assert (jax_side[f"{case}/search"] >= 0).sum() >= 16


@each_case
@both
def test_wide_lf_streaming_matches_jax(jax_side, indexes, case, source):
    got = ts.streaming_search(indexes(case, source), *_reads(jax_side, case))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_side[f"{case}/stream"])
    assert 0.1 < (jax_side[f"{case}/stream"] >= 0).mean() < 0.9


@each_case
@both
def test_wide_partial_search_matches_jax(jax_side, indexes, case, source):
    l, r, m = ts.partial_search_batch(indexes(case, source), *_reads(jax_side, case))
    assert l.dtype == r.dtype == torch.int64 and m.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), jax_side[f"{case}/partial_m"])
    np.testing.assert_array_equal(l.numpy(), jax_side[f"{case}/partial_l"])
    np.testing.assert_array_equal(r.numpy(), jax_side[f"{case}/partial_r"])
    assert len(set(jax_side[f"{case}/partial_m"].tolist())) > 5


@each_case
def test_partial_search_from_a_start_interval(jax_side, indexes, case):
    """Going on from the interval of a prefix gives the interval of the whole."""
    di = indexes(case, "built")
    codes, lens = _reads(jax_side, case)
    head = ts.partial_search_batch(di, codes[:, :4].contiguous(), lens.clamp(max=4))
    done = head[2] == 4
    whole = ts.partial_search_batch(di, codes, lens)
    rest = ts.partial_search_batch(di, codes[:, 4:].contiguous(), (lens - 4).clamp(min=0),
                                   start=torch.stack(head[:2], dim=1))
    assert int(done.sum()) > 10
    for a, b in zip(whole[:2], rest[:2]):
        assert torch.equal(a[done], b[done])
    assert torch.equal(whole[2][done], rest[2][done] + 4)


@each_case
@pytest.mark.parametrize("c", [0, 1, 2, 3])
def test_wide_forward_matches_jax(jax_side, indexes, case, c):
    nodes = torch.from_numpy(jax_side[f"{case}/nodes"])
    for source in ("built", "carried"):
        got = ts.forward_batch(indexes(case, source), nodes, torch.full_like(nodes, c))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), jax_side[f"{case}/forward"][c])


@each_case
def test_wide_turbo_table_matches_jax(jax_side, turbos, indexes, case):
    built, carried = turbos(case, "built"), turbos(case, "carried")
    n = indexes(case, "built").n_nodes
    for t in (built, carried):
        assert isinstance(t, tt.WideTurboIndex) and t.arity == 1
        assert t.tbl.dtype == torch.int64 and tuple(t.tbl.shape) == (n, 4)
    assert torch.equal(built.tbl, carried.tbl)
    # the JAX tables are padded to whole chunks, and hold the two words of each successor
    assert jax_side[f"{case}/turbo_tbl"].shape[0] >= n
    np.testing.assert_array_equal(built.tbl.numpy() >> 32, jax_side[f"{case}/turbo_tbl_hi"][:n])
    np.testing.assert_array_equal((built.tbl.numpy() & 0xFFFFFFFF).astype(np.uint32),
                                  jax_side[f"{case}/turbo_tbl"][:n].view(np.uint32))
    assert built.seed_bits.numpy().tobytes() == jax_side[f"{case}/turbo_seed_bits"].tobytes()
    assert torch.equal(built.seed_bits, carried.seed_bits)
    assert built.precalc.dtype == built.C.dtype == torch.int64
    # any arity asked of a wide index gives the arity-1 tier
    assert tt.build_turbo(indexes(case, "built"), arity=3).arity == 1


@each_case
@both
def test_wide_turbo_streaming_matches_jax(jax_side, turbos, indexes, case, source):
    got = tt.turbo_streaming_search(turbos(case, source), indexes(case, source),
                                    *_reads(jax_side, case))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_side[f"{case}/turbo_stream"])
    np.testing.assert_array_equal(got.numpy(), jax_side[f"{case}/stream"])


@each_case
def test_wide_fast_search_matches_jax(jax_side, turbos, case):
    ans, slow = tt.fast_search(turbos(case, "built"), torch.from_numpy(jax_side[f"{case}/kmers"]))
    assert ans.dtype == torch.int64
    np.testing.assert_array_equal(slow.numpy(), jax_side[f"{case}/fast_slow"])
    np.testing.assert_array_equal(ans.numpy(), jax_side[f"{case}/fast_ans"])


def test_rep_corpus_has_non_singleton_seeds(jax_side):
    pre = jax_side["rep/precalc"]
    live = pre[:, 0] >= 0
    assert (pre[live, 0] != pre[live, 1]).sum() > 20
    assert jax_side["rep/fast_slow"].any()


# ---------------------------------------------------------------------------
# 64-bit counts, routing, memory, the facade
# ---------------------------------------------------------------------------


def _shifted(di, offset):
    """The same index with every cumulative count raised by ``offset``."""
    tbl = di.rank_tbl.clone()
    cum = ((tbl[:, 2].long() << 32) | (tbl[:, 1].long() & 0xFFFFFFFF)) + offset
    low = cum & 0xFFFFFFFF
    tbl[:, 1] = torch.where(low >= 2**31, low - 2**32, low).int()
    tbl[:, 2] = (cum >> 32).int()
    return tw.WideMatrixIndex(tbl, di.sgs_tbl, di.C, di.precalc, n_nodes=di.n_nodes,
                              n_kmers=di.n_kmers, k=di.k, precalc_k=di.precalc_k,
                              n_words=di.n_words, has_streaming=di.has_streaming)


@pytest.mark.parametrize("offset", [2**31 - 3, 2**31, 2**32 - 1, 2**32, 2**33 + 2**31 + 9])
def test_counts_past_32_bits_are_reassembled_unsigned(indexes, offset):
    """A count's low half is unsigned: with the counts raised by hand past
    bit 31 and bit 32, every rank is the real one plus the offset."""
    di = indexes("diff", "built")
    pos = torch.arange(di.n_nodes + 1)
    shifted = _shifted(di, offset)
    for c in range(4):
        r0, b0 = di.extend_rank(torch.full_like(pos, c), pos)
        r1, b1 = shifted.extend_rank(torch.full_like(pos, c), pos)
        assert torch.equal(r1, r0 + offset) and torch.equal(b1, b0)
    fill = tm.precalc_fill_plain(shifted, 1)
    assert fill.dtype == torch.int64 and int(fill.max()) > 2**31


@pytest.mark.parametrize("windows", [7, 64, 1 << 24])
def test_rank_table_from_words_wide_matches_jax(windows):
    from sbwt_tpu.ops import bitvector as jbv

    words = np.random.default_rng(windows).integers(0, 2**32, size=1000, dtype=np.uint32)
    got = bv.rank_table_from_words_wide(words, windows)
    assert got.dtype == np.int32 and got.shape == (1000, 3)
    assert got.tobytes() == jbv.rank_table_from_words_wide(words, windows).tobytes()


def _complete_dbg(order):
    """Packed rows of the complete de Bruijn graph (tests/test_wide_index.py)."""
    n = 4**order + 1
    row = np.full(n // 32 + 1, 0x22222222, dtype=np.uint32)
    row[-1] = 0
    sgs = row.copy()
    sgs[0] = 0x22222223
    return np.stack([row] * 4), sgs, n


def test_complete_graph_answers_equal_the_closed_form():
    """The order-8 complete graph through the wide index: every query has
    the closed form search(x) = 1 + sum_i code_i * 4^i."""
    K = 8
    words, sgs, n = _complete_dbg(K)
    di = tw.from_packed_rows_wide(words, n, sgs, K, 4**K, "cpu", precalc_k=2)
    assert di.C.tolist() == [1 + c * 4 ** (K - 1) for c in range(4)]
    rng = np.random.default_rng(0)
    pows = 4 ** np.arange(K, dtype=np.int64)
    oracle = lambda codes: 1 + (codes.astype(np.int64) * pows).sum(axis=-1)
    qs = rng.integers(0, 4, size=(512, K)).astype(np.int8)
    qs[0], qs[1] = 0, 3
    got = ts.search_batch(di, torch.from_numpy(qs)).numpy()
    np.testing.assert_array_equal(got, oracle(qs))
    assert got[0] == 1 and got[1] == n - 1
    reads = rng.integers(0, 4, size=(32, 40)).astype(np.int8)
    reads[::4, 17] = -1
    ans = ts.streaming_search(di, torch.from_numpy(reads)).numpy()
    wins = np.lib.stride_tricks.sliding_window_view(reads, K, axis=1)
    np.testing.assert_array_equal(ans, np.where((wins >= 0).all(axis=2), oracle(wins.clip(0)), -1))
    for c in range(4):
        nxt = ts.forward_batch(di, torch.from_numpy(oracle(qs)), torch.full((512,), c)).numpy()
        succ = np.concatenate([qs[:, 1:], np.full((512, 1), c, dtype=np.int8)], axis=1)
        np.testing.assert_array_equal(nxt, oracle(succ))
    l, r, m = (t.numpy() for t in ts.partial_search_batch(di, torch.from_numpy(qs[:, :5].copy())))
    lo = 1 + (qs[:, :5].astype(np.int64) * pows[K - 5 :]).sum(axis=1)
    assert (m == 5).all()
    np.testing.assert_array_equal(l, lo)
    np.testing.assert_array_equal(r, lo + 4 ** (K - 5) - 1)
    # no precalc interval of the complete graph is one column wide, so K4's
    # restarts all take the exact LF steps
    tm.with_precalc(di, 3)
    turbo = tt.build_turbo(di)
    assert (di.precalc[:, 0] < di.precalc[:, 1]).all()
    got = tt.turbo_streaming_search(turbo, di, torch.from_numpy(reads)).numpy()
    np.testing.assert_array_equal(got, ans)


def test_routing_predicate():
    assert not tm.needs_wide_index(2**31 - 1)
    assert tm.needs_wide_index(2**31) and tm.needs_wide_index(4**16 + 1)


def test_normal_entry_points_route_to_the_wide_index(jax_side, monkeypatch, tmp_path):
    """With the predicate forced, ``from_packed_rows``, ``SBWT.from_packed``
    and ``load`` give a wide index whose int64 tables equal the JAX state,
    and a file's int64 precalc table is carried, not narrowed."""
    st = _state(jax_side, "diff")
    words, sgs_words = jax_side["diff/words"], jax_side["diff/sgs_words"]
    narrow = SBWT.from_packed(words.view(np.uint8), st["n_nodes"], sgs_words.view(np.uint8),
                              st["k"], st["n_kmers"], "cpu", precalc_k=st["precalc_k"])
    assert type(narrow.device_index) is tm.MatrixIndex
    path = tmp_path / "index.sbwt"
    port_io.save(str(path), narrow)
    monkeypatch.setattr(tm, "needs_wide_index", lambda n: True)
    routed = tm.from_packed_rows(words, st["n_nodes"], sgs_words, st["k"], st["n_kmers"], "cpu",
                                 st["precalc_k"])
    packed = SBWT.from_packed(words.view(np.uint8), st["n_nodes"], sgs_words.view(np.uint8),
                              st["k"], st["n_kmers"], "cpu", precalc_k=st["precalc_k"])
    loaded = port_io.load(str(path), "cpu")
    for di in (routed, packed.device_index, loaded.device_index):
        assert isinstance(di, tw.WideMatrixIndex)
        for f in ("rank_tbl", "sgs_tbl", "C", "precalc"):
            assert getattr(di, f).numpy().tobytes() == st[f].tobytes(), f
    assert loaded.get_precalc_k() == st["precalc_k"]
    codes, lens = jax_side["diff/reads"], jax_side["diff/lens"]
    np.testing.assert_array_equal(loaded.streaming_search_batch(codes, lens), jax_side["diff/stream"])
    np.testing.assert_array_equal(loaded.get_precalc(), narrow.get_precalc())
    again = tmp_path / "again.sbwt"
    port_io.save(str(again), loaded)
    assert again.read_bytes() == path.read_bytes()


def test_no_wide_compressed_variant():
    too_wide = types.SimpleNamespace(shape=(4, 2**31))
    with pytest.raises(ValueError, match="no compressed variant"):
        build_generic_index("rrr-split", too_wide, None, 31, 1, "cpu")


def test_wide_arity_selection_matches_jax():
    for n in (1000, 4_000_000, 200_000_000, 200_000_001, 2**31, 4**16 + 1):
        for free in (1 << 20, 8 << 30, 80 << 30, 1 << 40):
            for p in (0, 8, 13):
                assert select_turbo_arity(n, free, p, wide=True) == \
                    jax_select_turbo_arity(n, free, p, wide=True), (n, free, p)
        for a in (1, 2, 3):
            assert turbo_table_bytes(n, a, 13, wide=True) == jax_table_bytes(n, a, 13, wide=True)
    # unmeasurable free memory: the JAX engine's fixed threshold
    assert [select_turbo_arity(n, None, 13, wide=True) for n in (200_000_000, 200_000_001)] == [
        1, None]
    # what the port allocates: int64 [n, 4] and the seed bits
    assert turbo_table_bytes(1000, 3, 8, wide=True) == 1000 * 4 * 8 + 4**9 // 4
    # the 4.29-billion-column index: 137 GB, past any one card
    assert select_turbo_arity(4**16 + 1, 80 << 30, 8, wide=True) is None


def test_table_bytes_state_what_is_allocated(turbos):
    t = turbos("rep", "built")
    allocated = t.tbl.numel() * t.tbl.element_size() + t.seed_bits.numel() * 4
    assert turbo_table_bytes(t.n_nodes, 1, t.precalc_k, wide=True) == allocated


def test_pair_rows_carry_over_as_one_int64_table():
    """The JAX pair of int32 tables (low and high words, padded) becomes the
    port's one int64 table: -1 round-trips, and a successor past 2^31
    keeps its high word (tests/test_wide_turbo.py pins the same on the JAX
    side)."""
    rng = np.random.default_rng(3)
    n = 64
    succ = rng.integers(-1, 2**40, size=(n, 4))
    succ[rng.random((n, 4)) < 0.3] = -1
    succ[0] = [-1, 2**31 - 1, 2**31, 2**32 + 5]
    lo = (succ & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (succ >> 32).astype(np.int32)
    pad = np.zeros((16, 4), dtype=np.int32)
    state = {"tbl": np.concatenate([lo, pad]), "tbl_hi": np.concatenate([hi, pad]),
             "precalc": np.zeros((1, 2), np.int64), "C": np.zeros(4, np.int64), "seed_bits": None,
             "n_nodes": n, "k": 8, "precalc_k": 0}
    t = tt.wide_turbo_from_numpy_state(state, "cpu")
    assert t.tbl.dtype == torch.int64 and t.seed_bits is None
    np.testing.assert_array_equal(t.tbl.numpy(), succ)
    # on one chip every high word is 0 or -1, and the low word alone decides
    small = rng.integers(-1, n, size=(n, 4))
    state["tbl"] = small.astype(np.int32)
    state["tbl_hi"] = np.where(small < 0, -1, 0).astype(np.int32)
    np.testing.assert_array_equal(tt.wide_turbo_from_numpy_state(state, "cpu").tbl.numpy(), small)


@pytest.fixture(scope="module")
def facades(jax_side, indexes):
    """The narrow facade of the rep corpus and a facade around its wide index."""
    st = _state(jax_side, "rep")
    words, sgs_words = jax_side["rep/words"], jax_side["rep/sgs_words"]
    nb = (st["n_nodes"] + 7) // 8
    rows = np.ascontiguousarray(words.view(np.uint8).reshape(4, -1)[:, :nb])
    sgs = np.ascontiguousarray(sgs_words.view(np.uint8)[:nb])
    narrow = SBWT.from_packed(rows, st["n_nodes"], sgs, st["k"], st["n_kmers"], "cpu",
                              precalc_k=st["precalc_k"])
    return narrow, SBWT(indexes("rep", "built"), rows, st["n_nodes"], sgs)


def test_facade_on_a_wide_index(jax_side, facades):
    narrow, wide = facades
    codes, lens = jax_side["rep/reads"], jax_side["rep/lens"]
    assert wide.enable_turbo(None, free_bytes=1 << 10) is None and wide._turbo is None
    lf = wide.streaming_search_batch(codes, lens)
    assert lf.dtype == np.int64
    np.testing.assert_array_equal(lf, jax_side["rep/stream"])
    assert wide.enable_turbo(3) == 1 and isinstance(wide._turbo, tt.WideTurboIndex)
    np.testing.assert_array_equal(wide.streaming_search_batch(codes, lens), jax_side["rep/stream"])
    assert wide.enable_turbo(None, free_bytes=1 << 30) == 1
    np.testing.assert_array_equal(wide.search_batch(jax_side["rep/kmers"]), jax_side["rep/search"])
    np.testing.assert_array_equal(wide.C, narrow.C)
    np.testing.assert_array_equal(wide.get_precalc(), narrow.get_precalc())


@pytest.mark.parametrize("text", ["ACGTACGTACGTAC", "ACGTTTTTTTTTTTTTTTT", "acgtACGT", "ACNGT", "T", ""])
def test_facade_strings_on_a_wide_index(facades, text):
    narrow, wide = facades
    assert wide.partial_search(text) == narrow.partial_search(text)
    n = narrow.number_of_subsets()
    for interval in ((0, n - 1), (3, 40), (-1, -1)):
        assert wide.update_sbwt_interval(text, interval) == narrow.update_sbwt_interval(text, interval)
    for node in (0, 1, 17, n - 1):
        for c in "ACGTNa":
            assert wide.forward(node, c) == narrow.forward(node, c)


def test_cpu_tensors_launch_nothing(indexes, jax_side):
    before = dict(kernels.LAUNCHES)
    di = indexes("diff", "built")
    ts.streaming_search(di, *_reads(jax_side, "diff"))
    tt.build_turbo(di)
    assert kernels.LAUNCHES == before
    assert all(f"{op}[{kernels.WIDE}]" in kernels.LAUNCHES for op in kernels.LF_OPS)
