"""SubsetWTRank's device forms (csrc/subset_rank.cuh), transcribed in numpy.

plain-subsetwt holds each tree as int4 rows (hi word, hi count, lo word, lo
count) in position order; rrr-subsetwt holds each tree's RRR level 0 and,
in place of level 1, the sparse position-order vectors e, b, b_ac, b_gt
(MEF), or level 1 where those would take more bytes. The transcriptions
below follow the device code step for step, with each bit vector's rank
taken from its decoded bits, and are held to the port's plain
SubsetWTRank, to the JAX SubsetWTRank's answers (tests/torch_state.py) and
to the cumulative counts or tests/oracle.py. The cases
(tests/subsetwt_cases.py) hold empty sets and sets of all four chars, end
off a word, a block and a superblock, and are read at those edges.
"""
import numpy as np
import pytest
import torch

from oracle import OracleIndex
from sbwt_tpu.io import serialize as jax_io
from sbwt_tpu.models.sbwt import SBWT as JaxSBWT
from sbwt_tpu.models.subsetrank import build_struct as jax_build_struct
from sbwt_tpu_torch.io import serialize as port_io
from sbwt_tpu_torch.models import subsetrank as tsr
from sbwt_tpu_torch.models.sbwt import SBWT
from sbwt_tpu_torch.ops.wavelet import WaveletTree
from subsetwt_cases import CASES, case_bits, edge_positions
from test_torch_bv import assert_payload_equal
from torch_state import subsetwt_rank_answers

TREES = ("acgt", "ac", "gt")
# (bit-vector kind, sparse): the plain rows, rrr with the sparse vectors,
# rrr with level 1 kept
FORMS = {"plain": ("plain", None), "rrr-sparse": ("rrr", True), "rrr-level1": ("rrr", False)}
LOW32 = 0xFFFFFFFF


def _cum(bits):
    return np.concatenate([np.zeros((4, 1), np.int64), np.cumsum(bits, axis=1)], axis=1)


def _prefix(bools):
    """rank at 0 .. len + 1 of a bit vector (the position past its end reads
    as a zero bit, as the padded device rows do)."""
    p = np.concatenate([[0], np.cumsum(bools, dtype=np.int64)])
    return np.concatenate([p, p[-1:]])


def _run(bools, pos, length):
    """bits pos .. pos + length - 1 of a vector, per lane, in the low bits."""
    padded = np.concatenate([bools, np.zeros(33, dtype=bool)]).astype(np.int64)
    j = np.arange(32)
    take = padded[pos[:, None] + j] & (j < length[:, None])
    return (take << j).sum(axis=1)


def _deposit(v, m):
    """The low bits of v, in order, at the set bits of m (per lane)."""
    out, src = np.zeros_like(v), np.zeros_like(v)
    for j in range(32):
        mj = (m >> j) & 1
        out |= (((v >> src) & 1) & mj) << j
        src += mj
    return out


def _low_mask(n):
    return (np.int64(1) << n) - 1


# ---------------------------------------------------------------------------
# plain: the int4 plane rows
# ---------------------------------------------------------------------------


def _count_at(rows, lo, pos):
    """SubsetWTRank<PlainBV>::count_at: the lo (else hi) count before pos
    from pos's row, and the bit at pos."""
    row = rows[pos >> 5].astype(np.int64)
    w = np.where(lo, row[:, 2], row[:, 0]) & LOW32
    o = pos & 31
    return np.where(lo, row[:, 3], row[:, 1]) + np.bitwise_count(w & _low_mask(o)), (w >> o) & 1


def _plain_rank_pair(st, c, pos):
    rows = {t: getattr(st, t).numpy() for t in TREES}
    x, adv = _count_at(rows["acgt"], c >= 2, pos)
    odd = (c & 1) == 1
    ra, ba = _count_at(rows["ac"], odd, np.where(c < 2, x, 0))
    rg, bg = _count_at(rows["gt"], odd, np.where(c < 2, 0, x))
    r, bit = np.where(c < 2, ra, rg), np.where(c < 2, ba, bg)
    return r, r + (adv & bit)


def _planes(rows, pos, length):
    """SubsetWTRank<PlainBV>::planes: (hi, lo, hi count, lo count)."""
    row = rows[pos >> 5].astype(np.int64)
    nxt = rows[np.minimum((pos >> 5) + 1, len(rows) - 1)].astype(np.int64)
    o = pos & 31
    below = _low_mask(o)
    cross = o + length > 32
    planes = []
    for col in (0, 2):
        w = row[:, col] & LOW32
        v = (w >> o) | np.where(cross, ((nxt[:, col] & LOW32) << (32 - o)) & LOW32, 0)
        planes.append(v & _low_mask(length))
    return (planes[0], planes[1], row[:, 1] + np.bitwise_count(row[:, 0] & LOW32 & below),
            row[:, 3] + np.bitwise_count(row[:, 2] & LOW32 & below))


def _plain_subsets(st, pos, length):
    rows = {t: getattr(st, t).numpy() for t in TREES}
    hi, lo, rh, rl = _planes(rows["acgt"], pos, length)
    ah, al, _, _ = _planes(rows["ac"], rh, np.bitwise_count(hi))
    gh, gl, _, _ = _planes(rows["gt"], rl, np.bitwise_count(lo))
    return [_deposit(ah, hi), _deposit(al, hi), _deposit(gh, lo), _deposit(gl, lo)]


# ---------------------------------------------------------------------------
# rrr: level 0 and the sparse vectors, or level 1
# ---------------------------------------------------------------------------


def _rrr_vectors(st):
    """The bits of every vector the device form holds, and their prefixes."""
    out = {"l0": [bv.to_bools() for bv in st.l0]}
    if st.sparse:
        out.update({k: getattr(st, k).to_bools() for k in ("e", "b", "b_ac", "b_gt")})
    else:
        out["l1"] = [bv.to_bools() for bv in st.l1]
    return out, {k: ([_prefix(x) for x in v] if isinstance(v, list) else _prefix(v))
                 for k, v in out.items()}


def _rrr_rank_pair(st, c, pos):
    """SubsetWTRank<RRR15>::rank_pair. A lane reads the tree it does not
    use at 0, and the vectors it does not use at 0."""
    _, pre = _rrr_vectors(st)
    hi_side, odd = c < 2, (c & 1) == 1
    r, rq = pre["l0"][0][pos], pre["l0"][0][pos + 1]
    if st.sparse:
        q = np.where(hi_side, 0, pos)
        e, eq, b, bq = pre["e"][q], pre["e"][q + 1], pre["b"][q], pre["b"][q + 1]
        x = np.where(hi_side, r, pos - r - e + b)
        xq = np.where(hi_side, rq, pos + 1 - rq - eq + bq)
    else:
        base_l, rank_l, base_r, rank_r = st._nodes[0]
        l1 = pre["l1"][0]
        lo = l1[base_l + pos - r] - rank_l + l1[base_r + r] - rank_r
        loq = l1[base_l + pos + 1 - rq] - rank_l + l1[base_r + rq] - rank_r
        x, xq = np.where(hi_side, r, lo), np.where(hi_side, rq, loq)
    out = []
    for t, side in ((1, hi_side), (2, ~hi_side)):
        xt, xqt = np.where(side, x, 0), np.where(side, xq, 0)
        a, aq = pre["l0"][t][xt], pre["l0"][t][xqt]
        if st.sparse:
            bt = pre["b_ac" if t == 1 else "b_gt"]
            lo, loq = xt - a + bt[xt], xqt - aq + bt[xqt]
        else:
            base_l, rank_l, base_r, rank_r = st._nodes[t]
            l1 = pre["l1"][t]
            lo = l1[base_l + xt - a] - rank_l + l1[base_r + a] - rank_r
            loq = l1[base_l + xqt - aq] - rank_l + l1[base_r + aq] - rank_r
        out.append((np.where(odd, lo, a), np.where(odd, loq, aq)))
    return np.where(hi_side, out[0][0], out[1][0]), np.where(hi_side, out[0][1], out[1][1])


def _rrr_subsets(st, pos, length):
    """SubsetWTRank<RRR15>::subsets: the lo planes rebuilt from the vectors'
    runs, (~hi & ~e) | (hi & b) over acgt and ~hi | b over ac and gt, or
    read from level 1's two nodes."""
    vec, pre = _rrr_vectors(st)

    def tree_planes(t, p, ln, e=None, b=None):
        hi = _run(vec["l0"][t], p, ln)
        r0 = pre["l0"][t][p]
        mask = _low_mask(ln)
        if st.sparse:
            if e is None:
                lo = (~hi | _run(b, p, ln)) & mask
                return hi, lo, r0, p - r0 + pre["b_ac" if t == 1 else "b_gt"][p]
            lo = (~hi & ~_run(e, p, ln) & mask) | (hi & _run(b, p, ln))
            return hi, lo, r0, p - r0 - pre["e"][p] + pre["b"][p]
        base_l, rank_l, base_r, rank_r = st._nodes[t]
        l1 = vec["l1"][t]
        nh = np.bitwise_count(hi)
        lo_l = _run(l1, base_l + p - r0, ln - nh)
        lo_r = _run(l1, base_r + r0, nh)
        lo = _deposit(lo_l, ~hi & mask) | _deposit(lo_r, hi)
        c1 = pre["l1"][t][base_l + p - r0] - rank_l
        c3 = pre["l1"][t][base_r + r0] - rank_r
        return hi, lo, r0, c1 + c3

    hi, lo, rh, rl = tree_planes(0, pos, length, vec.get("e"), vec.get("b"))
    ah, al, _, _ = tree_planes(1, rh, np.bitwise_count(hi), b=vec.get("b_ac"))
    gh, gl, _, _ = tree_planes(2, rl, np.bitwise_count(lo), b=vec.get("b_gt"))
    return [_deposit(ah, hi), _deposit(al, hi), _deposit(gh, lo), _deposit(gl, lo)]


def _struct(case, form):
    kind, sparse = FORMS[form]
    st = tsr.SubsetWTRank.from_bits(case_bits(case), kind, sparse=sparse)
    assert st.sparse == bool(sparse)
    return st


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("case", list(CASES))
def test_device_form_rank_transcribed(case, form):
    """rank and rank_pair as the card takes them, at every (char, position):
    equal to the port's plain version, the JAX answers and the cumulative
    counts, and at the word, block and superblock edges to the oracle."""
    bits = case_bits(case)
    n = bits.shape[1]
    st = _struct(case, form)
    c = np.repeat(np.arange(4), n + 1)
    pos = np.tile(np.arange(n + 1), 4)
    pair = _plain_rank_pair if form == "plain" else _rrr_rank_pair
    rank, _ = pair(st, c, pos)  # the device's rank is rank_pair's first
    j, j1, j2 = subsetwt_rank_answers(case, FORMS[form][0])
    cum = _cum(bits)
    np.testing.assert_array_equal(rank, cum[c, pos])
    np.testing.assert_array_equal(rank, j)
    np.testing.assert_array_equal(st.rank(torch.from_numpy(c), torch.from_numpy(pos)).numpy(), j)
    c2, p2 = c[pos < n], pos[pos < n]
    r1, r2 = pair(st, c2, p2)
    np.testing.assert_array_equal(r1, j1)
    np.testing.assert_array_equal(r2, j2)
    np.testing.assert_array_equal(r2, cum[c2, p2 + 1])
    g1, g2 = st.rank_pair(torch.from_numpy(c2), torch.from_numpy(p2))
    np.testing.assert_array_equal(g1.numpy(), j1)
    np.testing.assert_array_equal(g2.numpy(), j2)
    orc = OracleIndex.__new__(OracleIndex)
    orc.bits = {ch: list(bits[i]) for i, ch in enumerate("ACGT")}
    edges = edge_positions(n)[:: max(1, len(edge_positions(n)) // 60)]
    for ci in range(4):
        got = r2[ci * n + edges]
        assert got.tolist() == [orc.rank(int(i) + 1, "ACGT"[ci]) for i in edges]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("case", list(CASES))
def test_device_form_subsets_transcribed(case, form):
    """subsets(pos, len) as succ1's span kernel takes it: bit j of w[c] is
    char c in column pos + j, at every word, block and superblock edge and
    at random positions, runs of 0-32 columns."""
    bits = case_bits(case)
    n = bits.shape[1]
    st = _struct(case, form)
    rng = np.random.default_rng(n + len(form))
    pos = np.concatenate([edge_positions(n), rng.integers(0, n, size=400)])
    length = np.minimum(rng.integers(0, 33, size=len(pos)), n - pos)
    length[:: 5] = np.minimum(32, n - pos[:: 5])
    got = (_plain_subsets if form == "plain" else _rrr_subsets)(st, pos, length)
    for c in range(4):
        np.testing.assert_array_equal(got[c], _run(bits[c], pos, length), err_msg=str(c))


@pytest.mark.parametrize("case", list(CASES))
def test_position_order_identities(case):
    """The counts the sparse form takes in place of level 1, at every
    position: GT-present(p) = (p - r0(p)) - e(p) + b(p) over acgt,
    C-present(x) = (x - a0(x)) + b_ac(x) over ac, T-present likewise over gt."""
    bits = case_bits(case)
    acgt, ac, gt = tsr._sswt_symbols(bits)
    A, C, G, T = bits
    for sym, lo_bits, e in ((acgt, G | T, acgt == 0), (ac, C[A | C], None), (gt, T[G | T], None)):
        p = np.arange(len(sym) + 1)
        r0 = _prefix(sym >= 2)[p]
        rhs = p - r0 + _prefix(sym == 3)[p]
        if e is None:
            assert not (sym == 0).any()
        else:
            rhs = rhs - _prefix(e)[p]
        np.testing.assert_array_equal(_prefix(lo_bits)[p], rhs)


@pytest.mark.parametrize("case", list(CASES))
def test_device_bytes_no_larger(case):
    """plain-subsetwt's device form holds exactly the bytes of its wavelet
    trees' levels; rrr-subsetwt's no more: the sparse vectors where they are
    smaller than level 1, else level 1 itself. Both report the trees' bytes
    as their size, as the JAX package does."""
    bits = case_bits(case)
    parent = {kind: sum(WaveletTree.build(s, 4, kind).size_in_bytes()
                        for s in tsr._sswt_symbols(bits)) for kind in ("plain", "rrr")}
    plain = tsr.SubsetWTRank.from_bits(bits, "plain")
    assert plain.device_bytes() == parent["plain"] == plain.size_in_bytes()
    assert plain.size_in_bytes() == jax_build_struct("plain-subsetwt", bits).size_in_bytes()
    rrr = tsr.SubsetWTRank.from_bits(bits, "rrr")
    assert rrr.size_in_bytes() == parent["rrr"]
    assert rrr.size_in_bytes() == jax_build_struct("rrr-subsetwt", bits).size_in_bytes()
    forced = {s: tsr.SubsetWTRank.from_bits(bits, "rrr", sparse=s).device_bytes()
              for s in (True, False)}
    assert forced[False] == parent["rrr"]
    assert rrr.sparse == (forced[True] <= forced[False])
    assert rrr.device_bytes() == min(forced.values()) <= parent["rrr"]
    assert rrr.sparse == (case == "unary")


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("case", list(CASES))
def test_payload_round_trip_from_device_form(case, form):
    """The payload rebuilt from the device form is the JAX payload byte for
    byte, and a structure loaded from it holds the same device form."""
    bits = case_bits(case)
    kind, sparse = FORMS[form]
    st = _struct(case, form)
    np.testing.assert_array_equal(st.to_bits(), bits)
    payload = st.payload()
    assert_payload_equal(payload, jax_build_struct(f"{kind}-subsetwt", bits).payload())
    back = tsr.SubsetWTRank.from_payload(payload, kind, sparse=sparse)
    assert back.sparse == st.sparse and back.device_bytes() == st.device_bytes()
    for (name, a), (name_b, b) in zip(st.state_dict().items(), back.state_dict().items()):
        assert name == name_b and torch.equal(a, b), name


@pytest.fixture(scope="module")
def genome_pair():
    """A genome with homopolymers and tandem repeats beside random sequence,
    indexed at k = 12 by both packages."""
    rng = np.random.default_rng(5)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    g = (rand(1500) + "A" * 200 + "ACGT" * 60 + rand(500) + "AC" * 100 + "GT" * 100 + rand(800)
         + "AAAAAAC" * 30 + rand(300))
    jax_sb = JaxSBWT.build([g], 12, precalc_k=4)
    port = SBWT.from_bits(jax_sb.bits, jax_sb.suffix_group_starts, 12, jax_sb.number_of_kmers(),
                          "cpu", 4)
    return jax_sb, port


@pytest.mark.parametrize("fmt", ["cpp", "native"])
@pytest.mark.parametrize("variant", ["plain-subsetwt", "rrr-subsetwt"])
def test_index_file_round_trip_from_device_form(genome_pair, tmp_path, variant, fmt):
    """A genome's index takes the sparse form (rrr) in fewer device bytes;
    its file, written from the device form, is the JAX file byte for byte,
    and loading and saving it again gives the same bytes."""
    jax_sb, port = genome_pair
    ps = port.to_variant(variant)
    st = ps.device_index.struct
    if variant == "rrr-subsetwt":
        assert st.sparse and st.device_bytes() < st.size_in_bytes()
    else:
        assert st.device_bytes() == st.size_in_bytes()
    jax_file, port_file, again = (tmp_path / f for f in ("jax.sbwt", "port.sbwt", "again.sbwt"))
    jax_io.save(str(jax_file), jax_sb.to_variant(variant), fmt)
    port_io.save(str(port_file), ps, fmt)
    assert port_file.read_bytes() == jax_file.read_bytes()
    loaded = port_io.load(str(port_file), "cpu")
    assert loaded.device_index.struct.sparse == st.sparse
    port_io.save(str(again), loaded, fmt)
    assert again.read_bytes() == jax_file.read_bytes()
