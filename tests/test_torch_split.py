"""SplitRank's device form (csrc/subset_rank.cuh), transcribed in numpy.

plain-, rrr- and mef-split hold X (plain, RRR or MEF), Z (plain) and Y,
the unary columns' labels, as position-order rows: one 32-byte row a 64
positions, (hi bits 0-31, hi bits 32-63, lo bits 0-31, lo bits 32-63, H,
L, B, 0). The transcriptions below follow the device code step for step,
with X's and Z's ranks taken from their decoded bits, and are held to the
port's plain SplitRank, to the JAX SplitRank's answers
(tests/torch_state.py), to the cumulative counts and to tests/oracle.py.
The cases (tests/subsetwt_cases.py SPLIT_CASES) hold empty sets and sets of
all four chars (n_Y = 0 in dense), a case with no branching column (n_b =
0) and Y lengths that are multiples of 64 (sets_1_4, sparse, all_unary),
so that p = n_Y reads the terminal row.
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
from subsetwt_cases import SPLIT_CASES, case_bits, edge_positions
from test_torch_bv import assert_payload_equal
from torch_state import split_rank_answers

X_KINDS = ("plain", "rrr", "mef")
U64 = np.uint64


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


def _word64(rows, col):
    """The 64-bit plane of rows' columns col (bits 0-31) and col + 1."""
    w = rows.astype(np.int64) & 0xFFFFFFFF
    return (w[:, col] | (w[:, col + 1] << 32)).astype(U64)


def _y_rank_get(rows, c, p):
    """SplitRank<X>::y_rank_get: the count of c in Y before p and whether
    the symbol at p is c, from p's row."""
    row = rows[p >> 6]
    flip_h = np.where((c & 2) != 0, U64(0), ~U64(0))
    flip_l = np.where((c & 1) != 0, U64(0), ~U64(0))
    m = (_word64(row, 0) ^ flip_h) & (_word64(row, 2) ^ flip_l)
    o = (p & 63).astype(U64)
    h, l, b = (row[:, i].astype(np.int64) for i in (4, 5, 6))
    before = np.select([c == 3, c == 2, c == 1], [b, h - b, l - b], (p & ~63) - h - l + b)
    below = (U64(1) << o) - U64(1)
    return before + np.bitwise_count(m & below).astype(np.int64), ((m >> o) & U64(1)).astype(np.int64)


def _vectors(st):
    return _prefix(st.X.to_bools()), st.X.to_bools(), _prefix(st.Z.to_bools()), st.Z.to_bools()


def _rank_pair(st, c, pos):
    """SplitRank<X>::rank_pair: X's rank pair, then Y's row beside Z's."""
    x, _, z, _ = _vectors(st)
    xr, xq = x[pos], x[pos + 1]
    y, ybit = _y_rank_get(st.Y.numpy(), c, pos - xr)
    zi = c * st.n_b + xr
    zb = st.z_base.numpy()[c]
    return y + z[zi] - zb, np.where(xq > xr, y + z[zi + 1], y + ybit + z[zi]) - zb


def _rank(st, c, pos):
    """SplitRank<X>::rank"""
    x, _, z, _ = _vectors(st)
    xr = x[pos]
    return _y_rank_get(st.Y.numpy(), c, pos - xr)[0] + z[c * st.n_b + xr] - st.z_base.numpy()[c]


def _y_planes(rows, p, length):
    """SplitRank<X>::y_planes: Y's hi and lo planes of p .. p + length - 1,
    the next row only where the run crosses into it."""
    r = p >> 6
    o = (p & 63).astype(U64)
    cross = (p & 63) + length > 64
    nxt = rows[np.where(cross, r + 1, r)]
    out = []
    for col in (0, 2):
        v = _word64(rows[r], col) >> o
        spill = np.where(cross, _word64(nxt, col) << (U64(64) - o), U64(0))
        out.append(((v | spill) & U64(0xFFFFFFFF)).astype(np.int64) & _low_mask(length))
    return out


def _subsets(st, pos, length):
    """SplitRank<X>::subsets: X's bits split the run between Z's run from
    xr and Y's symbols from pos - xr."""
    x, xb, z, zb = _vectors(st)
    xw = _run(xb, pos, length)
    xr = x[pos]
    nx = np.bitwise_count(xw).astype(np.int64)
    ny = length - nx
    yw = ~xw & _low_mask(length)
    hi, lo = _y_planes(st.Y.numpy(), pos - xr, ny)
    out = []
    for c in range(4):
        zw = _run(zb, c * st.n_b + xr, nx)
        eq = (hi if c & 2 else ~hi) & (lo if c & 1 else ~lo) & _low_mask(ny)
        out.append(_deposit(zw, xw) | _deposit(eq, yw))
    return out


def _y_row_edges(st, n):
    """Columns whose Y position (pos - X.rank(pos)) is at or beside a row
    edge of 64, and the last column."""
    x, _, _, _ = _vectors(st)
    pos = np.arange(n)
    yp = (pos - x[pos]) % 64
    return np.unique(np.concatenate([pos[(yp <= 1) | (yp >= 62)], [n - 1]]))


@pytest.mark.parametrize("x_kind", X_KINDS)
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_device_form_rank_transcribed(case, x_kind):
    """rank and rank_pair as the card takes them, at every (char, position
    0..n): equal to the port's plain version, the JAX answers and the
    cumulative counts, and at the word, block, superblock and Y-row edges
    to the oracle."""
    bits = case_bits(case)
    n = bits.shape[1]
    st = tsr.SplitRank.from_bits(bits, x_kind)
    c = np.repeat(np.arange(4), n + 1)
    pos = np.tile(np.arange(n + 1), 4)
    j, j1, j2 = split_rank_answers(case, x_kind)
    cum = _cum(bits)
    rank = _rank(st, c, pos)
    np.testing.assert_array_equal(rank, cum[c, pos])
    np.testing.assert_array_equal(rank, j)
    np.testing.assert_array_equal(st.rank(torch.from_numpy(c), torch.from_numpy(pos)).numpy(), j)
    c2, p2 = c[pos < n], pos[pos < n]
    r1, r2 = _rank_pair(st, c2, p2)
    np.testing.assert_array_equal(r1, j1)
    np.testing.assert_array_equal(r2, j2)
    np.testing.assert_array_equal(r2, cum[c2, p2 + 1])
    g1, g2 = st.rank_pair(torch.from_numpy(c2), torch.from_numpy(p2))
    np.testing.assert_array_equal(g1.numpy(), j1)
    np.testing.assert_array_equal(g2.numpy(), j2)
    orc = OracleIndex.__new__(OracleIndex)
    orc.bits = {ch: list(bits[i]) for i, ch in enumerate("ACGT")}
    edges = np.unique(np.concatenate([edge_positions(n), _y_row_edges(st, n)]))
    edges = edges[:: max(1, len(edges) // 80)]
    for ci in range(4):
        assert r2[ci * n + edges].tolist() == [orc.rank(int(i) + 1, "ACGT"[ci]) for i in edges]


@pytest.mark.parametrize("x_kind", X_KINDS)
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_device_form_subsets_transcribed(case, x_kind):
    """subsets(pos, len) as succ1's span kernel takes it: bit j of w[c] is
    char c in column pos + j, for runs of 32 (or to the end) from every
    column, and runs of 0-32 at the edges and at random columns."""
    bits = case_bits(case)
    n = bits.shape[1]
    st = tsr.SplitRank.from_bits(bits, x_kind)
    rng = np.random.default_rng(n + len(x_kind))
    some = np.concatenate([edge_positions(n), _y_row_edges(st, n), rng.integers(0, n, size=400)])
    pos = np.concatenate([np.arange(n), some])
    length = np.concatenate([np.minimum(32, n - np.arange(n)),
                             np.minimum(rng.integers(0, 33, size=len(some)), n - some)])
    got = _subsets(st, pos, length)
    for c in range(4):
        np.testing.assert_array_equal(got[c], _run(bits[c], pos, length), err_msg=str(c))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_y_rows_bytes(case):
    """Y's rows take the bytes of its wavelet tree's two levels (16 a 32
    positions), plus at most one row; the structure reports the tree's
    bytes as its size, as the JAX package does, and the rows in
    device_bytes."""
    bits = case_bits(case)
    for x_kind in X_KINDS:
        st = tsr.SplitRank.from_bits(bits, x_kind)
        levels = WaveletTree.build(st.y_symbols(), 4, "plain").size_in_bytes()
        rows = st.Y.numel() * 4
        assert levels <= rows <= levels + 32
        assert st.Y.shape == (st.n_y // 64 + 1, 8)
        assert st.size_in_bytes() == jax_build_struct(f"{x_kind}-split", bits).size_in_bytes()
        assert st.device_bytes() == st.size_in_bytes() - levels + rows
        assert st.Y.data_ptr() % 32 == 0


@pytest.mark.parametrize("x_kind", X_KINDS)
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_payload_round_trip_from_device_form(case, x_kind):
    """The payload rebuilt from the device form is the JAX payload byte for
    byte, and a structure loaded from it holds the same rows."""
    bits = case_bits(case)
    st = tsr.SplitRank.from_bits(bits, x_kind)
    np.testing.assert_array_equal(st.to_bits(), bits)
    payload = st.payload()
    assert_payload_equal(payload, jax_build_struct(f"{x_kind}-split", bits).payload())
    back = tsr.SplitRank.from_payload(payload, x_kind)
    assert back.n_y == st.n_y and back.device_bytes() == st.device_bytes()
    for (name, a), (name_b, b) in zip(st.state_dict().items(), back.state_dict().items()):
        assert name == name_b and torch.equal(a, b), name


@pytest.fixture(scope="module")
def genome_pair():
    """A genome with homopolymers and tandem repeats beside random sequence,
    indexed at k = 12 by both packages."""
    rng = np.random.default_rng(15)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    g = (rand(1500) + "A" * 200 + "ACGT" * 60 + rand(500) + "AC" * 100 + "GT" * 100 + rand(800)
         + "AAAAAAC" * 30 + rand(300))
    jax_sb = JaxSBWT.build([g], 12, precalc_k=4)
    port = SBWT.from_bits(jax_sb.bits, jax_sb.suffix_group_starts, 12, jax_sb.number_of_kmers(),
                          "cpu", 4)
    return jax_sb, port


@pytest.mark.parametrize("fmt", ["cpp", "native"])
@pytest.mark.parametrize("variant", ["plain-split", "rrr-split", "mef-split"])
def test_index_file_round_trip_from_device_form(genome_pair, tmp_path, variant, fmt):
    """A genome's index file, written from the device form, is the JAX file
    byte for byte, and loading and saving it again gives the same bytes."""
    jax_sb, port = genome_pair
    ps = port.to_variant(variant)
    st = ps.device_index.struct
    assert st.n_y > 0 and st.n_b > 0
    jax_file, port_file, again = (tmp_path / f for f in ("jax.sbwt", "port.sbwt", "again.sbwt"))
    jax_io.save(str(jax_file), jax_sb.to_variant(variant), fmt)
    port_io.save(str(port_file), ps, fmt)
    assert port_file.read_bytes() == jax_file.read_bytes()
    loaded = port_io.load(str(port_file), "cpu")
    assert torch.equal(loaded.device_index.struct.Y, st.Y)
    port_io.save(str(again), loaded, fmt)
    assert again.read_bytes() == jax_file.read_bytes()
