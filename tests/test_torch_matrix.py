"""Port parity: the plain-matrix index of sbwt_tpu_torch against sbwt_tpu.

Indexes are built by the JAX package and carried into the port as numpy
state (from_numpy_state); every rank, edge bit and suffix-group start is
compared at every position 0..n, and the port's own table builders must
give the JAX tables byte for byte. All outputs are integers: equality is
exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.ops import bitvector as tbv
from torch_state import matrix_state


# n crosses word boundaries: 300 bp (k=5), 4000 bp (k=14), 2049 bp (k=31)
@pytest.fixture(scope="module", params=[(5, 300), (14, 4000), (31, 2049)],
                ids=["k5", "k14", "k31"])
def pair(request):
    k, n_bp = request.param
    rng = np.random.default_rng(100 + k)
    g = "".join(rng.choice(list("ACGT"), size=n_bp))
    js = SBWT.build([g], k, precalc_k=0)
    return js, tm.from_numpy_state(matrix_state(js.device_index), "cpu")


@jax.jit
def _jax_ranks(di, pos):
    outs = [di.extend_rank(jnp.full_like(pos, c), pos) for c in range(4)]
    return jnp.stack([o[0] for o in outs]), jnp.stack([o[1] for o in outs])


def test_rank_and_extend_rank_every_position(pair):
    js, ti = pair
    n = ti.n_nodes
    pos = np.arange(n + 1, dtype=np.int32)
    ref_r, ref_b = (np.asarray(a) for a in _jax_ranks(js.device_index, jnp.asarray(pos)))
    pt = torch.from_numpy(pos)
    for c in range(4):
        r, b = ti.extend_rank(c, pt)
        np.testing.assert_array_equal(r.numpy(), ref_r[c])
        np.testing.assert_array_equal(b.numpy(), ref_b[c])
        np.testing.assert_array_equal(ti.rank_c(c, pt).numpy(), ref_r[c])


def test_sg_start_every_column(pair):
    js, ti = pair
    cols = np.arange(ti.n_nodes + 1, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda di, c: di.sg_start(c))(js.device_index, jnp.asarray(cols)))
    np.testing.assert_array_equal(ti.sg_start(torch.from_numpy(cols)).numpy(), ref)


def test_bitvector_rank_matches_host_popcount(pair):
    _, ti = pair
    tbl = ti.rank_tbl[: ti.n_words]  # the A row
    words = tbl[:, 0].numpy().view(np.uint32)
    bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).ravel()
    pos = torch.arange(ti.n_nodes + 1)
    np.testing.assert_array_equal(
        tbv.rank(tbl, pos).numpy(), np.concatenate([[0], np.cumsum(bits)])[: ti.n_nodes + 1]
    )


def test_port_builders_byte_equal(pair):
    js, ti = pair
    di = js.device_index
    bits, sgs = js.bits, js.suffix_group_starts
    from_bools = tm.from_host_arrays(bits, sgs, di.k, di.n_kmers, "cpu")
    row_words = np.stack([tbv.pack_bits_host(bits[c]) for c in range(4)])
    from_words = tm.from_packed_rows(row_words, di.n_nodes, tbv.pack_bits_host(sgs),
                                     di.k, di.n_kmers, "cpu")
    for idx in (from_bools, from_words):
        for f in ("rank_tbl", "sgs_tbl", "C", "precalc"):
            a, b = getattr(idx, f).numpy(), np.asarray(getattr(di, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert (idx.n_nodes, idx.n_words, idx.has_streaming) == (
            di.n_nodes, di.n_words, di.has_streaming)


def test_no_streaming_support_table():
    rng = np.random.default_rng(3)
    g = "".join(rng.choice(list("ACGT"), size=500))
    js = SBWT.build([g], 9, streaming_support=False)
    ti = tm.from_host_arrays(js.bits, js.suffix_group_starts, 9, js.number_of_kmers(), "cpu")
    assert not ti.has_streaming
    assert ti.sgs_tbl.numpy().tobytes() == np.asarray(js.device_index.sgs_tbl).tobytes()
