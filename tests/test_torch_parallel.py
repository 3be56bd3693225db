"""The port's parallel layer (sbwt_tpu_torch/parallel/sharded.py) against
the JAX package's (sbwt_tpu/parallel/sharded.py), on the CPU.

Each test mirrors one of tests/test_parallel.py with the same SEQS, K,
batch and (n_data, n_model): JAX runs on the 8 virtual CPU devices of
tests/conftest.py, the port over 8 slots of ``cpu`` (a mesh may repeat a
device), and the answers are equal exactly. DP and TP search and
streaming are held to the JAX sharded entry points themselves. The turbo
paths are held to the single-device answers that tests/test_parallel.py
holds the JAX sharded turbo paths to, so that this file does not compile
JAX's shard_map turbo programs again (34 s there for one test); the
sharded build's real rows are held to the JAX single-device table, as
there. A second corpus, whose table rows are not a multiple of the model
axis, hits the pad rows and the shard boundaries at n_model 1, 3 and 8.
On the CPU every sharded gather is the JAX formula: a masked local gather
per shard, summed over the shards.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_state  # noqa: F401  (one torch thread)
from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.ops.turbo import build_turbo as jax_build_turbo
from sbwt_tpu.parallel import sharded as jsh
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.parallel import sharded
from torch_state import matrix_state

SEQS = ["CCCGTGATGGCTAGCTAGCTGATCGATCGTACGTACGTAGCTAGCATCG" * 3, "TAATGCTGTAGCAAAGGCTTAC"]
K = 8
CPU8 = [torch.device("cpu")] * 8


def mesh(n_data, n_model):
    return sharded.make_mesh(n_data=n_data, n_model=n_model, devices=CPU8)


@pytest.fixture(scope="module")
def sbwt():
    return SBWT.build(SEQS, K, precalc_k=3)


@pytest.fixture(scope="module")
def index(sbwt):
    return tm.from_numpy_state(matrix_state(sbwt.device_index), "cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(42)
    reads = []
    for _ in range(16):
        if rng.random() < 0.5:
            s = SEQS[0][int(rng.integers(0, 20)) : int(rng.integers(40, 120))]
        else:
            s = "".join(rng.choice(list("ACGT"), size=64))
        reads.append(s)
    L = 160
    codes = np.full((16, L), -1, dtype=np.int8)
    lengths = np.zeros(16, dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = encode_query(r)
        lengths[i] = len(r)
    return codes, lengths


@pytest.fixture(scope="module")
def streaming_ref(sbwt, batch):
    return sbwt.streaming_search_batch(*batch)


def test_eight_cpu_slots():
    assert len(jax.devices()) == 8
    m = mesh(8, 1)
    assert m.shape == {"data": 8, "model": 1} and m.distinct_devices() == [torch.device("cpu")]


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()


def test_cuda_mesh_of_unreachable_cards_raises(monkeypatch):
    """make_mesh enables peer access from each data row's first card to its
    other cards; a refused pair raises, with no copy in its place."""
    asked = []

    def refuse(device, peer):
        asked.append((device, peer))
        raise RuntimeError(f"{device} cannot load from {peer}")

    monkeypatch.setattr(kernels, "enable_peer_access", refuse)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    sharded.make_mesh(n_data=2, n_model=1, devices=cards)  # DP: no pair to reach
    with pytest.raises(RuntimeError, match="cannot load from"):
        sharded.make_mesh(n_data=1, n_model=2, devices=cards)
    assert asked == [(cards[0], cards[1])]


def test_dp_search_matches_single_device(sbwt, index, batch):
    kmers = batch[0][:, :K]
    jm = jsh.make_mesh(n_data=8, n_model=1)
    want = np.asarray(jsh.dp_search(jsh.replicate_index(sbwt.device_index, jm), kmers, jm))
    np.testing.assert_array_equal(want, sbwt.search_batch(kmers))
    m = mesh(8, 1)
    got = sharded.dp_search(sharded.replicate_index(index, m), kmers, m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dp_streaming_matches_single_device(sbwt, index, batch, streaming_ref):
    codes, lengths = batch
    jm = jsh.make_mesh(n_data=8, n_model=1)
    want = np.asarray(jsh.dp_streaming_search(jsh.replicate_index(sbwt.device_index, jm), codes,
                                              lengths, jm))
    np.testing.assert_array_equal(want, streaming_ref)
    m = mesh(8, 1)
    got = sharded.dp_streaming_search(sharded.replicate_index(index, m), codes, lengths, m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4), (1, 8)])
def test_tp_search_matches_single_device(sbwt, index, batch, n_data, n_model):
    kmers = batch[0][:, :K]
    jm = jsh.make_mesh(n_data=n_data, n_model=n_model)
    want = np.asarray(jsh.tp_search(sbwt.device_index, kmers, jm))
    np.testing.assert_array_equal(want, sbwt.search_batch(kmers))
    got = sharded.tp_search(index, kmers, mesh(n_data, n_model))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4), (1, 8)])
def test_tp_streaming_matches_single_device(sbwt, index, batch, streaming_ref, n_data, n_model):
    codes, lengths = batch
    if (n_data, n_model) == (4, 2):  # the JAX test's mesh: hold the port to its sharded run too
        jm = jsh.make_mesh(n_data=4, n_model=2)
        want = np.asarray(jsh.tp_streaming_search(sbwt.device_index, codes, lengths, jm))
        np.testing.assert_array_equal(want, streaming_ref)
    got = sharded.tp_streaming_search(index, codes, lengths, mesh(n_data, n_model))
    np.testing.assert_array_equal(got.numpy(), streaming_ref)


def test_dp_turbo_matches_single_device(index, batch, streaming_ref):
    codes, lengths = batch
    turbo = tt.build_turbo(index)
    expected = tt.turbo_streaming_search(turbo, index, torch.from_numpy(codes),
                                         torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(expected, streaming_ref)
    got = sharded.dp_turbo_streaming_search(turbo, index, codes, lengths, mesh(8, 1))
    np.testing.assert_array_equal(got.numpy(), expected)


def test_shard_index_rows_idempotent(index):
    """The TP entry points accept a pre-sharded index without placing it again."""
    m = mesh(4, 2)
    s1 = sharded.shard_index_rows(index, m)
    assert sharded.is_row_sharded(s1, m)
    s2 = sharded.shard_index_rows(s1, m)
    assert s2 is s1
    assert not sharded.is_row_sharded(s1, mesh(2, 4))
    with pytest.raises(ValueError, match="another mesh"):
        sharded.shard_index_rows(s1, mesh(2, 4))


def test_slots_on_one_device_share_tables(index):
    m = mesh(4, 2)
    views = sharded.shard_index_rows(index, m).views
    assert all(v.rank_shard_1 is views[0].rank_shard_1 and v.C is views[0].C for v in views)
    reps = sharded.replicate_index(index, m)
    assert reps.on(torch.device("cpu")) is index


def test_tp_turbo_streaming_matches_reference(index, batch, streaming_ref):
    """Row-sharded turbo table (K20b's plain version): answers equal the
    single-device turbo engine's bit for bit, at arity 1 over (4, 2) and
    (2, 4), at arity 3 over (2, 4)."""
    codes, lengths = batch
    t1 = tt.build_turbo(index, arity=1)
    for n_data, n_model in [(4, 2), (2, 4)]:
        got = sharded.tp_turbo_streaming_search(t1, index, codes, lengths, mesh(n_data, n_model))
        np.testing.assert_array_equal(got.numpy(), streaming_ref, err_msg=f"{n_data}x{n_model}")
    t3 = tt.build_turbo(index, arity=3)
    got3 = sharded.tp_turbo_streaming_search(t3, index, codes, lengths, mesh(2, 4))
    np.testing.assert_array_equal(got3.numpy(), streaming_ref)


@pytest.mark.parametrize("arity", [2, 3])
def test_build_turbo_sharded_matches_single_device(sbwt, index, batch, streaming_ref, arity):
    """Per-shard table build (K20c's plain version): every real column's
    rows equal the JAX single-device table's, pad columns hold zeros, and
    the answers equal the single-device engine's."""
    codes, lengths = batch
    want_tbl = np.asarray(jax_build_turbo(sbwt.device_index, arity=arity).tbl)
    m = mesh(2, 4)
    tsh = sharded.build_turbo_sharded(index, m, arity=arity)
    assert sharded.is_turbo_row_sharded(tsh, m)
    rpc, n = 4**arity, index.n_nodes
    cols = tsh.views[0].cols
    assert cols == -(-n // 4)
    for shard, got in enumerate(tsh.views[0].tbl_shards):
        assert got.shape[0] == cols * rpc
        lo, hi = shard * cols, min(n, (shard + 1) * cols)
        real = max(0, hi - lo) * rpc
        np.testing.assert_array_equal(got[:real].numpy(), want_tbl[lo * rpc : lo * rpc + real],
                                      err_msg=f"shard {shard}")
        assert not got[real:].any()
    got = sharded.tp_turbo_streaming_search(tsh, index, codes, lengths, m)
    np.testing.assert_array_equal(got.numpy(), streaming_ref, err_msg=f"arity {arity}")


def test_build_turbo_sharded_exceeds_per_device_budget(index, batch, streaming_ref):
    """An aggregate table bigger than any one device's declared budget,
    never materialized whole: each shard fits the budget, the total does
    not."""
    codes, lengths = batch
    m = mesh(1, 8)
    tsh = sharded.build_turbo_sharded(index, m, arity=3)
    shards = tsh.views[0].tbl_shards
    total_bytes = sum(s.numel() * 4 for s in shards)
    per_shard_bytes = total_bytes // 8
    declared_budget = per_shard_bytes * 2  # any one device can hold 2 shards, not 8
    assert per_shard_bytes <= declared_budget < total_bytes
    assert all(s.numel() * 4 <= declared_budget for s in shards)
    got = sharded.tp_turbo_streaming_search(tsh, index, codes, lengths, m)
    np.testing.assert_array_equal(got.numpy(), streaming_ref)


def test_turbo_int32_ceiling_guards(index):
    """build_turbo and the TP shard placement refuse configurations whose
    flat row index col * 4^arity + sub would overflow int32 (the same
    exception type and message as the JAX package's)."""
    tt.check_turbo_index_range(2**25 - 1, 3)  # fits
    with pytest.raises(ValueError, match="int32"):
        tt.check_turbo_index_range(2**25, 3)
    with pytest.raises(ValueError, match="int32"):
        tt.check_turbo_index_range(2**27, 2)
    tt.check_turbo_index_range(2**30, 1)  # arity 1 indexes by bare column

    fake_big = copy.copy(index)
    fake_big.n_nodes = 2**26
    with pytest.raises(ValueError, match="int32"):
        tt.build_turbo(fake_big, arity=3)

    # per-shard guard: 8 shards of 2^25 columns at arity 3 would each
    # overflow; the sharded build refuses before allocating
    fake_huge = copy.copy(index)
    fake_huge.n_nodes = 2**28
    with pytest.raises(ValueError, match="shard"):
        sharded.build_turbo_sharded(fake_huge, mesh(1, 8), arity=3)


def test_cpu_runs_launch_nothing(index, batch):
    before = dict(kernels.LAUNCHES)
    m = mesh(2, 4)
    sharded.tp_streaming_search(index, *batch, m)
    sharded.tp_turbo_streaming_search(sharded.build_turbo_sharded(index, m, 2), index, *batch, m)
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# Shard boundaries: a corpus whose rank and suffix-group tables have a row
# count that is a multiple of neither 3 nor 8, so the last shard carries pad
# rows and real rows sit on every boundary.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def boundary_case():
    rng = np.random.default_rng(2024)
    genome = "".join(rng.choice(list("ACGT"), size=1200))  # n_words 47
    js = SBWT.build([genome, genome[200:500][::-1]], 11, precalc_k=4)
    enc = encode_query(genome)
    L, B = 48, 96
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    for i in range(0, B, 2):
        s = int(rng.integers(0, len(genome) - L))
        codes[i] = enc[s : s + L]
    for i in range(1, B, 4):  # chimeric: restarts land on real k-mers
        cut = int(rng.integers(1, L - 11))
        s = int(rng.integers(0, len(genome) - L))
        codes[i, cut:] = enc[s : s + L - cut]
    codes[1::3, 5:9] |= 4
    codes[3::7, 20] = -1
    lengths = np.full(B, L, np.int32)
    lengths[::5] = rng.integers(0, L + 1, size=len(lengths[::5]))
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    ti = tm.from_numpy_state(matrix_state(js.device_index), "cpu")
    return js, ti, codes, lengths, js.streaming_search_batch(codes, lengths)


@pytest.mark.parametrize("n_model", [1, 3, 8])
def test_shard_boundaries_and_pad_rows(boundary_case, n_model):
    js, ti, codes, lengths, want = boundary_case
    rows = ti.rank_tbl.shape[0], ti.sgs_tbl.shape[0]
    assert all(r % 3 and r % 8 for r in rows)
    m = sharded.make_mesh(n_data=2, n_model=n_model, devices=CPU8)
    view = sharded.shard_index_rows(ti, m).views[1]
    # every row of both tables through the shards, boundary rows included
    for flat, shards in ((ti.rank_tbl, view.rank_shards), (ti.sgs_tbl, view.sgs_shards)):
        per = -(-flat.shape[0] // n_model)
        assert all(s.shape[0] == per for s in shards)
        assert torch.equal(sharded.sharded_gather(shards, torch.arange(flat.shape[0])), flat)
        if n_model > 1:
            assert not shards[-1][flat.shape[0] - (n_model - 1) * per :].any()
    kmers = codes[:, :11]
    np.testing.assert_array_equal(sharded.tp_search(ti, kmers, m).numpy(), js.search_batch(kmers))
    np.testing.assert_array_equal(sharded.tp_streaming_search(ti, codes, lengths, m).numpy(), want)
    for arity in (1, 2, 3):
        t = tt.build_turbo(ti, arity)
        got = sharded.tp_turbo_streaming_search(t, ti, codes, lengths, m)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"placed, arity {arity}")
        if arity >= 2:
            b = sharded.build_turbo_sharded(ti, m, arity)
            flat = torch.cat(b.views[0].tbl_shards)[: t.tbl.shape[0]]
            assert torch.equal(flat, t.tbl)
            got = sharded.tp_turbo_streaming_search(b, ti, codes, lengths, m)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"built, arity {arity}")
