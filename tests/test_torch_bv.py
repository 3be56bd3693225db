"""Port parity: bit vectors with rank (K15's plain versions).

The JAX package's PlainBV, RRRBV and MEFBV and the port's, built from the
same numpy-seeded bools: host payloads byte-equal, and rank, rank_pair and
get equal at every position (exact integers). The sizes are those of
tests/test_rank_pair.py plus two that cross many RRR superblocks (240
bits) and MEF buckets. The port's structure carried over from the JAX
payload answers the same.
"""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sbwt_tpu.ops import bv as jbv
from sbwt_tpu_torch.kernels import CSRC
from sbwt_tpu_torch.ops import bv as tbv
from torch_state import bv_from_jax

SIZES = [(1, 0.5), (97, 0.3), (2048, 0.25), (700, 0.02), (5000, 0.5), (6000, 0.97)]


def _bools(n, density, seed):
    return np.random.default_rng(seed).random(n) < density


def assert_payload_equal(got: dict, ref: dict):
    assert list(got) == list(ref)
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("kind", ["plain", "rrr", "mef"])
@pytest.mark.parametrize("n,density", SIZES)
def test_bv_matches_jax(kind, n, density):
    bools = _bools(n, density, n + int(density * 100))
    ref = jbv.BV_CLASSES[kind].build(bools)
    got = tbv.BV_CLASSES[kind].build(bools)
    assert_payload_equal(got.payload(), ref.payload())
    assert got.size_in_bytes() == ref.size_in_bytes()
    np.testing.assert_array_equal(got.to_bools(), bools)
    pos = np.arange(n + 1, dtype=np.int32)
    want_rank = np.asarray(jax.jit(ref.rank)(jnp.asarray(pos)))
    want_r1, want_r2 = (np.asarray(a) for a in jax.jit(ref.rank_pair)(jnp.asarray(pos[:n])))
    want_get = np.asarray(jax.jit(ref.get)(jnp.asarray(pos[:n])))
    for bv in (got, bv_from_jax(ref)):
        tpos = torch.from_numpy(pos).long()
        np.testing.assert_array_equal(bv.rank(tpos).numpy(), want_rank)
        r1, r2 = bv.rank_pair(tpos[:n])
        np.testing.assert_array_equal(r1.numpy(), want_r1)
        np.testing.assert_array_equal(r2.numpy(), want_r2)
        np.testing.assert_array_equal(bv.get(tpos[:n]).numpy(), want_get)
    np.testing.assert_array_equal(want_rank, np.concatenate([[0], np.cumsum(bools)]))


def test_mef_width_matches_jax():
    for n, density in SIZES:
        bools = _bools(n, density, 3)
        assert tbv.best_mef_width(bools) == jbv._best_mef_width(bools)


def test_rrr_tables_match_jax_and_device_constants():
    np.testing.assert_array_equal(tbv.PATTERN15, jbv._PATTERN15)
    np.testing.assert_array_equal(tbv.WIDTH15, jbv._WIDTH15)
    np.testing.assert_array_equal(tbv.CLS_BASE15, jbv._CLS_BASE15)
    assert (tbv.W15LO, tbv.W15HI) == (int(jbv._W15LO), int(jbv._W15HI))
    header = (CSRC / "bv.cuh").read_text()
    lo = int(re.search(r"kW15Lo = (0x[0-9A-F]+)u", header).group(1), 16)
    hi = int(re.search(r"kW15Hi = (0x[0-9A-F]+)u", header).group(1), 16)
    assert (lo, hi) == (tbv.W15LO, tbv.W15HI)


def test_legacy_rrr_payload_is_refused():
    with pytest.raises(ValueError, match="legacy"):
        tbv.RRRBV.from_payload({"meta": np.zeros((1, 5), np.int32), "offs": np.zeros(1, np.int32),
                                "n_bits": np.int64(0)})
