"""Port parity: fast_search, the singleton-seed k-mer search through the
turbo table, against the JAX package's ``fast_search_jit``, on the CPU.

Two indexes, each built once by the JAX package and carried into the port
as numpy state; the successor tables of arity 1, 2 and 3 are built by each
package from its own index. The precalc length p is then varied over one
table (the table does not depend on p), so k - p covers 0 (k = p), 1, 2
and 3, where the last table row takes fewer chars than the arity, and 7,
8 and 9. Each batch holds genomic k-mers, random ones (dead seeds), k-mers
with lowercase or N (invalid rows) and, at short p, many rows whose seed
is wider than one column (needs_slow). Both outputs must equal JAX's
exactly; the entry point takes the plain version on CPU tensors. The wide
tier's case is in tests/test_torch_wide.py, the kernel's in
tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import OracleIndex
from sbwt_tpu.models.matrix import with_precalc as jax_with_precalc
from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.ops.turbo import build_turbo as jax_build_turbo
from sbwt_tpu.ops.turbo import fast_search_jit
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.ops import search as ts
from sbwt_tpu_torch.ops import turbo as tt
from torch_state import matrix_state

# k -> the precalc lengths held: k - p = 0, 1, 2, 3 and 7, 8, 9
K_P = {8: (8, 7, 6, 5), 14: (7, 6, 5)}
CASES = [(k, p, a) for k, ps in K_P.items() for p in ps for a in (1, 2, 3)]


def _rows(genome: str, k: int, rng) -> np.ndarray:
    """int8 [B, k]: genomic k-mers, random k-mers, and genomic k-mers with a
    lowercase char, an N, or a lowercase char inside the first p."""
    enc = encode_query(genome)
    starts = rng.integers(0, len(enc) - k, size=320)
    rows = enc[starts[:, None] + np.arange(k)].astype(np.int8)
    rows[160:240] = rng.integers(0, 4, size=(80, k))
    rows[240:260, k - 1] |= 4  # lowercase last char
    rows[260:280, rng.integers(0, k, size=20)] = -1  # N
    rows[280:300, 0] |= 4  # lowercase first char (inside every seed)
    return rows


class Index:
    """A JAX index at k, its port, and the JAX and port tables of each arity."""

    def __init__(self, k: int):
        rng = np.random.default_rng(k)
        self.genome = "".join(rng.choice(list("ACGT"), size=2500))
        # a repeated stretch: seeds wider than one column even at p = 6
        self.genome += self.genome[400:700] + "".join(rng.choice(list("ACGT"), size=300))
        self.k = k
        self.js = SBWT.build([self.genome], k, precalc_k=K_P[k][0])
        self.ti = tm.from_numpy_state(matrix_state(self.js.device_index), "cpu")
        self.rows = _rows(self.genome, k, rng)
        self._jax, self._port, self._pre = {}, {}, {}

    def precalc(self, p: int):
        """(JAX precalc, port precalc) at p, each filled by its own package."""
        if p not in self._pre:
            jp = jax_with_precalc(self.js.device_index, p).precalc
            pi = tm.from_numpy_state(matrix_state(self.js.device_index), "cpu")
            tm.with_precalc(pi, p)
            self._pre[p] = (jp, pi.precalc)
        return self._pre[p]

    def turbos(self, p: int, arity: int):
        """(JAX TurboIndex, port TurboIndex) at precalc length p."""
        if arity not in self._jax:
            self._jax[arity] = jax_build_turbo(self.js.device_index, arity=arity)
            self._port[arity] = tt.build_turbo(self.ti, arity=arity)
        jp, pp = self.precalc(p)
        jt = dataclasses.replace(self._jax[arity], precalc=jp, precalc_k=p, seed_bits=None)
        base = self._port[arity]
        pt = tt.TurboIndex(base.tbl, pp, base.C, None, n_nodes=base.n_nodes, k=self.k,
                           precalc_k=p, arity=arity)
        return jt, pt


@pytest.fixture(scope="module")
def index():
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = Index(k)
        return cache[k]

    return get


@pytest.fixture(scope="module")
def answers(index):
    """(k, p, arity) -> (JAX ans, JAX needs_slow, port ans, port needs_slow)."""
    cache = {}

    def get(k, p, arity):
        if (k, p, arity) not in cache:
            ix = index(k)
            jt, pt = ix.turbos(p, arity)
            ra, rs = (np.asarray(x) for x in fast_search_jit(jt, jnp.asarray(ix.rows)))
            ga, gs = tt.fast_search_plain(pt, torch.from_numpy(ix.rows))
            cache[(k, p, arity)] = (ra, rs, ga, gs)
        return cache[(k, p, arity)]

    return get


@pytest.mark.parametrize("k,p,arity", CASES, ids=[f"k{k}-p{p}-a{a}" for k, p, a in CASES])
def test_fast_search_plain_matches_jax(answers, k, p, arity):
    ra, rs, ga, gs = answers(k, p, arity)
    assert ga.dtype == torch.int32 and gs.dtype == torch.bool
    np.testing.assert_array_equal(gs.numpy(), rs)
    np.testing.assert_array_equal(ga.numpy(), ra)


@pytest.mark.parametrize("k,p", [(k, p) for k, ps in K_P.items() for p in ps])
def test_rows_reach_every_kind(answers, index, k, p):
    """Each batch has walked hits, dead rows and invalid rows; the short
    seeds have needs_slow rows, and k = p returns the seed itself."""
    ra, rs, _, _ = answers(k, p, 3)
    rows = index(k).rows
    invalid = ~((rows >= 0) & (rows < 4)).all(axis=1)
    assert invalid.sum() == 60 and (ra[invalid] == -1).all() and not rs[invalid].any()
    assert (ra >= 0).sum() > 5 and ((ra == -1) & ~rs & ~invalid).sum() > 15
    if p <= 6:
        assert rs.sum() > 50
    if k == p:
        jp = np.asarray(index(k).precalc(p)[0])
        pidx = (rows[~invalid].astype(np.int64) << (2 * np.arange(p))).sum(axis=1)
        single = (jp[pidx, 0] >= 0) & (jp[pidx, 0] == jp[pidx, 1])
        np.testing.assert_array_equal(ra[~invalid][single], jp[pidx, 0][single])


@pytest.mark.parametrize("k,p", [(8, 6), (14, 5)])
def test_fast_search_equals_search_where_not_slow(answers, index, k, p):
    """Where needs_slow is false, ans is the k-mer's colex rank: the port's
    LF search and the string oracle agree with it."""
    ix = index(k)
    _, _, ga, gs = answers(k, p, 2)
    want = ts.search_batch(ix.ti, torch.from_numpy(ix.rows))
    fast = ~gs
    assert torch.equal(ga[fast], want[fast])
    orc = OracleIndex([ix.genome], k)
    for i in np.flatnonzero(fast.numpy())[::7]:
        row = ix.rows[i]
        text = "".join("ACGT"[c] if 0 <= c < 4 else "N" for c in row)
        assert int(ga[i]) == (orc.search(text) if "N" not in text else -1)


def test_entry_point_on_cpu_runs_the_plain_version(index):
    ix = index(14)
    jt, pt = ix.turbos(5, 3)
    before = dict(kernels.LAUNCHES)
    codes = torch.from_numpy(ix.rows)
    ans, slow = tt.fast_search(pt, codes)
    want = tt.fast_search_plain(pt, codes)
    assert torch.equal(ans, want[0]) and torch.equal(slow, want[1])
    # rows of any leading shape, as the JAX function takes them
    ans3, slow3 = tt.fast_search(pt, codes[:300].reshape(10, 30, 14))
    assert ans3.shape == (10, 30) and torch.equal(ans3.reshape(-1), ans[:300])
    assert torch.equal(slow3.reshape(-1), slow[:300])
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="query length"):
        tt.fast_search(pt, codes[:, :13])


def test_fast_search_of_a_carried_table(index):
    """A table carried over from JAX (turbo_from_numpy_state) answers the same."""
    from torch_state import turbo_state

    ix = index(8)
    jt = jax_build_turbo(ix.js.device_index, arity=3)
    carried = tt.turbo_from_numpy_state(turbo_state(jt), "cpu")
    ra, rs = (np.asarray(x) for x in fast_search_jit(jt, jnp.asarray(ix.rows)))
    ga, gs = tt.fast_search(carried, torch.from_numpy(ix.rows))
    np.testing.assert_array_equal(gs.numpy(), rs)
    np.testing.assert_array_equal(ga.numpy(), ra)
