"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one and no JAX, run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Inputs come
from numpy seeds; every output is an integer, so equality is exact.
"""
import numpy as np
import pytest
import torch

from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu_torch.ops import search as ts
from sbwt_tpu_torch.ops import turbo as tt

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
    succ = kernels.succ1(di.rank_tbl, di.n_words, di.sgs_tbl, di.C, di.n_nodes)
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
