"""Port parity: wavelet-tree symbol rank (K16's plain version).

The JAX WaveletTree and the port's over the same numpy-seeded symbols, for
sigma 4 and 5 and each bit-vector kind: payloads byte-equal, rank and
rank_pair equal at every position for every symbol, the symbols decoded
back, and the kernel descriptor's steps equal to the JAX path tables.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sbwt_tpu.ops.wavelet import WaveletTree as JaxWT
from sbwt_tpu_torch.ops.wavelet import WaveletTree
from test_torch_bv import assert_payload_equal
from torch_state import wavelet_from_jax


@pytest.mark.parametrize("kind", ["plain", "rrr", "mef"])
@pytest.mark.parametrize("sigma,n", [(4, 1500), (5, 1500), (5, 0), (4, 7)])
def test_wavelet_matches_jax(kind, sigma, n):
    syms = np.random.default_rng(sigma * 10 + n).integers(0, sigma, size=n)
    ref = JaxWT.build(syms, sigma, kind)
    got = WaveletTree.build(syms, sigma, kind)
    assert_payload_equal(got.payload(), ref.payload())
    assert got.size_in_bytes() == ref.size_in_bytes()
    np.testing.assert_array_equal(got.to_symbols(), syms)
    sym = np.repeat(np.arange(sigma, dtype=np.int32), n + 1)
    pos = np.tile(np.arange(n + 1, dtype=np.int32), sigma)
    want = np.asarray(jax.jit(ref.rank)(jnp.asarray(sym), jnp.asarray(pos)))
    pair_sym, pair_pos = sym[pos < n], pos[pos < n]
    w1, w2 = (np.asarray(a) for a in jax.jit(ref.rank_pair)(jnp.asarray(pair_sym),
                                                            jnp.asarray(pair_pos)))
    for wt in (got, wavelet_from_jax(ref)):
        np.testing.assert_array_equal(wt.rank(torch.from_numpy(sym), torch.from_numpy(pos)).numpy(),
                                      want)
        r1, r2 = wt.rank_pair(torch.from_numpy(pair_sym), torch.from_numpy(pair_pos))
        np.testing.assert_array_equal(r1.numpy(), w1)
        np.testing.assert_array_equal(r2.numpy(), w2)
    counts = np.stack([np.concatenate([[0], np.cumsum(syms == s)]) for s in range(sigma)])
    np.testing.assert_array_equal(want, counts.ravel())


@pytest.mark.parametrize("sigma", [4, 5])
def test_descriptor_steps_follow_the_paths(sigma):
    syms = np.random.default_rng(sigma).integers(0, sigma, size=300)
    ref = JaxWT.build(syms, sigma, "plain")
    steps = WaveletTree.build(syms, sigma, "plain").steps()
    pn, pb, pv = (np.asarray(a) for a in (ref.path_node, ref.path_bit, ref.path_valid))
    nb, nr = np.asarray(ref.node_base), np.asarray(ref.node_rank)
    for s in range(5):
        for d in range(3):
            if s < sigma and d < ref.depth and pv[s, d]:
                want = [nb[pn[s, d]], nr[pn[s, d]], pb[s, d], 1]
            else:
                want = [0, 0, 0, 0]
            assert steps[s, d].tolist() == want, (s, d)
