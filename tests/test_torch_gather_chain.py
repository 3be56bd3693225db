"""The dependent-gather probe: the port's gather_chain (the plain version of
K21) against the JAX probe it ports, scratch/gather_bench.py.

scratch/gather_bench.py runs its benchmark when imported, so its two
chains are restated here at small R: mk_chain (:24-34) in jnp over [R, 2]
and [R, 8] tables, and pallas_chain (:58-74), whose kernel body runs under
``pl.pallas_call(..., interpret=True)`` on the CPU. Tables and start
indices come from numpy seeds; every value is an integer, so equality is
exact.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_state  # noqa: F401  (one torch thread)
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.ops import gather_chain as gc

R, B = 4 * 600, 256


def _inputs(width, seed):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2**31 - 1, size=(R, width), dtype=np.int32)
    idx0 = rng.integers(0, R // 4, size=B, dtype=np.int32)
    return tbl, idx0


def mk_chain(tbl, width, steps):
    """scratch/gather_bench.py mk_chain at this file's R."""
    def f(idx0):
        def step(i, idx):
            row = tbl[idx]
            s = row[..., 0]
            for j in range(1, width):
                s = s ^ row[..., j]
            return (s & 0x7FFFFFFF) % R
        return lax.fori_loop(0, steps, step, idx0)
    return jax.jit(f)


def pallas_chain(tbl, idx0, steps):
    """scratch/gather_bench.py pallas_chain at this file's R, B and steps,
    interpreted."""
    def kernel(tbl_ref, idx_ref, out_ref):
        def step(i, idx):
            row = tbl_ref[idx]
            s = row[..., 0] ^ row[..., 1]
            return (s & 0x7FFFFFFF) % R
        out_ref[:] = lax.fori_loop(0, steps, step, idx_ref[:])

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B,), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(tbl, idx0)


@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("steps", [0, 1, 64])
def test_gather_chain_equals_mk_chain(width, steps):
    tbl, idx0 = _inputs(width, 10 * width + steps)
    want = np.asarray(mk_chain(jnp.asarray(tbl), width, steps)(jnp.asarray(idx0)))
    got = gc.gather_chain(torch.from_numpy(tbl), torch.from_numpy(idx0), steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("steps", [1, 64])
def test_gather_chain_equals_pallas_chain(steps):
    tbl, idx0 = _inputs(2, steps)
    want = np.asarray(pallas_chain(jnp.asarray(tbl), jnp.asarray(idx0), steps))
    got = gc.gather_chain_plain(torch.from_numpy(tbl), torch.from_numpy(idx0), steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_chain_launches_nothing_and_the_wrapper_refuses_cpu():
    tbl, idx0 = _inputs(8, 3)
    before = dict(kernels.LAUNCHES)
    gc.gather_chain(torch.from_numpy(tbl), torch.from_numpy(idx0), 5)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        kernels.gather_chain(torch.from_numpy(tbl), torch.from_numpy(idx0), 5)


@pytest.mark.parametrize("R", [1, 2, 3, 7, 1 << 21, 1_000_003, 2_000_000, 1 << 26, 2**31 - 1])
def test_divisor_magic_equals_mod(R):
    """K21's remainder by R's multiplier (the kernel's arithmetic in Python
    integers) equals % at the edges of the dividend range, at the multiples
    of R just below 2^31 and at 10^4 seeded random dividends, with and
    without bit 31 set in the word (the mask drops it)."""
    m, l = kernels.divisor_magic(R)
    assert 0 < m < 2**32 and 0 <= l <= 31
    top = (2**31 - 1) // R * R
    near = [top - j * R + d for j in range(3) for d in (-1, 0, 1)]
    rng = np.random.default_rng(R % 1000)
    dividends = [0, R - 1, R, 2**31 - 1, *near, *rng.integers(0, 2**31, size=10**4).tolist()]
    for n in (n for n in dividends if 0 <= n < 2**31):
        for x in (n, n | 1 << 31):
            assert kernels.mod_by_magic(x, R, m, l) == n % R, (x, R)


def test_divisor_magic_refuses_rows_out_of_range():
    for R in (0, 2**31):
        with pytest.raises(ValueError, match="expected 1 to 2"):
            kernels.divisor_magic(R)


@pytest.mark.parametrize("R", [1, 1 << 16, 2_000_000])
def test_wrapper_passes_the_multiplier_of_the_tables_rows(R, monkeypatch):
    """The launch that kernels.gather_chain makes carries R, its multiplier
    and its shift, in the C entry point's order: on a CPU tensor the launch
    itself is recorded, not made."""
    launched = []
    monkeypatch.setattr(kernels, "_cuda_device", lambda t: t.device)
    monkeypatch.setattr(kernels, "enable_peer_access", lambda device, peer: None)
    monkeypatch.setattr(kernels, "_launch", lambda *args: launched.append(args))
    tbl = torch.zeros((R, 2), dtype=torch.int32)
    idx0 = torch.zeros(7, dtype=torch.int32)
    kernels.gather_chain(tbl, idx0, 3)
    (entry, counter, _, tbl_ptr, rows, width, m, l, idx_ptr, B, steps, _), = launched
    assert (entry, counter) == ("sbwt_gather_chain", "gather_chain")
    assert (tbl_ptr, rows, width, idx_ptr, B, steps) == (tbl.data_ptr(), R, 2, idx0.data_ptr(), 7, 3)
    assert (m, l) == kernels.divisor_magic(R)
    assert kernels._SIGNATURES["sbwt_gather_chain"][4:6] == [ctypes.c_uint, ctypes.c_int]
