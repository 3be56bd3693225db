"""The subset-rank types' ``contains(c, pos)`` against the JAX package's
and the bit matrix, and the port's scaling walkthrough against the JAX one.

``contains`` is held at every (char, position) of a small genome index
(k = 6, every kind of column a real graph has) and of
``subsetwt_cases``' sets_1_4 pattern (sets of one char, of all four and
empty ones), on the ten variants: plain-matrix as a ``MatrixRank`` over a
plain bit vector, the nine compressed ones as ``build_struct`` makes them
(rrr-subsetwt in both of its device forms). Every answer is 0 or 1 and
compared exactly.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbwt_tpu.models import subsetrank as jsr
from sbwt_tpu_torch.models import subsetrank as tsr
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from subsetwt_cases import case_bits

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bit_matrices():
    genome = "".join(np.random.default_rng(16).choice(list("ACGT"), size=700))
    return {"genome": SBWT.build([genome], 6, "cpu").bits, "sets_1_4": case_bits("sets_1_4")}


def _structs(variant, bits):
    """(the JAX struct, the port's structs) of one variant over bits."""
    if variant == "plain-matrix":
        return (jsr.MatrixRank.from_bits(bits, kind="plain"),
                [tsr.MatrixRank.from_bits(bits, kind="plain")])
    if variant == "rrr-subsetwt":
        ports = [tsr.SubsetWTRank.from_bits(bits, "rrr", sparse=s) for s in (True, False)]
    else:
        ports = [tsr.build_struct(variant, bits)]
    return jsr.build_struct(variant, bits), ports


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_contains_matches_jax_and_the_bits(bit_matrices, variant):
    for name, bits in bit_matrices.items():
        n = bits.shape[1]
        c = np.repeat(np.arange(4, dtype=np.int32), n)
        pos = np.tile(np.arange(n, dtype=np.int32), 4)
        jst, ports = _structs(variant, bits)
        want = np.asarray(jst.contains(jnp.asarray(c), jnp.asarray(pos))).astype(np.int64)
        np.testing.assert_array_equal(want, bits.astype(np.int64).ravel(), err_msg=name)
        for st in ports:
            got = st.contains(torch.from_numpy(c), torch.from_numpy(pos))
            assert got.dtype == torch.int64, (name, got.dtype)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            # scalars, at both ends
            for cc in range(4):
                for p in (0, n - 1):
                    assert int(st.contains(cc, p)) == int(bits[cc, p]), (name, cc, p)


def test_scaling_example_prints_the_jax_examples_lines(tmp_path):
    """examples/scaling_example_torch.py --device cpu, where only the port
    is importable, prints what examples/scaling_example.py prints."""
    jax_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen([sys.executable, str(REPO / "examples" / "scaling_example.py")],
                                cwd=tmp_path, env=jax_env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    # a tree that holds the example and the port only: the example puts its
    # parent directory on the path, where no sbwt_tpu lies
    (tmp_path / "examples").mkdir()
    shutil.copy(REPO / "examples" / "scaling_example_torch.py", tmp_path / "examples")
    (tmp_path / "sbwt_tpu_torch").symlink_to(REPO / "sbwt_tpu_torch", target_is_directory=True)
    probe = ("import runpy, sys; sys.argv = [sys.argv[1], '--device', 'cpu']; "
             "runpy.run_path(sys.argv[0], run_name='__main__'); "
             "bad = sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'sbwt_tpu')); assert not bad, bad")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", probe,
                           str(tmp_path / "examples" / "scaling_example_torch.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    want, jax_err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, jax_err
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want
    assert want.startswith("DP == TP over (32, 61) answers\n") and want.count("\n") == 2
