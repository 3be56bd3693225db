"""The port's multi-process layer (sbwt_tpu_torch/parallel/multihost.py)
against the JAX package's (sbwt_tpu/parallel/multihost.py).

The single-process tests mirror tests/test_multihost.py (JAX on the 8
virtual CPU devices of tests/conftest.py, the port over 8 slots of
``cpu``); the two-process test mirrors tests/test_multihost_mp.py with a
port-only worker (tests/torch_multihost_worker.py): two gloo processes
that cannot import the JAX package, data-parallel across the processes and
row-sharded (TP) inside each, whose output bytes must equal the JAX
package's single-process answers.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import torch_state  # noqa: F401  (one torch thread)
from sbwt_tpu.io.serialize import save
from sbwt_tpu.models.sbwt import SBWT
from sbwt_tpu.parallel import multihost as jmh
from sbwt_tpu.utils.dna import encode_query
from sbwt_tpu_torch.models import matrix as tm
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.parallel import multihost, sharded
from torch_state import matrix_state

SEQS = ["CCCGTGATGGCTAGCTAGCTGATCGATCGTACGTACGTAGCTAGCATCG" * 2, "TAATGCTGTAGCAAAGGCTTAC"]
K = 7
CPU8 = [torch.device("cpu")] * 8
REPO = Path(__file__).resolve().parent.parent


def _batch(n=16, L=96, seed=5):
    rng = np.random.default_rng(seed)
    codes = np.full((n, L), -1, dtype=np.int8)
    lengths = np.zeros(n, dtype=np.int32)
    for i in range(n):
        if rng.random() < 0.5:
            s = SEQS[0][: int(rng.integers(30, L))]
        else:
            s = "".join(rng.choice(list("ACGT"), size=int(rng.integers(30, L))))
        codes[i, : len(s)] = encode_query(s)
        lengths[i] = len(s)
    return codes, lengths


def _index():
    js = SBWT.build(SEQS, K, precalc_k=3)
    return js, tm.from_numpy_state(matrix_state(js.device_index), "cpu")


def test_my_read_slice_partition():
    items = list(range(10))
    got = [multihost.my_read_slice(items, process_id=p, n=4) for p in range(4)]
    assert [x for part in got for x in part] == items
    assert got == [jmh.my_read_slice(items, process_id=p, n=4) for p in range(4)]
    assert multihost.my_read_slice(items) == items  # one process: all of them


def test_global_batch_roundtrip():
    mesh = multihost.global_mesh(devices=CPU8)
    codes, _ = _batch()
    g = multihost.global_batch_from_local(codes, mesh)
    assert g.shape == codes.shape and len(g.blocks) == 8
    assert np.array_equal(multihost.local_shard(g), codes)
    padded = multihost.global_batch_from_local(codes, mesh, pad_to=20)
    assert padded.shape == (20, codes.shape[1])
    assert (multihost.local_shard(padded)[16:] == -1).all()


def test_distributed_streaming_matches_single_device():
    js, ti = _index()
    codes, lengths = _batch()
    want = js.streaming_search_batch(codes, lengths)
    jm = jmh.global_mesh()
    jans = jmh.distributed_streaming_search(jmh.replicate_index_global(js.device_index, jm),
                                            codes, lengths, jm)
    np.testing.assert_array_equal(jmh.local_shard(jans), want)
    mesh = multihost.global_mesh(devices=CPU8)
    index = multihost.replicate_index_global(ti, mesh)
    ans = multihost.distributed_streaming_search(index, codes, lengths, mesh)
    np.testing.assert_array_equal(multihost.local_shard(ans), want)


def test_distributed_turbo_matches_single_device():
    js, ti = _index()
    codes, lengths = _batch()
    want = js.streaming_search_batch(codes, lengths)
    mesh = multihost.global_mesh(devices=CPU8)
    turbo = tt.build_turbo(ti)
    ans = multihost.distributed_turbo_streaming_search(turbo, ti, codes, lengths, mesh)
    np.testing.assert_array_equal(multihost.local_shard(ans), want)


def test_all_hosts_agree_single_process():
    assert multihost.all_hosts_agree(12345)


def test_init_multihost_single_process_noop():
    multihost.init_multihost(num_processes=1)
    assert not torch.distributed.is_initialized()


def test_local_shard_dedups_model_axis_replicas():
    """Rows laid over a (data, model > 1) mesh come back once each, in order."""
    mesh = sharded.make_mesh(n_data=4, n_model=2, devices=CPU8)
    x = np.arange(32, dtype=np.int32).reshape(16, 2)
    g = sharded.shard_batch(x, mesh)
    assert len(g.blocks) == 4
    assert np.array_equal(multihost.local_shard(g), x)


# ---------------------------------------------------------------------------
# Two processes
# ---------------------------------------------------------------------------

K_MP = 9
SEQ = (
    "CCCGTGATGGCTAGCTAGCTGATCGATCGTACGTACGTAGCTAGCATCGGATTACAGT"
    "ACCGTTGATTGCCGTAAGGCTTAAACCGGTTAACCGGATCGATTACA"
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_reads(rng, n):
    reads = []
    for i in range(n):
        ln = int(rng.integers(20, 100))
        if rng.random() < 0.5:
            st = int(rng.integers(0, len(SEQ) - ln))
            reads.append(SEQ[st : st + ln])
        else:
            reads.append("".join(rng.choice(list("ACGT"), size=ln)))
    return reads


def test_two_process_distributed_search(tmp_path):
    sbwt = SBWT.build([SEQ], K_MP, precalc_k=3)
    index_path = str(tmp_path / "index.sbwt")
    save(index_path, sbwt, "native")

    rng = np.random.default_rng(17)
    per_file = 10
    files, all_reads = [], []
    for fi in range(2):
        reads = _make_reads(rng, per_file)
        all_reads.extend(reads)
        path = str(tmp_path / f"q{fi}.fastq")
        with open(path, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{fi}_{i}\n{r}\n+\n{'I' * len(r)}\n")
        files.append(path)

    # only the port is importable: a directory holding a link to it
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sbwt_tpu_torch").symlink_to(REPO / "sbwt_tpu_torch",
                                                       target_is_directory=True)
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "site"), OMP_NUM_THREADS="1")
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), index_path, str(tmp_path),
             str(per_file)] + files,
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-4000:]}"

    # expected: the JAX package's single-process answers in CLI text format
    expected_lines = []
    for r in all_reads:
        if len(r) < K_MP:
            expected_lines.append("\n")
            continue
        ans = sbwt.streaming_search(r)
        expected_lines.append("".join(f"{v} " for v in ans) + "\n")

    for prefix in ["dp", "tp"]:
        got = []
        for pid in range(2):
            got.extend((tmp_path / f"{prefix}_out_{pid}.txt").read_text().splitlines(keepends=True))
        assert got == expected_lines, prefix
