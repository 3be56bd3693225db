"""Worker process for the port's two-process multihost test
(tests/test_torch_multihost.py).

Each process joins the gloo process group, checks that the JAX package is
not importable, loads the index from disk with the port, reads only its
own slice of the query files, and writes its answers: data-parallel over
its own two CPU data slots, then row-sharded (TP) over two model slots.
The full flow of sbwt_tpu_torch/parallel/multihost.py's docstring, with no
step faked.

Usage: torch_multihost_worker.py <pid> <nproc> <port> <index> <outdir> <pad> <qfiles...>
"""
import importlib.util
import os
import sys

import numpy as np

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
index_path, outdir, pad = sys.argv[4], sys.argv[5], int(sys.argv[6])
qfiles = sys.argv[7:]

assert importlib.util.find_spec("sbwt_tpu") is None, "the JAX package is importable"

import torch  # noqa: E402

torch.set_num_threads(1)

from sbwt_tpu_torch.io import seqio  # noqa: E402
from sbwt_tpu_torch.io.serialize import load  # noqa: E402
from sbwt_tpu_torch.parallel import multihost, sharded  # noqa: E402
from sbwt_tpu_torch.utils.dna import encode_query  # noqa: E402

multihost.init_multihost(f"127.0.0.1:{port}", nproc, pid, device="cpu")
multihost.init_multihost(f"127.0.0.1:{port}", nproc, pid, device="cpu")  # twice: a no-op
assert multihost.process_count() == nproc and multihost.process_index() == pid

sbwt = load(index_path, "cpu")  # every process loads its own copy from disk
assert multihost.all_hosts_agree(sbwt.number_of_subsets())
assert not multihost.all_hosts_agree(pid)

# ---- process-local input: only this process's slice of the query files ----
mine = multihost.my_read_slice(qfiles)
reads = []
for qf in mine:
    reads.extend(s.decode() for s in seqio.read_sequences(qf))
L = 120
codes = np.full((len(reads), L), -1, dtype=np.int8)
lengths = np.zeros(len(reads), dtype=np.int32)
for i, r in enumerate(reads):
    enc = encode_query(r)[:L]
    codes[i, : len(enc)] = enc
    lengths[i] = len(enc)


def write(prefix, rows):
    with open(os.path.join(outdir, f"{prefix}_out_{pid}.txt"), "w") as f:
        for i in range(len(reads)):
            n_ans = lengths[i] - sbwt.k + 1
            f.write("".join(f"{int(v)} " for v in rows[i, : max(0, n_ans)]) + "\n")


cpu = [torch.device("cpu")] * 2
# ---- DP: this process's rows over its two data slots ----------------------
mesh = multihost.global_mesh(devices=cpu)
index = multihost.replicate_index_global(sbwt.device_index, mesh)
ans = multihost.distributed_streaming_search(index, codes, lengths, mesh)
write("dp", multihost.local_shard(ans))

# ---- TP: the index row-sharded over two model slots -----------------------
mesh_tp = multihost.global_mesh(n_model=2, devices=cpu)
g_codes = multihost.global_batch_from_local(codes, mesh_tp, pad_to=pad)
g_lens = multihost.global_batch_from_local(lengths, mesh_tp, pad_to=pad)
tp_index = sharded.shard_index_rows(sbwt.device_index, mesh_tp)
tp_ans = sharded.tp_streaming_search(tp_index, g_codes, g_lens, mesh_tp)
write("tp", multihost.local_shard(tp_ans)[: len(reads)])

torch.distributed.destroy_process_group()
print(f"worker {pid} done: {len(reads)} reads", flush=True)
