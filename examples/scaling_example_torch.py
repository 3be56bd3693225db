"""Scaling walkthrough of the PyTorch port, step for step the same as
examples/scaling_example.py: sharded queries, multi-process wiring, and
the int64 engine past 2^31 columns. It prints the same lines.

Run from the repo root:  python examples/scaling_example_torch.py [--device cpu]
(the default device is cuda: one card fills every slot of the 8-slot mesh
and the searches run the CUDA kernels; cpu runs their plain PyTorch
versions). A mesh slot may repeat a device, so no pod or second card is
needed.
"""
import argparse
import os
import sys

here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(here))  # repo root, when run in place

import numpy as np
import torch

from sbwt_tpu_torch.models.sbwt import SBWT
from sbwt_tpu_torch.parallel import sharded
from sbwt_tpu_torch.utils.dna import encode_query

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
dev = torch.device(parser.parse_args().device)

rng = np.random.default_rng(0)
genome = "".join(rng.choice(list("ACGT"), size=5000))
sbwt = SBWT.build([genome], k=20, device=dev, precalc_k=6)

# --- data-parallel queries over an 8-slot mesh ----------------------------
mesh = sharded.make_mesh(devices=[dev] * 8)  # (data, model) = (8, 1)
reads = [genome[i * 40 : i * 40 + 80] for i in range(32)]
codes = np.stack([encode_query(r) for r in reads]).astype(np.int8)
lengths = np.full(len(reads), codes.shape[1], dtype=np.int32)

index = sharded.replicate_index(sbwt.device_index, mesh)
ans_dp = sharded.dp_streaming_search(index, codes, lengths, mesh)

# --- tensor-parallel: the rank tables row-sharded over `model` -----------
mesh_tp = sharded.make_mesh(n_model=2, devices=[dev] * 8)  # (4, 2)
ans_tp = sharded.tp_streaming_search(sbwt.device_index, codes, lengths, mesh_tp)
assert torch.equal(ans_dp.cpu(), ans_tp.cpu())
print("DP == TP over", tuple(ans_dp.shape), "answers")

# --- multi-process: same calls, real process boundaries -------------------
# On a cluster each process runs (see tests/torch_multihost_worker.py for a
# live 2-process example driven by tests/test_torch_multihost.py):
#
#   multihost.init_multihost(coordinator, num_processes, process_id)
#   mesh  = multihost.global_mesh()
#   mine  = multihost.my_read_slice(query_files)      # process-local I/O
#   ans   = multihost.distributed_streaming_search(index, codes, lens, mesh)
#   write(multihost.local_shard(ans))                 # process-local output
#
# torch.distributed learns of no cluster by itself: coordinator is
# "host:port" of process 0 (NCCL between cards, gloo on the CPU).

# --- past 2^31 columns -----------------------------------------------------
# Indexes with >= 2^31 columns route to the int64 engine automatically:
# models.matrix.from_packed_rows / SBWT.from_packed pick models.wide.
# chip_smoke.py builds the complete order-16 de Bruijn graph (4^16 + 1 =
# 4.29 billion columns) on the card and validates every answer against a
# closed-form oracle.
from sbwt_tpu_torch.utils.memory import select_turbo_arity

print("turbo tier at 100M columns with 30 GB free:",
      select_turbo_arity(100_000_000, free_bytes=30 << 30))
