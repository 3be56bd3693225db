"""Chains of dependent gathers from a table: the port of the probe
scratch/gather_bench.py.

``gather_chain(tbl, idx0, steps)``: each lane of idx0 int32 [B] runs
``steps`` dependent row loads from the int32 table tbl [R, 2] (the
[4N, 2] table of pallas_chain, :58-74) or [R, 8] (mk_chain's wide table,
:24-34), each step idx <- (xor of the row's words & 0x7FFFFFFF) % R, and
returns the final idx. On a CUDA idx0 it launches K21 (csrc/gather_chain.cu;
the table on the same card or on a peer card); on a CPU idx0 it runs the
plain version. Nothing on a search path calls it: it measures the cost of
one dependent row gather from L2, from HBM or across NVLink, which every
LF and table step pays.

The kernel takes ``% R`` as a multiply by a constant that
``kernels.divisor_magic`` computes once a launch; ``kernels.mod_by_magic``
is the kernel's arithmetic in Python integers, so that the CPU tests hold
it to ``%``. The plain version keeps its plain ``%``.
"""
from __future__ import annotations

import torch

from .. import kernels


def gather_chain_plain(tbl: torch.Tensor, idx0: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of K21, the loop of mk_chain / pallas_chain."""
    R = tbl.shape[0]
    idx = idx0.long().to(tbl.device)
    for _ in range(steps):
        row = tbl[idx]
        s = row[:, 0]
        for j in range(1, row.shape[1]):
            s = s ^ row[:, j]
        idx = (s.long() & 0x7FFFFFFF) % R
    return idx.int().to(idx0.device)


def gather_chain(tbl: torch.Tensor, idx0: torch.Tensor, steps: int) -> torch.Tensor:
    if idx0.device.type == "cuda":
        return kernels.gather_chain(tbl, idx0, steps)
    return gather_chain_plain(tbl, idx0, steps)
