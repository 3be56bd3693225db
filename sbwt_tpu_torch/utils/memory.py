"""Device memory headroom, for picking the turbo arity that fits.

The port of sbwt_tpu/utils/memory.py: the successor table costs 16 B
(arity 1), 128 B (arity 2) or 1 KiB (arity 3) of device memory per column,
or 32 B on the wide tier, which has arity 1 only, and auto mode takes the
largest arity whose table fits half of the measured free memory."""
from __future__ import annotations

import os

import torch

# the table build and the query batches need room too; never plan to fill
# more than this fraction of free memory with the turbo table
HEADROOM_FRACTION = 0.5


def device_free_bytes(device) -> int | None:
    """Free memory of a device, or None when it cannot be measured: the
    CUDA driver's count for a GPU, sysconf's available pages for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    if device.type == "cpu":
        try:
            return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError):
            return None
    return None


def turbo_table_bytes(n_nodes: int, arity: int, precalc_k: int = 0, wide: bool = False) -> int:
    """Device bytes of the turbo tables: the successor table (arity 1 =
    int32 [n, 4]; arity 2/3 = int32 [n * 4^arity, 2 or 4]; a wide index =
    int64 [n, 4] whatever arity is asked) plus the seed bits (2 bits per
    (p+1)-mer, built when 0 < precalc_k <= 14)."""
    if wide:
        tbl = n_nodes * 32
    elif arity == 1:
        tbl = n_nodes * 16
    else:
        width = 2 if arity == 2 else 4
        tbl = n_nodes * (4**arity) * width * 4
    if 0 < precalc_k <= 14:
        tbl += 4 ** (precalc_k + 1) // 4
    return tbl


def select_turbo_arity(n_nodes: int, free_bytes: int | None, precalc_k: int = 0,
                       wide: bool = False) -> int | None:
    """Largest affordable turbo arity (3, 2, 1; a wide index has 1 only),
    or None when none fits. The table may take at most HEADROOM_FRACTION of
    free_bytes; an unmeasurable free size (None) uses the JAX engine's
    fixed thresholds."""
    if wide:
        if free_bytes is None:
            return 1 if n_nodes <= 200_000_000 else None
        budget = int(free_bytes * HEADROOM_FRACTION)
        return 1 if turbo_table_bytes(n_nodes, 1, precalc_k, wide=True) <= budget else None
    if free_bytes is None:
        if n_nodes <= 6_000_000:
            return 3
        if n_nodes <= 16_000_000:
            return 2
        return 1 if n_nodes <= 400_000_000 else None
    budget = int(free_bytes * HEADROOM_FRACTION)
    for arity in (3, 2, 1):
        if arity >= 2 and n_nodes * (4**arity) >= 2**31:
            continue  # flat row index would overflow int32
        if turbo_table_bytes(n_nodes, arity, precalc_k) <= budget:
            return arity
    return None
