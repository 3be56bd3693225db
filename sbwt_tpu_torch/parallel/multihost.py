"""Multi-process execution on torch.distributed: host-sharded query I/O.

The port of sbwt_tpu/parallel/multihost.py. Each process reads only its
slice of the query files, lays its rows over its own devices' data slots,
searches them with the data-parallel (or row-sharded) engines of
sharded.py, and writes its own answers. PyTorch has no global array over
processes: a "global batch" here is this process's rows, laid over its
data slots (sharded.ShardedBatch), and the data axis over processes is
implicit in which rows each process holds. As in the JAX package the search
path has no collective; torch.distributed (NCCL between cards, gloo on the
CPU) carries only the cross-process checks.

Typical flow on each process::

    init_multihost(coordinator, num_processes, process_id)
    mesh = global_mesh(n_model=1)
    reads = my_read_slice(all_files)            # process-local I/O
    ans   = distributed_streaming_search(index, codes, lens, mesh)
    write_answers(local_shard(ans))             # process-local output

Single-process, every helper works unchanged (one process, rank 0).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import sharded


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    """Join the process group (no-op when single-process; safe to call
    twice): NCCL when this process's devices are CUDA, gloo on the CPU.
    ``coordinator_address`` is host:port of process 0; without it the
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK environment is read."""
    if num_processes is not None and num_processes <= 1 and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    dist.init_process_group(
        "nccl" if torch.device(device).type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(n_model: int = 1, devices=None) -> sharded.Mesh:
    """(data, model) mesh over this process's own devices: by default every
    CUDA device it sees; the data axis over processes is implicit."""
    return sharded.make_mesh(n_model=n_model, devices=devices)


def my_read_slice(items: list, process_id: int | None = None, n: int | None = None) -> list:
    """The contiguous slice of `items` (query files, reads, ...) this process
    is responsible for reading. Processes with no items get an empty list."""
    pid = process_index() if process_id is None else process_id
    np_ = process_count() if n is None else n
    per = -(-len(items) // np_)
    return items[pid * per : (pid + 1) * per]


def global_batch_from_local(local: np.ndarray, mesh: sharded.Mesh, pad_to: int | None = None):
    """This process's rows, padded with -1 rows to ``pad_to``, laid over the
    mesh's data slots as a ShardedBatch. No process holds another's rows:
    PyTorch has no global array, so this is the process's part of the
    global batch, not the global batch."""
    if pad_to is not None and local.shape[0] < pad_to:
        pad = np.full((pad_to - local.shape[0],) + local.shape[1:], -1, local.dtype)
        local = np.concatenate([local, pad])
    return sharded.shard_batch(local, mesh)


def local_shard(x) -> np.ndarray:
    """This process's rows of a result (a tensor in row order, or a
    ShardedBatch), in order, as numpy."""
    if isinstance(x, sharded.ShardedBatch):
        return np.concatenate([b.cpu().numpy() for b in x.blocks])
    return x.cpu().numpy()


def replicate_index_global(index, mesh: sharded.Mesh):
    """The index on every device of this process's mesh; each process
    uploads from its own copy (the index file is read per process)."""
    return sharded.replicate_index(index, mesh)


def distributed_streaming_search(index, local_codes: np.ndarray, local_lengths: np.ndarray,
                                 mesh: sharded.Mesh) -> torch.Tensor:
    """Streaming search of this process's reads over its mesh (replicated
    index, reads cut over `data`): its answers, in row order."""
    codes = global_batch_from_local(local_codes, mesh)
    lengths = global_batch_from_local(local_lengths, mesh)
    return sharded.dp_streaming_search(index, codes, lengths, mesh)


def distributed_turbo_streaming_search(turbo, index, local_codes: np.ndarray,
                                       local_lengths: np.ndarray, mesh: sharded.Mesh) -> torch.Tensor:
    """Turbo streaming search of this process's reads (replicated tables,
    reads cut over `data`, no collective on the path)."""
    codes = global_batch_from_local(local_codes, mesh)
    lengths = global_batch_from_local(local_lengths, mesh)
    return sharded.dp_turbo_streaming_search(turbo, index, codes, lengths, mesh)


def all_hosts_agree(value: int) -> bool:
    """Cheap cross-process check (e.g. that every process loaded the same
    index: pass n_nodes): an all_gather of one int64. True iff ``value``
    matches on all processes."""
    if process_count() == 1:
        return True
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    mine = torch.tensor([value], dtype=torch.int64, device=dev)
    vals = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(vals, mine)
    return all(int(v.item()) == value for v in vals)
