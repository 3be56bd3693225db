"""Multi-device execution: data-parallel queries and row-sharded (TP) tables.

The port of sbwt_tpu/parallel/sharded.py. A ``Mesh`` is an [n_data,
n_model] grid of torch devices (slots). PyTorch has no SPMD program: each
data slot's block of rows is one launch on slot (d, 0)'s device, and the
answers are put back in row order on slot (0, 0)'s device.

* **Data parallelism** (``dp_*``): the batch is cut into n_data contiguous
  row blocks, as P("data") lays them out, and block d runs on its slot's
  replica of the index with the single-device kernels (kmer_search,
  lf_stream and turbo_stream of plain-matrix). Slots on one device share
  one replica.
* **Tensor parallelism** (``tp_*``): the rank tables (``shard_index_rows``)
  or the turbo successor table (``shard_turbo_rows``,
  ``build_turbo_sharded``) are zero-padded and cut into n_model row
  shards; shard m lies on slot (d, m) of every data row d, one copy a
  device. Block d runs on slot (d, 0): K20a (the ``sharded-matrix`` rank
  type) and K20b (K4 over a sharded table) load each row from its owning
  shard, over NVLink when that shard is on another card. The JAX views
  (TPIndexView, TPTurboView) gather masked rows on every model device and
  psum them; the plain versions here compute that sum, shard by shard.

Deviations from the JAX package: one device may fill several slots (the
CPU tests lay 8 slots on ``cpu``; one card can hold 4 model shards);
shards on other cards are read with peer loads inside the kernel, not
with a psum per step, and a pair of cards that cannot reach each other
raises; the trip-count sync of the JAX TP paths (sync_axes, lax.pcast)
has no counterpart, because a launch runs no collective; collectives
(NCCL, gloo) appear only across processes (multihost.py).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..models.matrix import sg_start_in
from ..ops import bitvector as bv
from ..ops import search as engines
from ..ops import turbo as tt


@dataclass(frozen=True)
class Mesh:
    """An [n_data, n_model] grid of devices; one device may fill several slots."""

    devices: tuple  # n_data tuples of n_model torch.devices

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def home(self, d: int) -> torch.device:
        """The device that runs data slot d's launches: slot (d, 0)."""
        return self.devices[d][0]

    def distinct_devices(self) -> list:
        return list(dict.fromkeys(dev for row in self.devices for dev in row))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """The (data, model) mesh over ``devices``, slot i taking devices[i % len]:
    by default every CUDA device (raises when there is none). With n_data
    None, as many data rows as the devices fill. Enables peer access from
    each data row's first card to the row's other cards, and raises if a
    pair cannot reach each other."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices= to lay slots on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if not devices or n_model < 1:
        raise ValueError(f"make_mesh: {len(devices)} devices, n_model = {n_model}")
    if n_data is None:
        n_data = max(1, len(devices) // n_model)
    slots = [devices[i % len(devices)] for i in range(n_data * n_model)]
    mesh = Mesh(tuple(tuple(slots[d * n_model : (d + 1) * n_model]) for d in range(n_data)))
    for row in mesh.devices:
        for dev in row[1:]:
            if dev.type == "cuda" and dev != row[0]:
                kernels.enable_peer_access(row[0], dev)
    return mesh


# ---------------------------------------------------------------------------
# Batches over the data axis, and replicas
# ---------------------------------------------------------------------------


@dataclass
class ShardedBatch:
    """One batch's rows laid over a mesh's data slots: blocks[d], a contiguous
    row range in order, on slot (d, 0)'s device. It stands where the JAX
    package has a global array sharded P("data"), which PyTorch lacks."""

    blocks: list

    @property
    def shape(self) -> tuple:
        return (sum(len(b) for b in self.blocks),) + tuple(self.blocks[0].shape[1:])


def shard_batch(x, mesh: Mesh) -> ShardedBatch:
    """Cut rows into n_data contiguous blocks of ceil(B / n_data) rows (the
    last ones shorter or empty) and put block d on slot (d, 0)."""
    n_data = mesh.shape["data"]
    if isinstance(x, ShardedBatch):
        if len(x.blocks) != n_data:
            raise ValueError(f"batch over {len(x.blocks)} data slots, mesh has {n_data}")
        return x
    x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    per = -(-len(x) // n_data)
    return ShardedBatch([x[d * per : (d + 1) * per].to(mesh.home(d)).contiguous()
                         for d in range(n_data)])


def gather_rows(blocks, mesh: Mesh) -> torch.Tensor:
    """The blocks' rows, in order, on slot (0, 0)'s device."""
    return torch.cat([b.to(mesh.home(0)) for b in blocks])


def _lengths(lengths, codes: ShardedBatch, mesh: Mesh) -> ShardedBatch:
    if lengths is None:
        return ShardedBatch([torch.full((len(b),), b.shape[1], dtype=torch.int32, device=b.device)
                             for b in codes.blocks])
    return shard_batch(lengths, mesh)


def moved(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself if its buffers lie on ``device``, else a shallow copy
    with its buffers copied there; the original stays where it is."""
    if all(b is None or b.device == device for b in module.buffers()):
        return module
    out = copy.copy(module)  # a new __dict__ whose entries are the module's
    out._buffers = {k: None if v is None else v.to(device) for k, v in module._buffers.items()}
    out._modules = {k: moved(v, device) for k, v in module._modules.items()}
    return out


class Replicated:
    """One copy of a module on each distinct device of a mesh."""

    def __init__(self, copies: dict):
        self.copies = copies

    def on(self, device: torch.device) -> nn.Module:
        return self.copies[device]


def replicate_index(index, mesh: Mesh) -> Replicated:
    """The index (or a turbo table) on every device of the mesh, one copy a
    device: the device it already lies on keeps it as it is."""
    if isinstance(index, Replicated):
        missing = [d for d in mesh.distinct_devices() if d not in index.copies]
        if not missing:
            return index
        src = next(iter(index.copies.values()))
        return Replicated({**index.copies, **{d: moved(src, d) for d in missing}})
    return Replicated({d: moved(index, d) for d in mesh.distinct_devices()})


# ---------------------------------------------------------------------------
# Data parallelism: replicated index, rows cut over the data axis
# ---------------------------------------------------------------------------


def dp_streaming_search(index, codes, lengths, mesh: Mesh) -> torch.Tensor:
    """Streaming search (K14) with the reads cut over the data axis."""
    reps = replicate_index(index, mesh)
    cb = shard_batch(codes, mesh)
    lb = _lengths(lengths, cb, mesh)
    return gather_rows([engines.streaming_search(reps.on(c.device), c, n)
                        for c, n in zip(cb.blocks, lb.blocks)], mesh)


def dp_search(index, codes, mesh: Mesh) -> torch.Tensor:
    """Per-k-mer search (K1) with the k-mers cut over the data axis."""
    reps = replicate_index(index, mesh)
    return gather_rows([engines.search_batch(reps.on(c.device), c)
                        for c in shard_batch(codes, mesh).blocks], mesh)


def dp_turbo_streaming_search(turbo, index, codes, lengths, mesh: Mesh) -> torch.Tensor:
    """Turbo streaming search (K4) with the reads cut over the data axis and
    the successor table replicated. Each slot runs its own launch: the
    turbo path has no collective."""
    t_reps, i_reps = replicate_index(turbo, mesh), replicate_index(index, mesh)
    cb = shard_batch(codes, mesh)
    lb = _lengths(lengths, cb, mesh)
    return gather_rows([tt.turbo_streaming_search(t_reps.on(c.device), i_reps.on(c.device), c, n)
                        for c, n in zip(cb.blocks, lb.blocks)], mesh)


# ---------------------------------------------------------------------------
# Tensor parallelism: row-sharded tables
# ---------------------------------------------------------------------------


def sharded_gather(shards, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx of a table cut into equal row shards: each shard's masked
    local gather, summed over the shards (TPIndexView._sharded_gather,
    sbwt_tpu/parallel/sharded.py:126-134); exactly one term is non-zero."""
    rows = shards[0].shape[0]
    total = None
    for m, tbl in enumerate(shards):
        local = idx.to(tbl.device) - m * rows
        in_range = (local >= 0) & (local < rows)
        row = torch.where(in_range[..., None], tbl[local.clamp(0, rows - 1)], 0).to(idx.device)
        total = row if total is None else total + row
    return total


def row_shards(tbl: torch.Tensor, n_shards: int, multiple: int = 1) -> list:
    """tbl's rows zero-padded to n_shards equal shards of a multiple of
    ``multiple`` rows each (the JAX _pad_rows, :143-149). Whole shards are
    views of tbl; only those that reach past its end are copies."""
    per = -(-tbl.shape[0] // (n_shards * multiple)) * multiple
    out = []
    for m in range(n_shards):
        part = tbl[m * per : (m + 1) * per]
        if part.shape[0] < per:
            pad = torch.zeros((per - part.shape[0],) + tuple(tbl.shape[1:]), dtype=tbl.dtype,
                              device=tbl.device)
            part = torch.cat([part, pad])
        out.append(part)
    return out


class ShardedMatrixIndex(nn.Module):
    """One data row's view of a plain-matrix index whose rank table int32
    [4W, 2] and suffix-group table int32 [W, 2] are cut into n_model row
    shards (shard m on slot m of the row); C and precalc lie on the row's
    home device, where its launches run. The rank interface (``rank_c``,
    ``extend_rank``, ``sg_start``) reads rows with ``sharded_gather``, the
    plain version of K20a (csrc/subset_rank.cuh ShardedMatrix). The port
    of TPIndexView (sbwt_tpu/parallel/sharded.py:105-140)."""

    variant = kernels.SHARDED
    pos_dtype = torch.int32

    def __init__(self, rank_shards, sgs_shards, C, precalc, *, n_nodes: int, n_kmers: int, k: int,
                 precalc_k: int, n_words: int, has_streaming: bool):
        super().__init__()
        if len(rank_shards) != len(sgs_shards):
            raise ValueError("rank and suffix-group tables need the same number of shards")
        self.n_shards = len(rank_shards)
        for m, (r, s) in enumerate(zip(rank_shards, sgs_shards)):
            self.register_buffer(f"rank_shard_{m}", r)
            self.register_buffer(f"sgs_shard_{m}", s)
        self.register_buffer("C", C)
        self.register_buffer("precalc", precalc)
        self.n_nodes = int(n_nodes)
        self.n_kmers = int(n_kmers)
        self.k = int(k)
        self.precalc_k = int(precalc_k)
        self.n_words = int(n_words)
        self.has_streaming = bool(has_streaming)

    @property
    def rank_shards(self) -> list:
        return [getattr(self, f"rank_shard_{m}") for m in range(self.n_shards)]

    @property
    def sgs_shards(self) -> list:
        return [getattr(self, f"sgs_shard_{m}") for m in range(self.n_shards)]

    @property
    def sgs_tbl(self) -> torch.Tensor:
        """Shard 0, the flat table argument of a launch; K20a reads the
        suffix-group rows through its descriptor's shards."""
        return self.sgs_shard_0

    @property
    def device(self) -> torch.device:
        return self.C.device

    def rank_row(self, c, w):
        return sharded_gather(self.rank_shards, c * self.n_words + w)

    def sgs_row(self, w):
        return sharded_gather(self.sgs_shards, w)

    def extend_rank(self, c, pos):
        """(rank_c(c, pos), bit of row c at pos) from one row; int64."""
        pos = torch.as_tensor(pos, device=self.device).long()
        c = torch.as_tensor(c, device=self.device).long()
        row = self.rank_row(c, pos >> 5)
        o = pos & 31
        word = bv.word_u32(row[..., 0])
        return row[..., 1].long() + bv.popcount32(word & ((1 << o) - 1)), (word >> o) & 1

    def rank_c(self, c, pos):
        return self.extend_rank(c, pos)[0]

    def sg_start(self, col):
        col = torch.as_tensor(col, device=self.device).long()
        return sg_start_in(self.sgs_row(col >> 5), col)

    def kernel_desc(self, dev):
        """K20a's descriptor: the shards' pointers (peer access enabled for
        shards on other cards) and rows per shard."""
        r, s = self.rank_shards, self.sgs_shards
        return kernels.ShardedMatrixDesc(
            kernels.shard_ptrs(r, "rank_tbl", dev, tuple(r[0].shape), 8),
            kernels.shard_ptrs(s, "sgs_tbl", dev, tuple(s[0].shape), 8),
            self.n_words, r[0].shape[0], s[0].shape[0])


class ShardedTurboIndex(nn.Module):
    """One data row's view of a turbo successor table cut into n_model row
    shards of ``cols`` whole columns (4^A rows a column, 1 at arity 1; the
    last shard's pad columns hold zero rows and are never read), with
    precalc, C and seed bits on the row's home device. ``row`` rebases the
    row index per shard, (col - shard * cols) * 4^A + sub, so only one
    shard's rows need to fit int32: the plain version of K20b. The port of
    TPTurboView (sbwt_tpu/parallel/sharded.py:233-287)."""

    pos_dtype = torch.int32

    def __init__(self, shards, precalc, C, seed_bits, *, n_nodes: int, k: int, precalc_k: int,
                 arity: int, cols: int):
        super().__init__()
        self.n_shards = len(shards)
        for m, t in enumerate(shards):
            self.register_buffer(f"tbl_shard_{m}", t)
        self.register_buffer("precalc", precalc)
        self.register_buffer("C", C)
        self.register_buffer("seed_bits", seed_bits)
        self.n_nodes = int(n_nodes)
        self.k = int(k)
        self.precalc_k = int(precalc_k)
        self.arity = int(arity)
        self.cols = int(cols)

    @property
    def tbl_shards(self) -> list:
        return [getattr(self, f"tbl_shard_{m}") for m in range(self.n_shards)]

    def row(self, col, sub=0):
        rpc = 4**self.arity if self.arity >= 2 else 1
        total = None
        for m, tbl in enumerate(self.tbl_shards):
            local_col = col.to(tbl.device) - m * self.cols
            in_range = (local_col >= 0) & (local_col < self.cols)
            local = local_col.clamp(0, self.cols - 1) * rpc + (torch.as_tensor(sub).to(tbl.device)
                                                                  if self.arity >= 2 else 0)
            part = torch.where(in_range[..., None], tbl[local], 0).to(col.device)
            total = part if total is None else total + part
        return total


@dataclass
class RowSharded:
    """A table placed row-sharded over a mesh: one view a data row
    (ShardedMatrixIndex or ShardedTurboIndex); views of rows whose slots
    share devices share the shards and the replicated tensors."""

    mesh: Mesh
    views: list


class _Placer:
    """Puts each tensor once on each device: (key, device) -> copy."""

    def __init__(self):
        self.placed = {}

    def __call__(self, key, t, device):
        if t is None:
            return None
        if (key, device) not in self.placed:
            self.placed[(key, device)] = t.to(device).contiguous()
        return self.placed[(key, device)]


def _check_model_axis(mesh: Mesh) -> int:
    n_model = mesh.shape["model"]
    if n_model > kernels.MAX_SHARDS:
        raise ValueError(f"model axis of {n_model}: the sharded kernels take at most "
                         f"{kernels.MAX_SHARDS} shards")
    return n_model


def is_row_sharded(index, mesh: Mesh) -> bool:
    """True if the index is already placed row-sharded over this mesh's
    model axis (the TP entry points then skip the placement)."""
    return (isinstance(index, RowSharded) and index.mesh == mesh
            and all(isinstance(v, ShardedMatrixIndex) for v in index.views))


def shard_index_rows(index, mesh: Mesh) -> RowSharded:
    """Place a plain-matrix index with its rank and suffix-group tables
    row-sharded over the model axis, C and precalc on each row's home.
    Returns the same object when it is already placed so."""
    if is_row_sharded(index, mesh):
        return index
    if isinstance(index, RowSharded):
        raise ValueError("index is placed over another mesh; shard the unsharded index")
    n_model = _check_model_axis(mesh)
    rank, sgs = row_shards(index.rank_tbl, n_model), row_shards(index.sgs_tbl, n_model)
    place = _Placer()
    meta = dict(n_nodes=index.n_nodes, n_kmers=index.n_kmers, k=index.k,
                precalc_k=index.precalc_k, n_words=index.n_words,
                has_streaming=index.has_streaming)
    views = [ShardedMatrixIndex([place(("rank", m), rank[m], dev) for m, dev in enumerate(row)],
                                [place(("sgs", m), sgs[m], dev) for m, dev in enumerate(row)],
                                place("C", index.C, row[0]), place("precalc", index.precalc, row[0]),
                                **meta)
             for row in mesh.devices]
    return RowSharded(mesh, views)


def tp_search(index, codes, mesh: Mesh) -> torch.Tensor:
    """Per-k-mer search (K20a's kmer_search) with the index row-sharded over
    `model` and the k-mers cut over `data`."""
    placed = shard_index_rows(index, mesh)
    return gather_rows([engines.search_batch(view, c) for view, c in
                        zip(placed.views, shard_batch(codes, mesh).blocks)], mesh)


def tp_streaming_search(index, codes, lengths, mesh: Mesh) -> torch.Tensor:
    """Streaming search (K20a's lf_stream) with the index row-sharded over
    `model` and the reads cut over `data`."""
    placed = shard_index_rows(index, mesh)
    cb = shard_batch(codes, mesh)
    lb = _lengths(lengths, cb, mesh)
    return gather_rows([engines.streaming_search(view, c, n) for view, c, n in
                        zip(placed.views, cb.blocks, lb.blocks)], mesh)


def _check_shard_cols(cols_per_shard: int, arity: int):
    if cols_per_shard * (4**arity) >= 2**31:
        raise ValueError(
            f"turbo TP shard too large: {cols_per_shard} columns * 4^{arity} "
            "rows exceeds int32 per-shard indexing; use more model-axis devices"
        )


def _turbo_views(shards_of, mesh: Mesh, turbo_meta: dict, small: dict) -> RowSharded:
    """One ShardedTurboIndex a data row: shards_of(m, device) gives shard m
    on that device; the small tables go to each row's home."""
    place = _Placer()
    views = [ShardedTurboIndex([shards_of(m, dev) for m, dev in enumerate(row)],
                               *(place(name, small[name], row[0])
                                 for name in ("precalc", "C", "seed_bits")), **turbo_meta)
             for row in mesh.devices]
    return RowSharded(mesh, views)


def shard_turbo_rows(turbo, mesh: Mesh) -> RowSharded:
    """Place an already-built turbo table (plain-matrix, int32)
    row-sharded over `model`, padded to whole columns; precalc, C and seed
    bits on each row's home. For a table too large for one device, use
    build_turbo_sharded."""
    n_model = _check_model_axis(mesh)
    rpc = 4**turbo.arity if turbo.arity >= 2 else 1
    cols = -(-turbo.tbl.shape[0] // (rpc * n_model))
    _check_shard_cols(cols, turbo.arity if turbo.arity >= 2 else 0)
    parts = row_shards(turbo.tbl, n_model, rpc)
    place = _Placer()
    meta = dict(n_nodes=turbo.n_nodes, k=turbo.k, precalc_k=turbo.precalc_k, arity=turbo.arity,
                cols=cols)
    small = {"precalc": turbo.precalc, "C": turbo.C, "seed_bits": turbo.seed_bits}
    return _turbo_views(lambda m, dev: place(("tbl", m), parts[m], dev), mesh, meta, small)


def is_turbo_row_sharded(turbo, mesh: Mesh) -> bool:
    """True if the turbo table is already row-sharded over this mesh's model
    axis on whole-column boundaries (shard_turbo_rows, build_turbo_sharded)."""
    return (isinstance(turbo, RowSharded) and turbo.mesh == mesh
            and all(isinstance(v, ShardedTurboIndex) for v in turbo.views))


def build_turbo_sharded(index, mesh: Mesh, arity: int = 2) -> RowSharded:
    """Build the turbo successor table directly row-sharded over `model`:
    succ1 (K2) runs once over the whole index, then each shard's own column
    range is composed (K20c) into that shard's own allocation on its own
    device, so no device ever holds the whole table. Shards hold
    ceil(n / n_model) columns; the last shard's pad columns hold zero rows
    (the JAX build composes them from zero-padded succ) and are never read.
    Query it with tp_turbo_streaming_search."""
    if arity not in (2, 3):
        raise ValueError("sharded turbo build supports arity 2 or 3")
    if not index.has_streaming:
        raise ValueError("turbo engine requires streaming support (suffix group marks)")
    n_model = _check_model_axis(mesh)
    n = index.n_nodes
    cols = -(-n // n_model)
    _check_shard_cols(cols, arity)
    if index.precalc_k <= 0:
        raise ValueError("turbo engine requires a precalc table (precalc_k > 0)")
    succ = tt.succ1(index)  # [4, n] int32, on the index's device
    place = _Placer()
    built = {}

    def shard(m, dev):
        if (m, dev) not in built:
            s = place("succ", succ, dev)
            built[(m, dev)] = (kernels.succ_compose(s, arity, m * cols, cols) if dev.type == "cuda"
                               else tt.compose_plain(s, arity, col0=m * cols, n_cols=cols))
        return built[(m, dev)]

    p = index.precalc_k
    small = {"precalc": index.precalc, "C": index.C,
             "seed_bits": tt.build_seed_bits(index.precalc, p) if p <= 14 else None}
    meta = dict(n_nodes=n, k=index.k, precalc_k=p, arity=arity, cols=cols)
    return _turbo_views(shard, mesh, meta, small)


def tp_turbo_block(view: ShardedTurboIndex, index, codes, lengths) -> torch.Tensor:
    """One data row's block: K20b on CUDA codes, its plain version on CPU ones."""
    if codes.device.type == "cuda":
        return kernels.turbo_stream_sharded(
            index.kernel_desc(codes.device), view.tbl_shards, view.cols, view.arity, view.C,
            view.precalc, view.precalc_k, view.seed_bits, codes,
            lengths.to(device=codes.device, dtype=torch.int32), view.k, view.n_nodes)
    return tt.turbo_streaming_search_plain(view, index, codes, lengths)


def tp_turbo_streaming_search(turbo, index, codes, lengths, mesh: Mesh) -> torch.Tensor:
    """Turbo streaming search (K20b) with the successor table row-sharded
    over `model` and the reads cut over `data`; the plain-matrix index
    (restarts from a wide seed) replicated. Per-device table memory falls
    with the model axis."""
    placed = turbo if is_turbo_row_sharded(turbo, mesh) else shard_turbo_rows(turbo, mesh)
    reps = replicate_index(index, mesh)
    cb = shard_batch(codes, mesh)
    lb = _lengths(lengths, cb, mesh)
    return gather_rows([tp_turbo_block(view, reps.on(c.device), c, n) for view, c, n in
                        zip(placed.views, cb.blocks, lb.blocks)], mesh)
