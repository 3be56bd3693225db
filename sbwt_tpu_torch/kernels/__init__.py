"""Loader and launch wrappers for the hand-written CUDA kernels.

The kernels live in ``sbwt_tpu_torch/csrc`` as CUDA C++ with a plain C
interface. At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library under ``sbwt_tpu_torch/_build/``
and loaded with ``ctypes``. The library's name carries a hash of the
sources and flags, so a stale build is never loaded.

Each launch function here takes CUDA tensors, checks device, dtype, shape
and contiguity, launches on PyTorch's current stream without
synchronising, raises if the launch was refused, and adds one to its
count in ``LAUNCHES``. The modules of the port call these only for CUDA
tensors; CPU tensors go to each kernel's plain PyTorch version.

K14 (``lf_stream``) and K4 (``turbo_stream``) also have instances that
count their work: inside ``count_work(device)`` those launch, and
``work_counts()`` reads the totals.

Importing this module builds nothing and needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..utils.profiling import annotate

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("succ_table.cu", "seed_bits.cu", "lf_stream.cu", "lf_split.cu", "lf_concat.cu",
           "lf_subsetwt.cu", "lf_wide.cu", "build_sbwt.cu", "lf_sharded.cu", "gather_chain.cu",
           "fast_search.cu", "answer_stats.cu")
HEADERS = ("sbwt_common.cuh", "bv.cuh", "wavelet.cuh", "subset_rank.cuh", "stream_tile.cuh",
           "lf_stream.cuh", "succ_table.cuh", "turbo_stream.cuh", "rank_ops.cuh")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

VARIANTS = ("plain-matrix", "rrr-matrix", "mef-matrix", "plain-split", "rrr-split",
            "mef-split", "plain-concat", "mef-concat", "plain-subsetwt", "rrr-subsetwt")
# the rank type of the wide (int64) tier: plain-matrix rows with 64-bit counts
WIDE = "wide-matrix"
# K20a: plain-matrix rows cut into row shards over a mesh's model axis
# (parallel/sharded.py). A rank type, not a variant: no file holds one.
SHARDED = "sharded-matrix"
# every rank type of csrc/subset_rank.cuh, in the order the kernels number them
RANK_TYPES = VARIANTS + (WIDE, SHARDED)
# the source file (and C entry point sbwt_lf_<family>) of each rank type's instances
FAMILY = {v: v.split("-")[1] for v in VARIANTS}
FAMILY[WIDE] = "wide"
FAMILY[SHARDED] = "sharded"
# the kernels that are templates over the rank type (csrc/rank_ops.cuh), in
# the order of the LFOp enum: K14, K1's fill and search, partial_search,
# K2's succ1, K4 and forward (one char a column)
LF_OPS = ("lf_stream", "precalc_fill", "kmer_search", "partial_search", "succ1", "turbo_stream",
          "forward")
# the ops each rank type's entry point launches: the sharded type serves the
# TP search and streaming search only
RANK_OPS = {v: LF_OPS for v in VARIANTS + (WIDE,)}
RANK_OPS[SHARDED] = ("lf_stream", "kmer_search")
# the widest model axis the sharded kernels take (csrc/sbwt_common.cuh kMaxShards)
MAX_SHARDS = 8
# K20b: K4 of plain-matrix over a row-sharded successor table
TURBO_SHARDED = "turbo_stream[plain-matrix/sharded-table]"
# K20c: K2's composition over one shard's column range
COMPOSE_RANGE = "succ_compose[column-range]"
# fast_search over a narrow table (arity 1-3) and over the wide tier's
FAST_SEARCH = {False: "fast_search[plain-matrix]", True: f"fast_search[{WIDE}]"}


def pos_dtype(variant: str) -> torch.dtype:
    """The type of a rank type's positions: columns, interval bounds, answers."""
    return torch.int64 if variant == WIDE else torch.int32


def lf_counter(op: str, variant: str) -> str:
    """The LAUNCHES key of one instance."""
    return f"{op}[{variant}]"


# K14's and K4's work counters (csrc/lf_stream.cuh WorkCounter), in order:
# real positions, full searches begun (restarts; K14's probes too), restarts
# that found their k-mer, exact LF steps the restarts took, successor-table
# rows read (K4), positions of k ACGT chars answered -1 by a probe's dead
# substring with no search of their own (K14)
WORK_COUNTERS = ("positions", "restarts", "restart_hits", "lf_steps", "table_rows", "skipped")

# K19, the on-device build (csrc/build_sbwt.cu); the ranged build adds pack_range
BUILD_OPS = ("pack_windows", "edge_src_probe", "emit_dummies", "finalize_tables")
PACK_RANGE = "pack_range"

# Launches per kernel entry point since the last reset_launch_counts().
LAUNCHES = {
    "succ_compose": 0,
    "seed_bits": 0,
    f"seed_bits[{WIDE}]": 0,
    "answer_stats": 0,
    f"answer_stats[{WIDE}]": 0,
    **{op: 0 for op in BUILD_OPS},
    PACK_RANGE: 0,
    **{lf_counter(op, v): 0 for op in LF_OPS for v in RANK_TYPES if op in RANK_OPS[v]},
    TURBO_SHARDED: 0,
    COMPOSE_RANGE: 0,
    "gather_chain": 0,
    **{name: 0 for name in FAST_SEARCH.values()},
}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # (device, succ, n_nodes, arity, col0, n_cols, rows scratch, tbl, stream)
    "sbwt_succ_compose": [_I, _P, _I, _I, _I, _I, _P, _P, _P],
    # (device, precalc, p, wide, bitmap scratch, out, stream)
    "sbwt_seed_bits": [_I, _P, _I, _I, _P, _P, _P],
    # (device, answers, n, wide, out, stream)
    "sbwt_answer_stats": [_I, _P, _LL, _I, _P, _P],
    # (device, op, variant, rank descriptor*, LFArgs*, stream)
    **{f"sbwt_lf_{fam}": [_I, _I, _I, _P, _P, _P] for fam in sorted(set(FAMILY.values()))},
    "sbwt_lf_desc_sizes": [_P],
    # (k, arity, answer bytes): K4's dynamic shared memory per block
    "sbwt_turbo_smem_bytes": [_I, _I, _I],
    # (k, rank type): K14's
    "sbwt_lf_smem_bytes": [_I, _I],
    "sbwt_pack_windows": [_I, _P, _LL, _I, _P, _P, _P],
    # (device, codes, m, k, lo, hi, bits, nodes, cap, edges, cap, count, stream)
    "sbwt_pack_range": [_I, _P, _LL, _I, ctypes.c_uint, ctypes.c_uint, _I, _P, _LL, _P, _LL, _P,
                        _P],
    # (device, keys, n, query keys, nq, k, edges, gstart, is_src, scratch, stream)
    "sbwt_edge_src_probe": [_I, _P, _LL, _P, _LL, _I, _P, _P, _P, _P, _P],
    # (k): the list keys a block of edge_src_probe takes at most
    "sbwt_edge_src_share": [_I],
    "sbwt_emit_dummies": [_I, _P, _LL, _I, _P, _P, _P, _P],
    "sbwt_finalize_tables": [_I, _P, _P, _P, _LL, _I, _LL, _I, _P, _P, _P, _P],
    # (device, PlainMatrix*, ShardedTable*, LFArgs*, stream)
    "sbwt_turbo_sharded_table": [_I, _P, _P, _P, _P],
    "sbwt_enable_peer": [_I, _I],
    # (device, tbl, R, width, R's multiplier m, its shift l, idx0, B, steps, out, stream)
    "sbwt_gather_chain": [_I, _P, _I, _I, ctypes.c_uint, _I, _P, _LL, _I, _P, _P],
    # (device, wide, tbl, arity, precalc, p, codes, B, k, ans, needs_slow, stream)
    "sbwt_fast_search": [_I, _I, _P, _I, _P, _I, _P, _LL, _I, _P, _P, _P],
}


# ---------------------------------------------------------------------------
# Descriptors of the rank structures, mirroring the device types of
# csrc/bv.cuh, wavelet.cuh, subset_rank.cuh and lf_stream.cuh field by field.
# A launch passes one by pointer; the C entry point hands it to the kernel
# by value. The loader checks every size against the library's.
# ---------------------------------------------------------------------------


def _struct(name: str, fields: list) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def c_ints(values) -> ctypes.Array:
    """A descriptor's fixed-size int array field holding ``values``."""
    vals = [int(x) for x in values]
    return (_I * len(vals))(*vals)


PlainBVDesc = _struct("PlainBV", [("tbl", _P)])
RRRDesc = _struct("RRR15", [("meta", _P), ("offs", _P)])
MEFDesc = _struct("MEF", [("upper", PlainBVDesc), ("lower", PlainBVDesc), ("wl", _I)])
BV_DESCS = {"plain": PlainBVDesc, "rrr": RRRDesc, "mef": MEFDesc}
# levels[3]; step[5][3][4] = (node base, node rank, go-right bit, valid); depth
WT_DESCS = {k: _struct(f"WaveletTree_{k}", [("level", bv * 3), ("step", _I * 60), ("depth", _I)])
            for k, bv in BV_DESCS.items()}
MATRIX_DESCS = {k: _struct(f"MatrixRank_{k}", [("bv", BV_DESCS[k]), ("n", _I), ("base", _I * 5)])
                for k in ("rrr", "mef")}
# X, Y's position-order rows (int4 pairs, 32-byte aligned), Z, n_b, z_base
SPLIT_DESCS = {k: _struct(f"SplitRank_{k}", [("X", BV_DESCS[k]), ("Y", _P), ("Z", PlainBVDesc),
                                             ("n_b", _I), ("z_base", _I * 5)])
               for k in ("plain", "rrr", "mef")}
CONCAT_DESCS = {k: _struct(f"ConcatRank_{k}", [("wt", WT_DESCS[k]), ("l_words", _P),
                                               ("samples", _P)])
                for k in ("plain", "rrr")}
# plain: the int4 plane rows of acgt, ac, gt; rrr: level 0 of each tree, the
# sparse vectors e, b, b_ac, b_gt, level 1 of each tree, its nodes' (base,
# ones before) pairs, and whether the sparse vectors stand in for level 1
SUBSETWT_DESCS = {
    "plain": _struct("SubsetWTRank_plain", [("acgt", _P), ("ac", _P), ("gt", _P)]),
    "rrr": _struct("SubsetWTRank_rrr", [("l0", RRRDesc * 3), ("e", MEFDesc), ("b", MEFDesc),
                                        ("b_ac", MEFDesc), ("b_gt", MEFDesc), ("l1", RRRDesc * 3),
                                        ("node", _I * 12), ("sparse", _I)]),
}
PlainMatrixDesc = _struct("PlainMatrix", [("rank_tbl", _P), ("n_words", _LL)])
WideMatrixDesc = _struct("WideMatrix", [("rank_tbl", _P), ("n_words", _LL)])
ShardedMatrixDesc = _struct("ShardedMatrix", [
    ("rank_shard", _P * MAX_SHARDS), ("sgs_shard", _P * MAX_SHARDS), ("n_words", _LL),
    ("rank_rows", _I), ("sgs_rows", _I),
])
ShardedTableDesc = _struct("ShardedTable", [("shard", _P * MAX_SHARDS), ("cols", _I)])
RANK_DESCS = {
    "plain-matrix": PlainMatrixDesc,
    "rrr-matrix": MATRIX_DESCS["rrr"], "mef-matrix": MATRIX_DESCS["mef"],
    "plain-split": SPLIT_DESCS["plain"], "rrr-split": SPLIT_DESCS["rrr"],
    "mef-split": SPLIT_DESCS["mef"],
    "plain-concat": CONCAT_DESCS["plain"], "mef-concat": CONCAT_DESCS["rrr"],
    "plain-subsetwt": SUBSETWT_DESCS["plain"], "rrr-subsetwt": SUBSETWT_DESCS["rrr"],
    WIDE: WideMatrixDesc, SHARDED: ShardedMatrixDesc,
}
LFArgs = _struct("LFArgs", [
    ("sgs_tbl", _P), ("C", _P), ("precalc", _P), ("codes", _P), ("lengths", _P), ("aux", _P),
    ("tbl", _P), ("seed_bits", _P), ("out", _P), ("out_r", _P), ("out_len", _P),
    ("B", _LL), ("n_nodes", _LL), ("L", _I), ("k", _I), ("p", _I), ("arity", _I),
    ("row_major", _I),
])


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found on PATH or at {NVCC_DEFAULT}: cannot build the CUDA kernels")
    return found


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsbwt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless the current library exists; returns
    (library path, seconds spent compiling). One nvcc per source runs in
    parallel, then one links the objects. The compilers' output (register
    and spill counts from ptxas) is kept beside the library as
    ``<name>.log``. Raises with nvcc's stderr if the build fails."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                                   str(CSRC / s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [(s, p.communicate()[0], p.returncode) for s, p in zip(SOURCES, procs)]
        failed = [f"{s} ({rc}):\n{log}" for s, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", str(tmp_lib), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(f"== {s}\n{log}" for s, log, _ in logs))
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or nothing
    return out, time.perf_counter() - t0


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _check_desc_sizes(lib)
            _lib = lib
        return _lib


def _check_desc_sizes(lib) -> None:
    """Raise unless every descriptor has the size the library compiled."""
    types = [RANK_DESCS[v] for v in RANK_TYPES] + [LFArgs, ShardedTableDesc]
    sizes = (ctypes.c_longlong * len(types))()
    lib.sbwt_lf_desc_sizes(sizes)
    for t, size in zip(types, sizes):
        if ctypes.sizeof(t) != size:
            raise RuntimeError(f"descriptor {t.__name__}: {ctypes.sizeof(t)} bytes in Python, "
                               f"{size} in the library")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
           shape: tuple | None = None, align: int = 4) -> int:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
    return t.data_ptr()


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {t.device}")
    return t.device


def _launch(entry: str, counter: str, device: torch.device, *args) -> None:
    fn = getattr(_library(), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(device.index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with cudaError {err}")
    LAUNCHES[counter] += 1


def succ_compose(succ, arity: int, col0: int = 0, n_cols: int | None = None) -> torch.Tensor:
    """K2 (succ_table.cu): the arity-A table from succ [4, n]: [n, 4] for
    A = 1, [n * 16, 2] for A = 2, [n * 64, 4] for A = 3. K20c: given
    n_cols, the rows of columns col0 .. col0 + n_cols - 1 only, as one model
    shard holds them (the rows of columns past n zeroed), counted apart.
    Arity 2 and 3 read the successors row by row from an [n, 4] scratch
    that the launch writes first."""
    dev = _cuda_device(succ)
    n = succ.shape[1]
    counter = "succ_compose" if n_cols is None else COMPOSE_RANGE
    n_cols = n if n_cols is None else n_cols
    real = min(n_cols, n - col0)
    if col0 < 0 or real < 1:
        raise ValueError(f"succ_compose: columns {col0} + {n_cols} of {n}")
    rows, width = {1: (1, 4), 2: (16, 2), 3: (64, 4)}[arity]
    out = torch.empty((n_cols * rows, width), dtype=torch.int32, device=dev)
    out[real * rows :].zero_()
    scratch = torch.empty((n, 4), dtype=torch.int32, device=dev) if arity > 1 else None
    _launch(
        "sbwt_succ_compose", counter, dev,
        _check(succ, "succ", torch.int32, dev, (4, n)), n, arity, col0, real,
        0 if scratch is None else _check(scratch, "rows", torch.int32, dev, align=16),
        _check(out, "tbl", torch.int32, dev, align=16),
    )
    return out


def seed_bits(precalc, p: int) -> torch.Tensor:
    """K3 (seed_bits.cu): packed 2-bit pair entries, int32 [4^(p+1) / 16]
    (the bits of the JAX package's uint32 words), of an int32 or (wide
    tier) int64 precalc table [4^p, 2], 16-byte aligned. One entry, two
    passes: the table's 4^p-bit liveness bitmap (a scratch tensor), then
    the pair words from it."""
    dev = _cuda_device(precalc)
    if not 1 <= p <= 14:
        raise ValueError(f"seed_bits: precalc length {p} outside 1..14")
    wide = precalc.dtype == torch.int64
    bitmap = torch.empty(-(-(4**p) // 32), dtype=torch.int32, device=dev)
    out = torch.empty(4 ** (p + 1) // 16, dtype=torch.int32, device=dev)
    _launch(
        "sbwt_seed_bits", f"seed_bits[{WIDE}]" if wide else "seed_bits", dev,
        _check(precalc, "precalc", torch.int64 if wide else torch.int32, dev, (4**p, 2), 16),
        p, int(wide), _check(bitmap, "bitmap", torch.int32, dev),
        _check(out, "out", torch.int32, dev),
    )
    return out


def answer_stats(out) -> torch.Tensor:
    """K13 (answer_stats.cu): int64 [2], the checksum (the int64 sum of
    every answer) and the hit count (answers >= 0) of a contiguous int32
    or (wide tier) int64 answer tensor of any shape."""
    dev = _cuda_device(out)
    wide = out.dtype == torch.int64
    if out.numel() == 0:
        return torch.zeros(2, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    _launch("sbwt_answer_stats", f"answer_stats[{WIDE}]" if wide else "answer_stats", dev,
            _check(out, "answers", torch.int64 if wide else torch.int32, dev,
                   align=out.element_size()),
            out.numel(), int(wide), _check(stats, "stats", torch.int64, dev, align=8))
    return stats


# ---------------------------------------------------------------------------
# The kernels over any rank type (csrc/rank_ops.cuh; one instance per rank
# type in lf_<family>.cu): K14, K1, partial_search, K2's succ1 and K4.
# Positions (C, precalc, answers) are int32, or int64 for the wide type.
# ---------------------------------------------------------------------------


def ptr(t: torch.Tensor, name: str, device: torch.device, align: int = 4) -> int:
    """Checked device pointer of an int32 tensor that a descriptor carries."""
    return _check(t, name, torch.int32, device, align=align)


def _lf_launch(op: str, variant: str, rank_desc, device: torch.device, **fields) -> None:
    if op not in RANK_OPS[variant]:
        raise ValueError(f"{variant}: no {op} instance")
    if not isinstance(rank_desc, RANK_DESCS[variant]):
        raise TypeError(f"{variant}: descriptor {type(rank_desc).__name__}, "
                        f"expected {RANK_DESCS[variant].__name__}")
    with annotate("sbwt.engine.launch"):
        args = LFArgs(**fields)
        entry = f"sbwt_lf_{FAMILY[variant]}"
        fn = getattr(_library(), entry)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(device.index, LF_OPS.index(op), RANK_TYPES.index(variant),
                 ctypes.byref(rank_desc), ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} ({op}, {variant}): CUDA launch failed with cudaError {err}")
    LAUNCHES[lf_counter(op, variant)] += 1


# The int64 [len(WORK_COUNTERS)] tensor that K14 and K4 add their work to
# inside count_work (else None), and the last such tensor.
_work: torch.Tensor | None = None
_work_last: torch.Tensor | None = None


@contextlib.contextmanager
def count_work(device):
    """Inside the block, ``lf_stream`` and ``turbo_stream`` launch their
    counting instances, which add their work (``WORK_COUNTERS``) to an
    int64 tensor on CUDA ``device``, zeroed on entry; ``work_counts()``
    reads it. The plain versions count nothing, and the row-sharded
    instances (K20a, K20b) refuse to count."""
    global _work, _work_last
    _work = _work_last = torch.zeros(len(WORK_COUNTERS), dtype=torch.int64,
                                     device=_cuda_device_of(device))
    try:
        yield
    finally:
        _work = None


def work_counts() -> dict:
    """The counts of the last ``count_work`` block (inside one: so far) as
    {counter: int}, with one synchronize and one copy."""
    if _work_last is None:
        raise RuntimeError("work_counts: no count_work block has run")
    return dict(zip(WORK_COUNTERS, _work_last.tolist()))


def _work_ptr(variant: str, device: torch.device) -> int:
    """LFArgs.out_r of a K14 or K4 launch (csrc/lf_stream.cuh WorkTally):
    the counters' pointer inside count_work, else 0."""
    if _work is None:
        return 0
    if variant == SHARDED:
        raise ValueError(f"{variant}: no instance that counts its work")
    if _work.device != device:
        raise ValueError(f"count_work on {_work.device}, launch on {device}")
    return _work.data_ptr()


def _check_C(C, variant: str, dev) -> int:
    return _check(C, "C", pos_dtype(variant), dev, (4,), pos_dtype(variant).itemsize)


def _check_precalc(precalc, variant: str, p: int, dev) -> int:
    dt = pos_dtype(variant)
    return _check(precalc, "precalc", dt, dev, (max(1, 4**p), 2), 2 * dt.itemsize)


def _check_reads(codes, lengths, dev):
    B = codes.shape[0]
    return (_check(codes, "codes", torch.int8, dev, align=1),
            _check(lengths, "lengths", torch.int32, dev, (B,)))


def lf_stream(variant: str, rank_desc, sgs_tbl, C, precalc, p: int, k: int, n_nodes: int,
              codes, lengths) -> torch.Tensor:
    """K14 (lf_stream.cuh): [B, L - k + 1] LF streaming answers of the
    int8 codes [B, L] with valid lengths int32 [B]; inside ``count_work``
    the counting instance."""
    dev = _cuda_device(codes)
    B, L = codes.shape
    out = torch.empty((B, L - k + 1), dtype=pos_dtype(variant), device=dev)
    if B == 0:
        return out
    codes_p, lengths_p = _check_reads(codes, lengths, dev)
    _lf_launch(
        "lf_stream", variant, rank_desc, dev,
        sgs_tbl=_check(sgs_tbl, "sgs_tbl", torch.int32, dev, align=8),
        C=_check_C(C, variant, dev), precalc=_check_precalc(precalc, variant, p, dev),
        codes=codes_p, lengths=lengths_p,
        out=_check(out, "out", out.dtype, dev), B=B, L=L, k=k, p=p, n_nodes=n_nodes,
        out_r=_work_ptr(variant, dev),
    )
    return out


def precalc_fill(variant: str, rank_desc, C, n_nodes: int, p: int) -> torch.Tensor:
    """K1 (lf_stream.cuh): [4^p, 2] intervals of all p-mers over the rank
    type's ranks, (-1, -1) when empty."""
    dev = _cuda_device(C)
    out = torch.empty((4**p, 2), dtype=pos_dtype(variant), device=dev)
    _lf_launch("precalc_fill", variant, rank_desc, dev, C=_check_C(C, variant, dev),
               out=_check(out, "out", out.dtype, dev, align=2 * out.dtype.itemsize),
               B=4**p, p=p, n_nodes=n_nodes)
    return out


def kmer_search(variant: str, rank_desc, C, n_nodes: int, precalc, p: int,
                codes) -> torch.Tensor:
    """K1 (lf_stream.cuh): colex rank or -1 of each int8 k-mer row [B, k]
    over the rank type's ranks."""
    dev = _cuda_device(codes)
    B, k = codes.shape
    out = torch.empty(B, dtype=pos_dtype(variant), device=dev)
    if B == 0:
        return out
    _lf_launch("kmer_search", variant, rank_desc, dev, C=_check_C(C, variant, dev),
               precalc=_check_precalc(precalc, variant, p, dev),
               codes=_check(codes, "codes", torch.int8, dev, align=1),
               out=_check(out, "out", out.dtype, dev), B=B, k=k, p=p, n_nodes=n_nodes)
    return out


def partial_search(variant: str, rank_desc, C, n_nodes: int, codes, lengths, start=None):
    """partial_search (lf_stream.cuh): LF steps over the first lengths[b]
    chars of each int8 row of codes [B, L] (lowercase as its base), from
    the full interval or from the lane's row of ``start`` [B, 2], until the
    first char < 0 or emptied interval. Returns (l [B], r [B], matched
    length int32 [B])."""
    dev = _cuda_device(codes)
    B, L = codes.shape
    dt = pos_dtype(variant)
    l, r = torch.empty(B, dtype=dt, device=dev), torch.empty(B, dtype=dt, device=dev)
    mlen = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return l, r, mlen
    codes_p, lengths_p = _check_reads(codes, lengths, dev)
    aux = 0 if start is None else _check(start, "start", dt, dev, (B, 2), 2 * dt.itemsize)
    _lf_launch("partial_search", variant, rank_desc, dev, C=_check_C(C, variant, dev),
               codes=codes_p, lengths=lengths_p, aux=aux, out=_check(l, "l", dt, dev),
               out_r=_check(r, "r", dt, dev), out_len=_check(mlen, "mlen", torch.int32, dev),
               B=B, L=L, n_nodes=n_nodes)
    return l, r, mlen


def succ1(variant: str, rank_desc, sgs_tbl, C, n_nodes: int, cols=None,
          row_major: bool = False) -> torch.Tensor:
    """K2 (succ_table.cuh): the successor of each column's suffix group by
    each char, or -1, over the rank type's ranks: [4, B], or [B, 4] when
    ``row_major``. The columns are ``cols`` [B], or all n_nodes."""
    dev = _cuda_device(C)
    dt = pos_dtype(variant)
    B = n_nodes if cols is None else cols.shape[0]
    out = torch.empty((B, 4) if row_major else (4, B), dtype=dt, device=dev)
    if B == 0:
        return out
    _lf_launch("succ1", variant, rank_desc, dev,
               sgs_tbl=_check(sgs_tbl, "sgs_tbl", torch.int32, dev, align=8),
               C=_check_C(C, variant, dev),
               aux=0 if cols is None else _check(cols, "cols", dt, dev, (B,), dt.itemsize),
               out=_check(out, "succ", dt, dev, align=16), B=B, n_nodes=n_nodes,
               row_major=int(row_major))
    return out


def forward(variant: str, rank_desc, sgs_tbl, C, n_nodes: int, cols, chars) -> torch.Tensor:
    """forward (succ_table.cuh): the successor of each column of ``cols``
    [B] by its char of ``chars`` int8 [B] (0..3), or -1, over the rank
    type's ranks: one rank pair a column."""
    dev = _cuda_device(C)
    dt = pos_dtype(variant)
    B = cols.shape[0]
    out = torch.empty(B, dtype=dt, device=dev)
    if B == 0:
        return out
    _lf_launch("forward", variant, rank_desc, dev,
               sgs_tbl=_check(sgs_tbl, "sgs_tbl", torch.int32, dev, align=8),
               C=_check_C(C, variant, dev), aux=_check(cols, "cols", dt, dev, (B,), dt.itemsize),
               codes=_check(chars, "chars", torch.int8, dev, (B,), 1),
               out=_check(out, "out", dt, dev), B=B, n_nodes=n_nodes)
    return out


def turbo_stream(variant: str, rank_desc, tbl, arity: int, C, precalc, p: int, seed_bits_tbl,
                 codes, lengths, k: int, n_nodes: int) -> torch.Tensor:
    """K4 (turbo_stream.cuh): [B, L - k + 1] streaming answers of the int8
    codes [B, L] with valid lengths int32 [B], over the arity-A successor
    table and, for restarts from a wide seed, the rank type's ranks. The
    wide type's table is int64 [n, 4] (arity 1). Inside ``count_work``
    the counting instance."""
    dev = _cuda_device(codes)
    B, L = codes.shape
    dt = pos_dtype(variant)
    out = torch.empty((B, L - k + 1), dtype=dt, device=dev)
    if B == 0:
        return out
    if p <= 0:
        raise ValueError("turbo_stream needs a precalc table (p > 0)")
    shape = {1: (n_nodes, 4), 2: (n_nodes * 16, 2), 3: (n_nodes * 64, 4)}.get(arity)
    if shape is None or (variant == WIDE and arity != 1):
        raise ValueError(f"turbo_stream: no arity-{arity} table on {variant}")
    codes_p, lengths_p = _check_reads(codes, lengths, dev)
    sb = 0 if seed_bits_tbl is None else _check(seed_bits_tbl, "seed_bits", torch.int32, dev,
                                                (4 ** (p + 1) // 16,))
    _lf_launch(
        "turbo_stream", variant, rank_desc, dev,
        tbl=_check(tbl, "tbl", dt, dev, shape, 16), arity=arity, C=_check_C(C, variant, dev),
        precalc=_check_precalc(precalc, variant, p, dev), seed_bits=sb,
        codes=codes_p, lengths=lengths_p, out=_check(out, "out", dt, dev),
        B=B, L=L, k=k, p=p, n_nodes=n_nodes, out_r=_work_ptr(variant, dev),
    )
    return out


def turbo_smem_bytes(k: int, arity: int, pos_bytes: int = 4) -> int:
    """The shared memory one block of K4 (and K20b) asks for at (k, arity)
    with answers of pos_bytes bytes; it builds the library."""
    return _library().sbwt_turbo_smem_bytes(k, arity, pos_bytes)


def lf_smem_bytes(variant: str, k: int) -> int:
    """The shared memory one block of K14 over a rank type asks for at k
    (its tile and warps a block are the rank type's); it builds the
    library."""
    return _library().sbwt_lf_smem_bytes(k, RANK_TYPES.index(variant))


def fast_search(tbl, arity: int, precalc, p: int, codes, n_nodes: int):
    """fast_search (fast_search.cu): over the int8 k-mer rows codes [B, k],
    the colex rank of each row with a live singleton precalc seed, walked
    through the arity-A successor table, and whether its seed is wider
    than one column (needs_slow, which only exact LF steps can answer).
    Returns (ans [B] in the table's type, -1 where dead or needs_slow;
    needs_slow bool [B]). The wide tier's table is int64 [n, 4] (arity 1)."""
    dev = _cuda_device(codes)
    B, k = codes.shape
    wide = tbl.dtype == torch.int64
    dt = torch.int64 if wide else torch.int32
    ans = torch.empty(B, dtype=dt, device=dev)
    slow = torch.empty(B, dtype=torch.uint8, device=dev)
    if B == 0:
        return ans, slow.bool()
    shape = {1: (n_nodes, 4), 2: (n_nodes * 16, 2), 3: (n_nodes * 64, 4)}.get(arity)
    if shape is None or (wide and arity != 1):
        raise ValueError(f"fast_search: no arity-{arity} {dt} table")
    if not 1 <= p <= min(k, 16):
        raise ValueError(f"fast_search: precalc length {p} outside 1..min(k = {k}, 16)")
    _launch("sbwt_fast_search", FAST_SEARCH[wide], dev, int(wide),
            _check(tbl, "tbl", dt, dev, shape, 16), arity,
            _check(precalc, "precalc", dt, dev, (4**p, 2), 2 * dt.itemsize), p,
            _check(codes, "codes", torch.int8, dev, align=1), B, k,
            _check(ans, "ans", dt, dev), _check(slow, "needs_slow", torch.uint8, dev, align=1))
    return ans, slow.bool()


# ---------------------------------------------------------------------------
# K20: row shards over a mesh's model axis (csrc/lf_sharded.cu). A shard may
# lie on another card than the one that runs the kernel: peer access is
# enabled for the pair first, and a pair that cannot reach each other raises.
# ---------------------------------------------------------------------------

_peers: set = set()


def enable_peer_access(device: torch.device, peer: torch.device) -> None:
    """Let kernels launched on CUDA ``device`` load from memory on CUDA
    ``peer``; raises if the pair cannot reach each other. Idempotent."""
    device, peer = _cuda_device_of(device), _cuda_device_of(peer)
    if device == peer or (device.index, peer.index) in _peers:
        return
    err = _library().sbwt_enable_peer(device.index, peer.index)
    if err != 0:
        raise RuntimeError(f"{device} cannot load from {peer} (peer access: cudaError {err}); "
                           "the sharded kernels never copy a table instead")
    _peers.add((device.index, peer.index))


def _cuda_device_of(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {device}")
    return device if device.index is not None else torch.device("cuda", torch.cuda.current_device())


def shard_ptrs(shards, name: str, device: torch.device, shape: tuple, align: int) -> ctypes.Array:
    """The checked data pointers of the int32 row shards (each of ``shape``)
    that a kernel on ``device`` reads, as a descriptor's pointer array;
    enables peer access to every other card that holds one."""
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"{name}: {len(shards)} shards, the kernels take 1 to {MAX_SHARDS}")
    ptrs = []
    for i, t in enumerate(shards):
        enable_peer_access(device, _cuda_device(t))
        ptrs.append(_check(t, f"{name}[{i}]", torch.int32, t.device, shape, align))
    return (_P * MAX_SHARDS)(*ptrs)


def turbo_stream_sharded(rank_desc, shards, cols: int, arity: int, C, precalc, p: int,
                         seed_bits_tbl, codes, lengths, k: int, n_nodes: int) -> torch.Tensor:
    """K20b (turbo_stream.cuh over a ShardedTable): K4 of plain-matrix with
    the arity-A successor table cut into row shards of ``cols`` whole
    columns each (4^A rows a column, 1 at arity 1)."""
    dev = _cuda_device(codes)
    B, L = codes.shape
    out = torch.empty((B, L - k + 1), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    if p <= 0:
        raise ValueError("turbo_stream needs a precalc table (p > 0)")
    if not isinstance(rank_desc, PlainMatrixDesc):
        raise TypeError(f"turbo_stream_sharded: descriptor {type(rank_desc).__name__}, "
                        "expected PlainMatrix")
    if _work is not None:
        raise ValueError(f"{TURBO_SHARDED}: no instance that counts its work")
    rows, width = {1: (1, 4), 2: (16, 2), 3: (64, 4)}[arity]
    if cols * len(shards) < n_nodes:
        raise ValueError(f"{len(shards)} shards of {cols} columns hold fewer than {n_nodes}")
    table = ShardedTableDesc(shard_ptrs(shards, "tbl", dev, (cols * rows, width), 16), cols)
    codes_p, lengths_p = _check_reads(codes, lengths, dev)
    sb = 0 if seed_bits_tbl is None else _check(seed_bits_tbl, "seed_bits", torch.int32, dev,
                                                (4 ** (p + 1) // 16,))
    args = LFArgs(arity=arity, C=_check_C(C, "plain-matrix", dev),
                  precalc=_check_precalc(precalc, "plain-matrix", p, dev), seed_bits=sb,
                  codes=codes_p, lengths=lengths_p, out=_check(out, "out", torch.int32, dev),
                  B=B, L=L, k=k, p=p, n_nodes=n_nodes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().sbwt_turbo_sharded_table(dev.index, ctypes.byref(rank_desc),
                                              ctypes.byref(table), ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"sbwt_turbo_sharded_table: CUDA launch failed with cudaError {err}")
    LAUNCHES[TURBO_SHARDED] += 1
    return out


# ---------------------------------------------------------------------------
# K21: the dependent-gather probe (csrc/gather_chain.cu)
# ---------------------------------------------------------------------------


def divisor_magic(R: int) -> tuple[int, int]:
    """(m, l) for the divisor 1 <= R < 2^31: l = ceil(log2 R) and
    m = floor(2^(31 + l) / R) + 1, which is below 2^32 (Granlund and
    Montgomery's round-up multiplier, exact for every dividend below 2^31)."""
    if not 1 <= R < 2**31:
        raise ValueError(f"gather_chain: {R} rows, expected 1 to 2^31 - 1")
    l = (R - 1).bit_length()
    return (1 << (31 + l)) // R + 1, l


def mod_by_magic(x: int, R: int, m: int, l: int) -> int:
    """(x & 0x7FFFFFFF) % R as K21 computes it from (m, l) = divisor_magic(R),
    for any 32-bit word x: the quotient is the high word of m * (x << 1)
    (2 n, whatever x's top bit) shifted right by l."""
    q = (m * ((x << 1) & 0xFFFFFFFF)) >> 32 >> l
    return (x & 0x7FFFFFFF) - q * R


def gather_chain(tbl, idx0, steps: int) -> torch.Tensor:
    """K21: each lane of idx0 int32 [B] runs ``steps`` dependent loads from
    the int32 table [R, 2] or [R, 8]: idx <- (xor of row idx & 0x7FFFFFFF)
    % R, the remainder by R's multiplier (``divisor_magic``). The kernel
    runs on idx0's card; the table may lie on a peer card."""
    dev = _cuda_device(idx0)
    enable_peer_access(dev, _cuda_device(tbl))
    R, width = tbl.shape
    if width not in (2, 8):
        raise ValueError(f"gather_chain: rows of {width} words, expected 2 or 8")
    m, l = divisor_magic(R)
    B = idx0.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    _launch("sbwt_gather_chain", "gather_chain", dev,
            _check(tbl, "tbl", torch.int32, tbl.device, align=4 * width if width == 2 else 16),
            R, width, m, l, _check(idx0, "idx0", torch.int32, dev, (B,)), B, steps,
            _check(out, "out", torch.int32, dev))
    return out


# ---------------------------------------------------------------------------
# K19: the on-device build (csrc/build_sbwt.cu). Keys are int32 [n, W] rows
# holding the bits of W = ceil(k / 16) uint32 words, word 0 most significant.
# ---------------------------------------------------------------------------


def key_words(k: int) -> int:
    return -(-k // 16)


def pack_windows(codes, k: int):
    """Every length-k window of the int8 codes [Ntot] as a key: int32
    [m, W] (m = Ntot - k + 1) and bool [m] validity; a window holding a
    code < 0 is invalid and its key all ones."""
    dev = _cuda_device(codes)
    m, W = codes.shape[0] - k + 1, key_words(k)
    if m < 1:
        raise ValueError(f"codes: {codes.shape[0]} codes hold no window of k = {k}")
    keys = torch.empty((m, W), dtype=torch.int32, device=dev)
    valid = torch.empty(m, dtype=torch.bool, device=dev)
    _launch("sbwt_pack_windows", "pack_windows", dev,
            _check(codes, "codes", torch.int8, dev, (m + k - 1,), 1), m, k,
            _check(keys, "keys", torch.int32, dev),
            _check(valid, "valid", torch.bool, dev, align=1))
    return keys, valid


def pack_range(codes, k: int, lo: int, hi: int, bits: int, cap_nodes: int, cap_edges: int):
    """The valid length-k windows of the int8 codes [Ntot] whose key's top
    ``bits`` bits lie in [lo, hi) (int32 [cap_nodes, W]), and those whose
    (k-1)-prefix's top bits do (int32 [cap_edges, W]), each in no fixed
    order, and int64 [2] the windows the kernel sent to each: the caller
    checks them against the capacities (a key past one is not written)."""
    dev = _cuda_device(codes)
    m, W = codes.shape[0] - k + 1, key_words(k)
    if m < 1:
        raise ValueError(f"codes: {codes.shape[0]} codes hold no window of k = {k}")
    if not 0 <= bits <= min(16, 2 * (k - 1)) or not 0 <= lo <= hi <= 1 << bits:
        raise ValueError(f"pack_range: bits {bits}, range [{lo}, {hi}) at k = {k}")
    nodes = torch.empty((cap_nodes, W), dtype=torch.int32, device=dev)
    edges = torch.empty((cap_edges, W), dtype=torch.int32, device=dev)
    count = torch.empty(2, dtype=torch.int64, device=dev)
    _launch("sbwt_pack_range", PACK_RANGE, dev,
            _check(codes, "codes", torch.int8, dev, (m + k - 1,), 1), m, k, lo, hi, bits,
            _check(nodes, "nodes", torch.int32, dev), cap_nodes,
            _check(edges, "edges", torch.int32, dev), cap_edges,
            _check(count, "count", torch.int64, dev, align=8))
    return nodes, edges, count


def edge_src_probe(keys, k: int, queries):
    """Over the n sorted distinct k-mer keys int32 [n, W] (the list) and the
    sorted distinct query keys [nq, W]: uint8
    [n] edge nibble (bit c: the suffix group's out-edge c, among the
    queries, on the group's first column only), bool [n] suffix-group
    start, bool [nq] source (no list key's (k-1)-suffix is its
    (k-1)-prefix)."""
    dev = _cuda_device(keys)
    n = keys.shape[0]
    nq = queries.shape[0]
    # the kernel ORs each edge bit into its 4-byte word: whole words, aligned
    edges = torch.empty(-(-n // 4) * 4, dtype=torch.uint8, device=dev)[:n]
    gstart = torch.empty(n, dtype=torch.bool, device=dev)
    is_src = torch.empty(nq, dtype=torch.bool, device=dev)
    if n == 0:
        is_src.fill_(True)
        return edges, gstart, is_src
    # every partition's split and the run starts (merge_parts in build_sbwt.cu)
    parts = -(-(n + nq) // edge_src_share(k))
    scratch = torch.empty(4 * (parts + 1) + 4, dtype=torch.int64, device=dev)
    _launch("sbwt_edge_src_probe", "edge_src_probe", dev,
            _check(keys, "keys", torch.int32, dev, (n, key_words(k))), n,
            _check(queries, "queries", torch.int32, dev, (nq, key_words(k))), nq, k,
            _check(edges, "edges", torch.uint8, dev),
            _check(gstart, "gstart", torch.bool, dev, align=1),
            _check(is_src, "is_src", torch.bool, dev, align=1),
            _check(scratch, "scratch", torch.int64, dev, align=8))
    return edges, gstart, is_src


def edge_src_share(k: int) -> int:
    """The list keys one block of the edge_src_probe kernel takes at most
    at this k: its merge partitions are ceil(2 n / share) a run."""
    return _library().sbwt_edge_src_share(k)


def emit_dummies(src, k: int):
    """The dummy prefixes of the source keys int32 [n_src, W]: row s * k + l
    is source s's l-char prefix (key, length l, edge char = its char at
    index l), and the last row the root (zeros, 0, -1). Returns int32
    [n_src * k + 1, W] keys, int32 lengths, int32 edges."""
    dev = _cuda_device(src)
    n_src, W = src.shape[0], key_words(k)
    total = n_src * k + 1
    out_keys = torch.empty((total, W), dtype=torch.int32, device=dev)
    out_len = torch.empty(total, dtype=torch.int32, device=dev)
    out_edge = torch.empty(total, dtype=torch.int32, device=dev)
    _launch("sbwt_emit_dummies", "emit_dummies", dev,
            _check(src, "src", torch.int32, dev, (n_src, W)), n_src, k,
            _check(out_keys, "out_keys", torch.int32, dev),
            _check(out_len, "out_len", torch.int32, dev),
            _check(out_edge, "out_edge", torch.int32, dev))
    return out_keys, out_len, out_edge


def finalize_tables(keys, lengths, edges, k: int, streaming: bool, lead: int = 0,
                    n_words: int | None = None):
    """Over the T merged nodes sorted by (key, length): the packed edge rows
    int32 [4 * n_words] (char-major, n_words = T // 32 + 1 unless given),
    their per-word popcounts int32 [4 * n_words], and the packed streaming
    marks int32 [n_words] (None without streaming support). Column t sits
    at bit ``lead`` + t (0 <= lead < 32)."""
    dev = _cuda_device(keys)
    T = keys.shape[0]
    if n_words is None:
        n_words = T // 32 + 1
    if not 0 <= lead < 32 or n_words * 32 < lead + T:
        raise ValueError(f"finalize_tables: {T} columns at lead {lead} in {n_words} words")
    rank_words = torch.empty(4 * n_words, dtype=torch.int32, device=dev)
    pops = torch.empty(4 * n_words, dtype=torch.int32, device=dev)
    sgs_words = torch.empty(n_words, dtype=torch.int32, device=dev) if streaming else None
    _launch("sbwt_finalize_tables", "finalize_tables", dev,
            _check(keys, "keys", torch.int32, dev, (T, key_words(k))),
            _check(lengths, "lengths", torch.int32, dev, (T,)),
            _check(edges, "edges", torch.uint8, dev, (T,), 1), T, k, n_words, lead,
            _check(rank_words, "rank_words", torch.int32, dev),
            _check(pops, "pops", torch.int32, dev),
            _check(sgs_words, "sgs_words", torch.int32, dev) if streaming else 0)
    return rank_words, pops, sgs_words
