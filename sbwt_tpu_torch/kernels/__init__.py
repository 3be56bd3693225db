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

Importing this module builds nothing and needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lf_interval.cu", "succ_table.cu", "seed_bits.cu", "turbo_stream.cu")
HEADERS = ("sbwt_common.cuh",)
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches per kernel entry point since the last reset_launch_counts().
LAUNCHES = {
    "precalc_fill": 0,
    "kmer_search": 0,
    "succ1": 0,
    "succ_compose": 0,
    "seed_bits": 0,
    "turbo_stream": 0,
}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "sbwt_precalc_fill": [_I, _P, _LL, _P, _I, _I, _P, _P],
    "sbwt_kmer_search": [_I, _P, _LL, _P, _I, _P, _I, _P, _LL, _I, _P, _P],
    "sbwt_succ1": [_I, _P, _LL, _P, _P, _I, _P, _P],
    "sbwt_succ_compose": [_I, _P, _I, _I, _P, _P],
    "sbwt_seed_bits": [_I, _P, _I, _P, _P],
    "sbwt_turbo_stream": [_I, _P, _I, _P, _LL, _P, _P, _I, _P, _P, _LL, _I, _I, _P, _P, _P],
}


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
    (library path, seconds spent compiling). The compiler's output
    (register and spill counts from ptxas) is kept beside the library as
    ``<name>.log``. Raises with nvcc's stderr if the build fails."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds


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
            _lib = lib
        return _lib


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


def precalc_fill(rank_tbl, n_words: int, C, n_nodes: int, p: int) -> torch.Tensor:
    """K1 (lf_interval.cu): int32 [4^p, 2] intervals of all p-mers."""
    dev = _cuda_device(rank_tbl)
    out = torch.empty((4**p, 2), dtype=torch.int32, device=dev)
    _launch(
        "sbwt_precalc_fill", "precalc_fill", dev,
        _check(rank_tbl, "rank_tbl", torch.int32, dev, (4 * n_words, 2), 8), n_words,
        _check(C, "C", torch.int32, dev, (4,)), n_nodes, p,
        _check(out, "out", torch.int32, dev, align=8),
    )
    return out


def kmer_search(rank_tbl, n_words: int, C, n_nodes: int, precalc, p: int, codes) -> torch.Tensor:
    """K1 (lf_interval.cu): colex rank or -1 of each int8 k-mer row [B, k]."""
    dev = _cuda_device(codes)
    B, k = codes.shape
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    _launch(
        "sbwt_kmer_search", "kmer_search", dev,
        _check(rank_tbl, "rank_tbl", torch.int32, dev, (4 * n_words, 2), 8), n_words,
        _check(C, "C", torch.int32, dev, (4,)), n_nodes,
        _check(precalc, "precalc", torch.int32, dev, (max(1, 4**p), 2), 8), p,
        _check(codes, "codes", torch.int8, dev, align=1), B, k,
        _check(out, "out", torch.int32, dev),
    )
    return out


def succ1(rank_tbl, n_words: int, sgs_tbl, C, n_nodes: int) -> torch.Tensor:
    """K2 (succ_table.cu): int32 [4, n] successor of each column by each char."""
    dev = _cuda_device(rank_tbl)
    out = torch.empty((4, n_nodes), dtype=torch.int32, device=dev)
    _launch(
        "sbwt_succ1", "succ1", dev,
        _check(rank_tbl, "rank_tbl", torch.int32, dev, (4 * n_words, 2), 8), n_words,
        _check(sgs_tbl, "sgs_tbl", torch.int32, dev, (n_words, 2), 8),
        _check(C, "C", torch.int32, dev, (4,)), n_nodes,
        _check(out, "succ", torch.int32, dev),
    )
    return out


def succ_compose(succ, arity: int) -> torch.Tensor:
    """K2 (succ_table.cu): the arity-A table from succ [4, n]: [n, 4] for
    A = 1, [n * 16, 2] for A = 2, [n * 64, 4] for A = 3."""
    dev = _cuda_device(succ)
    n = succ.shape[1]
    shape = {1: (n, 4), 2: (n * 16, 2), 3: (n * 64, 4)}[arity]
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    _launch(
        "sbwt_succ_compose", "succ_compose", dev,
        _check(succ, "succ", torch.int32, dev, (4, n)), n, arity,
        _check(out, "tbl", torch.int32, dev, align=16),
    )
    return out


def seed_bits(precalc, p: int) -> torch.Tensor:
    """K3 (seed_bits.cu): packed 2-bit pair entries, int32 [4^(p+1) / 16]
    (the bits of the JAX package's uint32 words)."""
    dev = _cuda_device(precalc)
    out = torch.empty(4 ** (p + 1) // 16, dtype=torch.int32, device=dev)
    _launch(
        "sbwt_seed_bits", "seed_bits", dev,
        _check(precalc, "precalc", torch.int32, dev, (4**p, 2), 8), p,
        _check(out, "out", torch.int32, dev),
    )
    return out


def turbo_stream(tbl, arity: int, rank_tbl, n_words: int, C, precalc, p: int,
                 seed_bits_tbl, codes, lengths, k: int) -> torch.Tensor:
    """K4 (turbo_stream.cu): int32 [B, L - k + 1] streaming answers of the
    int8 codes [B, L] with valid lengths int32 [B]."""
    dev = _cuda_device(codes)
    B, L = codes.shape
    out = torch.empty((B, L - k + 1), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    sb = 0 if seed_bits_tbl is None else _check(seed_bits_tbl, "seed_bits", torch.int32, dev)
    _launch(
        "sbwt_turbo_stream", "turbo_stream", dev,
        _check(tbl, "tbl", torch.int32, dev, align=16), arity,
        _check(rank_tbl, "rank_tbl", torch.int32, dev, (4 * n_words, 2), 8), n_words,
        _check(C, "C", torch.int32, dev, (4,)),
        _check(precalc, "precalc", torch.int32, dev, (4**p, 2), 8), p, sb,
        _check(codes, "codes", torch.int8, dev, align=1), B, L, k,
        _check(lengths, "lengths", torch.int32, dev, (B,)),
        _check(out, "out", torch.int32, dev),
    )
    return out
