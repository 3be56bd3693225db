"""High-level SBWT API of the port: the plain-matrix index object.

The plain-matrix surface of sbwt_tpu/models/sbwt.py in PyTorch. Host
construction is shared with the JAX package (sbwt_tpu/construct, which
imports no JAX); the index tables live on an explicit ``device``. On a
CUDA device every query runs a hand-written kernel; on the CPU the plain
PyTorch versions run. The ``search_batch`` / ``streaming_search_batch`` /
``has_streaming_query_support`` / ``k`` surface is the one the shared
query runner (sbwt_tpu/io/query_runner.py) drives.

Streaming search runs on the turbo successor engine only: call
``enable_turbo`` first. The LF streaming engine is not yet ported.
"""
from __future__ import annotations

import numpy as np
import torch

from sbwt_tpu.utils.dna import encode_query

from ..ops import search as engines
from ..ops.turbo import build_turbo, turbo_streaming_search
from ..utils.memory import device_free_bytes, select_turbo_arity
from .matrix import MatrixIndex, from_host_arrays, from_packed_rows, with_precalc

VARIANT_NAMES = [
    "plain-matrix",
    "rrr-matrix",
    "mef-matrix",
    "plain-split",
    "rrr-split",
    "mef-split",
    "plain-concat",
    "mef-concat",
    "plain-subsetwt",
    "rrr-subsetwt",
]
PORTED_VARIANTS = ("plain-matrix",)


def require_ported_variant(variant: str) -> None:
    if variant not in VARIANT_NAMES:
        raise ValueError(f"unknown variant: {variant}")
    if variant not in PORTED_VARIANTS:
        raise NotImplementedError(f"variant {variant} is not yet ported to sbwt_tpu_torch")


def _as_int8_tensor(codes, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)).to(device)


class SBWT:
    """Plain-matrix SBWT index with its tables on a torch device."""

    variant = "plain-matrix"

    def __init__(self, device_index: MatrixIndex, bits_packed: np.ndarray, n_cols: int,
                 sgs_packed: np.ndarray | None):
        """Wrap a built index. The host keeps the rows byte-packed
        (little bit order, [4, ceil(n/8)]) for serialization."""
        self.device_index = device_index
        self._n_cols = int(n_cols)
        self._bits_packed = np.asarray(bits_packed, dtype=np.uint8)
        if sgs_packed is None:
            self._n_sgs = 0
            self._sgs_packed = np.zeros(0, dtype=np.uint8)
        else:
            self._n_sgs = int(n_cols)
            self._sgs_packed = np.ascontiguousarray(sgs_packed, dtype=np.uint8)
        self._turbo = None

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_packed(cls, bits_packed: np.ndarray, n: int, sgs_packed: np.ndarray | None,
                    k: int, n_kmers: int, device, precalc_k: int = 0,
                    precalc_table: np.ndarray | None = None) -> "SBWT":
        """Index from byte-packed rows [4, ceil(n/8)] (little bit order),
        never expanding them to bools."""
        W = n // 32 + 1

        def to_words(packed_rows):
            buf = np.zeros((packed_rows.shape[0], W * 4), dtype=np.uint8)
            buf[:, : packed_rows.shape[1]] = packed_rows
            return buf.view("<u4").astype(np.uint32)

        row_words = to_words(np.asarray(bits_packed, dtype=np.uint8))
        sgs_words = (
            to_words(np.asarray(sgs_packed, dtype=np.uint8)[None, :])[0]
            if sgs_packed is not None else None
        )
        index = from_packed_rows(row_words, n, sgs_words, k, n_kmers, device,
                                 precalc_k, precalc_table)
        return cls(index, np.ascontiguousarray(bits_packed, dtype=np.uint8), n, sgs_packed)

    @classmethod
    def from_built(cls, built, device, precalc_k: int = 0) -> "SBWT":
        """Index from a host BuiltSBWT (sbwt_tpu/construct/inmemory.py)."""
        bits = np.asarray(built.bits, dtype=bool)
        sgs = np.asarray(built.suffix_group_starts, dtype=bool)
        index = from_host_arrays(bits, sgs, built.k, built.n_kmers, device, precalc_k)
        return cls(
            index,
            np.packbits(bits, axis=1, bitorder="little"),
            bits.shape[1],
            np.packbits(sgs, bitorder="little") if len(sgs) else None,
        )

    @classmethod
    def build(cls, seqs, k: int, device, streaming_support: bool = True,
              precalc_k: int = 0, min_abundance: int = 1, max_abundance: int | None = None,
              add_reverse_complements: bool = False, variant: str = "plain-matrix",
              method: str = "auto", ram_bytes: int = 2 << 30, n_threads: int = 4,
              temp_dir: str | None = None, input_bases: int | None = None) -> "SBWT":
        """Construct from sequences with the shared host builders, then
        upload to ``device`` and fill the precalc table there. method:
        'memory', 'external', or 'auto' (external when the k-mer spill would
        exceed half of ram_bytes). A generator of sequences needs
        ``input_bases`` for 'auto'."""
        require_ported_variant(variant)
        streamed = not hasattr(seqs, "__len__")
        if method == "auto":
            from sbwt_tpu.utils import kmers_wide

            if streamed and input_bases is None:
                raise ValueError("auto method needs input_bases when seqs is a generator")
            bases = input_bases if input_bases is not None else sum(len(s) for s in seqs)
            est = bases * 8 * kmers_wide.n_words(k) * (2 if add_reverse_complements else 1)
            method = "external" if est > ram_bytes // 2 else "memory"
        if method == "external":
            from sbwt_tpu.construct.external import build_sbwt_external

            built = build_sbwt_external(
                seqs, k, streaming_support=streaming_support, min_abundance=min_abundance,
                max_abundance=max_abundance, add_reverse_complements=add_reverse_complements,
                ram_bytes=ram_bytes, n_threads=n_threads, temp_dir=temp_dir,
            )
        else:
            from sbwt_tpu.construct.inmemory import build_sbwt

            built = build_sbwt(
                list(seqs) if streamed else seqs, k, streaming_support=streaming_support,
                min_abundance=min_abundance, max_abundance=max_abundance,
                add_reverse_complements=add_reverse_complements,
            )
        if hasattr(built, "bits_packed"):  # the streaming build emits packed rows
            return cls.from_packed(built.bits_packed, built.n_cols, built.sgs_packed,
                                   built.k, built.n_kmers, device, precalc_k)
        return cls.from_built(built, device, precalc_k)

    def to(self, device) -> "SBWT":
        """Move the index (and the turbo tables, if built) to ``device``."""
        self.device_index.to(device)
        if self._turbo is not None:
            self._turbo.to(device)
        return self

    # ---- metadata (SBWT.hh accessors) --------------------------------
    @property
    def device(self) -> torch.device:
        return self.device_index.device

    @property
    def k(self) -> int:
        return self.device_index.k

    def get_k(self) -> int:
        return self.k

    def number_of_subsets(self) -> int:
        return self.device_index.n_nodes

    def number_of_kmers(self) -> int:
        return self.device_index.n_kmers

    def get_precalc_k(self) -> int:
        return self.device_index.precalc_k

    @property
    def C(self) -> np.ndarray:
        return self.device_index.C.cpu().numpy().astype(np.int64)

    def get_C_array(self) -> np.ndarray:
        return self.C

    def has_streaming_query_support(self) -> bool:
        return self.device_index.has_streaming

    def get_precalc(self) -> np.ndarray:
        """Precalc intervals [4^p, 2] of (left, right); (-1, -1) when empty."""
        if self.get_precalc_k() == 0:
            return np.empty((0, 2), dtype=np.int64)
        return self.device_index.precalc.cpu().numpy().astype(np.int64)

    @property
    def bits(self) -> np.ndarray:
        """The four indicator rows as bools [4, n] (unpacked on demand)."""
        return np.unpackbits(self._bits_packed, axis=1, bitorder="little",
                             count=self._n_cols).astype(bool)

    @property
    def suffix_group_starts(self) -> np.ndarray:
        return np.unpackbits(self._sgs_packed, bitorder="little",
                             count=self._n_sgs).astype(bool)

    def get_streaming_support(self) -> np.ndarray:
        return self.suffix_group_starts

    def structure_size_in_bytes(self) -> int:
        return self.device_index.rank_tbl.numel() * 4

    # ---- queries ------------------------------------------------------
    def do_kmer_prefix_precalc(self, p: int) -> None:
        with_precalc(self.device_index, p)
        self._turbo = None  # built on the old precalc table

    def search_batch(self, codes: np.ndarray) -> np.ndarray:
        """Batched k-mer search; codes [B, k] from encode_query."""
        out = engines.search_batch(self.device_index, _as_int8_tensor(codes, self.device))
        return out.cpu().numpy()

    def search(self, kmer: str) -> int:
        """Single k-mer search (SBWT.hh:390-415); longer inputs use the first k chars."""
        codes = encode_query(kmer[: self.k])
        if len(codes) != self.k:
            raise ValueError(f"query shorter than k={self.k}")
        return int(self.search_batch(codes[None, :])[0])

    def enable_turbo(self, arity: int | None = None, free_bytes: int | None = None) -> int:
        """Build the successor turbo table on the index's device and use it
        for streaming search. arity=None picks the largest of 3, 2, 1 whose
        table fits half of the free device memory (free_bytes overrides the
        measurement). Returns the arity."""
        if self.device_index.precalc_k <= 0:
            # the reference's default prefix length (sbwt_build.cpp -p 8)
            self.do_kmer_prefix_precalc(min(self.k, 8))
        if arity is None:
            if free_bytes is None:
                free_bytes = device_free_bytes(self.device)
            arity = select_turbo_arity(self.number_of_subsets(), free_bytes,
                                       self.device_index.precalc_k)
            if arity is None:
                raise RuntimeError("turbo table does not fit; the LF engine is not yet ported")
        self._turbo = build_turbo(self.device_index, arity=arity)
        return arity

    def streaming_search_batch(self, codes: np.ndarray, lengths: np.ndarray | None = None
                               ) -> np.ndarray:
        """Batched streaming search; codes [B, L] padded with -1."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming search support not built")
        if self._turbo is None:
            raise RuntimeError(
                "streaming search needs the turbo engine (enable_turbo); "
                "the LF streaming engine is not yet ported"
            )
        B, L = codes.shape
        if lengths is None:
            lengths = np.full(B, L, dtype=np.int32)
        out = turbo_streaming_search(
            self._turbo, self.device_index, _as_int8_tensor(codes, self.device),
            torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(self.device),
        )
        return out.cpu().numpy()

    def streaming_search(self, text: str) -> list[int]:
        """All k-mer answers of one input string (SBWT.hh:545-581)."""
        if len(text) < self.k:
            return []
        return [int(x) for x in self.streaming_search_batch(encode_query(text)[None, :])[0]]
