"""High-level SBWT API of the port: the index object of all ten variants.

The surface of sbwt_tpu/models/sbwt.py in PyTorch. ``build`` constructs on
the host (the port's own construct/inmemory.py and external.py) and
uploads; ``build_on_device`` constructs on the device (construct/device.py).
The index tables live on an explicit ``device``. ``variant`` picks the
subset-rank structure: plain-matrix keeps the fused-row ``MatrixIndex``
(a ``WideMatrixIndex`` with int64 positions from 2^31 columns on),
the nine compressed variants a ``GenericIndex`` over their own structure.
On a CUDA device every query runs a hand-written kernel; on the CPU the
plain PyTorch versions run. The ``search_batch`` /
``streaming_search_batch`` / ``has_streaming_query_support`` / ``k``
surface is the one the query runner (io/query_runner.py) drives.

Streaming search runs the turbo successor engine once ``enable_turbo``
has built its table from the index's own ranks (any variant, and the wide
tier at arity 1), and the LF engine otherwise.

The k-mer access tooling (``compute_dummy_node_marks``,
``reconstruct_all_kmers``, ``get_kmer*``, ``select_support`` and the
ascii export) is that of the JAX package: host numpy over the rows, but
for the dummy marks' BFS, whose levels run on the index's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops import search as engines
from ..ops.turbo import TurboUnavailable, build_turbo, succ1, turbo_streaming_search
from ..utils.dna import CODE_TO_CHAR, encode_query
from ..utils.memory import device_free_bytes, select_turbo_arity
from .matrix import from_host_arrays, from_packed_rows, with_precalc
from .select import MatrixSelectSupport
from .variants import build_generic_index

# the reference's ten variants, in the order the LF kernels number them
VARIANT_NAMES = list(kernels.VARIANTS)


def require_known_variant(variant: str) -> None:
    if variant not in VARIANT_NAMES:
        raise ValueError(f"unknown variant: {variant}")


def _as_int8_tensor(codes, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)).to(device)


class SBWT:
    """SBWT index of any variant with its tables on a torch device."""

    def __init__(self, device_index, bits_packed: np.ndarray, n_cols: int,
                 sgs_packed: np.ndarray | None, variant: str = "plain-matrix"):
        """Wrap a built index (a MatrixIndex or WideMatrixIndex, or a
        GenericIndex of ``variant``). The host keeps the rows byte-packed
        (little bit order, [4, ceil(n/8)]) for serialization and
        re-encoding."""
        require_known_variant(variant)
        self.device_index = device_index
        self.variant = variant
        self._n_cols = int(n_cols)
        self._bits_packed = np.asarray(bits_packed, dtype=np.uint8)
        if sgs_packed is None:
            self._n_sgs = 0
            self._sgs_packed = np.zeros(0, dtype=np.uint8)
        else:
            self._n_sgs = int(n_cols)
            self._sgs_packed = np.ascontiguousarray(sgs_packed, dtype=np.uint8)
        self._turbo = None
        self._select_support = None

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_packed(cls, bits_packed: np.ndarray, n: int, sgs_packed: np.ndarray | None,
                    k: int, n_kmers: int, device, precalc_k: int = 0,
                    precalc_table: np.ndarray | None = None) -> "SBWT":
        """Index from byte-packed rows [4, ceil(n/8)] (little bit order),
        never expanding them to bools. With 2^31 columns or more the index
        is a WideMatrixIndex (int64 positions)."""
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
    def from_device_index(cls, device_index, bits: np.ndarray,
                          suffix_group_starts: np.ndarray | None) -> "SBWT":
        """Wrap an already-built index (a payload loaded, say) with the bool
        rows [4, n] and suffix-group starts (None or empty without streaming
        support) it was built from; the host keeps them packed."""
        bits = np.asarray(bits, dtype=bool)
        sgs = None
        if suffix_group_starts is not None and len(suffix_group_starts):
            sgs = np.packbits(np.asarray(suffix_group_starts, dtype=bool), bitorder="little")
        variant = getattr(device_index, "variant", "plain-matrix")
        return cls(device_index, np.packbits(bits, axis=1, bitorder="little"), bits.shape[1], sgs,
                   variant if variant in VARIANT_NAMES else "plain-matrix")

    @classmethod
    def from_built(cls, built, device, precalc_k: int = 0,
                   variant: str = "plain-matrix") -> "SBWT":
        """Index from a host BuiltSBWT (construct/inmemory.py). A
        compressed variant fills its precalc table over its own ranks."""
        bits = np.asarray(built.bits, dtype=bool)
        sgs = np.asarray(built.suffix_group_starts, dtype=bool)
        return cls.from_bits(bits, sgs if len(sgs) else None, built.k, built.n_kmers, device,
                             precalc_k, variant)

    @classmethod
    def from_bits(cls, bits: np.ndarray, sgs: np.ndarray | None, k: int, n_kmers: int, device,
                  precalc_k: int = 0, variant: str = "plain-matrix",
                  precalc_table=None, struct=None) -> "SBWT":
        """Index of ``variant`` from the bool rows [4, n] and the suffix-group
        starts (None without streaming support); ``precalc_table`` (a tensor
        or an array) is carried over instead of filled, and ``struct`` is a
        compressed variant's structure when it was loaded already."""
        require_known_variant(variant)
        if variant == "plain-matrix":
            if precalc_table is not None:
                precalc_table = torch.as_tensor(precalc_table).cpu().numpy()
            index = from_host_arrays(bits, sgs, k, n_kmers, device, precalc_k, precalc_table)
        else:
            index = build_generic_index(variant, bits, sgs, k, n_kmers, device, precalc_k,
                                        precalc_table, struct)
        return cls(
            index,
            np.packbits(bits, axis=1, bitorder="little"),
            bits.shape[1],
            np.packbits(sgs, bitorder="little") if sgs is not None else None,
            variant,
        )

    @classmethod
    def build(cls, seqs, k: int, device, streaming_support: bool = True,
              precalc_k: int = 0, min_abundance: int = 1, max_abundance: int | None = None,
              add_reverse_complements: bool = False, variant: str = "plain-matrix",
              method: str = "auto", ram_bytes: int = 2 << 30, n_threads: int = 4,
              temp_dir: str | None = None, input_bases: int | None = None) -> "SBWT":
        """Construct from sequences on the host (construct/), then
        upload to ``device`` and fill the precalc table there. method:
        'memory', 'external', or 'auto' (external when the k-mer spill would
        exceed half of ram_bytes). A generator of sequences needs
        ``input_bases`` for 'auto'."""
        require_known_variant(variant)
        streamed = not hasattr(seqs, "__len__")
        if method == "auto":
            from ..utils import kmers_wide

            if streamed and input_bases is None:
                raise ValueError("auto method needs input_bases when seqs is a generator")
            bases = input_bases if input_bases is not None else sum(len(s) for s in seqs)
            est = bases * 8 * kmers_wide.n_words(k) * (2 if add_reverse_complements else 1)
            method = "external" if est > ram_bytes // 2 else "memory"
        if method == "external":
            from ..construct.external import build_sbwt_external

            built = build_sbwt_external(
                seqs, k, streaming_support=streaming_support, min_abundance=min_abundance,
                max_abundance=max_abundance, add_reverse_complements=add_reverse_complements,
                ram_bytes=ram_bytes, n_threads=n_threads, temp_dir=temp_dir,
            )
        else:
            from ..construct.inmemory import build_sbwt

            built = build_sbwt(
                list(seqs) if streamed else seqs, k, streaming_support=streaming_support,
                min_abundance=min_abundance, max_abundance=max_abundance,
                add_reverse_complements=add_reverse_complements,
            )
        if hasattr(built, "bits_packed"):  # the streaming build emits packed rows
            plain = cls.from_packed(built.bits_packed, built.n_cols, built.sgs_packed,
                                    built.k, built.n_kmers, device, precalc_k)
            return plain if variant == "plain-matrix" else plain.to_variant(variant)
        return cls.from_built(built, device, precalc_k, variant)

    @classmethod
    def build_on_device(cls, seqs, k: int, device, streaming_support: bool = True,
                        precalc_k: int = 0, src_pad: int | None = None) -> "SBWT":
        """Construct on ``device``: the whole pipeline (window packing, colex
        sort, dedup, out-edge probes, dummy emission, rank-table packing)
        runs there (construct/device.py), any k <= 255, with the build
        kernels on a CUDA device and their plain versions on the CPU.
        Raises ValueError when the input has more sources than an explicit
        ``src_pad``; calling ``build`` instead is then the caller's choice.

        The host packed rows (serialization, variant re-encoding) are
        recovered from the device tables in one download of n / 2 bytes."""
        from ..construct.device import build_sbwt_device

        di = build_sbwt_device(seqs, k, device, streaming_support=streaming_support,
                               precalc_k=precalc_k, src_pad=src_pad)
        n = di.n_nodes
        nb = (n + 7) // 8

        def packed(words):  # int32 word column -> little-endian bytes
            return words.contiguous().cpu().numpy().view(np.uint8)

        rows = packed(di.rank_tbl[:, 0]).reshape(4, di.n_words * 4)
        sgs = packed(di.sgs_tbl[:, 0])[:nb] if di.has_streaming else None
        return cls(di, np.ascontiguousarray(rows[:, :nb]), n, sgs)

    def to_variant(self, variant: str) -> "SBWT":
        """Re-encode into another variant on the same device, carrying k,
        n_kmers and the precalc table over (the build-variant path,
        src/CLI/sbwt_build_from_plain_matrix.cpp)."""
        di = self.device_index
        return SBWT.from_bits(
            self.bits, self.suffix_group_starts if self.has_streaming_query_support() else None,
            self.k, self.number_of_kmers(), self.device, di.precalc_k, variant,
            precalc_table=di.precalc if di.precalc_k > 0 else None,
        )

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

    def get_subset_rank_structure(self):
        """The index on the device: its subset-rank structure (SBWT.hh:111)."""
        return self.device_index

    def structure_size_in_bytes(self) -> int:
        """Bytes of the subset-rank structure (RRR's shared pattern LUT not
        counted), as the JAX package reports them."""
        return self.device_index.size_in_bytes()

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

    def enable_turbo(self, arity: int | None = None, free_bytes: int | None = None) -> int | None:
        """Build the successor turbo table on the index's device and use it
        for streaming search. arity=None picks the largest of 3, 2, 1 whose
        table fits half of the free device memory (free_bytes overrides the
        measurement) and returns None, leaving the LF engine in use, when
        none fits. Returns the arity. The table is built from the index's
        own ranks, whatever the variant; a wide index has the arity-1 tier
        only (32 B a column), whatever arity is asked.

        Raises TurboUnavailable when the index cannot have a table (no
        streaming support, or an arity past int32 row indexing)."""
        if not self.has_streaming_query_support():
            raise TurboUnavailable("turbo engine requires streaming support (suffix group marks)")
        if self.device_index.precalc_k <= 0:
            # the reference's default prefix length (sbwt_build.cpp -p 8)
            self.do_kmer_prefix_precalc(min(self.k, 8))
        if arity is None:
            if free_bytes is None:
                free_bytes = device_free_bytes(self.device)
            arity = select_turbo_arity(self.number_of_subsets(), free_bytes,
                                       self.device_index.precalc_k,
                                       wide=self.device_index.pos_dtype == torch.int64)
            if arity is None:
                self._turbo = None
                return None
        self._turbo = build_turbo(self.device_index, arity=arity)
        return self._turbo.arity

    def streaming_search_batch(self, codes: np.ndarray, lengths: np.ndarray | None = None
                               ) -> np.ndarray:
        """Batched streaming search; codes [B, L] padded with -1. Runs the
        turbo engine when its table is built, else the LF engine."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming search support not built")
        B, L = codes.shape
        if lengths is None:
            lengths = np.full(B, L, dtype=np.int32)
        codes_t = _as_int8_tensor(codes, self.device)
        lengths_t = torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(self.device)
        if self._turbo is None:
            out = engines.streaming_search(self.device_index, codes_t, lengths_t)
        else:
            out = turbo_streaming_search(self._turbo, self.device_index, codes_t, lengths_t)
        return out.cpu().numpy()

    def streaming_search(self, text: str) -> list[int]:
        """All k-mer answers of one input string (SBWT.hh:545-581)."""
        if len(text) < self.k:
            return []
        return [int(x) for x in self.streaming_search_batch(encode_query(text)[None, :])[0]]

    def partial_search_batch(self, codes: np.ndarray, lengths: np.ndarray | None = None):
        """Batched partial search; codes [B, L] padded with -1. Returns
        (l, r, matched length) arrays: the interval of each row's longest
        matching prefix."""
        lengths_t = None if lengths is None else torch.from_numpy(
            np.asarray(lengths, dtype=np.int32)).to(self.device)
        out = engines.partial_search_batch(self.device_index,
                                           _as_int8_tensor(codes, self.device), lengths_t)
        return tuple(t.cpu().numpy() for t in out)

    def partial_search(self, text: str) -> tuple[tuple[int, int], int]:
        """Longest matching prefix interval (SBWT.hh:526-537)."""
        l, r, mlen = self.partial_search_batch(encode_query(text)[None, :])
        return (int(l[0]), int(r[0])), int(mlen[0])

    def update_sbwt_interval(self, s: str, interval: tuple[int, int]) -> tuple[int, int]:
        """Run LF iterations from a given interval (SBWT.hh:423-437);
        (-1, -1) when a char is not uppercase ACGT or the interval empties."""
        if interval[0] == -1:
            return interval
        codes = encode_query(s)
        codes = np.where((codes >= 0) & (codes < 4), codes, -1)[None, :]
        l, r, mlen = engines.partial_search_batch(
            self.device_index, _as_int8_tensor(codes, self.device),
            start=torch.tensor([interval], dtype=self.device_index.pos_dtype))
        if int(mlen[0]) != len(s):
            return (-1, -1)
        return (int(l[0]), int(r[0]))

    def forward_batch(self, nodes: np.ndarray, chars: np.ndarray) -> np.ndarray:
        """The successor of each node by its char code (0..3), or -1."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming support required for forward")
        di = self.device_index
        nodes_t = torch.as_tensor(np.asarray(nodes)).to(device=self.device, dtype=di.pos_dtype)
        chars_t = torch.as_tensor(np.asarray(chars)).to(device=self.device, dtype=torch.int64)
        return engines.forward_batch(di, nodes_t, chars_t).cpu().numpy()

    def forward(self, node: int, c: str) -> int:
        """Follow a labeled edge in the de Bruijn graph (SBWT.hh:369-381)."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming support required for forward")
        code = int(encode_query(c)[0])
        if code < 0 or code >= 4:
            return -1
        return int(self.forward_batch(np.array([node]), np.array([code]))[0])

    # ---- host-side tooling -------------------------------------------
    # Host numpy over the unpacked rows ``self.bits`` and ``self.C``, as in
    # the JAX package: 4 bytes of host memory a column at least (16 MB at 4M
    # columns, 17 GB on an index of 4.29 billion), so not for the largest
    # wide indexes. compute_dummy_node_marks alone runs on the device.

    def compute_dummy_node_marks(self) -> np.ndarray:
        """Mark the nodes that are not full k-mers (SBWT.hh:589-614) by a
        level-synchronous BFS over the dummy tree from the root. Each level
        takes all four successors of the whole frontier at once: one launch
        of K2's succ1 on a CUDA index, its plain version on the CPU. The
        frontier stays on the device, in the index's position type. Needs
        streaming support, as forward does."""
        if not self.has_streaming_query_support():
            raise RuntimeError("streaming support required for compute_dummy_node_marks")
        marks = np.zeros(self.number_of_subsets(), dtype=bool)
        di = self.device_index
        frontier = torch.zeros(1, dtype=di.pos_dtype, device=self.device)
        for depth in range(self.k):
            marks[frontier.cpu().numpy()] = True
            if depth == self.k - 1:
                break
            nxt = succ1(di, frontier, row_major=True)  # [F, 4]
            frontier = nxt[nxt >= 0]
            if len(frontier) == 0:
                break
        return marks

    def _incoming_labels(self) -> np.ndarray:
        """last[i] = label of the incoming edge of column i (-1 for '$')."""
        n = self.number_of_subsets()
        counts = self.bits.sum(axis=1, dtype=np.int64)
        C = self.C
        last = np.full(n, -1, dtype=np.int8)
        for c in range(4):
            last[C[c] : C[c] + counts[c]] = c
        return last

    def reconstruct_all_kmers(self) -> str:
        """All node labels in colex order, '$'-padded, concatenated
        (SBWT.hh:648-698), as k rounds of vectorized label propagation."""
        n = self.number_of_subsets()
        k = self.k
        bits = self.bits  # unpack once
        C = self.C
        out = np.full((n, k), ord("$"), dtype=np.uint8)
        last = self._incoming_labels()
        for rnd in range(k):
            out[:, k - 1 - rnd] = np.where(last >= 0, CODE_TO_CHAR[np.clip(last, 0, 3)], ord("$"))
            propagated = np.full(n, -1, dtype=np.int8)
            for c in range(4):
                src = np.flatnonzero(bits[c])
                propagated[C[c] : C[c] + len(src)] = last[src]
            last = propagated
        return out.tobytes().decode("ascii")

    def get_kmer(self, colex_rank: int) -> str:
        """Label of one column, via backward steps (SBWT.hh:701-725)."""
        return self.get_kmer_fast(colex_rank, self.select_support())

    def select_support(self):
        """The select support over the rows (SubsetMatrixSelectSupport),
        built once."""
        if self._select_support is None:
            self._select_support = MatrixSelectSupport(self.bits)
        return self._select_support

    def get_kmer_fast(self, colex_rank: int, ss) -> str:
        """Label via select support (SBWT.hh:729-746)."""
        C = self.C
        buf = [""] * self.k
        for i in range(self.k):
            if colex_rank == 0:
                buf[self.k - 1 - i] = "$"
            else:
                char_idx = int(np.searchsorted(C, colex_rank, side="right") - 1)
                buf[self.k - 1 - i] = "ACGT"[char_idx]
                colex_rank = ss.select(colex_rank - int(C[char_idx]) + 1, char_idx)  # 1-based
        return "".join(buf)

    def get_kmers_batch(self, colex_ranks) -> list[str]:
        """Labels of many columns at once: k rounds of batched searchsorted
        and select over the whole column set (get_kmer_fast vectorized)."""
        ss = self.select_support()
        C = self.C
        cur = np.asarray(colex_ranks, dtype=np.int64).copy()
        out = np.full((len(cur), self.k), ord("$"), dtype=np.uint8)
        for i in range(self.k):
            nz = np.flatnonzero(cur > 0)
            if len(nz) == 0:
                break
            ci = np.searchsorted(C, cur[nz], side="right") - 1
            out[nz, self.k - 1 - i] = CODE_TO_CHAR[ci]
            rel = cur[nz] - C[ci] + 1  # 1-based rank within the char's block
            nxt = np.empty(len(nz), dtype=np.int64)
            for c in range(4):
                m = ci == c
                if m.any():
                    nxt[m] = ss.positions[c][rel[m] - 1]
            cur = np.zeros_like(cur)
            cur[nz] = nxt
        return [bytes(row).decode("ascii") for row in out]

    def ascii_export_metadata(self) -> str:
        """Metadata block of ``sbwt ascii-export`` (SBWT.hh:777-784)."""
        from ..io.serialize import SBWT_VERSION

        return (
            f"version: {SBWT_VERSION}\n"
            f"k: {self.k}\n"
            f"number_of_sets: {self.number_of_subsets()}\n"
            f"number_of_kmers: {self.number_of_kmers()}\n"
        )

    def ascii_export_sets(self) -> str:
        """The sets concatenated, each set's chars in ACGT order with the
        last lowercased, '$' for an empty set (SBWT.hh:750-773)."""
        bits = self.bits  # unpack once
        sizes = bits.sum(axis=0)
        # the row of each set's last char, -1 for an empty set
        last_row = np.where(sizes > 0, np.argmax(np.cumsum(bits, axis=0) == sizes[None, :], axis=0), -1)
        rows = np.where(bits, CODE_TO_CHAR[:, None], 0).astype(np.uint8)  # [4, n]
        rows[(last_row[None, :] == np.arange(4)[:, None]) & bits] += 32  # to lowercase
        dollar = np.where(sizes == 0, ord("$"), 0).astype(np.uint8)
        flat = np.concatenate([rows.T, dollar[:, None]], axis=1).ravel()  # column-major
        return flat[flat != 0].tobytes().decode("ascii") + "\n"
