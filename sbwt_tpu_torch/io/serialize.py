"""Index files of the port: all ten variants, in the reference's cpp
format and the native format of sbwt_tpu/io/serialize.py.

Loading parses with the shared readers (sbwt_tpu/io/serialize.py and
sdsl.py, which import no JAX) and builds the port's SBWT on an explicit
device. Saving hands the shared writers ``save_cpp`` / ``save_native`` a
host view of numpy arrays, since they read the index through
``np.asarray``, which a CUDA tensor does not support. A compressed
variant's native payload is its structure's ``payload()``, byte-equal to
the JAX package's.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from sbwt_tpu.io import sdsl
from sbwt_tpu.io.serialize import (
    NATIVE_MAGIC,
    SBWT_VERSION,
    CppFormatError,
    _read_struct_cpp,
    _section,
    read_int64_vector,
    read_string,
    save_cpp,
    save_native,
)

from ..models.sbwt import SBWT, VARIANT_NAMES
from ..models.subsetrank import struct_from_payload


@dataclass(frozen=True)
class HostIndex:
    """The fields of an index that the shared writers read, on the host."""

    C: np.ndarray
    precalc: np.ndarray
    precalc_k: int
    n_nodes: int
    n_kmers: int
    k: int
    has_streaming: bool
    struct: object  # a compressed variant's structure (its payload()), or None


@dataclass(frozen=True)
class HostSBWT:
    """What save_cpp / save_native read of an SBWT object."""

    variant: str
    device_index: HostIndex
    _n_cols: int
    _bits_packed: np.ndarray
    _n_sgs: int
    _sgs_packed: np.ndarray

    @property
    def bits(self) -> np.ndarray:
        return np.unpackbits(self._bits_packed, axis=1, bitorder="little",
                             count=self._n_cols).astype(bool)


def host_view(sbwt: SBWT) -> HostSBWT:
    di = sbwt.device_index
    return HostSBWT(
        variant=sbwt.variant,
        device_index=HostIndex(
            C=di.C.cpu().numpy(), precalc=di.precalc.cpu().numpy(),
            precalc_k=di.precalc_k, n_nodes=di.n_nodes, n_kmers=di.n_kmers, k=di.k,
            has_streaming=di.has_streaming, struct=getattr(di, "struct", None),
        ),
        _n_cols=sbwt._n_cols,
        _bits_packed=sbwt._bits_packed,
        _n_sgs=sbwt._n_sgs,
        _sgs_packed=sbwt._sgs_packed,
    )


def save(path: str, sbwt: SBWT, fmt: str = "cpp") -> int:
    """Write a cpp (reference-compatible) or native file; returns bytes written."""
    if fmt == "cpp":
        return save_cpp(path, host_view(sbwt))
    if fmt == "native":
        return save_native(path, host_view(sbwt))
    raise ValueError(f"unknown format {fmt!r}")


def _check_C(C: np.ndarray, sbwt: SBWT) -> None:
    if not np.array_equal(C, sbwt.C):
        raise CppFormatError(
            f"corrupt index: stored C array {C.tolist()} does not match the "
            f"C array recomputed from the decoded rows {sbwt.C.tolist()}"
        )


def load_cpp_stream(f, device) -> SBWT:
    """Load a reference-format index stream of any of the ten variants
    (the dispatch of src/CLI/sbwt_search.cpp:204-253). A compressed
    structure is decoded to bit rows and re-encoded as the port's
    structure of the same variant."""
    with _section(f, "variant tag string"):
        variant = read_string(f)
    if variant not in VARIANT_NAMES:
        raise CppFormatError(f"unrecognized variant tag {variant!r}")
    with _section(f, "SBWT version string"):
        version = read_string(f)
    if version != SBWT_VERSION:
        raise CppFormatError(
            "corrupt index file, or the index was constructed with an "
            "incompatible version of SBWT "
            f"(found version tag {version!r}, want {SBWT_VERSION!r})"
        )
    if variant == "plain-matrix":
        # keep the rows byte-packed end to end (no bool matrix)
        rows = []
        for c in range(4):
            with _section(f, f"sdsl::bit_vector {'ACGT'[c]}_bits"):
                packed_row, n_bits = sdsl.read_bit_vector_packed(f)
            rows.append(packed_row)
        for c in range(4):
            with _section(f, f"rank_support_v5 {'ACGT'[c]}_bits_rs (skipped)"):
                sdsl.skip_int_vector64(f)  # payloads recomputed
        with _section(f, "bit_vector suffix_group_starts"):
            sgs_packed, sgs_bits = sdsl.read_bit_vector_packed(f)
    else:
        bits = _read_struct_cpp(f, variant)
        n_bits = bits.shape[1]
        with _section(f, "bit_vector suffix_group_starts"):
            sgs = sdsl.read_bit_vector(f)
    with _section(f, "C array (int64 vector)"):
        C = read_int64_vector(f)
    with _section(f, "k-mer prefix precalc pair vector"):
        pairs = read_int64_vector(f)
    with _section(f, "trailing scalars (precalc_k, n_nodes, n_kmers, k)"):
        precalc_k, n_nodes, n_kmers, k = struct.unpack("<4q", f.read(32))
    if n_bits != n_nodes:
        raise CppFormatError(
            f"bit rows have {n_bits} columns but the trailing n_nodes scalar says {n_nodes}"
        )
    # stored int64 on disk; the narrow engine holds int32
    precalc_table = pairs.reshape(-1, 2) if precalc_k > 0 else None
    if variant == "plain-matrix":
        sbwt = SBWT.from_packed(
            np.stack(rows), int(n_nodes), sgs_packed if sgs_bits else None, k=int(k),
            n_kmers=int(n_kmers), device=device, precalc_k=int(precalc_k),
            precalc_table=precalc_table,
        )
    else:
        sbwt = SBWT.from_bits(bits, sgs if len(sgs) else None, int(k), int(n_kmers), device,
                              int(precalc_k), variant, precalc_table)
    _check_C(C, sbwt)
    return sbwt


def load_native(f, device) -> SBWT:
    """Load a native-format index of any of the ten variants."""
    if f.read(len(NATIVE_MAGIC)) != NATIVE_MAGIC:
        raise ValueError("not a native SBWT-TPU index file")
    (hlen,) = struct.unpack("<q", f.read(8))
    meta = json.loads(f.read(hlen))
    variant = meta["variant"]
    if variant not in VARIANT_NAMES:
        raise ValueError(f"unknown variant: {variant}")
    payload = {key: np.load(f) for key in meta["payload_keys"]}
    n = meta["n_nodes"]
    precalc_table = payload["precalc"] if meta["precalc_k"] > 0 else None
    if variant == "plain-matrix":
        return SBWT.from_packed(
            payload["bits_packed"], n, payload["sgs_packed"] if meta["has_streaming"] else None,
            k=meta["k"], n_kmers=meta["n_kmers"], device=device, precalc_k=meta["precalc_k"],
            precalc_table=precalc_table,
        )
    st = struct_from_payload(variant, payload, device)
    sgs = (np.unpackbits(payload["sgs_packed"], bitorder="little")[:n].astype(bool)
           if meta["has_streaming"] else None)
    return SBWT.from_bits(st.to_bits(), sgs, meta["k"], meta["n_kmers"], device,
                          meta["precalc_k"], variant, precalc_table, struct=st)


def load(path: str, device) -> SBWT:
    """Load a cpp or native index file of any variant onto ``device``."""
    with open(path, "rb") as f:
        head = f.read(len(NATIVE_MAGIC))
        f.seek(0)
        if head == NATIVE_MAGIC:
            return load_native(f, device)
        return load_cpp_stream(f, device)
