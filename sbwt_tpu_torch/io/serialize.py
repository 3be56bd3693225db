"""Index files of the port: all ten variants, in the reference's cpp
format and the native format, byte-equal to sbwt_tpu/io/serialize.py.

* **cpp** — byte-layout compatible with the reference `.sbwt` files
  (variant tag + SBWT v0.1 stream, src/CLI/sbwt_build.cpp:140-142 and
  include/sbwt/SBWT.hh:463-516): little-endian length-prefixed strings
  (globals.cpp:49-62), sdsl bit_vector framing (8-byte bit count +
  64-bit words), rank_support_v5 payloads (skipped and recomputed on
  load), raw int64 metadata.
* **native** — a numpy container holding the variant's own compressed
  structure payload (models/subsetrank.py).

The readers and writers are host code over numpy; loading builds the
port's SBWT on an explicit device, and saving copies the index's small
tensors (C, precalc) to the host first.
"""
from __future__ import annotations

import json
import struct
from contextlib import contextmanager

import numpy as np

from ..models.sbwt import SBWT, VARIANT_NAMES
from ..models.subsetrank import struct_from_payload
from . import sdsl

SBWT_VERSION = "v0.1"  # serialized version tag, matches SBWT.hh:28

NATIVE_MAGIC = b"SBWT-TPU-NATIVE-v1\x00"


class CppFormatError(ValueError):
    """Structured parse failure: names the structure and its file offset,
    so first contact with a real C++-written file is debuggable instead of
    a bare struct.unpack crash."""


@contextmanager
def _section(f, name: str):
    start = f.tell()
    try:
        yield
    except CppFormatError:
        raise
    except Exception as e:
        raise CppFormatError(
            f"cpp-format parse failed in {name} (structure starts at byte "
            f"offset {start}, error at byte {f.tell()}): "
            f"{type(e).__name__}: {e}"
        ) from e


# ---------------------------------------------------------------------------
# Low-level cpp-format primitives
# ---------------------------------------------------------------------------

def write_string(f, s: str) -> int:
    """serialize_string (globals.cpp:49-54): i64 length + ascii bytes."""
    data = s.encode("ascii")
    f.write(struct.pack("<q", len(data)))
    f.write(data)
    return 8 + len(data)


def read_string(f) -> str:
    (n,) = struct.unpack("<q", f.read(8))
    return f.read(n).decode("ascii")


def write_int64_vector(f, vals: np.ndarray) -> int:
    """serialize_std_vector framing (SBWT.hh:442-449): i64 byte count + data."""
    data = np.asarray(vals, dtype="<i8").tobytes()
    f.write(struct.pack("<q", len(data)))
    f.write(data)
    return 8 + len(data)


def read_int64_vector(f) -> np.ndarray:
    (n_bytes,) = struct.unpack("<q", f.read(8))
    return np.frombuffer(f.read(n_bytes), dtype="<i8").copy()


# ---------------------------------------------------------------------------
# cpp format: variant decompositions
#
# The reference CLI always builds the plain matrix first and re-encodes it
# into the requested variant (sbwt_build.cpp:127-195); the decompositions
# below replicate the corresponding Subset*Rank constructors so the byte
# streams we write carry exactly what the C++ constructors would produce
# from the same 4 bit vectors.
# ---------------------------------------------------------------------------

_CHAR_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _split_decompose(bits: np.ndarray):
    """SubsetSplitRank constructor (SubsetSplitRank.hh:90-141): X marks
    columns with != 1 outgoing edge; Y = the single labels as a string;
    Z = the 4 matrix rows restricted to X columns."""
    deg = bits.sum(axis=0)
    X = deg != 1
    uni = ~X
    y_char = np.zeros(int(uni.sum()), dtype=np.uint8)
    sub = bits[:, uni]
    for c in range(4):
        y_char[sub[c]] = _CHAR_BYTES[c]
    Z = bits[:, X]
    return X, y_char, Z


def _concat_decompose(bits: np.ndarray):
    """SubsetConcatRank constructor (SubsetConcatRank.hh:36-65): sets
    concatenated in ACGT order with '$' for empty sets; L has a 0 at each
    set start, 1s for the remaining members, and a trailing 0 sentinel."""
    n = bits.shape[1]
    sizes = bits.sum(axis=0)
    emit = np.maximum(sizes, 1)
    total = int(emit.sum())
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(emit, out=starts[1:])
    concat = np.full(total, ord("$"), dtype=np.uint8)  # empty sets keep '$'
    offs = starts[:-1].copy()
    for c in range(4):
        idx = np.flatnonzero(bits[c])
        concat[offs[idx]] = _CHAR_BYTES[c]
        offs[idx] += 1
    L = np.ones(total + 1, dtype=bool)
    starts = np.concatenate([[0], np.cumsum(emit)])
    L[starts] = False  # includes the end sentinel at position `total`
    return concat, L


def _sswt_decompose(bits: np.ndarray):
    """SubsetWT constructor (SubsetWT.hh:41-91): three strings over the
    2-bit pair alphabet {'0','1','2','3'} where char = 2*left + right."""
    AC = bits[0] | bits[1]
    GT = bits[2] | bits[3]

    def pair_string(left, right):
        return (np.uint8(ord("0")) + 2 * left.astype(np.uint8) + right.astype(np.uint8))

    acgt = pair_string(AC, GT)
    ac = pair_string(bits[0][AC], bits[1][AC])
    gt = pair_string(bits[2][GT], bits[3][GT])
    return acgt, ac, gt


def _split_recompose(X, y_char, Z):
    n = len(X)
    bits = np.zeros((4, n), dtype=bool)
    uni_cols = np.flatnonzero(~X)
    for c in range(4):
        bits[c, uni_cols[y_char == _CHAR_BYTES[c]]] = True
        bits[c, np.flatnonzero(X)] = Z[c]
    return bits


def _concat_recompose(concat: np.ndarray, L: np.ndarray):
    # L: 0 at each set start (+ sentinel); member i of the stream belongs
    # to the set counted by zeros before it.
    set_id = np.cumsum(~L[: len(concat)]) - 1
    n = int((~L).sum()) - 1  # minus the end sentinel
    bits = np.zeros((4, n), dtype=bool)
    for c in range(4):
        cols = set_id[concat == _CHAR_BYTES[c]]
        bits[c, cols] = True
    return bits


def _sswt_recompose(acgt, ac, gt):
    n = len(acgt)
    root = acgt - np.uint8(ord("0"))
    AC = (root >> 1).astype(bool)
    GT = (root & 1).astype(bool)
    bits = np.zeros((4, n), dtype=bool)
    sub_ac = ac - np.uint8(ord("0"))
    sub_gt = gt - np.uint8(ord("0"))
    ac_cols = np.flatnonzero(AC)
    gt_cols = np.flatnonzero(GT)
    bits[0, ac_cols] = (sub_ac >> 1).astype(bool)
    bits[1, ac_cols] = (sub_ac & 1).astype(bool)
    bits[2, gt_cols] = (sub_gt >> 1).astype(bool)
    bits[3, gt_cols] = (sub_gt & 1).astype(bool)
    return bits


# ---------------------------------------------------------------------------
# cpp format: subset-rank structure writers/readers per variant
# ---------------------------------------------------------------------------

def _write_struct_cpp(f, variant: str, bits: np.ndarray) -> int:
    w = 0
    if variant == "plain-matrix":
        # SubsetMatrixRank<bit_vector, rank_support_v5> (SubsetMatrixRank.hh:86-100)
        for c in range(4):
            w += sdsl.write_bit_vector(f, bits[c])
        for c in range(4):
            w += sdsl.write_rank_support_v5(f, bits[c])
    elif variant == "rrr-matrix":
        # SubsetMatrixRank<rrr_vector<63>, ...>; rrr rank supports carry no payload
        for c in range(4):
            w += sdsl.write_rrr(f, bits[c])
    elif variant == "mef-matrix":
        encs = [sdsl.mef_encode(bits[c]) for c in range(4)]
        for c in range(4):
            enc = encs[c]
            f.write(struct.pack("<Q", enc["m"]))
            f.write(struct.pack("<B", enc["wl"]))
            w += 9
            w += sdsl.write_bit_vector(f, enc["upper"])
            w += sdsl.write_bit_vector(f, enc["lower"])
            w += sdsl.write_rank_support_v(f, enc["upper"])
            w += sdsl.write_rank_support_v(f, enc["lower"])
        for c in range(4):
            w += sdsl.write_mef_rank_support(f, encs[c]["wl"])
    elif variant in ("plain-split", "rrr-split", "mef-split"):
        X, y_char, Z = _split_decompose(bits)
        if variant == "plain-split":
            w += sdsl.write_bit_vector(f, X)
        elif variant == "rrr-split":
            w += sdsl.write_rrr(f, X)
        else:
            x_enc = sdsl.mef_encode(X)
            x_wl = x_enc["wl"]
            f.write(struct.pack("<Q", x_enc["m"]))
            f.write(struct.pack("<B", x_wl))
            w += 9
            w += sdsl.write_bit_vector(f, x_enc["upper"])
            w += sdsl.write_bit_vector(f, x_enc["lower"])
            w += sdsl.write_rank_support_v(f, x_enc["upper"])
            w += sdsl.write_rank_support_v(f, x_enc["lower"])
        w += sdsl.write_wt_blcd(f, y_char, compressed=False)
        for c in range(4):
            w += sdsl.write_bit_vector(f, Z[c])
        # rank supports: X first, then the 4 Z rows (SubsetSplitRank.hh:46-50)
        if variant == "plain-split":
            w += sdsl.write_rank_support_v5(f, X)
        elif variant == "mef-split":
            w += sdsl.write_mef_rank_support(f, x_wl)
        # rrr-split: X's rrr rank support carries no payload
        for c in range(4):
            w += sdsl.write_rank_support_v5(f, Z[c])
    elif variant in ("plain-concat", "mef-concat"):
        concat, L = _concat_decompose(bits)
        # serialize order: concat WT, L, L_ss0 (SubsetConcatRank.hh:67-73)
        if variant == "plain-concat":
            w += sdsl.write_wt_blcd(f, concat, compressed=False)
            w += sdsl.write_bit_vector(f, L)
            w += sdsl.write_select_mcl(f, L, 0)
        else:
            w += sdsl.write_wt_blcd(f, concat, compressed=True)
            w += sdsl.write_sd(f, L)
            # sd_vector<>::select_0_type carries no payload
    elif variant in ("plain-subsetwt", "rrr-subsetwt"):
        acgt, ac, gt = _sswt_decompose(bits)
        compressed = variant == "rrr-subsetwt"
        for s in (acgt, ac, gt):
            w += sdsl.write_wt_blcd(f, s, compressed=compressed)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return w


def _read_struct_cpp(f, variant: str) -> np.ndarray:
    """Parse a cpp-format subset-rank structure back to the 4 bit rows.

    Every sub-structure parses inside a named _section so a malformed or
    truncated file reports WHAT failed and WHERE, not a struct.unpack
    traceback."""
    chars = "ACGT"
    if variant == "plain-matrix":
        rows = []
        for c in range(4):
            with _section(f, f"sdsl::bit_vector {chars[c]}_bits"):
                rows.append(sdsl.read_bit_vector(f))
        for c in range(4):
            with _section(f, f"rank_support_v5 {chars[c]}_bits_rs (skipped)"):
                sdsl.skip_int_vector64(f)  # payloads recomputed on load
        return np.stack(rows)
    if variant == "rrr-matrix":
        rows = []
        for c in range(4):
            with _section(f, f"rrr_vector<63> {chars[c]}_bits"):
                rows.append(sdsl.read_rrr(f))
        return np.stack(rows)
    if variant == "mef-matrix":
        rows = []
        for c in range(4):
            with _section(f, f"mod_ef_vector {chars[c]}_bits"):
                rows.append(sdsl.read_mef(f))
        for c in range(4):
            with _section(f, f"rank_support_mod_ef {chars[c]}_bits_rs"):
                sdsl.read_mef_rank_support(f)
        return np.stack(rows)
    if variant in ("plain-split", "rrr-split", "mef-split"):
        xtype = {"plain-split": "bit_vector", "rrr-split": "rrr_vector<63>",
                 "mef-split": "mod_ef_vector"}[variant]
        with _section(f, f"{xtype} X (non-degree-1 marks)"):
            if variant == "plain-split":
                X = sdsl.read_bit_vector(f)
            elif variant == "rrr-split":
                X = sdsl.read_rrr(f)
            else:
                X = sdsl.read_mef(f)
        with _section(f, "wt_blcd Y (degree-1 labels)"):
            y_char = sdsl.wt_decode(sdsl.read_wt_fields(f, compressed=False))
        Zrows = []
        for c in range(4):
            with _section(f, f"bit_vector Z_{chars[c]}"):
                Zrows.append(sdsl.read_bit_vector(f))
        Z = np.stack(Zrows)
        with _section(f, "X rank support"):
            if variant == "plain-split":
                sdsl.skip_int_vector64(f)
            elif variant == "mef-split":
                sdsl.read_mef_rank_support(f)
        for c in range(4):
            with _section(f, f"rank_support_v5 Z_{chars[c]}_rs (skipped)"):
                sdsl.skip_int_vector64(f)
        return _split_recompose(X, y_char, Z)
    if variant in ("plain-concat", "mef-concat"):
        if variant == "plain-concat":
            with _section(f, "wt_blcd concat"):
                concat = sdsl.wt_decode(sdsl.read_wt_fields(f, compressed=False))
            with _section(f, "bit_vector L (set boundaries)"):
                L = sdsl.read_bit_vector(f)
            with _section(f, "select_support_mcl L_ss0"):
                sdsl.read_select_mcl(f)
        else:
            with _section(f, "wt_blcd<rrr_vector<63>> concat"):
                concat = sdsl.wt_decode(sdsl.read_wt_fields(f, compressed=True))
            with _section(f, "sd_vector L (set boundaries)"):
                L = sdsl.read_sd(f)
        return _concat_recompose(concat, L)
    if variant in ("plain-subsetwt", "rrr-subsetwt"):
        compressed = variant == "rrr-subsetwt"
        wts = []
        for name in ("root (AC,GT)", "left (A,C)", "right (G,T)"):
            with _section(f, f"SubsetWT {name} wavelet tree"):
                wts.append(sdsl.wt_decode(sdsl.read_wt_fields(f, compressed=compressed)))
        return _sswt_recompose(*wts)
    raise ValueError(f"unknown variant {variant!r}")


# ---------------------------------------------------------------------------
# cpp format: full index files
# ---------------------------------------------------------------------------

def save_cpp(path: str, sbwt) -> int:
    """Write a reference-compatible `.sbwt` file for any of the 10 variants.

    Stream layout = CLI variant tag (sbwt_build.cpp:140-142) followed by
    SBWT::serialize (SBWT.hh:463-491): version string, the subset-rank
    structure, suffix_group_starts, C, the precalc pair vector, and the
    four raw int64 scalars.
    """
    di = sbwt.device_index
    with open(path, "wb") as f:
        written = write_string(f, sbwt.variant)
        written += write_string(f, SBWT_VERSION)
        if sbwt.variant == "plain-matrix":
            # chunked path: stream the packed host rows directly; never
            # materialize the bool matrix (17 GB transient at the wide
            # engine's 4.3e9-column scale)
            n = sbwt._n_cols
            for c in range(4):
                written += sdsl.write_bit_vector_packed(f, sbwt._bits_packed[c], n)
            for c in range(4):
                written += sdsl.write_int_vector64(
                    f, sdsl.rank_v5_payload_packed(sbwt._bits_packed[c], n)
                )
        else:
            written += _write_struct_cpp(f, sbwt.variant, sbwt.bits)
        if sbwt._n_sgs:
            written += sdsl.write_bit_vector_packed(f, sbwt._sgs_packed, sbwt._n_sgs)
        else:
            written += sdsl.write_bit_vector(f, np.zeros(0, dtype=bool))
        written += write_int64_vector(f, sbwt.C)
        if di.precalc_k == 0:
            pairs = np.empty((0, 2), dtype=np.int64)
        else:
            pairs = sbwt.get_precalc()
        written += write_int64_vector(f, pairs.ravel())
        f.write(struct.pack("<q", di.precalc_k))
        f.write(struct.pack("<q", di.n_nodes))
        f.write(struct.pack("<q", di.n_kmers))
        f.write(struct.pack("<q", di.k))
        written += 32
    return written


# ---------------------------------------------------------------------------
# native format: MAGIC, json header (meta + ordered payload keys), then one
# np.save per payload array. For plain-matrix the payload is the packed bit
# matrix; for every other variant it is the variant's own compressed
# structure payload (models/subsetrank.py).
# ---------------------------------------------------------------------------


def _variant_payload(sbwt) -> dict:
    if sbwt.variant == "plain-matrix":
        # the host copy is already byte-packed; no bool expansion
        return {"bits_packed": sbwt._bits_packed}
    return sbwt.device_index.struct.payload()


def save_native(path: str, sbwt) -> int:
    di = sbwt.device_index
    payload = _variant_payload(sbwt)
    payload["sgs_packed"] = sbwt._sgs_packed
    # the engine's dtype (int32, or int64 on the wide tier)
    payload["precalc"] = di.precalc.cpu().numpy()
    meta = {
        "variant": sbwt.variant,
        "k": di.k,
        "n_nodes": di.n_nodes,
        "n_kmers": di.n_kmers,
        "precalc_k": di.precalc_k,
        "has_streaming": di.has_streaming,
        "payload_keys": list(payload.keys()),
    }
    with open(path, "wb") as f:
        f.write(NATIVE_MAGIC)
        header = json.dumps(meta).encode()
        f.write(struct.pack("<q", len(header)))
        f.write(header)
        for key in payload:
            np.save(f, np.asarray(payload[key]))
        return f.tell()


def save(path: str, sbwt: SBWT, fmt: str = "cpp") -> int:
    """Write a cpp (reference-compatible) or native file; returns bytes written."""
    if fmt == "cpp":
        return save_cpp(path, sbwt)
    if fmt == "native":
        return save_native(path, sbwt)
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
    # stored int64 on disk and handed on as int64: the narrow engine narrows
    # it to int32, the wide one (n >= 2^31, routed to by from_packed) keeps it
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
