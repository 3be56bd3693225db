"""The port's ranged device build (sbwt_tpu_torch/construct/device.py
``_build_ranged``) on the CPU, where its stages run their plain versions.

Held word for word, at many ranges, against the same build at one range
and the port's host build (construct/inmemory.py), narrow and forced onto
the wide tables; the wide index's streaming answers against the
benchmark's bucketed reference (portbench/reference/buckets.py) and the
string oracle (tests/oracle.py). Also the benchmark's reader of the build
record. Inputs come from
numpy and torch seeds; every output is an integer, so equality is exact.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_state  # noqa: F401  (one torch thread in each test worker)
from oracle import OracleIndex

from portbench import gen, spec
from portbench.reference import buckets
from sbwt_tpu_torch.construct import device as td
from sbwt_tpu_torch.construct.inmemory import build_sbwt
from sbwt_tpu_torch.models.matrix import from_host_arrays
from sbwt_tpu_torch.models.sbwt import SBWT
from sbwt_tpu_torch.models.wide import WideMatrixIndex, from_packed_rows_wide
from sbwt_tpu_torch.ops import bitvector as bv
from sbwt_tpu_torch.ops.search import streaming_search

PANGENOME = {
    "core_bases": 900, "strains": 4, "strain_substitution_rate": 0.02,
    "accessory_pool_blocks": 20, "accessory_block_bases": 30, "accessory_blocks_per_strain": 4,
    "accessory_hotspots": 2, "accessory_zipf_exponent": 1.0, "add_reverse_complements": True,
}
STRAINS = {"base_bases": 700, "strains": 3, "strain_substitution_rate": 0.01,
           "add_reverse_complements": True}
KINDS = ("strains_rc", "pangenome", "non_acgt", "short")


def _sequences(kind: str, k: int) -> list:
    """int8 code arrays of one kind: strains with their reverse
    complements; the pangenome shape with its reverse complements; text
    with N and other non-ACGT characters (codes -1); many short sequences
    (many sources and dummies)."""
    rng = np.random.default_rng(2000 + k)
    if kind == "strains_rc":
        return [s.numpy() for s in gen.genome(STRAINS, 11 + k, "cpu")[1]]
    if kind == "pangenome":
        return [s.numpy() for s in gen.genome(PANGENOME, 13 + k, "cpu")[1]]
    if kind == "non_acgt":
        return [rng.choice(np.array([-1, 0, 1, 2, 3], np.int8), p=[0.03] + [0.2425] * 4,
                           size=int(n)) for n in rng.integers(k, 500, 6)]
    return [rng.integers(0, 4, size=int(n)).astype(np.int8)
            for n in rng.integers(max(1, k - 2), k + 10, 150)]


def _text(codes) -> str:
    return "".join("ACGT"[c] if c >= 0 else "N" for c in codes)


def _host_build(seqs, k):
    text = [_text(s.tolist()) for s in seqs]
    return build_sbwt(text, k), text


def _build(seqs, k, monkeypatch, budget=None, wide=False, **kw):
    """build_sbwt_device with at most ``budget`` windows a range (None: the
    free memory's) and, with ``wide``, the 2^31-column predicate forced."""
    with monkeypatch.context() as m:
        if budget is not None:
            m.setattr(td, "range_budget", lambda device, k: budget)
        if wide:
            m.setattr(td, "needs_wide_index", lambda n: True)
        return td.build_sbwt_device(seqs, k, "cpu", **kw)


def _assert_same_tables(a, b):
    assert (a.n_nodes, a.n_kmers, a.n_words, a.k, a.precalc_k, a.has_streaming) == (
        b.n_nodes, b.n_kmers, b.n_words, b.k, b.precalc_k, b.has_streaming)
    for name in ("rank_tbl", "sgs_tbl", "C", "precalc"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("budget", [40, 300])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [3, 16, 31])
def test_ranged_build_equals_one_range_and_host_build(k, kind, budget, monkeypatch):
    seqs = _sequences(kind, k)
    p = min(k, 4)
    one = td.build_sbwt_device(seqs, k, "cpu", precalc_k=p)
    assert td.LAST_BUILD["key_ranges"] == 1
    ranged = _build(seqs, k, monkeypatch, budget, precalc_k=p)
    rec = dict(td.LAST_BUILD)
    built, _ = _host_build(seqs, k)
    host = from_host_arrays(built.bits, built.suffix_group_starts, k, built.n_kmers, "cpu", p)
    _assert_same_tables(one, host)
    _assert_same_tables(ranged, host)
    assert rec["key_ranges"] > 1 and rec["index"] == "MatrixIndex"
    assert rec["columns"] == sum(rec["range_columns"]) == host.n_nodes
    assert rec["bases_read"] == rec["bases"] * (rec["key_ranges"] + 1)
    # every range starts a suffix group; some start inside a 32-column word
    cuts = np.cumsum(rec["range_columns"])[:-1]
    cuts = cuts[cuts < host.n_nodes]
    marks = bv.word_u32(ranged.sgs_tbl[:, 0])
    assert all((int(marks[c >> 5]) >> (c & 31)) & 1 for c in cuts)
    if kind != "short" or k > 3:
        assert any(c % 32 for c in cuts)


@pytest.mark.parametrize("budget", [None, 25])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 2])
def test_build_at_the_fewest_bucket_bits_equals_host_build(k, kind, budget, monkeypatch):
    """k = 1 has no bucket bits (one range whatever the budget), k = 2 two."""
    seqs = _sequences(kind, k)
    got = _build(seqs, k, monkeypatch, budget, precalc_k=1)
    ranges = td.LAST_BUILD["key_ranges"]
    built, _ = _host_build(seqs, k)
    _assert_same_tables(got, from_host_arrays(built.bits, built.suffix_group_starts, k,
                                              built.n_kmers, "cpu", 1))
    assert ranges == (1 if k == 1 or budget is None else 4)  # a bucket a range


@pytest.mark.parametrize("k", [3, 16, 31])
def test_ranged_build_without_streaming_support(k, monkeypatch):
    seqs = _sequences("pangenome", k)
    ranged = _build(seqs, k, monkeypatch, 60, streaming_support=False)
    assert td.LAST_BUILD["key_ranges"] > 1
    _assert_same_tables(ranged, td.build_sbwt_device(seqs, k, "cpu", streaming_support=False))
    assert tuple(ranged.sgs_tbl.shape) == (1, 2)


def test_ranged_build_keeps_the_source_budget(monkeypatch):
    seqs = _sequences("short", 16)
    with pytest.raises(ValueError, match="source budget exceeded"):
        _build(seqs, 16, monkeypatch, 40, src_pad=3)


def test_survey_sources_equal_the_probe_sources():
    """The survey's sources (run-start windows whose (k-1)-prefix is no
    window's (k-1)-suffix) are the whole build's edge_src_probe sources."""
    for kind in KINDS:
        seqs = _sequences(kind, 16)
        codes = td.prepare_device_codes(seqs, 16, "cpu")
        dv = td.sorted_distinct_kmers(codes, 16)
        want = dv[td.edge_src_probe(dv, 16, dv)[2]]
        assert torch.equal(td.survey(codes, 16, td.range_bits(16), chunk=97)[2], want), kind


def _batches(seqs, k):
    text = torch.cat([torch.from_numpy(s) for s in seqs])[None, :].clamp(min=0)
    g = gen.generator(k, 9, "cpu")
    mix = {"batch_reads": 24, "read_length": [k - 1, 60], "pad_quantum": 8,
           "source_share": 0.8, "reverse_strand_share": 0.5, "substitution_rate": 0.02}
    return [(b.codes, b.lengths) for b in (gen.read_batch(mix, text, k, g) for _ in range(2))]


@pytest.mark.parametrize("budget", [None, 50])
@pytest.mark.parametrize("kind", ["strains_rc", "pangenome", "non_acgt"])
@pytest.mark.parametrize("k", [3, 16, 31])
def test_forced_wide_build_equals_host_wide_tables_and_references(k, kind, budget,
                                                                  monkeypatch):
    seqs = _sequences(kind, k)
    p = min(k, 4)
    wide = _build(seqs, k, monkeypatch, budget, wide=True, precalc_k=p)
    assert isinstance(wide, WideMatrixIndex) and td.LAST_BUILD["index"] == "WideMatrixIndex"
    built, text = _host_build(seqs, k)
    row_words = np.stack([bv.pack_bits_host(built.bits[c]) for c in range(4)])
    host = from_packed_rows_wide(row_words, built.bits.shape[1],
                                 bv.pack_bits_host(built.suffix_group_starts), k,
                                 built.n_kmers, "cpu", p)
    _assert_same_tables(wide, host)
    batches = _batches(seqs, k)
    want = buckets.streaming_answers([torch.from_numpy(s) for s in seqs], k, batches,
                                     max_keys=64).answers
    oracle = OracleIndex(text, k)
    for (codes, lengths), ref in zip(batches, want):
        got = streaming_search(wide, codes, lengths)
        assert got.dtype == torch.int64 and torch.equal(got, ref)
        assert (ref >= 0).any() and (ref < 0).any()
        for row in range(0, codes.shape[0], 5):
            n = int(lengths[row])
            want_row = oracle.streaming_search(_text(codes[row, :n].tolist()))
            assert got[row, : max(0, n - k + 1)].tolist() == want_row


def test_build_on_device_routes_to_the_wide_index(monkeypatch):
    """At 2^31 columns (the predicate forced) SBWT.build_on_device returns a
    WideMatrixIndex from the device tables, with the host rows of the
    narrow build and its answers at int64."""
    seqs = _sequences("pangenome", 31)
    monkeypatch.setattr(td, "range_budget", lambda device, k: 100)
    narrow = SBWT.build_on_device(seqs, 31, "cpu", precalc_k=4)
    assert td.LAST_BUILD["key_ranges"] > 1
    monkeypatch.setattr(td, "needs_wide_index", lambda n: True)
    wide = SBWT.build_on_device(seqs, 31, "cpu", precalc_k=4)
    assert isinstance(wide.device_index, WideMatrixIndex)
    np.testing.assert_array_equal(wide._bits_packed, narrow._bits_packed)
    np.testing.assert_array_equal(wide._sgs_packed, narrow._sgs_packed)
    codes = _batches(seqs, 31)[0][0][:8].numpy()
    np.testing.assert_array_equal(wide.streaming_search_batch(codes),
                                  narrow.streaming_search_batch(codes))


def test_plan_ranges_cuts_at_the_budget():
    hn = torch.tensor([5, 0, 7, 1, 9, 30, 2, 2])
    he = torch.tensor([1, 4, 0, 2, 0, 1, 3, 3])
    plan = td.plan_ranges(hn, he, 10)
    assert [(lo, hi) for lo, hi, _, _ in plan] == [(0, 2), (2, 4), (4, 5), (5, 6), (6, 8)]
    assert [(a, b) for _, _, a, b in plan] == [(5, 5), (8, 2), (9, 0), (30, 1), (4, 6)]
    assert td.plan_ranges(hn, he, 1 << 40) == [(0, 8, 56, 14)]


RECORD = {"key_ranges": 19, "range_columns": [1] * 19, "bases": 9_200_000_000,
          "bases_read": 184_000_000_000, "columns": 2_500_000_000, "kmers": 2_400_000_000,
          "sources": 546, "table_bytes": 4_300_000_000, "peak_bytes": 60_000_000_000,
          "index": "WideMatrixIndex"}


@pytest.mark.parametrize("name,want", [("build_ranges", 19)])
def test_build_readers_on_a_synthetic_record(monkeypatch, name, want):
    """The reader gives the record's count where the run timed a build, and
    None without a record or without a build span."""
    read = spec.reader(Path(__file__).resolve().parents[1], name)
    run = {"spans": {"build": 20.0}, "peaks": {"hbm_bytes_per_s": 3.35e12}}
    monkeypatch.setattr(td, "LAST_BUILD", dict(RECORD))
    assert read(run) == want
    assert read({"spans": {}, "peaks": run["peaks"]}) is None
    monkeypatch.setattr(td, "LAST_BUILD", {})
    assert read(run) is None
    monkeypatch.delattr(td, "LAST_BUILD")
    assert read(run) is None
