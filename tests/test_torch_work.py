"""K14's and K4's work counters and the engine's spans, on the CPU.

The work oracle (tests/work_oracle.py) walks each read as the kernels do;
here it is held to what the engines' plain versions answer and to a
hand-worked index. On a card, tests/test_torch_cuda.py holds the counting
instances to the same oracle.
"""
import ctypes

import numpy as np
import pytest
import torch

from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu_torch.ops import search as ts
from sbwt_tpu_torch.ops import turbo as tt
from sbwt_tpu_torch.utils import profiling
from sbwt_tpu_torch.utils.dna import encode_query

from work_oracle import counts_from_answers, string_answers, work_oracle, work_reads

K, P = 12, 5


@pytest.fixture(scope="module")
def plain_sbwt():
    rng = np.random.default_rng(2020)
    g = "".join(rng.choice(list("ACGT"), size=3000)) + "ACGT" * 40
    return g, SBWT.build([g], K, "cpu", precalc_k=P)


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_work_oracle_restarts_follow_from_the_answers(plain_sbwt, variant):
    """On every narrow rank type, the oracle's walk answers as K14's and
    K4's plain versions do. K4's positions, restarts and restart hits are
    those the answers imply, and only K4 reads table rows. K14 probes: each
    position that K4 restarts at is searched, answered by a probe's hit or
    skipped, so K14's restarts and skipped positions together cover K4's
    restarts, with fewer searches."""
    g, sb = plain_sbwt
    di = sb.to_variant(variant).device_index
    rng = np.random.default_rng(len(variant))
    codes, lengths = work_reads(g, rng, 160, 40, K)
    want = ts.streaming_search_plain(di, codes, lengths).long()
    derived = counts_from_answers(want, codes, lengths, K)
    assert derived[1] > derived[2] > 0  # restarts that hit and restarts that miss
    ans, lf = work_oracle(di, codes, lengths)
    assert torch.equal(ans, want)
    assert lf["positions"] == derived[0] and lf["table_rows"] == 0
    assert lf["restarts"] + lf["skipped"] >= derived[1] > lf["restarts"]
    assert lf["restart_hits"] >= derived[2] and lf["skipped"] > 0
    assert lf["lf_steps"] >= lf["restarts"] - lf["restart_hits"]
    turbo = tt.build_turbo(di, 3)
    ans, t4 = work_oracle(di, codes, lengths, turbo)
    assert torch.equal(ans, tt.turbo_streaming_search_plain(turbo, di, codes, lengths).long())
    assert torch.equal(ans, want)
    assert (t4["positions"], t4["restarts"], t4["restart_hits"]) == derived
    assert t4["table_rows"] > 0 and t4["skipped"] == 0


@pytest.fixture(scope="module")
def probe_genome():
    rng = np.random.default_rng(2121)
    return "".join(rng.choice(list("ACGT"), size=2500)) + "ACGT" * 30


@pytest.fixture(scope="module")
def probe_cases(probe_genome):
    """Per k: the reads (work_reads: both strands, errors, N, lowercase,
    lengths below L and below k) and their answers by tests/oracle.py."""
    from oracle import OracleIndex

    cases = {}
    for k in (5, 30, 31):
        codes, lengths = work_reads(probe_genome, np.random.default_rng(k), 48, k + 28, k)
        cases[k] = codes, lengths, string_answers(OracleIndex([probe_genome], k), codes, lengths)
    return cases


@pytest.fixture(scope="module")
def probe_sbwt(probe_genome):
    built = {}

    def get(k, p):
        if (k, p) not in built:
            built[k, p] = SBWT.build([probe_genome], k, "cpu", precalc_k=p)
        return built[k, p]
    return get


@pytest.mark.parametrize("variant", VARIANT_NAMES)
@pytest.mark.parametrize("k,p", [(5, 0), (5, 2), (30, 0), (30, 2), (30, 8), (31, 0), (31, 2),
                                 (31, 8)])
def test_k14_probe_walk_equals_plain_and_string_oracle(probe_sbwt, probe_cases, variant, k, p):
    """K14's walk with its probes answers as the plain streaming search and
    tests/oracle.py do, on every narrow rank type. At k = 5 the first die
    offset (ceil(log4 n) + 1, at most k - 1) leaves no room ahead, so every
    restart is serial and nothing is skipped; at k = 30 and 31 the probes
    skip most of the windows that K4 searches."""
    codes, lengths, want = probe_cases[k]
    di = probe_sbwt(k, p).to_variant(variant).device_index
    ans, lf = work_oracle(di, codes, lengths)
    assert torch.equal(ans, ts.streaming_search_plain(di, codes, lengths).long())
    assert torch.equal(ans, want)
    derived = counts_from_answers(want, codes, lengths, k)
    assert lf["positions"] == derived[0] and lf["restart_hits"] >= derived[2]
    if k == 5:
        assert lf["skipped"] == 0 and lf["restarts"] == derived[1]
    else:
        assert lf["skipped"] > 0 and lf["restarts"] < derived[1] <= lf["restarts"] + lf["skipped"]


# a de Bruijn sequence of order 2: each of the 16 two-char strings once, so
# every live 2-char seed is one column, and a search from it walks the table
DEBRUIJN2 = "AACAGATCCGCTGGTTA"


@pytest.mark.parametrize("arity,rows", [(1, 3 + 12 + 5), (2, 2 + 6 + 5), (3, 1 + 4 + 5)])
def test_work_oracle_hand_worked_counts(arity, rows):
    """k = 5, p = 2 over DEBRUIJN2. The sequence itself: one restart that
    hits (3 LF steps for K14; ceil(3 / arity) table rows for K4) and 12
    extensions (ceil(12 / arity) rows). AAAAAAAAA: 5 restarts, each seed
    live and its first step empty (one LF step or one row each). NNNNNNN:
    3 positions, no restart. A read shorter than k: none. K14 probes no
    window ahead: the index has 18 columns, so its first die offset is
    ceil(log4 18) + 1 = 4 = k - 1 and every probe is at pos itself, a
    restart as K4's; nothing is skipped."""
    sb = SBWT.build([DEBRUIJN2], 5, "cpu", precalc_k=2)
    di = sb.device_index
    reads = [DEBRUIJN2, "AAAAAAAAA", "NNNNNNN", "ACG"]
    L = len(DEBRUIJN2)
    codes = torch.full((len(reads), L), -1, dtype=torch.int8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = torch.from_numpy(encode_query(r))
    lengths = torch.tensor([len(r) for r in reads], dtype=torch.int32)
    ans, lf = work_oracle(di, codes, lengths)
    assert lf == {"positions": 13 + 5 + 3, "restarts": 6, "restart_hits": 1, "lf_steps": 3 + 5,
                  "table_rows": 0, "skipped": 0}
    assert (ans[0, :13] >= 0).all() and (ans[1:] < 0).all()
    turbo = tt.build_turbo(di, arity)
    ans4, t4 = work_oracle(di, codes, lengths, turbo)
    assert torch.equal(ans4, ans)
    assert t4 == {"positions": 21, "restarts": 6, "restart_hits": 1, "lf_steps": 0,
                  "table_rows": rows, "skipped": 0}


def test_k14_probe_hand_worked_counts():
    """k = 12, p = 2 over DEBRUIJN2: 6 k-mers and 12 dummies (the prefixes
    of AACAGATCCGCT), 18 columns, so the first die offset is 4 and a lane in
    restart mode probes q = pos + 11 - 4 = pos + 7, at most its tile's last
    position. A^20, 9 positions: at 0 the probe at 7 seeds AA (the dummy
    AA's column) and empties at its first LF step, char 2: every window
    from 7 + 2 - 11 < 0 to 7 holds AAA and is -1, so 0-7 are skipped (8);
    die is now 2, and at 8 the probe would be at min(8, 8 + 9) = 8, a
    restart as before: 2 searches, 2 LF steps. DEBRUIJN2, 6 positions (all
    hits): the probe at min(5, 7) = 5 hits (10 LF steps) and keeps its
    column; 0 restarts (10 steps), 1-4 extend, 5 takes the kept column:
    2 searches, 2 hits, 20 LF steps, where K4 searches once."""
    sb = SBWT.build([DEBRUIJN2], 12, "cpu", precalc_k=2)
    di = sb.device_index
    reads = ["A" * 20, DEBRUIJN2]
    codes = torch.full((2, 20), -1, dtype=torch.int8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = torch.from_numpy(encode_query(r))
    lengths = torch.tensor([len(r) for r in reads], dtype=torch.int32)
    ans, lf = work_oracle(di, codes, lengths)
    assert torch.equal(ans, ts.streaming_search_plain(di, codes, lengths).long())
    assert lf == {"positions": 9 + 6, "restarts": 2 + 2, "restart_hits": 2, "lf_steps": 2 + 20,
                  "table_rows": 0, "skipped": 8}
    assert (ans[0] < 0).all() and (ans[1, :6] >= 0).all()
    ans4, t4 = work_oracle(di, codes, lengths, tt.build_turbo(di, 1))
    assert torch.equal(ans4, ans)
    assert (t4["restarts"], t4["restart_hits"], t4["skipped"]) == (9 + 1, 1, 0)


def test_annotate_builds_no_span_without_a_profiler(monkeypatch):
    """With no profiler recording, annotate returns one shared no-op
    context and never builds a record_function."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = profiling.annotate("sbwt.engine"), profiling.annotate("sbwt.engine.desc")
    assert first is second
    with first, second:
        pass


@pytest.mark.parametrize("engine", ["lf", "turbo"])
def test_cpu_profile_shows_the_engine_span(plain_sbwt, engine):
    """A profiled CPU call of either streaming engine holds one
    sbwt.engine range; the kernel spans (desc, launch) open on a card
    only."""
    from torch.profiler import ProfilerActivity, profile

    g, sb = plain_sbwt
    di = sb.device_index
    codes, lengths = work_reads(g, np.random.default_rng(7), 8, 30, K)
    turbo = tt.build_turbo(di, 1) if engine == "turbo" else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if turbo is None:
            ts.streaming_search(di, codes, lengths)
        else:
            tt.turbo_streaming_search(turbo, di, codes, lengths)
    names = [e.name for e in prof.events()]
    assert names.count("sbwt.engine") == 1
    assert "sbwt.engine.desc" not in names and "sbwt.engine.launch" not in names


def test_counting_pointer_rides_in_out_r(monkeypatch):
    """K14's and K4's launches carry the counters in LFArgs.out_r, which
    they do not otherwise read: null outside count_work, the counters'
    pointer inside it, refused for the row-sharded type and for a launch
    on another device. LFArgs keeps its layout (csrc/lf_stream.cuh)."""
    assert kernels.LFArgs._fields_[-1] == ("row_major", ctypes.c_int)
    cpu = torch.device("cpu")
    assert kernels._work_ptr("rrr-split", cpu) == 0
    counts = torch.zeros(len(kernels.WORK_COUNTERS), dtype=torch.int64)
    monkeypatch.setattr(kernels, "_work", counts)
    assert kernels._work_ptr("rrr-split", cpu) == counts.data_ptr()
    with pytest.raises(ValueError, match="counts its work"):
        kernels._work_ptr(kernels.SHARDED, cpu)
    with pytest.raises(ValueError, match="count_work on cpu"):
        kernels._work_ptr("plain-matrix", torch.device("cuda", 0))
    assert kernels.WORK_COUNTERS == ("positions", "restarts", "restart_hits", "lf_steps",
                                     "table_rows", "skipped")


def test_count_work_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        with kernels.count_work("cpu"):
            pass
