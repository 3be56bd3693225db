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

from work_oracle import counts_from_answers, work_oracle, work_reads

K, P = 12, 5


@pytest.fixture(scope="module")
def plain_sbwt():
    rng = np.random.default_rng(2020)
    g = "".join(rng.choice(list("ACGT"), size=3000)) + "ACGT" * 40
    return g, SBWT.build([g], K, "cpu", precalc_k=P)


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_work_oracle_restarts_follow_from_the_answers(plain_sbwt, variant):
    """On every narrow rank type, the oracle's walk answers as K14's and
    K4's plain versions do, and its positions, restarts and restart hits
    are those the answers imply; K14's and K4's agree, and only K4 reads
    table rows."""
    g, sb = plain_sbwt
    di = sb.to_variant(variant).device_index
    rng = np.random.default_rng(len(variant))
    codes, lengths = work_reads(g, rng, 160, 40, K)
    want = ts.streaming_search_plain(di, codes, lengths).long()
    derived = counts_from_answers(want, codes, lengths, K)
    assert derived[1] > derived[2] > 0  # restarts that hit and restarts that miss
    ans, lf = work_oracle(di, codes, lengths)
    assert torch.equal(ans, want)
    assert (lf["positions"], lf["restarts"], lf["restart_hits"]) == derived
    assert lf["lf_steps"] >= lf["restarts"] - lf["restart_hits"] and lf["table_rows"] == 0
    turbo = tt.build_turbo(di, 3)
    ans, t4 = work_oracle(di, codes, lengths, turbo)
    assert torch.equal(ans, tt.turbo_streaming_search_plain(turbo, di, codes, lengths).long())
    assert torch.equal(ans, want)
    assert (t4["positions"], t4["restarts"], t4["restart_hits"]) == derived
    assert t4["lf_steps"] < lf["lf_steps"] and t4["table_rows"] > 0


# a de Bruijn sequence of order 2: each of the 16 two-char strings once, so
# every live 2-char seed is one column, and a search from it walks the table
DEBRUIJN2 = "AACAGATCCGCTGGTTA"


@pytest.mark.parametrize("arity,rows", [(1, 3 + 12 + 5), (2, 2 + 6 + 5), (3, 1 + 4 + 5)])
def test_work_oracle_hand_worked_counts(arity, rows):
    """k = 5, p = 2 over DEBRUIJN2. The sequence itself: one restart that
    hits (3 LF steps for K14; ceil(3 / arity) table rows for K4) and 12
    extensions (ceil(12 / arity) rows). AAAAAAAAA: 5 restarts, each seed
    live and its first step empty (one LF step or one row each). NNNNNNN:
    3 positions, no restart. A read shorter than k: none."""
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
                  "table_rows": 0}
    assert (ans[0, :13] >= 0).all() and (ans[1:] < 0).all()
    turbo = tt.build_turbo(di, arity)
    ans4, t4 = work_oracle(di, codes, lengths, turbo)
    assert torch.equal(ans4, ans)
    assert t4 == {"positions": 21, "restarts": 6, "restart_hits": 1, "lf_steps": 0,
                  "table_rows": rows}


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
                                     "table_rows")


def test_count_work_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        with kernels.count_work("cpu"):
            pass
