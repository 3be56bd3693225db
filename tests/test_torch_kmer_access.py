"""Port parity: the facade's k-mer access tooling and the host modules it
uses, against the JAX package and tests/oracle.py, on the CPU.

One corpus of several sequences (so the dummy tree branches), built once
by the JAX package; the port builds its own index of the same corpus,
whose rows must equal JAX's, and re-encodes it into every variant.
``compute_dummy_node_marks`` runs on each of the ten variants (succ1's
plain version over the variant's own ranks here; one succ1 launch a BFS
level on a CUDA index) and on a wide (int64) index; the host tooling
(``reconstruct_all_kmers``, ``get_kmer``, ``get_kmer_fast``,
``get_kmers_batch``, ``ascii_export_*``) must give JAX's strings on every
variant that JAX lets export (the seven non-mef ones) and the oracle's
labels. ``MatrixSelectSupport`` and the suffix-group functions are the
port's copies of numpy modules: they must give JAX's arrays on the cases
of tests/test_suffix_groups.py. The port's twin of examples/api_example.py
must print the same lines.
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oracle import OracleIndex, get_kmers
from sbwt_tpu.models.sbwt import SBWT as JaxSBWT
from sbwt_tpu.models.select import MatrixSelectSupport as JaxSelect
from sbwt_tpu.ops import suffix_groups as jsg
from sbwt_tpu_torch import kernels
from sbwt_tpu_torch.models import wide as tw
from sbwt_tpu_torch.models.sbwt import SBWT, VARIANT_NAMES
from sbwt_tpu_torch.models.select import MatrixSelectSupport
from sbwt_tpu_torch.ops import suffix_groups as psg
from sbwt_tpu_torch.utils.dna import encode_query
from test_suffix_groups import _oracle_push_left, _oracle_spread, _random_case
import torch_state  # noqa: F401  (one torch thread per test worker)

K = 7
EXPORTABLE = [v for v in VARIANT_NAMES if not v.startswith("mef-")]


class Corpus:
    def __init__(self):
        rng = np.random.default_rng(17)
        self.seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in (400, 260, 90, 31)]
        self.seqs.append(self.seqs[0][100:180] + "T")  # shares k-mers, adds a source
        # short reads: a source each, so the dummy tree branches widely
        self.seqs += ["".join(rng.choice(list("ACGT"), size=int(n)))
                      for n in rng.integers(K, K + 5, size=25)]
        self.js = JaxSBWT.build(self.seqs, K, precalc_k=3)
        self.plain = SBWT.build(self.seqs, K, "cpu", precalc_k=3)
        self.oracle = OracleIndex(self.seqs, K)
        self._variants = {}
        self._jax = {}

    def port(self, variant):
        if variant not in self._variants:
            self._variants[variant] = (self.plain if variant == "plain-matrix"
                                       else self.plain.to_variant(variant))
        return self._variants[variant]

    def jax(self, variant):
        """The JAX index of the variant (host tooling only: nothing compiles)."""
        if variant not in self._jax:
            self._jax[variant] = (self.js if variant == "plain-matrix"
                                  else self.js.to_variant(variant))
        return self._jax[variant]


@pytest.fixture(scope="module")
def corpus():
    return Corpus()


@pytest.fixture(scope="module")
def jax_marks(corpus):
    return corpus.js.compute_dummy_node_marks()


def test_port_index_has_the_jax_rows(corpus):
    np.testing.assert_array_equal(corpus.plain.bits, corpus.js.bits)
    np.testing.assert_array_equal(corpus.plain.suffix_group_starts, corpus.js.suffix_group_starts)
    np.testing.assert_array_equal(corpus.plain.C, corpus.js.C)
    # the dummy tree branches: several sources, many dummies
    assert corpus.plain.number_of_subsets() - corpus.plain.number_of_kmers() > 10 * K


@pytest.mark.parametrize("variant", VARIANT_NAMES)
def test_dummy_node_marks_match_jax_and_oracle(corpus, jax_marks, variant):
    sb = corpus.port(variant)
    before = dict(kernels.LAUNCHES)
    marks = sb.compute_dummy_node_marks()
    assert kernels.LAUNCHES == before
    assert marks.dtype == bool
    np.testing.assert_array_equal(marks, jax_marks)
    np.testing.assert_array_equal(marks, [len(x) < K for x in corpus.oracle.nodes])
    assert int(marks.sum()) == sb.number_of_subsets() - sb.number_of_kmers()


def test_dummy_node_marks_on_a_wide_index(corpus, jax_marks):
    """The BFS frontier in int64 positions, over the wide rank type."""
    di = corpus.plain.device_index
    words = di.rank_tbl[:, 0].numpy().view(np.uint32).reshape(4, di.n_words)
    sgs = di.sgs_tbl[:, 0].numpy().view(np.uint32)
    wide = tw.from_packed_rows_wide(words, di.n_nodes, sgs, K, di.n_kmers, "cpu", precalc_k=3)
    sb = SBWT(wide, corpus.plain._bits_packed, di.n_nodes, corpus.plain._sgs_packed)
    assert sb.device_index.pos_dtype == torch.int64
    np.testing.assert_array_equal(sb.compute_dummy_node_marks(), jax_marks)


def test_dummy_node_marks_need_streaming_support(corpus):
    sb = SBWT.build(corpus.seqs, K, "cpu", streaming_support=False)
    with pytest.raises(RuntimeError, match="streaming support required"):
        sb.compute_dummy_node_marks()


@pytest.mark.parametrize("variant", EXPORTABLE)
def test_reconstruct_all_kmers_matches_jax_and_oracle(corpus, variant):
    got = corpus.port(variant).reconstruct_all_kmers()
    assert got == corpus.jax(variant).reconstruct_all_kmers()
    want = "".join("$" * (K - len(x)) + x for x in corpus.oracle.nodes)
    assert got == want


@pytest.mark.parametrize("variant", EXPORTABLE)
def test_ascii_export_matches_jax(corpus, variant):
    sb, js = corpus.port(variant), corpus.jax(variant)
    assert sb.ascii_export_metadata() == js.ascii_export_metadata()
    assert sb.ascii_export_sets() == js.ascii_export_sets()


def test_ascii_export_matches_oracle(corpus):
    orc = corpus.oracle
    expect = []
    for i in range(len(orc.nodes)):
        members = [c for c in "ACGT" if orc.bits[c][i]]
        expect.append("".join(members[:-1]) + members[-1].lower() if members else "$")
    assert corpus.plain.ascii_export_sets() == "".join(expect) + "\n"
    meta = corpus.plain.ascii_export_metadata()
    assert meta.startswith(f"version: v0.1\nk: {K}\nnumber_of_sets: {len(orc.nodes)}\n")
    assert meta.endswith(f"number_of_kmers: {orc.n_kmers}\n")


@pytest.mark.parametrize("variant", ["plain-matrix", "rrr-split", "mef-concat", "rrr-subsetwt"])
def test_get_kmer_and_get_kmer_fast_match_jax_and_oracle(corpus, variant):
    sb, js = corpus.port(variant), corpus.jax(variant)
    ss, jss = sb.select_support(), js.select_support()
    assert sb.select_support() is ss
    for i, node in enumerate(corpus.oracle.nodes):
        want = "$" * (K - len(node)) + node
        assert sb.get_kmer(i) == want == js.get_kmer(i)
        assert sb.get_kmer_fast(i, ss) == want == js.get_kmer_fast(i, jss)


def test_get_kmers_batch_matches_jax_and_scalar(corpus):
    sb, js = corpus.plain, corpus.js
    n = sb.number_of_subsets()
    cols = np.random.default_rng(3).integers(0, n, size=3 * n)
    got = sb.get_kmers_batch(cols)
    assert got == js.get_kmers_batch(cols)
    ss = sb.select_support()
    assert got[:200] == [sb.get_kmer_fast(int(c), ss) for c in cols[:200]]
    assert sb.get_kmers_batch([]) == []


def test_kmer_round_trip_through_search(corpus):
    """get_kmer of every full k-mer's column searches back to that column,
    and the k-mers are exactly the indexed ones."""
    sb = corpus.plain
    marks = sb.compute_dummy_node_marks()
    cols = np.flatnonzero(~marks)
    kmers = sb.get_kmers_batch(cols)
    assert set(kmers) == get_kmers(corpus.seqs, K)
    ans = sb.search_batch(np.stack([encode_query(s) for s in kmers]))
    np.testing.assert_array_equal(ans, cols)


def test_from_device_index_and_the_rank_structure(corpus):
    js = corpus.js
    for sgs in (js.suffix_group_starts, None):
        sb = SBWT.from_device_index(corpus.plain.device_index, js.bits, sgs)
        assert sb.get_subset_rank_structure() is corpus.plain.device_index
        assert sb.variant == "plain-matrix" and sb.device == corpus.plain.device
        np.testing.assert_array_equal(sb.bits, js.bits)
        assert sb._bits_packed.tobytes() == corpus.plain._bits_packed.tobytes()
        if sgs is None:
            assert len(sb.suffix_group_starts) == 0
        else:
            np.testing.assert_array_equal(sb.suffix_group_starts, sgs)
    rrr = corpus.port("rrr-split")
    sb = SBWT.from_device_index(rrr.device_index, js.bits, js.suffix_group_starts)
    assert sb.variant == "rrr-split"
    assert sb.reconstruct_all_kmers() == js.reconstruct_all_kmers()


# ---------------------------------------------------------------------------
# the host copies: models/select.py and ops/suffix_groups.py
# ---------------------------------------------------------------------------


def test_select_support_matches_jax(corpus):
    bits = corpus.js.bits
    got, want = MatrixSelectSupport(bits), JaxSelect(bits)
    for c in range(4):
        np.testing.assert_array_equal(got.positions[c], want.positions[c])
        ranks = np.arange(1, len(want.positions[c]) + 1)
        np.testing.assert_array_equal(got.select_batch(ranks, c), want.select_batch(ranks, c))
        assert got.select(len(ranks), c) == want.select(len(ranks), c)


@pytest.mark.parametrize("n", [1, 2, 17, 500])
def test_push_and_spread_match_jax_and_oracle(n):
    rng = np.random.default_rng(n)
    for _ in range(10):
        bits, marks = _random_case(rng, n)
        pushed = psg.push_bits_left(bits, marks)
        np.testing.assert_array_equal(pushed, jsg.push_bits_left(bits, marks))
        np.testing.assert_array_equal(pushed, _oracle_push_left(bits, marks))
        spread = psg.spread_bits_after_push_left(pushed, marks)
        np.testing.assert_array_equal(spread, jsg.spread_bits_after_push_left(pushed, marks))
        np.testing.assert_array_equal(spread, _oracle_spread(pushed, marks))


def test_mark_suffix_groups_recovers_construction_marks(corpus):
    for sb in (corpus.plain, SBWT.build(corpus.seqs[:2], 10, "cpu")):
        got = psg.mark_suffix_groups(sb.bits, sb.k)
        np.testing.assert_array_equal(got, jsg.mark_suffix_groups(sb.bits, sb.k))
        np.testing.assert_array_equal(got, sb.suffix_group_starts)


def test_indexes_of_pushed_and_spread_bits_answer_as_jax(corpus):
    """An index of the pushed rows answers as the original (a suffix
    group's rank intervals do not move); of the spread rows, as the JAX
    package's index of the same rows (on this corpus both packages answer
    one window of the read otherwise than the original index)."""
    sb = corpus.plain
    read = corpus.seqs[0][37:137]
    want = sb.streaming_search(read)
    pushed = psg.push_bits_left(sb.bits, sb.suffix_group_starts)
    spread = psg.spread_bits_after_push_left(pushed, sb.suffix_group_starts)
    got = [SBWT.from_bits(bits, sb.suffix_group_starts, K, sb.number_of_kmers(), "cpu",
                          precalc_k=3).streaming_search(read) for bits in (pushed, spread)]
    assert got[0] == want
    jax_spread = JaxSBWT(spread, sb.suffix_group_starts, K, sb.number_of_kmers(), precalc_k=3)
    assert got[1] == jax_spread.streaming_search(read)


def test_column_entropy_matches_jax(corpus):
    bits = np.zeros((4, 8), dtype=bool)
    bits[0, :4] = True
    bits[3, 4:] = True
    assert abs(psg.compute_column_entropy(bits) - 1.0) < 1e-12
    assert psg.compute_column_entropy(np.zeros((4, 5), dtype=bool)) == 0.0
    assert psg.compute_column_entropy(corpus.js.bits) == jsg.compute_column_entropy(corpus.js.bits)


def test_api_example_prints_the_jax_examples_lines():
    """examples/api_example_torch.py --device cpu, run as a user runs it,
    prints what examples/api_example.py prints."""
    examples = Path(__file__).resolve().parents[1] / "examples"
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        runpy.run_path(str(examples / "api_example.py"), run_name="__main__")
    proc = subprocess.run([sys.executable, str(examples / "api_example_torch.py"), "--device", "cpu"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want.getvalue()
    assert proc.stdout.count("\n") > 40 and "--\n" in proc.stdout
