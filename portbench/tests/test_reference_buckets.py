"""The bucketed reference against the whole-table one, the generators' shapes
and the yardstick's answer width, on the CPU at small sizes.

    python -m pytest portbench/tests/test_reference_buckets.py -q
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench import control, gen, yardstick
from portbench.reference import buckets, sbwt_ref
from portbench.tests import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PANGENOME = {
    "core_bases": 1500, "strains": 6, "strain_substitution_rate": 0.01,
    "accessory_pool_blocks": 30, "accessory_block_bases": 40, "accessory_blocks_per_strain": 5,
    "accessory_hotspots": 2, "accessory_zipf_exponent": 1.0, "add_reverse_complements": True,
}
# sha256 of every indexed sequence's bytes, made by gen.genome before the
# pangenome shape was added: (genome keys, seed) -> digest
STRAIN_HASHES = {
    ("coli3", 2**31 + 977): "414da994c4fadc7652373966ec147102bfa9cc58a0572beefe98f27edbe5fbd4",
    ("coli3", 5): "68f76d1711182f559e46fe81534cdfc18a20491a10d9365fd48ff5cac00e5145",
    ("tiny", 2**31 + 977): "f62a4efb85d3a0388908bb5a593b2292e8477cf69d49919b86b087310f5ff910",
    ("tiny", 5): "bb488cd5b3fe1854ebd97dfaf36de68ce7ec184731d5509cb2a0e6b0ee85f81c",
}
ONE_BUCKET = 1 << 29


def _noisy(n: int, g: torch.Generator) -> torch.Tensor:
    """n codes, ACGT but for about one in twenty that is 4 or -1."""
    codes = torch.randint(0, 4, (n,), generator=g, dtype=torch.int8)
    odd = torch.rand(n, generator=g) < 0.05
    return torch.where(odd, torch.randint(-1, 1, (n,), generator=g, dtype=torch.int8) * 5 + 4,
                       codes).to(torch.int8)


def indexed(kind: str, k: int) -> list:
    """Sequences of one kind: codes other than ACGT inside them; strains with
    their reverse complements; many short ones (many sources and dummies);
    the pangenome shape."""
    g = torch.Generator().manual_seed(1000 + k)
    if kind == "non_acgt":
        return [_noisy(int(n), g) for n in torch.randint(k, 400, (6,), generator=g)]
    if kind == "strains_rc":
        return gen.genome(dict(tiny.CONFIG["genome"], base_bases=800), 7 + k, "cpu")[1]
    if kind == "short":
        return [torch.randint(0, 4, (int(n),), generator=g, dtype=torch.int8)
                for n in torch.randint(max(1, k - 2), k + 12, (300,), generator=g)]
    return gen.genome(PANGENOME, 7 + k, "cpu")[1]


def queries(seqs: list, k: int) -> list:
    """Three batches of reads from the sequences and foreign ones, with
    errors, codes other than ACGT and lengths under k and of 0."""
    text = torch.cat([s.to(torch.int8) for s in seqs])[None, :]
    g = gen.generator(k, 9, "cpu")
    out = []
    for _ in range(3):
        mix = dict(tiny.MIX, batch_reads=40, read_length=[0, 70], source_share=0.8)
        b = gen.read_batch(mix, text, k, g)
        codes, lengths = b.codes.clone(), b.lengths.clone()
        codes[4, 10], codes[5, 3], lengths[0] = -1, 5, k - 1
        out.append((codes, lengths))
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 30, 31])
def test_window_keys_equal_whole_table_keys(k):
    codes = torch.randint(-1, 6, (7, 90), generator=torch.Generator().manual_seed(k))
    keys, ok = sbwt_ref.window_keys(codes, k)
    assert torch.equal(buckets.window_keys(codes, k), torch.where(ok, keys, -1))


@pytest.mark.parametrize("max_keys", [ONE_BUCKET, 300, 45])
@pytest.mark.parametrize("kind", ["non_acgt", "strains_rc", "short", "pangenome"])
@pytest.mark.parametrize("k", [3, 5, 16, 30, 31])
def test_buckets_equal_whole_table(k, kind, max_keys):
    seqs = indexed(kind, k)
    batches = queries(seqs, k)
    whole = sbwt_ref.ReferenceIndex(seqs, k)
    got = buckets.streaming_answers(seqs, k, batches, chunk_bases=257, max_keys=max_keys)
    n = whole.kmers.shape[0]
    if n <= max_keys // 2:
        assert len(got.buckets) == 1
    if n > max_keys:
        assert len(got.buckets) > 1
    assert [hi for _, hi, _ in got.buckets][-1] == 4**k
    assert (got.n_kmers, got.n_sources, got.n_nodes) == (
        whole.kmers.shape[0], whole.n_sources, whole.n_nodes)
    if kind == "short" and k >= 16:
        assert whole.n_sources > 100
    for (codes, lengths), ans in zip(batches, got.answers):
        want = whole.streaming_answers(codes, lengths)
        assert (want >= 0).any() and (want < 0).any()
        assert torch.equal(ans, want)


@pytest.mark.parametrize("max_keys", [ONE_BUCKET, 300, 45])
@pytest.mark.parametrize("kind", ["non_acgt", "strains_rc", "short", "pangenome"])
@pytest.mark.parametrize("k", [16, 30, 31])
def test_control_buckets_equal_whole_table(k, kind, max_keys):
    """The control's 32-bit comparison, bucket by bucket, answers as the
    whole table's does."""
    seqs = indexed(kind, k)
    batches = queries(seqs, k)
    whole = sbwt_ref.ReferenceIndex(seqs, k)
    got = buckets.streaming_answers(seqs, k, batches, chunk_bases=257, max_keys=max_keys,
                                    key_bits=control.KEY_BITS)
    assert got.n_nodes == whole.n_nodes
    for (codes, lengths), ans in zip(batches, got.answers):
        assert torch.equal(ans, whole.streaming_answers(codes, lengths, key_bits=control.KEY_BITS))


@pytest.mark.parametrize("max_keys", [ONE_BUCKET, 45, 7])
def test_control_class_across_buckets(max_keys):
    """k-mers that share their last 16 chars span several buckets; the
    control answers each the first of them, the exact reference itself."""
    k, g = 31, torch.Generator().manual_seed(5)
    tail = torch.randint(0, 4, (16,), generator=g, dtype=torch.int8)
    heads = torch.randint(0, 4, (120, k - 16), generator=g, dtype=torch.int8)
    seqs = [torch.cat([h, tail]) for h in heads[:100]]
    codes = torch.cat([heads, tail.expand(120, 16)], 1)
    batches = [(codes, torch.full((120,), k))]
    whole = sbwt_ref.ReferenceIndex(seqs, k)
    got = buckets.streaming_answers(seqs, k, batches, chunk_bases=257, max_keys=max_keys,
                                    key_bits=control.KEY_BITS).answers[0]
    exact = buckets.streaming_answers(seqs, k, batches, chunk_bases=257,
                                      max_keys=max_keys).answers[0]
    assert torch.equal(got, whole.streaming_answers(*batches[0], key_bits=control.KEY_BITS))
    assert torch.equal(exact, whole.streaming_answers(*batches[0]))
    assert bool((got == got[0]).all()) and int(got[0]) >= 0
    assert int((exact < 0).sum()) >= 1 and int((got != exact).sum()) >= 100


@pytest.mark.parametrize("seed", [2**31 + 977, 5])
@pytest.mark.parametrize("keys", ["coli3", "tiny"])
def test_strain_shape_unchanged(keys, seed):
    if keys == "coli3":
        params = [json.loads((CONFIGS / f"{c}.json").read_text())["genome"]
                  for c in ("coli3-turbo3", "coli3-rrrsplit-lf")]
        assert params[0] == params[1]
        params = params[0]
    else:
        params = tiny.CONFIG["genome"]
    strains, seqs = gen.genome(params, seed, "cpu")
    digest = hashlib.sha256(b"".join(s.numpy().tobytes() for s in seqs)).hexdigest()
    assert digest == STRAIN_HASHES[(keys, seed)]
    assert strains.dtype == torch.int8 and len(seqs) == strains.shape[0] * (
        2 if params["add_reverse_complements"] else 1)


def test_pangenome_deterministic_and_seeded():
    s1, q1 = gen.genome(PANGENOME, 11, "cpu")
    s2, q2 = gen.genome(PANGENOME, 11, "cpu")
    s3, q3 = gen.genome(PANGENOME, 2**31 + 12, "cpu")
    S, G = PANGENOME["strains"], 1500 + 5 * 40
    assert s1.shape == s3.shape == (S, G) and s1.dtype == torch.int8
    assert torch.equal(s1, s2) and all(torch.equal(a, b) for a, b in zip(q1, q2))
    assert not torch.equal(s1, s3)
    assert len(q1) == 2 * S and torch.equal(q1[S + 2], (3 - s1[2].flip(0)).to(torch.int8))


def test_pangenome_layout():
    """Without substitutions: every strain carries the same core, around
    hotspots of distinct pool blocks; a steep rank law puts the first block
    in most strains."""
    p = dict(PANGENOME, strains=40, strain_substitution_rate=0.0, accessory_zipf_exponent=3.0,
             add_reverse_complements=False)
    strains, _ = gen.genome(p, 3, "cpu")
    b, A = p["accessory_block_bases"], p["accessory_blocks_per_strain"]
    cut0, cut1 = 1500 // 3, 2 * 1500 // 3  # hotspots of 2 and 3 blocks
    core = torch.cat([strains[:, :cut0], strains[:, cut0 + 2 * b : cut1 + 2 * b],
                      strains[:, cut1 + A * b :]], 1)
    assert core.shape[1] == 1500 and bool((core == core[0]).all())
    blocks = torch.cat([strains[:, cut0 : cut0 + 2 * b], strains[:, cut1 + 2 * b : cut1 + A * b]],
                       1).reshape(40, A, b)
    assert all(torch.unique(blocks[i], dim=0).shape[0] == A for i in range(40))
    kinds, counts = torch.unique(blocks.reshape(-1, b), dim=0, return_counts=True)
    assert kinds.shape[0] <= p["accessory_pool_blocks"] and int(counts.max()) >= 30


@pytest.mark.parametrize("dtype,width", [(torch.int32, 4), (torch.int64, 8)])
def test_yardstick_counts_the_answers_width(dtype, width):
    answers = torch.zeros((3, 5), dtype=dtype)
    assert yardstick.answer_bytes(answers) == width
    assert yardstick.compulsory_bytes(300, 3, 15, yardstick.answer_bytes(answers)) == (
        300 + 4 * 3 + width * 15)
