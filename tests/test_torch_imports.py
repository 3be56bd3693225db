"""The port never imports JAX or the JAX package, and CPU runs never
launch a kernel.

A fresh interpreter, started where only ``sbwt_tpu_torch`` is importable
(the ``sbwt_tpu`` directory is not on its path), imports every module of
the port and runs the CPU slice (build, precalc, turbo tables, streaming
and k-mer search, fast_search, the facade's k-mer access, file round
trip), a variant slice (build --variant, re-encoding, the LF engine, the
variant's own precalc fill, its files) and a device-build slice
(``build_on_device`` on the CPU); afterwards no ``jax`` and no
``sbwt_tpu`` module may be loaded and every kernel launch counter must
still be 0. The kernel loader's sources must exist, and a
wrapper handed CPU tensors must refuse them rather than fall back. The
port's copies of the host modules must give the JAX package's bytes.
"""
import gzip
import importlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sbwt_tpu_torch import kernels

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "sbwt_tpu_torch"

_SLICE = r"""
import importlib, json, pkgutil, sys, tempfile
import numpy as np
import sbwt_tpu_torch
from sbwt_tpu_torch import kernels
mods = [m.name for m in pkgutil.walk_packages(sbwt_tpu_torch.__path__, "sbwt_tpu_torch.")
        if not m.name.endswith("__main__")]
for m in mods:
    importlib.import_module(m)
from sbwt_tpu_torch.io.serialize import load, save
from sbwt_tpu_torch.models.sbwt import SBWT
from sbwt_tpu_torch.utils.dna import encode_query

rng = np.random.default_rng(3)
g = "".join(rng.choice(list("ACGT"), size=3000))
sb = SBWT.build([g], 14, "cpu", precalc_k=6)
arity = sb.enable_turbo()
enc = encode_query(g)
codes = np.concatenate([enc[s : s + 40][None] for s in range(0, 2000, 40)])
codes[::3, 7] |= 4
ans = sb.streaming_search_batch(codes)
kmers = sb.search_batch(codes[:, :14])
with tempfile.TemporaryDirectory() as d:
    save(d + "/i.sbwt", sb)
    again = load(d + "/i.sbwt", "cpu")
    again.enable_turbo(1)
    same = bool((again.streaming_search_batch(codes) == ans).all())
    variants_same = True
    built = SBWT.build([g], 14, "cpu", precalc_k=4, variant="rrr-subsetwt")
    for v in ("mef-matrix", "rrr-split", "mef-concat"):
        vs = sb.to_variant(v)
        vs.do_kmer_prefix_precalc(5)
        save(d + "/v.sbwt", vs, "native")
        back = load(d + "/v.sbwt", "cpu")
        for x in (vs, back, built):
            variants_same &= bool((x.streaming_search_batch(codes) == ans).all())
            variants_same &= bool((x.search_batch(codes[:, :14]) == kmers).all())
    on_dev = SBWT.build_on_device([g, g[100:400] + "NNA" + g[7:90]], 14, "cpu", precalc_k=6)
    host = SBWT.build([g, g[100:400] + "NNA" + g[7:90]], 14, "cpu", precalc_k=6)
    device_build = bool((on_dev._bits_packed == host._bits_packed).all()
                        and (on_dev._sgs_packed == host._sgs_packed).all()
                        and (on_dev.streaming_search_batch(codes)
                             == host.streaming_search_batch(codes)).all())
    save(d + "/dev.sbwt", on_dev)
    device_build &= bool((load(d + "/dev.sbwt", "cpu").search_batch(codes[:, :14])
                          == host.search_batch(codes[:, :14])).all())
from sbwt_tpu_torch.ops.gather_chain import gather_chain
from sbwt_tpu_torch.parallel import multihost, sharded
from sbwt_tpu_torch.utils.profiling import ThroughputMeter, annotate, trace
mesh = sharded.make_mesh(2, 2, ["cpu"])
tp = sharded.build_turbo_sharded(sb.device_index, mesh, 3)
with tempfile.TemporaryDirectory() as d, trace(d), annotate("parallel"):
    parallel = bool((sharded.tp_streaming_search(sb.device_index, codes, None, mesh).numpy()
                     == ans).all())
    parallel &= bool((sharded.tp_turbo_streaming_search(tp, sb.device_index, codes, None, mesh)
                      .numpy() == ans).all())
    parallel &= bool((multihost.local_shard(multihost.distributed_streaming_search(
        sb.device_index, codes, np.full(len(codes), 40, np.int32), mesh)) == ans).all())
import torch
from sbwt_tpu_torch.ops.turbo import fast_search
fs_ans, fs_slow = fast_search(sb._turbo, torch.from_numpy(codes[:, :14]))
marks = sb.compute_dummy_node_marks()
access = bool(((fs_ans.numpy() == kmers) | fs_slow.numpy()).all())
access &= int(marks.sum()) == sb.number_of_subsets() - sb.number_of_kmers()
access &= sb.ascii_export_sets().count("\n") == 1 and sb.get_kmers_batch([5]) == [sb.get_kmer(5)]
parallel &= gather_chain(torch.zeros((8, 2), dtype=torch.int32),
                         torch.arange(4, dtype=torch.int32), 3).tolist() == [0, 0, 0, 0]
print(json.dumps({
    "parallel": parallel,
    "access": access,
    "modules": len(mods),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "sbwt_tpu": sorted(m for m in sys.modules if m == "sbwt_tpu" or m.startswith("sbwt_tpu.")),
    "device_build": device_build,
    "launches": kernels.LAUNCHES,
    "arity": arity,
    "hit": float((ans >= 0).mean()),
    "kmer_hits": int((kmers >= 0).sum()),
    "roundtrip": same,
    "variants": variants_same,
}))
"""


def test_cpu_slice_imports_no_jax_and_launches_nothing(tmp_path):
    # only the port is importable: a directory holding a link to it, not the repository
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sbwt_tpu_torch").symlink_to(PKG, target_is_directory=True)
    # one torch thread, as in the test workers (torch_state.py)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(tmp_path / "site"))
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["sbwt_tpu"] == []
    assert out["modules"] >= 28
    assert out["device_build"]
    assert set(out["launches"]) == set(kernels.LAUNCHES)
    assert all(v == 0 for v in out["launches"].values())
    assert out["arity"] == 3 and out["roundtrip"] and out["variants"] and out["parallel"]
    assert out["access"]
    assert 0.5 < out["hit"] < 1.0 and out["kmer_hits"] > 0


def test_package_source_never_names_jax():
    """No import of jax, and none of the JAX package, in the port, in
    chip_smoke.py or in the port's examples (comments may cite
    sbwt_tpu/...:line as the counterpart)."""
    jax_package = re.compile(r"^\s*(from|import)\s+sbwt_tpu(\.|\s|$)")
    examples = sorted((REPO / "examples").glob("*_torch.py"))
    assert len(examples) >= 2
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py", *examples]:
        if kernels.BUILD_DIR in path.parents:
            continue  # build outputs, not package source
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            assert not (words[:1] == ["import"] and "jax" in words[1:2]), (path, line)
            assert not (words[:1] == ["from"] and words[1:2] == ["jax"]), (path, line)
            assert "import jax" not in line, (path, line)
            assert not jax_package.match(line), (path, line)


def test_loader_sources_exist():
    named = set(kernels.SOURCES) | set(kernels.HEADERS)
    on_disk = {p.name for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert named == on_disk
    assert all((kernels.CSRC / s).stat().st_size > 0 for s in named)
    for s in kernels.SOURCES:
        assert 'extern "C"' in (kernels.CSRC / s).read_text()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    before = kernels.library_path()
    assert before.parent == kernels.BUILD_DIR and before.suffix == ".so"
    for name in kernels.SOURCES + kernels.HEADERS:
        (tmp_path / name).write_bytes((kernels.CSRC / name).read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    assert kernels.library_path() == before
    with open(tmp_path / kernels.SOURCES[-1], "a") as f:
        f.write("\n// edited\n")
    assert kernels.library_path() != before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernels, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def _rank_desc(variant="rrr-split"):
    from sbwt_tpu_torch.models.sbwt import SBWT

    sb = SBWT.build(["ACGTTGCAAGGCTTAGC"], 5, "cpu").to_variant(variant)
    return sb.device_index.kernel_desc(torch.device("cpu"))


def _wide_desc():
    return kernels.WideMatrixDesc(0, 1)


@pytest.mark.parametrize("call", [
    lambda t: kernels.precalc_fill("plain-matrix", _rank_desc("plain-matrix"), t["C"], 10, 2),
    lambda t: kernels.kmer_search("plain-matrix", _rank_desc("plain-matrix"), t["C"], 10,
                                  t["pre"], 0, t["codes"]),
    lambda t: kernels.succ1("plain-matrix", _rank_desc("plain-matrix"), t["sgs"], t["C"], 10),
    lambda t: kernels.succ_compose(torch.zeros((4, 10), dtype=torch.int32), 3),
    lambda t: kernels.seed_bits(t["pre"], 1),
    lambda t: kernels.turbo_stream("plain-matrix", _rank_desc("plain-matrix"), t["rank"], 1,
                                   t["C"], t["pre"], 1, None, t["codes"],
                                   torch.full((2,), 5, dtype=torch.int32), 5, 1),
    lambda t: kernels.lf_stream("rrr-split", _rank_desc(), t["sgs"], t["C"], t["pre"], 1, 5, 10,
                                t["codes"], torch.full((2,), 5, dtype=torch.int32)),
    lambda t: kernels.precalc_fill("rrr-split", _rank_desc(), t["C"], 10, 2),
    lambda t: kernels.kmer_search("rrr-split", _rank_desc(), t["C"], 10, t["pre"], 1, t["codes"]),
    lambda t: kernels.partial_search("rrr-split", _rank_desc(), t["C"], 10, t["codes"],
                                     torch.full((2,), 5, dtype=torch.int32)),
    lambda t: kernels.succ1("mef-concat", _rank_desc("mef-concat"), t["sgs"], t["C"], 10),
    lambda t: kernels.turbo_stream("rrr-subsetwt", _rank_desc("rrr-subsetwt"), t["rank"], 1,
                                   t["C"], t["pre"], 1, None, t["codes"],
                                   torch.full((2,), 5, dtype=torch.int32), 5, 1),
    lambda t: kernels.seed_bits(t["pre"].long(), 1),
    lambda t: kernels.precalc_fill(kernels.WIDE, _wide_desc(), t["C"].long(), 10, 2),
    lambda t: kernels.kmer_search(kernels.SHARDED, kernels.ShardedMatrixDesc(), t["C"], 10,
                                  t["pre"], 1, t["codes"]),
    lambda t: kernels.lf_stream(kernels.SHARDED, kernels.ShardedMatrixDesc(), t["sgs"], t["C"],
                                t["pre"], 1, 5, 10, t["codes"],
                                torch.full((2,), 5, dtype=torch.int32)),
    lambda t: kernels.turbo_stream_sharded(_rank_desc("plain-matrix"), [t["rank"], t["rank"]], 1, 1,
                                           t["C"], t["pre"], 1, None, t["codes"],
                                           torch.full((2,), 5, dtype=torch.int32), 5, 2),
    lambda t: kernels.succ_compose(torch.zeros((4, 10), dtype=torch.int32), 3, 4, 3),
    lambda t: kernels.gather_chain(t["rank"], torch.zeros(3, dtype=torch.int32), 4),
    lambda t: kernels.shard_ptrs([t["rank"]], "tbl", torch.device("cpu"), (4, 2), 8),
    lambda t: kernels.fast_search(t["rank"], 1, t["pre"], 1, t["codes"], 4),
    lambda t: kernels.fast_search(t["rank"].long(), 1, t["pre"].long(), 1, t["codes"], 4),
    lambda t: kernels.answer_stats(t["rank"]),
    lambda t: kernels.answer_stats(t["rank"].long()),
    lambda t: kernels.forward("plain-matrix", _rank_desc("plain-matrix"), t["sgs"], t["C"], 10,
                              torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int8)),
    lambda t: kernels.forward("rrr-subsetwt", _rank_desc("rrr-subsetwt"), t["sgs"], t["C"], 10,
                              torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int8)),
], ids=["precalc_fill", "kmer_search", "succ1", "succ_compose", "seed_bits", "turbo_stream",
        "lf_stream", "variant_precalc_fill", "variant_kmer_search", "variant_partial_search",
        "variant_succ1", "variant_turbo_stream", "wide_seed_bits", "wide_precalc_fill",
        "sharded_kmer_search", "sharded_lf_stream", "turbo_stream_sharded_table",
        "succ_compose_column_range", "gather_chain", "shard_pointers", "fast_search",
        "wide_fast_search", "answer_stats", "wide_answer_stats", "forward", "variant_forward"])
def test_wrappers_refuse_cpu_tensors(call):
    tensors = {
        "rank": torch.zeros((4, 2), dtype=torch.int32),
        "sgs": torch.zeros((1, 2), dtype=torch.int32),
        "C": torch.ones(4, dtype=torch.int32),
        "pre": torch.zeros((4, 2), dtype=torch.int32),
        "codes": torch.zeros((2, 5), dtype=torch.int8),
    }
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        call(tensors)
    assert kernels.LAUNCHES == before


def test_launch_counters_name_every_lf_instance():
    lf = [name for name in kernels.LAUNCHES if "[" in name]
    # seven ops on eleven rank types and two on the sharded one (K20a); the
    # wide tier's seed bits, K20b, K20c, the narrow and wide fast_search and
    # the wide tier's answer stats have counters of their own
    assert len(lf) == 7 * 11 + 2 + 3 + 2 + 1
    assert set(kernels.FAST_SEARCH.values()) == {"fast_search[plain-matrix]",
                                                 f"fast_search[{kernels.WIDE}]"}
    for op in kernels.LF_OPS:
        assert kernels.lf_counter(op, "rrr-split") in lf
        assert kernels.lf_counter(op, kernels.WIDE) in lf
        assert kernels.lf_counter(op, "plain-matrix") in kernels.LAUNCHES
        sharded = kernels.lf_counter(op, kernels.SHARDED) in lf
        assert sharded == (op in ("lf_stream", "kmer_search"))
    assert kernels.lf_counter("succ1", "plain-matrix") == "succ1[plain-matrix]"
    assert set(kernels.RANK_DESCS) == set(kernels.RANK_TYPES) == set(kernels.FAMILY)
    assert kernels.RANK_TYPES == kernels.VARIANTS + (kernels.WIDE, kernels.SHARDED)
    assert kernels.SHARDED not in kernels.VARIANTS
    for fam in set(kernels.FAMILY.values()):
        src = "lf_stream.cu" if fam == "matrix" else f"lf_{fam}.cu"
        assert f"sbwt_lf_{fam}(" in (kernels.CSRC / src).read_text()


# ---------------------------------------------------------------------------
# The port's copies of the host modules against the JAX package's originals:
# the same seeded input through both must give the same bytes.
# ---------------------------------------------------------------------------


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _blob(*parts) -> bytes:
    out = bytearray()
    for p in parts:
        if isinstance(p, np.ndarray):
            p = repr((p.dtype.str, p.shape)).encode() + np.ascontiguousarray(p).tobytes()
        elif not isinstance(p, (bytes, bytearray)):
            p = repr(p).encode()
        out += p + b"|"
    return bytes(out)


def _text(seed, n, alphabet="ACGT"):
    return "".join(np.random.default_rng(seed).choice(list(alphabet), size=n))


def _text_with_n(seed, n):
    t = list(_text(seed, n))
    t[n // 3] = t[n // 2] = "N"
    return "".join(t)


def _seqs():
    return [_text(1, 900), _text(2, 400, "ACGTN"), _text(3, 60), _text(1, 900)[100:300]]


def _dna(pkg, tmp):
    m = _mod(pkg, "utils.dna")
    t = _text(4, 500, "ACGTacgtNn-")
    return _blob(m.encode(t), m.encode_query(t), m.reverse_complement_bytes(t.encode()),
                 m.decode(m.encode(_text(5, 99))), m.reverse_complement(_text(6, 77)))


def _kmer_ops(m, vals, k):
    return [m.drop_first(vals, k), m.drop_last(vals), m.append_last(vals, 2),
            m.append_from_base(m.append_last_base(vals), 3), m.first_char(vals, k),
            m.last_char(vals), m.char_at_distance(vals, 3), m.prefix_of_length(vals, k, k // 2),
            m.colex_argsort(vals), m.to_string(vals[0], k)]


def _kmers(pkg, tmp):
    m = _mod(pkg, "utils.kmers")
    codes = _mod(pkg, "utils.dna").encode(_text_with_n(7, 700))
    vals, valid = m.pack_windows(codes, 21)
    one = m.pack_kmer(codes[:21].clip(min=0))
    return _blob(vals, valid, one, m.unpack_kmer(one, 21), *_kmer_ops(m, vals[valid], 21))


def _kmers_wide(pkg, tmp):
    m = _mod(pkg, "utils.kmers_wide")
    codes = _mod(pkg, "utils.dna").encode(_text_with_n(8, 700))
    vals, valid = m.pack_windows(codes, 45)
    vals = vals[valid]
    srt = vals[m.colex_argsort(vals)]
    one = m.pack_kmer(codes[:45].clip(min=0))
    return _blob(m.n_words(45), vals, valid, one, m.unpack_kmer(one, 45), *_kmer_ops(m, vals, 45),
                 m.rows_less(vals[1:], vals[:-1]), m.searchsorted_rows(srt, vals[:50]),
                 m.isin_sorted(srt, m.append_last(vals[:50], 1)), *m.unique_rows_sorted(srt))


def _built(b):
    if hasattr(b, "bits_packed"):
        return _blob(b.bits_packed, b.sgs_packed, b.n_cols, b.k, b.n_kmers)
    return _blob(b.bits, b.suffix_group_starts, b.k, b.n_kmers)


def _inmemory(pkg, tmp):
    m = _mod(pkg, "construct.inmemory")
    enc = _mod(pkg, "utils.dna").encode
    return _blob(_built(m.build_sbwt(_seqs(), 9)), _built(m.build_sbwt(_seqs(), 40)),
                 _built(m.build_sbwt(_seqs(), 12, streaming_support=False, min_abundance=2,
                                     add_reverse_complements=True)),
                 m.encode_rc(enc(_text(9, 50, "ACGTN"))),
                 m.mark_suffix_groups(m.build_sbwt(_seqs(), 9).bits, 9))


def _external(pkg, tmp):
    """construct/external.py over construct/streaming.py and the native sorts."""
    m = _mod(pkg, "construct.external")
    enc = _mod(pkg, "utils.dna").encode
    seqs = [enc(s) for s in _seqs()]
    return _blob(
        _built(m.build_sbwt_external(seqs, 13, ram_bytes=1 << 20, n_threads=2, temp_dir=str(tmp))),
        _built(m.build_sbwt_external(iter(seqs), 37, add_reverse_complements=True,
                                     ram_bytes=1 << 20, n_threads=1, temp_dir=str(tmp))))


def _streaming(pkg, tmp):
    """build_streaming with tiny chunks, so every cross-chunk carry runs."""
    m = _mod(pkg, "construct.streaming")
    km = _mod(pkg, "utils.kmers")
    tf = _mod(pkg, "utils.tempfiles").TempFileManager()
    tf.set_dir(str(tmp))
    vals, valid = km.pack_windows(_mod(pkg, "utils.dna").encode(_text(10, 3000)), 15)
    distinct = np.unique(vals[valid])
    path = str(tmp / f"distinct_{pkg}.bin")
    distinct.tofile(path)
    return _built(m.build_streaming(path, len(distinct), 15, True, ram_bytes=1 << 20,
                                    n_threads=2, tfm=tf, chunk_records=257))


def _seqio(pkg, tmp):
    m = _mod(pkg, "io.seqio")
    seqs = _seqs() + [_text(11, 130, "ACGTacgtN")]
    fa, fq, gz = tmp / "a.fna", tmp / "b.fastq", tmp / "c.fna.gz"
    fa.write_text("".join(f">s{i} x\n{s[:70]}\n{s[70:]}\n" for i, s in enumerate(seqs)))
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs)))
    with gzip.open(gz, "wt") as f:
        f.write(fa.read_text())
    rc = tmp / f"rc_{pkg}.fna"
    m.create_reverse_complement_files([str(fa)], [str(rc)])
    parts = [rc.read_bytes()]
    for path in (fa, fq, gz):
        fmt = m.figure_out_file_format(str(path))
        parts += [fmt.format, fmt.gzipped, *m.read_sequences(str(path)),
                  *m.stream_build_codes([str(path)]),
                  *[b for batch in m.iter_sequence_batches(str(path), max_reads=2) for b in batch]]
    return _blob(*parts)


def _sdsl(pkg, tmp):
    m = _mod(pkg, "io.sdsl")
    rng = np.random.default_rng(12)
    bits = rng.random(5000) < 0.3
    sparse = rng.random(5000) < 0.02
    text = np.frombuffer(_text(13, 3000, "ACGT$").encode(), dtype=np.uint8)
    f = io.BytesIO()
    m.write_bit_vector(f, bits)
    m.write_bit_vector_packed(f, np.packbits(bits, bitorder="little"), len(bits))
    m.write_rank_support_v(f, bits)
    m.write_rank_support_v5(f, bits)
    m.write_int_vector64(f, m.rank_v5_payload_packed(np.packbits(bits, bitorder="little"), 5000))
    m.write_select_mcl(f, sparse, 0)
    m.write_rrr(f, bits)
    m.write_sd(f, sparse)
    m.write_mef(f, bits)
    m.write_mef_rank_support(f, m.mef_encode(bits)["wl"])
    m.write_wt_blcd(f, text, compressed=False)
    m.write_wt_blcd(f, text, compressed=True)
    data = f.getvalue()
    f.seek(0)
    back = [m.read_bit_vector(f), m.read_bit_vector_packed(f)[0]]
    return _blob(data, *back, m.mef_optimize_w(bits))


def _native(pkg, tmp):
    m = _mod(pkg, "native")
    assert m.available()
    rng = np.random.default_rng(14)
    vals = rng.integers(-1, 10**9, size=300)
    lens = np.array([0, 100, 1, 199], dtype=np.int64)
    codes = _mod(pkg, "utils.dna").encode(_text_with_n(15, 4000))
    raw, srt, ded = (str(tmp / f"{n}_{pkg}.bin") for n in ("raw", "sorted", "dedup"))
    n_spilled = m.spill_windows_u64(codes, 19, raw, n_threads=2)
    m.em_sort_u64_file(raw, srt, str(tmp), ram_bytes=1 << 16, n_threads=2)
    n_kept = m.em_dedup_count_u64_file(srt, ded, 1, 2**62)
    packed = m.pack_windows_u64(codes, 19)
    distinct = np.fromfile(ded, dtype=np.uint64)
    return _blob(m.format_ranks(vals, lens), n_spilled, n_kept, distinct, *packed,
                 *m.merge_isin_u64(distinct, np.sort(distinct[::3] ^ np.uint64(1))))


def _query_runner(pkg, tmp):
    m = _mod(pkg, "io.query_runner")
    reads = [s.encode() for s in _seqs()] + [b"", b"acgtNNAC"]
    rng = np.random.default_rng(16)
    rows = [rng.integers(-1, 5000, size=n) for n in (5, 0, 71, 1)]
    return _blob(*m.encode_reads(reads), *m.encode_reads(reads[:2], pad_len=1024),
                 m.format_answers(rows), m.format_answers([]))


def _serialize(pkg, tmp):
    """An index built, saved in both formats and re-read, by each package's own
    facade and writers; plain-matrix and one compressed variant."""
    facade, ser = _mod(pkg, "models.sbwt"), _mod(pkg, "io.serialize")
    dev = () if pkg == "sbwt_tpu" else ("cpu",)
    parts = []
    for variant in ("plain-matrix", "mef-split"):
        sb = facade.SBWT.build(_seqs(), 10, *dev, precalc_k=3, variant=variant)
        for fmt in ("cpp", "native"):
            path = str(tmp / f"{pkg}_{variant}.{fmt}")
            parts += [ser.save(path, sb, fmt), open(path, "rb").read()]
            back = ser.load(path, *dev)
            parts += [back.variant, back.k, back.number_of_kmers(), np.asarray(back.bits)]
    f = io.BytesIO()
    parts += [ser.write_string(f, "plain-matrix"), ser.write_int64_vector(f, np.arange(7)),
              f.getvalue(), ser.SBWT_VERSION, ser.NATIVE_MAGIC]
    return _blob(*parts)


def _small_utils(pkg, tmp):
    """utils/logging.py, utils/tempfiles.py and the progress ticker."""
    log, tf = _mod(pkg, "utils.logging"), _mod(pkg, "utils.tempfiles")
    out = io.StringIO()
    progress = _mod(pkg, "utils.profiling").ProgressPrinter(37, n_steps=10, stream=out)
    for _ in range(37):
        progress.job_done()
    before = log.get_log_level()
    log.set_log_level(log.LogLevel.MINOR)
    levels = [int(v) for v in log.LogLevel], int(log.get_log_level())
    log.set_log_level(before)
    manager = tf.TempFileManager()
    manager.set_dir(str(tmp))
    name = manager.create_filename("pre_", ".suf")
    open(name, "w").close()
    shape = (os.path.dirname(name) == manager.get_dir(), os.path.basename(name)[:4], name[-4:])
    manager.delete_file(name)
    return _blob(out.getvalue(), levels, shape, os.path.exists(name))


def _select(pkg, tmp):
    m = _mod(pkg, "models.select")
    bits = np.random.default_rng(18).random((4, 3000)) < 0.3
    ss = m.MatrixSelectSupport(bits)
    ranks = np.arange(1, int(bits[2].sum()) + 1)
    return _blob(*ss.positions, ss.select_batch(ranks, 2), ss.select(7, 1), ss.select(1, 3))


def _suffix_groups(pkg, tmp):
    m = _mod(pkg, "ops.suffix_groups")
    rng = np.random.default_rng(19)
    bits = rng.random((4, 2000)) < 0.3
    marks = np.concatenate([[True], rng.random(1999) < 0.5])
    pushed = m.push_bits_left(bits, marks)
    built = _mod(pkg, "construct.inmemory").build_sbwt(_seqs(), 9)
    return _blob(pushed, m.spread_bits_after_push_left(pushed, marks),
                 m.mark_suffix_groups(built.bits, 9), m.compute_column_entropy(bits),
                 m.push_bits_left(bits[:, :0], marks[:0]))


_COPIED = {"models.select": _select, "ops.suffix_groups": _suffix_groups, "utils.dna": _dna, "utils.kmers": _kmers, "utils.kmers_wide": _kmers_wide,
           "utils.logging+tempfiles+profiling": _small_utils, "native": _native,
           "io.sdsl": _sdsl, "io.seqio": _seqio, "io.query_runner": _query_runner,
           "io.serialize": _serialize, "construct.inmemory": _inmemory,
           "construct.external": _external, "construct.streaming": _streaming}


@pytest.mark.parametrize("module", list(_COPIED))
def test_copied_host_module_gives_the_jax_packages_bytes(module, tmp_path):
    want = _COPIED[module]("sbwt_tpu", tmp_path)
    got = _COPIED[module]("sbwt_tpu_torch", tmp_path)
    assert len(want) > 100
    assert got == want


def test_sharded_rank_type_refuses_the_ops_it_has_no_instance_of():
    for op in ("precalc_fill", "partial_search", "succ1", "turbo_stream", "forward"):
        with pytest.raises(ValueError, match=f"no {op} instance"):
            kernels._lf_launch(op, kernels.SHARDED, kernels.ShardedMatrixDesc(), None)


@pytest.mark.parametrize("name", ["ThroughputMeter", "ProgressPrinter"])
def test_profiling_classes_are_the_jax_packages(name):
    """utils/profiling.py's counters are copies: the same source text."""
    import inspect

    want = getattr(_mod("sbwt_tpu", "utils.profiling"), name)
    got = getattr(_mod("sbwt_tpu_torch", "utils.profiling"), name)
    assert inspect.getsource(got) == inspect.getsource(want)


def test_native_library_builds_into_the_ports_build_directory():
    from sbwt_tpu_torch import native

    assert native.available()
    assert Path(native._so_path()).parent == kernels.BUILD_DIR
    assert not list((PKG / "native").glob("*.so"))


def test_streaming_build_shuts_its_probe_pool_down_on_error(tmp_path, monkeypatch):
    """Fault F3 of the JAX package's construct/streaming.py, closed in the
    port's copy: an exception in phase 1 leaves no probe thread behind."""
    from concurrent import futures

    from sbwt_tpu_torch.construct import streaming
    from sbwt_tpu_torch.utils.tempfiles import TempFileManager

    pools = []

    class Pool(futures.ThreadPoolExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pools.append(self)

    monkeypatch.setattr(futures, "ThreadPoolExecutor", Pool)

    def boom(self, y):
        raise OSError("probe failed")

    monkeypatch.setattr(streaming._ProbeCursor, "probe", boom)
    distinct = np.arange(1, 4000, 7, dtype=np.uint64) << np.uint64(34)
    path = str(tmp_path / "distinct.bin")
    distinct.tofile(path)
    tf = TempFileManager()
    tf.set_dir(str(tmp_path))
    with pytest.raises(OSError, match="probe failed"):
        streaming.build_streaming(path, len(distinct), 15, True, ram_bytes=1 << 20, n_threads=2,
                                  tfm=tf, chunk_records=100)
    assert len(pools) == 1 and pools[0]._shutdown
