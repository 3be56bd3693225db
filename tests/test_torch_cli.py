"""Port parity: the CLI of sbwt_tpu_torch against sbwt_tpu's, byte for byte.

The port runs with ``--device cpu`` (the kernels' plain versions). Its
search output must give the reference golden bytes of tests/test_cli.py,
equal the JAX CLI's output on a random corpus for every engine (the turbo
engines too, built from a compressed variant's own ranks) and all ten
variants, and come out the same from index files written by either CLI in
either format. Its ``ascii-export`` must write the JAX CLI's bytes on every
non-mef variant and refuse the mef ones with the JAX CLI's error.
"""
import gzip

import numpy as np
import pytest

from sbwt_tpu.cli import main as jax_cli
from sbwt_tpu.io.seqio import SequenceWriter
from sbwt_tpu_torch.cli import main as port_cli
from sbwt_tpu_torch.models.sbwt import VARIANT_NAMES as VARIANTS
import torch_state  # noqa: F401  (one torch thread per test worker)

# the reference's end_to_end_build_and_query fixture (tests/test_cli.py)
SEQS1 = ["ACTAGTGTAGCTACAAA", "ATGTGCTGATGCTAGCATTTTTTT"]
SEQS2 = ["GTGTACTAGTGTGTAGTCGAT"]
QUERIES = [
    "GGAGAACTAGTGTAGCTACAAAGAGAG",
    "AGTGTGTAGCAAAATGTGCTGATGCTAGCAAAAAAAA",
    "CTCTACACACTTC",
]
GOLDEN = (
    "-1 -1 -1 -1 -1 74 55 77 22 47 36 70 19 31 8 4 3 -1 -1 -1 -1 -1 \n"
    "57 78 23 47 36 -1 -1 -1 -1 -1 52 -1 -1 39 73 54 15 65 53 38 72 20 46 35 11 -1 -1 -1 -1 2 2 2 \n"
    "-1 -1 26 5 25 66 -1 -1 \n"
)
CPU = ["--device", "cpu"]


def _write(path, seqs):
    with SequenceWriter(str(path)) as w:
        for s in seqs:
            w.write_sequence(s)
    return path


@pytest.fixture(scope="module")
def golden_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden")
    f1 = _write(tmp / "seqs1.fna.gz", SEQS1)
    f2 = _write(tmp / "seqs2.fna.gz", SEQS2)
    listfile = tmp / "inputs.txt"
    listfile.write_text(f"{f1}\n{f2}\n")
    index = tmp / "index.sbwt"
    rc = port_cli(["build", "-i", str(listfile), "-o", str(index), "-k", "6",
                   "--add-reverse-complements", "--temp-dir", str(tmp),
                   "--precalc-length", "4", *CPU])
    assert rc == 0
    return index


@pytest.mark.parametrize("gz_out", [False, True], ids=["plain", "gzip"])
def test_golden_bytes(golden_index, tmp_path, gz_out):
    qpaths = [_write(tmp_path / n, QUERIES) for n in ("q1.fq", "q2.fna", "q3.fq.gz", "q4.fna.gz")]
    opaths = [tmp_path / f"o{i}.txt{'.gz' if gz_out else ''}" for i in range(4)]
    qlist, olist = tmp_path / "queries.txt", tmp_path / "outputs.txt"
    qlist.write_text("".join(f"{p}\n" for p in qpaths))
    olist.write_text("".join(f"{p}\n" for p in opaths))
    argv = ["search", "-o", str(olist), "-i", str(golden_index), "-q", str(qlist), *CPU]
    assert port_cli(argv + (["--gzip-output"] if gz_out else [])) == 0
    for p in opaths:
        text = gzip.open(p, "rt").read() if gz_out else p.read_text()
        assert text == GOLDEN


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 20 kbp random genome and reads: genomic, mutated, random, with
    lowercase spans, N and varied lengths (one length bucket)."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(2024)
    g = "".join(rng.choice(list("ACGT"), size=20_000))
    genome = _write(tmp / "genome.fna", [g[:12_000], g[12_000:]])
    reads = []
    for i in range(160):
        n = int(rng.integers(70, 96))
        s = int(rng.integers(0, len(g) - n))
        r = list(g[s : s + n]) if i % 4 else list(rng.choice(list("ACGT"), size=n))
        if i % 5 == 1:
            r[int(rng.integers(0, n))] = "N"
        if i % 7 == 2:
            a = int(rng.integers(0, n - 10))
            r[a : a + 8] = [c.lower() for c in r[a : a + 8]]
        if i % 6 == 3:
            r[int(rng.integers(0, n))] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    queries = _write(tmp / "reads.fq", reads)
    jax_index = tmp / "jax.sbwt"
    assert jax_cli(["build", "-i", str(genome), "-o", str(jax_index), "-k", "31",
                    "-p", "10", "--temp-dir", str(tmp)]) == 0
    jax_out = tmp / "jax_out.txt"
    assert jax_cli(["search", "-i", str(jax_index), "-q", str(queries), "-o", str(jax_out)]) == 0
    return tmp, genome, queries, jax_index, jax_out.read_bytes()


@pytest.mark.parametrize("engine", ["auto", "turbo1", "turbo2", "turbo3", "lf"])
def test_search_matches_jax_cli(corpus, engine):
    tmp, genome, queries, _, jax_bytes = corpus
    index = tmp / "port.sbwt"
    if not index.exists():
        assert port_cli(["build", "-i", str(genome), "-o", str(index), "-k", "31", "-p", "10",
                         "--temp-dir", str(tmp), *CPU]) == 0
    out = tmp / f"port_{engine}.txt"
    assert port_cli(["search", "-i", str(index), "-q", str(queries), "-o", str(out),
                     "--engine", engine, *CPU]) == 0
    assert out.read_bytes() == jax_bytes
    assert jax_bytes.count(b"\n") == 160 and b" -1 " in jax_bytes


@pytest.mark.parametrize("fmt", ["cpp", "native"])
def test_index_files_interchange(corpus, fmt):
    """The port reads either CLI's files, and writes the same bytes."""
    tmp, genome, queries, _, jax_bytes = corpus
    jax_file, port_file = tmp / f"jax_{fmt}.sbwt", tmp / f"port_{fmt}.sbwt"
    common = ["-i", str(genome), "-k", "31", "-p", "10", "--temp-dir", str(tmp), "--format", fmt]
    assert jax_cli(["build", "-o", str(jax_file), *common]) == 0
    assert port_cli(["build", "-o", str(port_file), *common, *CPU]) == 0
    assert port_file.read_bytes() == jax_file.read_bytes()
    out = tmp / f"from_jax_{fmt}.txt"
    assert port_cli(["search", "-i", str(jax_file), "-q", str(queries), "-o", str(out),
                     *CPU]) == 0
    assert out.read_bytes() == jax_bytes


def test_index_without_streaming_support(corpus):
    """auto on an index without suffix-group marks answers each k-mer by
    full search (K1's plain version here), as the JAX CLI does."""
    tmp, genome, queries, _, jax_bytes = corpus
    index = _nostream_index(corpus)
    out = tmp / "nostream_out.txt"
    assert port_cli(["search", "-i", str(index), "-q", str(queries), "-o", str(out), *CPU]) == 0
    ref = tmp / "nostream_jax.txt"
    assert jax_cli(["search", "-i", str(index), "-q", str(queries), "-o", str(ref)]) == 0
    assert out.read_bytes() == ref.read_bytes()


def _nostream_index(corpus):
    tmp, genome = corpus[0], corpus[1]
    index = tmp / "nostream.sbwt"
    if not index.exists():
        assert port_cli(["build", "-i", str(genome), "-o", str(index), "-k", "31", "-p", "10",
                         "--no-streaming-support", "--temp-dir", str(tmp), *CPU]) == 0
    return index


@pytest.mark.parametrize("engine", ["turbo3", "lf"])
def test_turbo_without_streaming_support_runs_lf(corpus, capsys, engine):
    """F5: a turbo engine that the index cannot have falls back as in the
    JAX CLI (sbwt_tpu/cli.py:159-173): exit 0 and the JAX CLI's bytes."""
    tmp, _, queries, _, _ = corpus
    index = _nostream_index(corpus)
    out, ref = tmp / f"f5_{engine}.txt", tmp / f"f5_{engine}_jax.txt"
    assert port_cli(["search", "-i", str(index), "-q", str(queries), "-o", str(out),
                     "--engine", engine, *CPU]) == 0
    if engine == "turbo3":
        assert "Turbo engine unavailable (turbo engine requires streaming support" in \
            capsys.readouterr().err
    assert jax_cli(["search", "-i", str(index), "-q", str(queries), "-o", str(ref),
                    "--engine", engine]) == 0
    assert out.read_bytes() == ref.read_bytes()


def test_kernel_failure_under_turbo_still_exits_1(corpus, capsys, monkeypatch):
    """Only the turbo preconditions fall back: a kernel that cannot be built
    or launched ends the run."""
    from sbwt_tpu_torch.models import sbwt as facade

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc not found on PATH")

    monkeypatch.setattr(facade, "build_turbo", broken)
    tmp, _, queries, jax_index, _ = corpus
    assert port_cli(["search", "-i", str(jax_index), "-q", str(queries), "-o", str(tmp / "z.txt"),
                     "--engine", "turbo2", *CPU]) == 1
    assert "Error: nvcc not found on PATH" in capsys.readouterr().err


def test_auto_without_room_for_a_table_runs_lf(corpus, monkeypatch, capsys):
    from sbwt_tpu_torch.models import sbwt as facade

    monkeypatch.setattr(facade, "device_free_bytes", lambda device: 1 << 10)
    tmp, _, queries, jax_index, jax_bytes = corpus
    out = tmp / "no_room.txt"
    assert port_cli(["search", "-i", str(jax_index), "-q", str(queries), "-o", str(out), *CPU]) == 0
    assert "Turbo table exceeds free device memory; using LF engine" in capsys.readouterr().err
    assert out.read_bytes() == jax_bytes


@pytest.fixture(scope="module")
def variant_files(corpus):
    """variant -> (port build-variant file, JAX build-variant file) of the
    JAX CLI's plain index."""
    tmp, _, _, jax_index, _ = corpus
    files = {}
    for v in VARIANTS[1:]:
        port_file, jax_file = tmp / f"port_{v}.sbwt", tmp / f"jax_{v}.sbwt"
        assert port_cli(["build-variant", "-i", str(jax_index), "-o", str(port_file),
                         "--variant", v, *CPU]) == 0
        assert jax_cli(["build-variant", "-i", str(jax_index), "-o", str(jax_file),
                        "--variant", v]) == 0
        files[v] = (port_file, jax_file)
    files["plain-matrix"] = (jax_index, jax_index)
    return files


@pytest.mark.parametrize("variant", VARIANTS)
def test_build_variant_then_lf_matches_jax(corpus, variant_files, variant):
    """The port's file equals the JAX CLI's, and the port's LF answers on it
    equal the JAX CLI's answers, which do not depend on the variant
    (tests/test_variants.py)."""
    tmp, _, queries, _, jax_bytes = corpus
    port_file, jax_file = variant_files[variant]
    assert port_file.read_bytes() == jax_file.read_bytes()
    out = tmp / f"lf_{variant}.txt"
    assert port_cli(["search", "-i", str(port_file), "-q", str(queries), "-o", str(out),
                     "--engine", "lf", *CPU]) == 0
    assert out.read_bytes() == jax_bytes


@pytest.mark.parametrize("variant", VARIANTS)
def test_golden_bytes_on_every_variant(golden_index, tmp_path, variant):
    index = tmp_path / "v.sbwt"
    assert port_cli(["build-variant", "-i", str(golden_index), "-o", str(index),
                     "--variant", variant, *CPU]) == 0
    q = _write(tmp_path / "q.fq", QUERIES)
    for engine in ("lf", "auto", "turbo3"):
        out = tmp_path / f"o_{engine}.txt"
        assert port_cli(["search", "-i", str(index), "-q", str(q), "-o", str(out),
                         "--engine", engine, *CPU]) == 0
        assert out.read_text() == GOLDEN


@pytest.mark.parametrize("variant,fmt", [("mef-split", "cpp"), ("rrr-subsetwt", "native")])
def test_build_with_variant_matches_jax(corpus, variant, fmt, capsys):
    """build --variant fills the precalc table over the variant's own ranks
    (K1's variant instance); auto then builds the turbo table from them
    and says so."""
    tmp, genome, queries, _, jax_bytes = corpus
    common = ["-i", str(genome), "-k", "31", "-p", "5", "--temp-dir", str(tmp),
              "--variant", variant, "--format", fmt]
    port_file, jax_file = tmp / f"built_{variant}.sbwt", tmp / f"built_{variant}_jax.sbwt"
    assert port_cli(["build", "-o", str(port_file), *common, *CPU]) == 0
    assert jax_cli(["build", "-o", str(jax_file), *common]) == 0
    assert port_file.read_bytes() == jax_file.read_bytes()
    out = tmp / f"built_{variant}.txt"
    capsys.readouterr()
    assert port_cli(["search", "-i", str(port_file), "-q", str(queries), "-o", str(out), *CPU]) == 0
    assert "Turbo successor engine enabled (arity 3)" in capsys.readouterr().err
    assert out.read_bytes() == jax_bytes


@pytest.mark.parametrize("engine", ["turbo", "turbo1", "turbo2", "turbo3", "auto"])
@pytest.mark.parametrize("variant", ["rrr-matrix", "mef-split", "plain-concat", "rrr-subsetwt"])
def test_turbo_on_variant_matches_jax_cli(corpus, variant_files, capsys, variant, engine):
    """search with a turbo engine on a compressed-variant file: exit 0 and
    the JAX CLI's bytes, which depend neither on the engine nor on the
    variant (tests/test_variant_turbo.py; test_jax_cli_turbo_on_variant
    runs the JAX CLI itself on one)."""
    tmp, _, queries, _, jax_bytes = corpus
    out = tmp / f"turbo_{variant}_{engine}.txt"
    capsys.readouterr()
    assert port_cli(["search", "-i", str(variant_files[variant][0]), "-q", str(queries),
                     "-o", str(out), "--engine", engine, *CPU]) == 0
    arity = {"turbo1": 1, "turbo2": 2}.get(engine, 3)
    assert f"Turbo successor engine enabled (arity {arity})" in capsys.readouterr().err
    assert out.read_bytes() == jax_bytes


def test_jax_cli_turbo_on_variant(corpus, variant_files):
    """The JAX CLI on a compressed variant with a turbo engine: exit 0 and
    the same bytes as on plain-matrix, which the test above holds the port to."""
    tmp, _, queries, _, jax_bytes = corpus
    ref = tmp / "jax_turbo1_rrr-matrix.txt"
    assert jax_cli(["search", "-i", str(variant_files["rrr-matrix"][1]), "-q", str(queries),
                    "-o", str(ref), "--engine", "turbo1"]) == 0
    assert ref.read_bytes() == jax_bytes


def test_turbo_on_variant_without_room_degrades_to_lf(corpus, variant_files, monkeypatch, capsys):
    from sbwt_tpu_torch.models import sbwt as facade

    monkeypatch.setattr(facade, "device_free_bytes", lambda device: 1 << 10)
    tmp, _, queries, _, jax_bytes = corpus
    out = tmp / "variant_no_room.txt"
    assert port_cli(["search", "-i", str(variant_files["mef-concat"][0]), "-q", str(queries),
                     "-o", str(out), "--engine", "turbo", *CPU]) == 0
    assert "Turbo table exceeds free device memory; using LF engine" in capsys.readouterr().err
    assert out.read_bytes() == jax_bytes


@pytest.mark.parametrize("argv,message", [
    (["build", "--variant", "nope"], "unknown variant"),
    (["build-variant", "--variant", "nope"], "unknown variant"),
    (["build-variant", "--variant", "rrr-split"], "not a plain-matrix"),
    (["ascii-export"], "Error: ascii export not supported for mef variants"),
], ids=["unknown-variant", "build-variant-unknown", "build-variant-input", "ascii-export"])
def test_not_ported_paths_exit_1(corpus, variant_files, capsys, argv, message):
    tmp, genome, queries, jax_index, _ = corpus
    compressed = str(variant_files["mef-concat"][0])
    files = {"search": ["-i", compressed, "-q", str(queries), "-o", str(tmp / "x.txt")],
             "build": ["-i", str(genome), "-o", str(tmp / "x.sbwt"), "-k", "31"],
             "build-variant": ["-i", compressed if "rrr-split" in argv else str(jax_index),
                               "-o", str(tmp / "y.sbwt")],
             "ascii-export": ["-i", compressed, "-o", str(tmp / "x_export.txt")]}
    assert port_cli(argv[:1] + files.get(argv[0], []) + argv[1:] + CPU) == 1
    assert message in capsys.readouterr().err


def test_ascii_export_golden_index_matches_jax_cli(golden_index, tmp_path):
    """The reference's golden index (tests/test_cli.py:106): the port's
    export equals the JAX CLI's bytes."""
    port_out, jax_out = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert port_cli(["ascii-export", "-i", str(golden_index), "-o", str(port_out), *CPU]) == 0
    assert jax_cli(["ascii-export", "-i", str(golden_index), "-o", str(jax_out)]) == 0
    text = port_out.read_text()
    assert text.startswith("version: v0.1\nk: 6\n") and "number_of_sets:" in text
    assert port_out.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("variant", [v for v in VARIANTS if not v.startswith("mef-")])
def test_ascii_export_matches_jax_cli(corpus, variant_files, variant):
    """Each non-mef variant's file, written by the port, exported by the
    port; the same variant's file written and exported by the JAX CLI."""
    tmp = corpus[0]
    port_file, jax_file = variant_files[variant]
    port_out, jax_out = tmp / f"export_port_{variant}.txt", tmp / f"export_jax_{variant}.txt"
    assert port_cli(["ascii-export", "-i", str(port_file), "-o", str(port_out), *CPU]) == 0
    assert jax_cli(["ascii-export", "-i", str(jax_file), "-o", str(jax_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert port_out.read_text().count("\n") == 5


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v.startswith("mef-")])
def test_ascii_export_refuses_mef_as_the_jax_cli(corpus, variant_files, capsys, variant):
    tmp = corpus[0]
    port_file, jax_file = variant_files[variant]
    out = tmp / f"export_{variant}.txt"
    capsys.readouterr()
    assert port_cli(["ascii-export", "-i", str(port_file), "-o", str(out), *CPU]) == 1
    port_err = capsys.readouterr().err
    assert jax_cli(["ascii-export", "-i", str(jax_file), "-o", str(out)]) == 1
    jax_err = capsys.readouterr().err
    errors = [[ln for ln in err.splitlines() if ln.startswith("Error")] for err in (port_err, jax_err)]
    assert errors[0] == errors[1] == ["Error: ascii export not supported for mef variants"]
    assert not out.exists()


def test_cuda_device_without_cuda_is_an_error(corpus, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp, _, queries, jax_index, _ = corpus
    assert port_cli(["search", "-i", str(jax_index), "-q", str(queries),
                     "-o", str(tmp / "y.txt")]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
