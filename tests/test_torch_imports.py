"""The port never imports JAX, and CPU runs never launch a kernel.

A fresh interpreter imports every module of sbwt_tpu_torch and runs the
CPU slice (build, precalc, turbo tables, streaming and k-mer search, file
round trip) and a variant slice (build --variant, re-encoding, the LF
engine, the variant's own precalc fill, its files); afterwards no ``jax``
module may be loaded and every kernel launch counter must still be 0. The
kernel loader's sources must exist, and a wrapper handed CPU tensors must
refuse them rather than fall back.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

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
from sbwt_tpu.utils.dna import encode_query

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
print(json.dumps({
    "modules": len(mods),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "launches": kernels.LAUNCHES,
    "arity": arity,
    "hit": float((ans >= 0).mean()),
    "kmer_hits": int((kmers >= 0).sum()),
    "roundtrip": same,
    "variants": variants_same,
}))
"""


def test_cpu_slice_imports_no_jax_and_launches_nothing():
    # one torch thread, as in the test workers (torch_state.py)
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == []
    assert out["modules"] >= 12
    assert set(out["launches"]) == set(kernels.LAUNCHES)
    assert all(v == 0 for v in out["launches"].values())
    assert out["arity"] == 3 and out["roundtrip"] and out["variants"]
    assert 0.5 < out["hit"] < 1.0 and out["kmer_hits"] > 0


def test_package_source_never_names_jax():
    for path in PKG.rglob("*.py"):
        if kernels.BUILD_DIR in path.parents:
            continue  # build outputs, not package source
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            assert not (words[:1] == ["import"] and "jax" in words[1:2]), (path, line)
            assert not (words[:1] == ["from"] and words[1:2] == ["jax"]), (path, line)
            assert "import jax" not in line, (path, line)


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


@pytest.mark.parametrize("call", [
    lambda t: kernels.precalc_fill("plain-matrix", _rank_desc("plain-matrix"), t["C"], 10, 2),
    lambda t: kernels.kmer_search("plain-matrix", _rank_desc("plain-matrix"), t["C"], 10,
                                  t["pre"], 0, t["codes"]),
    lambda t: kernels.succ1(t["rank"], 1, t["sgs"], t["C"], 10),
    lambda t: kernels.succ_compose(torch.zeros((4, 10), dtype=torch.int32), 3),
    lambda t: kernels.seed_bits(t["pre"], 1),
    lambda t: kernels.turbo_stream(t["rank"], 1, t["rank"], 1, t["C"], t["pre"], 1, None,
                                   t["codes"], torch.full((2,), 5, dtype=torch.int32), 5),
    lambda t: kernels.lf_stream("rrr-split", _rank_desc(), t["sgs"], t["C"], t["pre"], 1, 5, 10,
                                t["codes"], torch.full((2,), 5, dtype=torch.int32)),
    lambda t: kernels.precalc_fill("rrr-split", _rank_desc(), t["C"], 10, 2),
    lambda t: kernels.kmer_search("rrr-split", _rank_desc(), t["C"], 10, t["pre"], 1, t["codes"]),
], ids=["precalc_fill", "kmer_search", "succ1", "succ_compose", "seed_bits", "turbo_stream",
        "lf_stream", "variant_precalc_fill", "variant_kmer_search"])
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
    assert len(lf) == 3 * 10
    for op in kernels.LF_OPS:
        assert kernels.lf_counter(op, "plain-matrix") in lf
    assert set(kernels.RANK_DESCS) == set(kernels.VARIANTS) == set(kernels.FAMILY)
    for fam in set(kernels.FAMILY.values()):
        src = "lf_stream.cu" if fam == "matrix" else f"lf_{fam}.cu"
        assert f"sbwt_lf_{fam}(" in (kernels.CSRC / src).read_text()
