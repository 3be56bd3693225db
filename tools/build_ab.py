"""Time K19, the on-device build (csrc/build_sbwt.cu), of one checkout of
the repository on the card, for comparing two commits on the same card in
one run:

    python3 tools/build_ab.py <checkout root>

The input is the same for every checkout: chip_smoke.py's genome (4 Mbp,
uniform random, numpy seed 20260817) at k = 30, its codes on the card.
At the genome build's shapes it times each of K19's four kernels
(``pack_windows`` over the codes, ``edge_src_probe`` over the 3,999,971
sorted distinct k-mers, ``emit_dummies`` over the sources,
``finalize_tables`` over the merged nodes), beside them
``torch.searchsorted`` of the k-mers' predecessor keys in the masked list
with the equality gather (chip_smoke.py's yardstick of edge_src_probe,
the same code in every checkout), and the whole device build
(``construct.device.build_sbwt_device`` from the codes, no precalc). Each
is six means of five launches by CUDA events, each group queued behind a
2 ms spin of the card. It prints checksums of the outputs, which must be
equal across checkouts, the registers and spill bytes of each
edge_src_probe instance from nvcc's -Xptxas -v log, and the build's
seconds. Run the parent and the change in turns (parent, change, change,
parent).
"""
import importlib.util
import re
import sys
from pathlib import Path

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.construct import device as td  # noqa: E402

K = 30
SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1,980 MHz
# the yardstick comes from this tree's chip_smoke.py, whichever checkout is timed
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def ptxas(log: str) -> dict:
    """'edge_src_probe_<word capacity>' -> 'registers/spill bytes'."""
    out, entry, spill = {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            if w := re.search(r"edge_src_probe_kernelILi(\d+)E", entry):
                out[f"edge_src_probe_{w.group(1)}"] = f"{m.group(1)}/{spill}"
    return out


def mean_ms(fn):
    """Six means of five launches of fn by CUDA events, and its last output."""
    out = fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(6):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        for _ in range(5):
            del out
            out = fn()
        e.record()
        e.synchronize()
        res.append(s.elapsed_time(e) / 5)
    return res, out


def checksum(out) -> int:
    if isinstance(out, (tuple, list)):
        return sum(checksum(t) for t in out if t is not None)
    return int(out.sum(dtype=torch.int64))


lib, nvcc_seconds = kernels.build()
regs = ptxas(lib.with_suffix(".log").read_text())
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
codes = td.prepare_device_codes([genome], K, dev)
dv = td.sorted_distinct_kmers(codes, K)
probe = kernels.edge_src_probe(dv, K)
src = dv[probe[2]]
nodes = td.merged_nodes(td.dummy_nodes(src, K), dv, probe[0], K)
library, _ = smoke.searchsorted_probe(dv, K)
fields = []
for name, fn in (("pack_windows", lambda: kernels.pack_windows(codes, K)),
                 ("edge_src_probe", lambda: kernels.edge_src_probe(dv, K)),
                 ("searchsorted", library),
                 ("emit_dummies", lambda: kernels.emit_dummies(src, K)),
                 ("finalize_tables", lambda: kernels.finalize_tables(*nodes, K, True)),
                 ("device_build", lambda: td.build_sbwt_device(None, K, dev, prepared=codes))):
    res, out = mean_ms(fn)
    if name == "device_build":
        out = (out.rank_tbl, out.sgs_tbl, out.C)
    fields.append(f"{name}_ms={res} {name}_checksum={checksum(out)}")
    del out
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} n_kmers={len(dv)} sources={len(src)} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
