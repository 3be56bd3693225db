"""Time K2's succ1 over all columns (``ops.turbo.succ1``) of one checkout of
the repository on the card, for comparing two commits on the same card in
one run:

    python3 tools/succ_ab.py <checkout root>

The input is the same for every checkout: tools/search_ab.py's index (the
4 Mbp uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13,
built on the card: 4,000,001 columns) and its nine compressed variants.
For plain-matrix and each variant it prints the mean device time of five
launches, six times, by CUDA events (each group queued behind a 2 ms spin
of the card), and a checksum of the successors, which must be equal across
the instances (the run fails otherwise) and across checkouts; then the
registers and spill bytes of each instance's succ1 kernel (the whole-table
span kernel where the checkout has one, else the one-thread-a-column
kernel) from nvcc's -Xptxas -v log, and the build's seconds. Run the parent
and the change in turns (parent, change, change, parent).
"""
import re
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.models.sbwt import SBWT  # noqa: E402
from sbwt_tpu_torch.ops import turbo as tt  # noqa: E402

K, P = 30, 13
SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1,980 MHz
VARIANTS = ("rrr-matrix", "mef-matrix", "plain-split", "rrr-split", "mef-split", "plain-concat",
            "mef-concat", "plain-subsetwt", "rrr-subsetwt")
# mangled rank types, as ptxas names the instances
MANGLED = {"plain-matrix": "11PlainMatrix", "rrr-matrix": "10MatrixRankINS_5RRR15",
           "mef-matrix": "10MatrixRankINS_3MEF", "plain-split": "9SplitRankINS_7PlainBV",
           "rrr-split": "9SplitRankINS_5RRR15", "mef-split": "9SplitRankINS_3MEF",
           "plain-concat": "10ConcatRankINS_7PlainBV", "mef-concat": "10ConcatRankINS_5RRR15",
           "plain-subsetwt": "12SubsetWTRankINS_7PlainBV",
           "rrr-subsetwt": "12SubsetWTRankINS_5RRR15"}


def ptxas(log: str) -> dict:
    """rank type -> 'registers/spill bytes' of its succ1 kernels: the span
    kernel's where it is compiled (it serves all columns), else the one
    thread a column kernel's."""
    lane, span, entry, spill = {}, {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            for name, mangled in MANGLED.items():
                if re.search(rf"\d+succ1_kernelINS_{mangled}E", entry):
                    lane[name] = f"{m.group(1)}/{spill}"
                elif re.search(rf"\d+succ1_span_kernelINS_{mangled}E", entry):
                    span[name] = f"span:{m.group(1)}/{spill}"
    return {**lane, **span}


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


lib, nvcc_seconds = kernels.build()
regs = ptxas(lib.with_suffix(".log").read_text())
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
sb = SBWT.build_on_device([genome], K, dev, precalc_k=P)
indexes = {"plain-matrix": sb.device_index, **{v: sb.to_variant(v).device_index for v in VARIANTS}}
fields, want = [], None
for name, index in indexes.items():
    res, out = mean_ms(lambda: tt.succ1(index))
    got = int(out.sum(dtype=torch.int64))
    want = got if want is None else want
    assert got == want, f"{name}: successors differ from plain-matrix's"
    fields.append(f"{name}_succ1_ms={res}")
    del out
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} succ1_checksum={want} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
