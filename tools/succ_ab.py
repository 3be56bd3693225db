"""Time K2's succ1 over all columns (``ops.turbo.succ1``) of one checkout of
the repository on the card, for comparing two commits on the same card in
one run:

    python3 tools/succ_ab.py <checkout root>

The input is the same for every checkout: tools/search_ab.py's index (the
4 Mbp uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13,
built on the card: 4,000,001 columns), its nine compressed variants and the
index forced onto the wide tier (``wide``: all columns, [n, 4] int64, as
the forced-wide table build asks); then chip_smoke.py's giant (the
complete order-16 de Bruijn graph, 4,294,967,297 columns, built once a
run) over its 2^20 sampled columns (numpy seed 6), row-major as there,
and over 2^20 random columns of its first 2^27 (``giant_low``: the same
random loads past L2, on 1/32 of the table's pages).
For each it prints the mean device time of five launches, six times, by
CUDA events (each group queued behind a 2 ms spin of the card), and a
checksum of the successors, which must be equal across the 4M-column
instances (the run fails otherwise) and across checkouts; then the
registers and spill bytes of each instance's succ1 kernel (the whole-table
span kernel where the checkout has one, the wide tier's one-round kernel
where it has one, else the one-thread-a-column kernel) from nvcc's -Xptxas
-v log, and the build's seconds. Run the parent and the change in turns
(parent, change, change, parent).
"""
import re
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.models.sbwt import SBWT  # noqa: E402
from sbwt_tpu_torch.models.wide import from_packed_rows_wide  # noqa: E402
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
           "rrr-subsetwt": "12SubsetWTRankINS_5RRR15", "wide": "10WideMatrix"}


def ptxas(log: str) -> dict:
    """rank type -> 'registers/spill bytes' of its succ1 kernels: the span
    kernel's or the wide tier's one-round kernel's where it is compiled (it
    serves all columns), else the one thread a column kernel's."""
    lane, span, entry, spill = {}, {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            if "succ1_wide_kernel" in entry:
                span["wide"] = f"round:{m.group(1)}/{spill}"
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
di = sb.device_index
words = di.rank_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32).reshape(4, di.n_words)
sgs_words = di.sgs_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32)
indexes = {"plain-matrix": di, **{v: sb.to_variant(v).device_index for v in VARIANTS},
           "wide": from_packed_rows_wide(words, di.n_nodes, sgs_words, K, di.n_kmers, dev)}
fields, want = [], None
for name, index in indexes.items():
    wide = name == "wide"
    res, out = mean_ms(lambda: tt.succ1(index, row_major=wide))
    got = int(out.sum(dtype=torch.int64))
    want = got if want is None else want
    assert got == want, f"{name}: successors differ from plain-matrix's"
    fields.append(f"{name}_succ1_ms={res}")
    del out
del indexes, sb, di
torch.cuda.empty_cache()

# the giant's sampled columns, as chip_smoke.py's giant phase
rows, sgs, n, n_kmers = smoke.complete_dbg_packed(smoke.GIANT_K)
giant = SBWT.from_packed(rows, n, sgs, smoke.GIANT_K, n_kmers, dev,
                         precalc_k=smoke.GIANT_P).device_index
del rows, sgs
reads, _, _ = smoke.giant_batches(dev)
cols = torch.from_numpy(np.random.default_rng(6).integers(0, n, size=len(reads))).to(dev)
res, out = mean_ms(lambda: tt.succ1(giant, cols, row_major=True))
fields.append(f"giant_sampled_succ1_ms={res} giant_sampled_checksum={int(out.sum(dtype=torch.int64))}")
# the same count of random columns among the first 2^27 only: each plane's
# rows there are 50 MB, past L2 as the whole table is, on 1/32 of its pages
low = torch.from_numpy(np.random.default_rng(6).integers(0, 1 << 27, size=len(reads))).to(dev)
res, out = mean_ms(lambda: tt.succ1(giant, low, row_major=True))
fields.append(f"giant_low_succ1_ms={res} giant_low_checksum={int(out.sum(dtype=torch.int64))}")
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} succ1_checksum={want} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
