"""Time fast_search (``ops.turbo.fast_search``, csrc/fast_search.cu) of one
checkout of the repository on the card, for comparing two commits on the
same card in one run:

    python3 tools/fast_search_ab.py <checkout root>

The input is the same for every checkout: tools/search_ab.py's index (the
4 Mbp uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13,
built on the card), its turbo tables of arity 1, 2 and 3 and the same index
forced onto the wide tier with its int64 arity-1 table (``wide``), and the
first 30-mers of search_ab.py's two batches of 2^20 reads (numpy seeds 2
and 3: hit98 with 2% random reads, hit0 all random). For each table and
batch it prints the mean device time of five launches, six times, by CUDA
events (each group queued behind a 2 ms spin of the card), and a checksum
of the answers and needs_slow, which must be equal across tables (the run
fails otherwise) and across checkouts; beside them K1's kmer_search of the
same rows on plain-matrix; then the registers and spill bytes of the two
fast_search instances from nvcc's -Xptxas -v log, and the build's seconds.
Run the parent and the change in turns (parent, change, change, parent).
"""
import re
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.models.sbwt import SBWT  # noqa: E402
from sbwt_tpu_torch.models.wide import from_packed_rows_wide  # noqa: E402
from sbwt_tpu_torch.ops import search as ts  # noqa: E402
from sbwt_tpu_torch.ops import turbo as tt  # noqa: E402

K, P, READ_LEN, N_READS = 30, 13, 100, 1 << 20
SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1,980 MHz


def ptxas(log: str) -> dict:
    """'narrow' / 'wide' -> 'registers/spill bytes' of fast_search_kernel<int> / <int64_t>."""
    out, entry, spill = {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and "fast_search_kernel" in entry:
            out["wide" if re.search(r"fast_search_kernelI[lx]E", entry) else "narrow"] = \
                f"{m.group(1)}/{spill}"
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


lib, nvcc_seconds = kernels.build()
regs = ptxas(lib.with_suffix(".log").read_text())
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
sb = SBWT.build_on_device([genome], K, dev, precalc_k=P)
di = sb.device_index
words = di.rank_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32).reshape(4, di.n_words)
sgs_words = di.sgs_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32)
wide = from_packed_rows_wide(words, di.n_nodes, sgs_words, K, di.n_kmers, dev, precalc_k=P)
tables = {f"arity{a}": tt.build_turbo(di, a) for a in (1, 2, 3)}
tables["wide"] = tt.build_turbo(wide, 1)
kms = {}
for seed, (mix, frac) in enumerate((("hit98", 0.02), ("hit0", 1.0)), start=2):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - READ_LEN, size=N_READS)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    rows = rng.choice(N_READS, size=int(N_READS * frac), replace=False)
    codes[rows] = rng.integers(0, 4, size=(len(rows), READ_LEN), dtype=np.int8)
    kms[mix] = torch.from_numpy(np.ascontiguousarray(codes[:, :K])).to(dev)
fields = []
for mix, km in kms.items():
    res, _ = mean_ms(lambda: ts.search_batch(di, km))
    fields.append(f"kmer_search_{mix}_ms={res}")
    want = None
    for name, turbo in tables.items():
        res, (ans, slow) = mean_ms(lambda: tt.fast_search(turbo, km))
        got = (int(ans.sum(dtype=torch.int64)), int(slow.sum()))
        want = got if want is None else want
        assert got == want, f"{name} {mix}: answers differ from arity 1's"
        fields.append(f"{name}_{mix}_ms={res}")
        del ans, slow
    fields.append(f"{mix}_checksum={want[0]} {mix}_needs_slow={want[1]}")
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
