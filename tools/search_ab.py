"""Time kmer_search (K1's search, K18b's, K20a's) and partial_search
(``kernels.kmer_search``, ``kernels.partial_search``) of one checkout of
the repository on the card, for comparing two commits on the same card in
one run:

    python3 tools/search_ab.py <checkout root>

The input is the same for every checkout: tools/lf_ab.py's index (the 4 Mbp
uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13,
built on the card), its nine compressed variants, the index forced onto the
wide tier (``wide``, int64) and plain-matrix cut into four row shards on
this card (``sharded``, kmer_search only); the first 30-mers of its two
batches of 2^20 reads (numpy seeds 2 and 3: hit98 with 2% random reads,
hit0 all random); chip_smoke.py's 2^20 partial-search lanes (the first 40
chars of the hit98 reads, lengths 0..40 from numpy seed 31), from the full
interval and, after each lane's first three chars, from the interval
plain-matrix reached there; and the giant of chip_smoke.py (the complete
order-16 de Bruijn graph, 4,294,967,297 columns, k = 16, p = 8): the first
16-mers of its 2^20 reads, and its 2^20 prefixes of 1..16 chars. Beside
them, K2's succ1 over the plain-matrix index's columns.

For each instance it prints the mean device time of five launches, six
times, by CUDA events, and the answers' checksums, which must be equal
across checkouts (and are equal across instances, or the run fails); then
the registers and spill bytes of each timed kernel from nvcc's -Xptxas -v
log and the build's seconds. Run the parent and the change in turns
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
from sbwt_tpu_torch.ops import search as ts  # noqa: E402
from sbwt_tpu_torch.ops import turbo as tt  # noqa: E402
from sbwt_tpu_torch.parallel import sharded  # noqa: E402

K, P, READ_LEN, N_READS, SHARDS, HEAD = 30, 13, 100, 1 << 20, 4, 3
SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1,980 MHz
VARIANTS = ("rrr-matrix", "mef-matrix", "plain-split", "rrr-split", "mef-split", "plain-concat",
            "mef-concat", "plain-subsetwt", "rrr-subsetwt")
# mangled rank types of the instances timed here, as ptxas names them
RANK_TYPES = {"plain": "11PlainMatrix", "rrr-matrix": "10MatrixRankINS_5RRR15",
              "mef-matrix": "10MatrixRankINS_3MEF", "plain-split": "9SplitRankINS_7PlainBV",
              "rrr-split": "9SplitRankINS_5RRR15", "mef-split": "9SplitRankINS_3MEF",
              "plain-concat": "10ConcatRankINS_7PlainBV", "mef-concat": "10ConcatRankINS_5RRR15",
              "plain-subsetwt": "12SubsetWTRankINS_7PlainBV",
              "rrr-subsetwt": "12SubsetWTRankINS_(5RRR15|11RRR15Staged)", "wide": "10WideMatrix",
              "sharded": "13ShardedMatrix"}


def ptxas(log: str) -> dict:
    """'kernel_instance' -> 'registers/spill bytes' of the timed kernels: the
    staged form's entry, or the one-thread-a-lane form's where an instance
    keeps it (one of the two is compiled)."""
    out, entry, spill = {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            for kern in ("kmer_search", "partial_search"):
                for name, mangled in RANK_TYPES.items():
                    if re.search(rf"\d+{kern}(_lane)?_kernelINS_{mangled}E", entry):
                        out[f"{kern}_{name}"] = f"{m.group(1)}/{spill}"
    return out


def mean_ms(fn):
    """Six means of five launches of fn by CUDA events, and its last output.
    Each group is queued behind a 2 ms spin of the card, so that the host's
    time to launch a call (tens of us) does not leave the card idle
    between the five launches."""
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
    if isinstance(out, tuple):
        return sum(int(t.sum(dtype=torch.int64)) for t in out)
    return int(out.sum(dtype=torch.int64))


lib, nvcc_seconds = kernels.build()
regs = ptxas(lib.with_suffix(".log").read_text())
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
sb = SBWT.build_on_device([genome], K, dev, precalc_k=P)
di = sb.device_index
words = di.rank_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32).reshape(4, di.n_words)
sgs_words = di.sgs_tbl[:, 0].contiguous().cpu().numpy().view(np.uint32)
wide = from_packed_rows_wide(words, di.n_nodes, sgs_words, K, di.n_kmers, dev, precalc_k=P)
view = sharded.shard_index_rows(di, sharded.make_mesh(1, SHARDS, [dev])).views[0]
indexes = {"plain": di, **{v: sb.to_variant(v).device_index for v in VARIANTS}, "wide": wide,
           "sharded": view}
runs = {}
for seed, (mix, frac) in enumerate((("hit98", 0.02), ("hit0", 1.0)), start=2):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - READ_LEN, size=N_READS)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    rows = rng.choice(N_READS, size=int(N_READS * frac), replace=False)
    codes[rows] = rng.integers(0, 4, size=(len(rows), READ_LEN), dtype=np.int8)
    runs[mix] = (codes, None)
lane_np, len_np, _ = smoke.lane_batch(runs)
lanes = torch.from_numpy(lane_np).to(dev)
lane_len = torch.from_numpy(len_np).to(dev)
head = ts.partial_search_batch(di, lanes[:, :HEAD].contiguous(), lane_len.clamp(max=HEAD))
start = torch.stack(head[:2], dim=1)
tail, tail_len = lanes[:, HEAD:].contiguous(), lane_len - HEAD
del head
kms = {mix: torch.from_numpy(np.ascontiguousarray(codes[:, :K])).to(dev)
       for mix, (codes, _) in runs.items()}
del runs

fields, want = [], {}


def timed(name: str, what: str, fn) -> None:
    res, out = mean_ms(fn)
    fields.append(f"{name}_{what}_ms={res}")
    got = checksum(out)
    if name == "giant":
        fields.append(f"giant_{what}_checksum={got}")
    else:
        want.setdefault(what, got)
        assert got == want[what], f"{name} {what}: answers differ from plain-matrix's"


timed("plain", "succ1", lambda: tt.succ1(di))  # beside them, a kernel this change leaves alone
for name, index in indexes.items():
    for mix, km in kms.items():
        timed(name, f"kmer_{mix}", lambda: ts.search_batch(index, km))
    if "partial_search" not in kernels.RANK_OPS[index.variant]:
        continue
    timed(name, "partial", lambda: ts.partial_search_batch(index, lanes, lane_len))
    st = start.to(index.pos_dtype)
    timed(name, "partial_start", lambda: ts.partial_search_batch(index, tail, tail_len, st))
fields += [f"{what}_checksum={v}" for what, v in want.items()]
del indexes, sb, di, wide, view, kms, lanes, lane_len, start, tail, tail_len
torch.cuda.empty_cache()

# the giant: its first 16-mers and prefixes, as chip_smoke.py's giant phase
rows, sgs, n, n_kmers = smoke.complete_dbg_packed(smoke.GIANT_K)
giant = SBWT.from_packed(rows, n, sgs, smoke.GIANT_K, n_kmers, dev,
                         precalc_k=smoke.GIANT_P).device_index
del rows, sgs
reads, _, prefix_len = smoke.giant_batches(dev)
gkm = torch.from_numpy(np.ascontiguousarray(reads[:, :smoke.GIANT_K])).to(dev)
plen = torch.from_numpy(prefix_len).to(dev)
timed("giant", "kmer", lambda: ts.search_batch(giant, gkm))
timed("giant", "partial", lambda: ts.partial_search_batch(giant, gkm, plen))
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
