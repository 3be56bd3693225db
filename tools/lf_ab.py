"""Time K14 (``kernels.lf_stream``) and K1's fill (``kernels.precalc_fill``)
of one checkout of the repository on the card, for comparing two commits
on the same card in one run:

    python3 tools/lf_ab.py <checkout root>

The input is the same for every checkout: chip_smoke.py's index (the 4 Mbp
uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13, built
on the card) and its two batches of 2^20 reads of 100 bp (numpy seeds 2 and
3; hit98 with 2% random reads, hit0 all random). For each batch it prints
the mean device time of five launches, three times, by CUDA events, of K14
on plain-matrix (``plain``), on each of the nine compressed variants
(``to_variant`` of the same index), on the index forced onto the wide tier
(``wide``, int64) and of K20a, plain-matrix cut into four row shards on
this card (``sharded``), and a checksum of the answers, which must be
equal for all twelve; then the p = 13 fill, narrow ([4^13, 2] int32) and
wide (int64), the same way, with the tables' checksums, and each
variant's fill at p = 8 and 12 (equal tables). Last the
registers and spill bytes of each timed instance from nvcc's -Xptxas -v
log, the build's seconds, and K14's dynamic shared memory per block where
the library has the query. Run the parent and the change in turns (parent, change, change,
parent).
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
from sbwt_tpu_torch.parallel import sharded  # noqa: E402

K, P, READ_LEN, N_READS, SHARDS = 30, 13, 100, 1 << 20, 4
VARIANTS = ("rrr-matrix", "mef-matrix", "plain-split", "rrr-split", "mef-split", "plain-concat",
            "mef-concat", "plain-subsetwt", "rrr-subsetwt")
# mangled rank types of the instances timed here, as ptxas names them (regular
# expressions: K1's fill runs rrr-subsetwt as SubsetWTRank<RRR15Staged> at p = 12)
RANK_TYPES = {"plain": "11PlainMatrix", "rrr-matrix": "10MatrixRankINS_5RRR15",
              "mef-matrix": "10MatrixRankINS_3MEF", "plain-split": "9SplitRankINS_7PlainBV",
              "rrr-split": "9SplitRankINS_5RRR15", "mef-split": "9SplitRankINS_3MEF",
              "plain-concat": "10ConcatRankINS_7PlainBV", "mef-concat": "10ConcatRankINS_5RRR15",
              "plain-subsetwt": "12SubsetWTRankINS_7PlainBV",
              "rrr-subsetwt": "12SubsetWTRankINS_(5RRR15|11RRR15Staged)", "wide": "10WideMatrix",
              "sharded": "13ShardedMatrix"}


def ptxas(log: str) -> dict:
    """(kernel, rank type) -> 'registers/spill bytes' of the timed instances."""
    out, entry, spill = {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and "ShardedTable" not in entry:
            for kern in ("lf_stream_kernel", "precalc_fill_kernel"):
                for name, mangled in RANK_TYPES.items():
                    timed = kern == "lf_stream_kernel" or name in ("plain", "wide")
                    counting = "Lb1E" in entry  # K14's instance that counts its work
                    if timed and kern in entry and re.search(mangled, entry) and not counting:
                        # the fill may have one instance a subtree depth D
                        d = re.search(r"kernelILi(\d+)E", entry)
                        key = f"{kern.split('_kernel')[0]}{'_d' + d.group(1) if d else ''}_{name}"
                        out[key] = f"{m.group(1)}/{spill}"
    return out


def mean_ms(fn):
    """Three means of five launches of fn by CUDA events, and its last output."""
    out = fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
smem = ({name: kernels.lf_smem_bytes(v, K) for name, v in
         (("plain", "plain-matrix"), ("mef-concat", "mef-concat"), ("wide", kernels.WIDE))}
        if hasattr(kernels, "lf_smem_bytes") else {})
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
fields = []
for seed, (mix, frac) in enumerate((("hit98", 0.02), ("hit0", 1.0)), start=2):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - READ_LEN, size=N_READS)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    rows = rng.choice(N_READS, size=int(N_READS * frac), replace=False)
    codes[rows] = rng.integers(0, 4, size=(len(rows), READ_LEN), dtype=np.int8)
    codes = torch.from_numpy(codes).to(dev)
    lengths = torch.full((N_READS,), READ_LEN, dtype=torch.int32, device=dev)
    want = None
    for name, index in indexes.items():
        res, out = mean_ms(lambda: ts.streaming_search(index, codes, lengths))
        want = out if want is None else want
        assert torch.equal(out.long(), want.long()), f"{name} {mix}: answers differ from plain-matrix K14's"
        fields.append(f"{name}_{mix}_ms={res}")
        del out
    fields.append(f"{mix}_checksum={int(want.sum(dtype=torch.int64))}")
    del want
for name, index in (("fill", di), ("fill_wide", wide)):
    desc = index.kernel_desc(dev)
    res, out = mean_ms(lambda: kernels.precalc_fill(index.variant, desc, index.C, index.n_nodes, P))
    assert torch.equal(out, index.precalc), f"{name}: differs from the index's table"
    fields.append(f"{name}_ms={res} {name}_checksum={int(out.sum(dtype=torch.int64))}")
    del out
# the fills a variant makes itself (p = 8, and 12, the largest it takes)
for p in (8, 12):
    want = None
    for name, index in indexes.items():
        if name in ("wide", "sharded"):
            continue
        desc = index.kernel_desc(dev)
        res, out = mean_ms(lambda: kernels.precalc_fill(index.variant, desc, index.C,
                                                        index.n_nodes, p))
        want = out if want is None else want
        assert torch.equal(out, want), f"{name} p = {p}: differs from plain-matrix's table"
        fields.append(f"fill{p}_{name}_ms={res}")
    fields.append(f"fill{p}_checksum={int(want.sum(dtype=torch.int64))}")
    del want, out
for name in ("plain-matrix", *VARIANTS, kernels.WIDE, kernels.SHARDED):
    assert kernels.LAUNCHES[kernels.lf_counter("lf_stream", name)] == 2 * 16, name
# the two index builds launched each fill once more
assert kernels.LAUNCHES["precalc_fill[plain-matrix]"] == 3 * 16 + 1
assert kernels.LAUNCHES[f"precalc_fill[{kernels.WIDE}]"] == 16 + 1
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} "
      + " ".join(f"k14_smem_per_block_{k}={v}" for k, v in smem.items()) + " "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
