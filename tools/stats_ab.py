"""Time K3 (``kernels.seed_bits``), K13 (``kernels.answer_stats``) and K4
(``kernels.turbo_stream``) of one checkout of the repository on the card,
for comparing two commits on the same card in one run:

    python3 tools/stats_ab.py <checkout root>

The input is the same for every checkout: chip_smoke.py's index (the 4 Mbp
uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13, built
on the card) and its two batches of 2^20 reads of 100 bp (numpy seeds 2 and
3; hit98 with 2% random reads, hit0 all random). It prints the mean device
time of five launches, three times, by CUDA events, of the seed bits of the
p = 13 table, narrow (int32 [4^13, 2]) and wide (the same table as int64),
with a checksum of the words; for each batch, of K4 over the arity-3 table
with a checksum of its answers, and of the two PyTorch calls that reduce
its answers (``torch.sum`` in int64 and the count of answers >= 0) beside
K13 where the checkout has it, on the int32 answers and on the same answers
as int64. Last the registers and spill bytes of each timed kernel from
nvcc's -Xptxas -v log. Run the parent and the change in turns (parent,
change, change, parent).
"""
import re
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.models.sbwt import SBWT  # noqa: E402
from sbwt_tpu_torch.ops import turbo as tt  # noqa: E402

K, P, READ_LEN, N_READS = 30, 13, 100, 1 << 20
# the timed kernels, as ptxas names them (the parent's seed bits are one
# kernel, the change's two)
ENTRIES = {"seed_bits": "seed_bits_kernel", "live_bitmap": "live_bitmap_kernel",
           "pack_pairs": "pack_pairs_kernel", "answer_stats": "answer_stats_kernel",
           "k4": "turbo_stream_kernelINS_11PlainMatrixENS_9FlatTable"}
WIDTHS = {"IiE": "int", "IlE": "int64", "I4int2E": "int", "I9longlong2E": "int64"}


def ptxas(log: str) -> dict:
    """Timed kernel (and its instance's position type) -> 'registers/spill bytes'."""
    out, entry, spill = {}, "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            for name, mangled in ENTRIES.items():
                if mangled in entry and "Lb1E" not in entry:  # not a counting instance
                    width = next((w for t, w in WIDTHS.items() if t in entry), "")
                    out[f"{name}{'_' + width if width else ''}"] = f"{m.group(1)}/{spill}"
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
has_stats = hasattr(kernels, "answer_stats")
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
sb = SBWT.build_on_device([genome], K, dev, precalc_k=P)
assert sb.enable_turbo(3) == 3
di, turbo = sb.device_index, sb._turbo
fields = []
for name, precalc in (("seed_bits", di.precalc), ("seed_bits_wide", di.precalc.long())):
    res, out = mean_ms(lambda: kernels.seed_bits(precalc, P))
    assert torch.equal(out, turbo.seed_bits), f"{name}: differs from the table's seed bits"
    fields.append(f"{name}_ms={res} {name}_checksum={int(out.sum(dtype=torch.int64))}")
    del out
for seed, (mix, frac) in enumerate((("hit98", 0.02), ("hit0", 1.0)), start=2):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - READ_LEN, size=N_READS)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    rows = rng.choice(N_READS, size=int(N_READS * frac), replace=False)
    codes[rows] = rng.integers(0, 4, size=(len(rows), READ_LEN), dtype=np.int8)
    codes = torch.from_numpy(codes).to(dev)
    lengths = torch.full((N_READS,), READ_LEN, dtype=torch.int32, device=dev)
    res, ans = mean_ms(lambda: tt.turbo_streaming_search(turbo, di, codes, lengths))
    fields.append(f"k4_{mix}_ms={res} {mix}_checksum={int(ans.sum(dtype=torch.int64))}")
    for width, out in (("int", ans), ("int64", ans.long())):
        want = torch.stack([torch.sum(out, dtype=torch.int64), (out >= 0).sum()])
        res_sum, _ = mean_ms(lambda: torch.sum(out, dtype=torch.int64))
        res_hits, _ = mean_ms(lambda: (out >= 0).sum())
        fields.append(f"torch_sum_{mix}_{width}_ms={res_sum} "
                      f"torch_hits_{mix}_{width}_ms={res_hits}")
        if has_stats:
            res, got = mean_ms(lambda: kernels.answer_stats(out))
            assert torch.equal(got, want), f"answer_stats {mix} {width}: {got} != {want}"
            fields.append(f"answer_stats_{mix}_{width}_ms={res}")
        fields.append(f"{mix}_{width}_stats={want.tolist()}")
        del out
    del ans, codes
# the table build launched the narrow seed bits once more
assert kernels.LAUNCHES["seed_bits"] == 16 + 1
assert kernels.LAUNCHES[f"seed_bits[{kernels.WIDE}]"] == 16
assert kernels.LAUNCHES["turbo_stream[plain-matrix]"] == 2 * 16
print(f"AB {sys.argv[1]} nvcc_seconds={nvcc_seconds:.1f} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(fields), flush=True)
