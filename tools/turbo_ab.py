"""Time K4 (``kernels.turbo_stream`` of plain-matrix over the flat arity-3
table) of one checkout of the repository on the card, for comparing two
commits on the same card in one run:

    python3 tools/turbo_ab.py <checkout root>

The input is the same for every checkout: chip_smoke.py's index (the 4 Mbp
uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13, built
on the card) and its two batches of 2^20 reads of 100 bp (numpy seeds 2 and
3; hit98 with 2% random reads, hit0 all random). Prints the mean device
time of five launches, three times for each batch, by CUDA events, and a
checksum of the answers. Run the parent and the change in turns (parent,
change, change, parent).
"""
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.models.sbwt import SBWT  # noqa: E402
from sbwt_tpu_torch.ops import turbo as tt  # noqa: E402

K, READ_LEN, N_READS = 30, 100, 1 << 20
lib, _ = kernels.build()
# the registers ptxas gave the flat plain-matrix instance (nvcc's -Xptxas -v log)
entry, registers = None, None
for line in lib.with_suffix(".log").read_text().splitlines():
    if "Compiling entry function" in line:
        entry = line
    elif "Used" in line and "registers" in line and entry and \
            "turbo_stream_kernelINS_11PlainMatrixENS_9FlatTable" in entry:
        registers = line.split("Used")[1].split("registers")[0].strip()
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
sb = SBWT.build_on_device([genome], K, dev, precalc_k=13)
assert sb.enable_turbo(3) == 3
fields = []
for seed, (mix, frac) in enumerate((("hit98", 0.02), ("hit0", 1.0)), start=2):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - READ_LEN, size=N_READS)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    rows = rng.choice(N_READS, size=int(N_READS * frac), replace=False)
    codes[rows] = rng.integers(0, 4, size=(len(rows), READ_LEN), dtype=np.int8)
    codes = torch.from_numpy(codes).to(dev)
    lengths = torch.full((N_READS,), READ_LEN, dtype=torch.int32, device=dev)
    out = tt.turbo_streaming_search(sb._turbo, sb.device_index, codes, lengths)
    torch.cuda.synchronize()
    res = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(5):
            del out
            out = tt.turbo_streaming_search(sb._turbo, sb.device_index, codes, lengths)
        e.record()
        e.synchronize()
        res.append(s.elapsed_time(e) / 5)
    fields.append(f"turbo_{mix}_ms={res} {mix}_checksum={int(out.sum(dtype=torch.int64))}")
assert kernels.LAUNCHES["turbo_stream[plain-matrix]"] == 2 * 16
print(f"AB {sys.argv[1]} k4_registers={registers} " + " ".join(fields), flush=True)
