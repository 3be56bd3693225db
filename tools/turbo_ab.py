"""Time K4 (``kernels.turbo_stream``) of one checkout of the repository on
the card, for comparing two commits on the same card in one run:

    python3 tools/turbo_ab.py <checkout root>

The input is the same for every checkout: chip_smoke.py's index (the 4 Mbp
uniform random genome of numpy seed 20260817, k = 30, precalc_k = 13, built
on the card) and its two batches of 2^20 reads of 100 bp (numpy seeds 2 and
3; hit98 with 2% random reads, hit0 all random). For each batch it prints
the mean device time of five launches, three times, by CUDA events, of K4
of plain-matrix over the flat arity-3 table (``turbo``), of K4 of one
compressed variant (rrr-split) over its own arity-3 table (``variant``) and
of K20b, plain-matrix over the flat table cut into four row shards on this
card (``sharded``), and a checksum of the answers; then the registers and
shared memory per block of the flat plain-matrix K4 (nvcc's -Xptxas -v log;
the dynamic shared memory from the library where it has the query). Run
the parent and the change in turns (parent, change, change, parent).
"""
import re
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.models.sbwt import SBWT  # noqa: E402
from sbwt_tpu_torch.ops import turbo as tt  # noqa: E402
from sbwt_tpu_torch.parallel import sharded  # noqa: E402

K, READ_LEN, N_READS, VARIANT, SHARDS = 30, 100, 1 << 20, "rrr-split", 4
lib, _ = kernels.build()
# registers and static shared memory ptxas gave the flat plain-matrix instance
entry, registers, static_smem = None, None, 0
for line in lib.with_suffix(".log").read_text().splitlines():
    if "Compiling entry function" in line:
        entry = line
    elif "Used" in line and "registers" in line and entry and \
            "turbo_stream_kernelINS_11PlainMatrixENS_9FlatTable" in entry and \
            "Lb1E" not in entry:  # not the instance that counts its work
        registers = line.split("Used")[1].split("registers")[0].strip()
        if m := re.search(r"(\d+) bytes smem", line):
            static_smem = int(m.group(1))
dynamic_smem = (kernels.turbo_smem_bytes(K, 3) if hasattr(kernels, "turbo_smem_bytes") else 0)
dev = torch.device("cuda", 0)
genome = np.random.default_rng(20260817).integers(0, 4, size=4_000_000, dtype=np.int8)
sb = SBWT.build_on_device([genome], K, dev, precalc_k=13)
assert sb.enable_turbo(3) == 3
di, turbo = sb.device_index, sb._turbo
vs = sb.to_variant(VARIANT)
vdi = vs.device_index
vturbo = tt.build_turbo(vdi, 3)
view = sharded.shard_turbo_rows(turbo, sharded.make_mesh(1, SHARDS, [dev])).views[0]
engines = {
    "turbo": lambda c, n: tt.turbo_streaming_search(turbo, di, c, n),
    "variant": lambda c, n: tt.turbo_streaming_search(vturbo, vdi, c, n),
    "sharded": lambda c, n: sharded.tp_turbo_block(view, di, c, n),
}
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
    for name, fn in engines.items():
        out = fn(codes, lengths)
        torch.cuda.synchronize()
        res = []
        for _ in range(3):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5):
                del out
                out = fn(codes, lengths)
            e.record()
            e.synchronize()
            res.append(s.elapsed_time(e) / 5)
        want = out if want is None else want
        assert torch.equal(out, want), f"{name} {mix}: answers differ from plain-matrix K4's"
        fields.append(f"{name}_{mix}_ms={res}")
        del out
    fields.append(f"{mix}_checksum={int(want.sum(dtype=torch.int64))}")
assert kernels.LAUNCHES["turbo_stream[plain-matrix]"] == 2 * 16
assert kernels.LAUNCHES[f"turbo_stream[{VARIANT}]"] == 2 * 16
assert kernels.LAUNCHES[kernels.TURBO_SHARDED] == 2 * 16
print(f"AB {sys.argv[1]} k4_registers={registers} k4_static_smem={static_smem} "
      f"k4_dynamic_smem_per_block={dynamic_smem} " + " ".join(fields), flush=True)
