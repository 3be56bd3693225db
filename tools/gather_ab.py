"""Time K21 gather_chain (``ops.gather_chain.gather_chain``,
csrc/gather_chain.cu) of one checkout of the repository on the card, for
comparing two commits on the same card in one run:

    python3 tools/gather_ab.py <checkout root> [--sass <file>]

The input is the same for every checkout: chip_smoke.py's probe tables
(``probe_tables`` of this tree's chip_smoke.py: [2M, 2] and [2M, 8], 16
and 64 MB, and [2^26, 2] and [2^26, 8], 512 MB and 2 GB, random words from
torch seed 0 on the card) and its 65,536 start indices, 64 steps. At each
table it times the probe's shape as chip_smoke.py does (the same start
indices every launch, so rows of a table past L2 may hit in L2 from the
launch before) and with fresh start indices every launch (``fresh``: cold
rows), and at 0 steps (the launch's fixed cost: the start indices read,
the answers written); then 32 lanes at 64 and at 320 steps and a lane
sweep of 132 x 32, 2^14, 2^16, 2^18 and 2^20 lanes at 64 steps, each
launch from fresh start indices. Start indices come from torch seed 1,
drawn in a fixed order. Each case is six means of five launches by CUDA
events, each group queued behind a 2 ms spin of the card; the last output
is held to the plain version's and its checksum printed, which must be
equal across checkouts. From each table's sweep (the medians of the six
means) it prints the unloaded step latency, (t(32 lanes, 320 steps) - t(32
lanes, 64 steps)) / 256, the saturated rate, the most dependent gathers a
second of any sweep point, and the ceiling at the probe's shape, max(64 x
latency, 65,536 x 64 / rate), beside the byte bound (chip_smoke.py's: the
distinct rows the probe's chains read, idx0 and the answers). Then the registers and spill bytes of both
instances from nvcc's -Xptxas -v log and the build's seconds. With --sass
it writes cuobjdump's SASS of the checkout's csrc/gather_chain.cu,
compiled alone with the library's flags, to <file>. Run the parent and the
change in turns (parent, change, change, parent).
"""
import argparse
import importlib.util
import itertools
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ARGS = argparse.ArgumentParser()
ARGS.add_argument("checkout")
ARGS.add_argument("--sass", type=Path, help="write the SASS of gather_chain.cu here")
args = ARGS.parse_args()
sys.path.insert(0, args.checkout)
import torch  # noqa: E402

import ab_common  # noqa: E402
from sbwt_tpu_torch import kernels  # noqa: E402
from sbwt_tpu_torch.ops import gather_chain as gc  # noqa: E402

# the probe's tables come from this tree's chip_smoke.py, whichever checkout is timed
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

STEPS, LONG_STEPS = smoke.PROBE_STEPS, 320
SWEEP_LANES = (32, 132 * 32, 1 << 14, 1 << 16, 1 << 18, 1 << 20)


def sass(checkout: Path, out: Path) -> None:
    """cuobjdump -sass of the checkout's gather_chain.cu compiled alone."""
    nvcc = kernels._nvcc()
    csrc = checkout / "sbwt_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as d:
        cubin = Path(d) / "gather_chain.cubin"
        flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *flags, "-cubin", "-I", str(csrc), "-o", str(cubin),
                        str(csrc / "gather_chain.cu")], check=True, capture_output=True)
        dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout
    out.write_text(dump)


lib, nvcc_seconds = kernels.build()
regs = {("w8" if "ILi8E" in entry else "w2"): f"{r}/{spill}"
        for entry, r, spill in ab_common.ptxas_entries(lib.with_suffix(".log").read_text())
        if "gather_chain_kernel" in entry}
if args.sass:
    sass(Path(args.checkout), args.sass)
dev = torch.device("cuda", 0)
tables, idx0 = smoke.probe_tables(dev)
g = torch.Generator(device=dev).manual_seed(1)
fields, derived = [], []


def fresh(rows: int, lanes: int) -> list:
    """Start indices for each launch of ab_common.mean_ms's six groups of
    five and its warm-up."""
    return [torch.randint(0, rows, (lanes,), dtype=torch.int32, device=dev, generator=g)
            for _ in range(31)]


def timed(name, tbl, starts, steps):
    """The six means of the chain, launch i from starts[i % len(starts)],
    the last output checked; their median."""
    order = itertools.cycle(starts)
    last = []

    def chain():
        last[:] = [next(order)]
        return gc.gather_chain(tbl, last[0], steps)

    res, out = ab_common.mean_ms(chain)
    assert torch.equal(out, gc.gather_chain_plain(tbl, last[0], steps)), f"{name}: differs from plain"
    fields.append(f"{name}_ms={res} {name}_checksum={int(out.sum(dtype=torch.int64))}")
    return statistics.median(res)


for (rows, width), tbl in tables.items():
    table = f"r{rows}_w{width}"
    probe_ms = timed(table, tbl, [idx0], STEPS)
    fresh_ms = timed(f"{table}_fresh", tbl, fresh(rows, len(idx0)), STEPS)
    fixed_ms = timed(f"{table}_steps0", tbl, [idx0], 0)
    # 32 lanes first, while a table that fits L2 is resident from the probe
    # (the plain version's checks of the wide sweep points evict it)
    short_ms = timed(f"{table}_lanes32", tbl, fresh(rows, 32), STEPS)
    long_ms = timed(f"{table}_lanes32_steps{LONG_STEPS}", tbl, fresh(rows, 32), LONG_STEPS)
    rate = 32 * STEPS / (short_ms / 1e3)
    for lanes in SWEEP_LANES[1:]:
        ms = timed(f"{table}_lanes{lanes}", tbl, fresh(rows, lanes), STEPS)
        rate = max(rate, lanes * STEPS / (ms / 1e3))
    latency_ns = (long_ms - short_ms) / (LONG_STEPS - STEPS) * 1e6
    ceiling_ms = max(STEPS * latency_ns / 1e6, len(idx0) * STEPS / rate * 1e3)
    rows_read = smoke.chain_rows_read(tbl, idx0, STEPS)
    bound_ms = (rows_read * width * 4 + 2 * 4 * len(idx0)) / smoke.HBM_BYTES_PER_S * 1e3
    derived.append(f"{table}_rows_read={rows_read} {table}_byte_bound_ms={bound_ms} "
                   f"{table}_probe_median_ms={probe_ms} {table}_fresh_median_ms={fresh_ms} "
                   f"{table}_steps0_median_ms={fixed_ms} {table}_step_latency_ns={latency_ns} "
                   f"{table}_saturated_gathers_per_s={rate} {table}_ceiling_ms={ceiling_ms}")
print(f"AB {args.checkout} nvcc_seconds={nvcc_seconds:.1f} "
      + " ".join(f"regs_spill_{k}={v}" for k, v in sorted(regs.items())) + " "
      + " ".join(derived) + " " + " ".join(fields), flush=True)
