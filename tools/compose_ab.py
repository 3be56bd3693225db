"""Time K2's table composition (``kernels.succ_compose``, arity 3) of one
checkout of the repository on the card, for comparing two commits on the
same card in one run:

    python3 tools/compose_ab.py <checkout root>

The input is synthetic and the same for every checkout: succ [4, n] of
n = 4,000,001 columns from a seeded generator on the card, with three
quarters of the edges absent (-1), about what a de Bruijn graph gives.
Prints the mean device time of five launches, three times, by CUDA events,
of the whole table (``compose_ms``) and of K20c, the column-range instance,
on the last of four shards with its pad columns (``range_ms``), as
``build_turbo_sharded`` composes it over a (1, 4) mesh. Run the parent and
the change in turns (parent, change, change, parent).
"""
import sys

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

from sbwt_tpu_torch import kernels  # noqa: E402

kernels.build()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
n = 4_000_001
succ = torch.randint(0, n, (4, n), dtype=torch.int32, device=dev, generator=g)
succ[torch.rand((4, n), device=dev, generator=g) < 0.75] = -1
cols = -(-n // 4)
fields = []
for name, fn in (("compose_ms", lambda: kernels.succ_compose(succ, 3)),
                 ("range_ms", lambda: kernels.succ_compose(succ, 3, 3 * cols, cols))):
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
    fields.append(f"{name}={res} {name[:-3]}_checksum={int(out.sum(dtype=torch.int64))}")
    del out
print(f"AB {sys.argv[1]} " + " ".join(fields), flush=True)
