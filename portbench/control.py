"""The control: the plain reference put in the program's place and computed
at the precision below the one the configuration states, which the check
has to refuse.

The configuration states exact answers: a k-mer is the 2k-bit key of its
chars (60 bits at k = 30, an int64). The control compares keys in 32 bits,
the last 16 chars of each k-mer, and answers the first indexed k-mer that
shares them: the shortcut of a 32-bit key or hash. Run on the card at a
cell's own size, it prints the numbers the check compares, one line a seed:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from portbench import deploy  # noqa: E402
from portbench.reference import buckets  # noqa: E402

KEY_BITS = 32


def setup(config: dict, seqs: list, device) -> deploy.Deployment:
    """The control in the program's place: the bucketed reference at
    KEY_BITS, so that it runs in bounded device memory at any index size.
    It answers every pool batch in one set of passes, at the first call
    (in the warm-up), and each call then returns its batch's answers."""
    k = int(config["k"])
    spans: dict = {}
    info: dict = {}
    batches: list = []
    answers: list = []

    def prepare(batch):
        batches.append(deploy.engine_args(batch))
        return (len(batches) - 1,)

    def run(i):
        if not answers:
            got = deploy.timed(spans, "reference", device, buckets.streaming_answers, seqs, k,
                               batches, key_bits=KEY_BITS)
            answers.extend(got.answers)
            info["n_nodes"] = got.n_nodes
        return answers[i]

    return deploy.Deployment(run, prepare, spans, info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control's readings at a cell's size")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                time.perf_counter(), setup=setup)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "failed": line["failed"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
