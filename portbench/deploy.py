"""The system under test, set up from a configuration's file.

A configuration names the index (k, the precalc length p, the variant) and
the engine (the turbo successor table of a given arity, or the LF engine
over the variant's own ranks). A batch goes through the engine entry that
the facade calls, with the answers left on the card.

Set-up builds the index on the card from the generated sequences
(``SBWT.build_on_device``), converts it to the variant (``to_variant``) and
builds the turbo table (``build_turbo``), each timed by the host clock
around the call and a synchronize.

The program is imported here, inside functions: nothing else of the
benchmark imports it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Deployment:
    engine: object               # engine(*args) -> answers of one batch
    prepare: object              # prepare(Batch) -> the engine's args
    spans: dict = field(default_factory=dict)  # set-up stage -> host seconds
    info: dict = field(default_factory=dict)
    launches: object = None      # () -> {kernel: launches so far}, or None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(spans: dict, name: str, device, fn, *args, **kwargs):
    """fn(*args, **kwargs), its host seconds to a synchronize in spans[name]."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(device)
    spans[name] = time.perf_counter() - t0
    return out


def engine_args(batch):
    return batch.codes, batch.lengths


def program(config: dict, seqs: list, device) -> Deployment:
    """The port, set up as ``config`` states, driven through its engine entry."""
    from sbwt_tpu_torch import kernels
    from sbwt_tpu_torch.models.sbwt import SBWT
    from sbwt_tpu_torch.ops import search as search_ops
    from sbwt_tpu_torch.ops import turbo as turbo_ops
    from sbwt_tpu_torch.utils.memory import device_free_bytes, select_turbo_arity

    k, p = int(config["k"]), int(config["precalc_k"])
    variant, engine = config["variant"], config["engine"]
    spans: dict = {}
    host_seqs = [s.cpu().numpy() for s in seqs]
    sb = timed(spans, "build", device, SBWT.build_on_device, host_seqs, k, device, precalc_k=p)
    info = {"n_nodes": sb.number_of_subsets(), "n_kmers": sb.number_of_kmers()}
    if variant != "plain-matrix":
        sb = timed(spans, "variant", device, sb.to_variant, variant)
    index = sb.device_index
    if engine == "turbo":
        arity = int(config["turbo_arity"])
        info["auto_arity"] = select_turbo_arity(sb.number_of_subsets(), device_free_bytes(device),
                                                sb.get_precalc_k())
        table = timed(spans, "table", device, turbo_ops.build_turbo, index, arity)
    elif engine != "lf":
        raise ValueError(f"unknown engine {engine!r}")

    if engine == "turbo":
        def run(codes, lengths):
            return turbo_ops.turbo_streaming_search(table, index, codes, lengths)
    else:
        def run(codes, lengths):
            return search_ops.streaming_search(index, codes, lengths)
    return Deployment(run, engine_args, spans, info, lambda: dict(kernels.LAUNCHES))
