"""The comparison that decides ``correct``: the answers that the timed calls
produced, against the plain reference's, worked out again from the
sequences and the reads.

Every answer is exact (a column of the SBWT, or -1), so the limit of the
count of mismatched answers is 0. Each pool batch's last answers are
judged, and those of the calls drawn from the seed. The reference works in
buckets of keys (``portbench/reference/buckets.py``), so that it judges an
index of billions of columns in bounded device memory.
"""
from __future__ import annotations

import torch

from portbench.reference import buckets

LIMITS = {"mismatched_answers": 0}


def judged(run) -> dict:
    """slot -> the kept answers of that pool batch's calls."""
    out: dict = {}
    for slot, ans in run.last.items():
        out.setdefault(slot, []).append(ans)
    for _, slot, ans in run.sampled:
        out.setdefault(slot, []).append(ans)
    return out


def compare(run, pool, seqs, k: int) -> dict:
    """{name: (value, limit)} of the numbers compared, the calls and
    answers judged, the calls whose answers were wrong, and the reference's
    share of the judged real answers that are indexed (hits); the reference
    runs here, after the program is freed."""
    bad = wrong_calls = n_answers = n_real = n_hits = 0
    kept = judged(run)
    slots = sorted(kept)
    wants = buckets.streaming_answers(seqs, k, [(pool[s].codes, pool[s].lengths)
                                                for s in slots]).answers
    for slot in slots:
        answers, batch, want = kept[slot], pool[slot], wants.pop(0)
        n_real += batch.answers * len(answers)
        n_hits += int((want >= 0).sum()) * len(answers)
        for ans in answers:
            got = torch.as_tensor(ans).to(want.device)
            miss = want.numel() if got.shape != want.shape else int((got.long() != want).sum())
            bad += miss
            wrong_calls += miss > 0
            n_answers += want.numel()
        del want
    values = {"mismatched_answers": bad}
    return {
        "checks": {name: (v, LIMITS[name]) for name, v in values.items()},
        "calls_judged": sum(len(a) for a in kept.values()),
        "answers_judged": n_answers,
        "calls_wrong": wrong_calls,
        "hit_share": n_hits / n_real if n_real else None,
    }


def passed(checks: dict) -> bool:
    return all(v <= limit for v, limit in checks.values())
