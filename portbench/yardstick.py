"""The yardstick: the work a batch needs whatever implements it, and the
device's peaks.

The compulsory bytes of a streaming search count each real base read once
(1 B), each read's length once (4 B) and each real answer written once, at
the width of the answers the engine returned (4 B for int32, 8 B for the
int64 answers of an index of 2^31 columns or more). They depend on the
traffic and that width alone, never on the index's tables or the kernel, so
no later change to the program can make them stale. (The "codes and answers
alone" bound of chip_smoke.py ``turbo_work`` and ``lf_work``, restated over
the real bases and answers only.)
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

LENGTH_BYTES = 4

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def answer_bytes(answers) -> int:
    """Bytes of one answer of an engine's answers tensor."""
    return torch.as_tensor(answers).element_size()


def compulsory_bytes(bases: int, reads: int, answers: int, width: int) -> int:
    """Bytes a streaming search of ``reads`` reads of ``bases`` real bases
    with ``answers`` real k-mer answers of ``width`` bytes has to move at
    least."""
    return bases + LENGTH_BYTES * reads + width * answers


def peaks(kind: str) -> dict | None:
    """The published peaks of the device named ``kind`` (the name that
    torch.cuda.get_device_name gives), or None when the table lacks it."""
    return json.loads(_PEAKS.read_text())["devices"].get(kind)
