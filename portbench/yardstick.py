"""The yardstick: the work a batch needs whatever implements it, and the
device's peaks.

The compulsory bytes of a streaming search count each real base read once
(1 B), each read's length once (4 B) and each real answer written once (4
B, int32). They depend on the traffic alone, never on the index, its tables
or the kernel, so no later change to the program can make them stale. (The
"codes and answers alone" bound of chip_smoke.py ``turbo_work`` and
``lf_work``, restated over the real bases and answers only.)
"""
from __future__ import annotations

import json
from pathlib import Path

ANSWER_BYTES = 4
LENGTH_BYTES = 4

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def compulsory_bytes(bases: int, reads: int, answers: int) -> int:
    """Bytes a streaming search of ``reads`` reads of ``bases`` real bases
    with ``answers`` real k-mer answers has to move at least."""
    return bases + LENGTH_BYTES * reads + ANSWER_BYTES * answers


def peaks(kind: str) -> dict | None:
    """The published peaks of the device named ``kind`` (the name that
    torch.cuda.get_device_name gives), or None when the table lacks it."""
    return json.loads(_PEAKS.read_text())["devices"].get(kind)
