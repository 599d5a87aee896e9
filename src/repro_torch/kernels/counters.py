"""Launch counts of the port's kernels.

Each kernel wrapper adds one to its name here where it launches its
kernel, and nowhere else, so a run can show that the main path went
through the kernels (``chip_smoke.py`` resets the counts just before it
drives the serving path and reads them just after).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

LAUNCHES: Counter = Counter()


def reset() -> None:
    LAUNCHES.clear()


def snapshot() -> Dict[str, int]:
    return dict(LAUNCHES)
