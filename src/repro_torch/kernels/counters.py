"""Launch counts of the port's kernels.

Each kernel wrapper adds one to its name here where it launches its
kernel, and nowhere else, so a run can show that the main path went
through the kernels (``chip_smoke.py`` resets the counts just before it
drives the serving path and reads them just after).  ``bump`` holds a
lock, so launches from several threads of one process are all counted.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

LAUNCHES: Counter = Counter()
_LOCK = threading.Lock()


def bump(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def reset() -> None:
    LAUNCHES.clear()


def snapshot() -> Dict[str, int]:
    return dict(LAUNCHES)
