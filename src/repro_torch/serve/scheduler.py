"""Request queue + slot assignment for the continuous-batching engine: the
port's own copy of ``src/repro/serve/scheduler.py`` (it is framework-free,
but the port imports nothing of ``repro``).

Scheduling policy (DESIGN.md §2.13 of the JAX package):

  * FCFS with head-of-line blocking: requests admit strictly in arrival
    order; if the head request does not fit (no free slot, or the cache
    budget check fails), nothing behind it admits either.  This forgoes a
    little utilization for a starvation-free guarantee -- a large request
    can never be overtaken forever by small ones.
  * Admission is all-or-nothing against the request's WORST-CASE budget
    (prompt + max_new_tokens): the engine's ``reserve`` callback atomically
    checks AND reserves pages / slot capacity for the full reservation at
    the moment the slot is granted.  Reserving inside the admission loop is
    what keeps multi-admission ticks safe -- the second queued head is
    checked against a pool that already counts the first head's grant -- and
    an admitted sequence never needs preemption or mid-flight re-allocation;
    retirement (EOS or token budget) releases the whole reservation at once.

Time is measured in engine ticks: one decode step per tick, and prefill
occupies the tick a request admits on (its first decode step lands on the
next tick), which keeps every latency number in the replay benchmark
deterministic.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.  ``extras`` carries per-request conditioning
    without the batch axis (vlm ``patch_embeds`` (P, Dm), audio
    ``frame_embeds`` (F, Dmel...)); the engine adds the axis at prefill."""

    rid: int
    tokens: np.ndarray  # (S,) int32 prompt
    max_new_tokens: int
    arrival: int = 0  # tick the request becomes visible
    extras: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class SlotState:
    """Bookkeeping for an in-flight request bound to a decode slot."""

    req: Request
    slot: int
    admit_tick: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    token_ticks: List[int] = dataclasses.field(default_factory=list)
    finish_tick: int = -1
    finish_reason: str = ""

    @property
    def emitted(self) -> int:
        return len(self.out_tokens)


class Scheduler:
    """Admission-controlled FCFS queue over a fixed set of decode slots."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self.queue: deque[Request] = deque()
        self._free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self.active: Dict[int, SlotState] = {}  # slot -> state

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def try_admit(
        self, now: int, reserve: Callable[[Request, int], bool]
    ) -> List[SlotState]:
        """Admit from the queue head while slots and budget allow.

        ``reserve(req, slot)`` must atomically check AND reserve the
        request's worst-case budget for ``slot``; returning False leaves
        the queue and the slot untouched.  Because the reservation lands
        before the next head is examined, two requests that each fit
        individually but not together can never both admit in one tick."""
        admitted = []
        while self.queue and self._free_slots:
            slot = self._free_slots[-1]
            if not reserve(self.queue[0], slot):
                break  # head-of-line: preserve arrival order
            req = self.queue.popleft()
            self._free_slots.pop()
            st = SlotState(req=req, slot=slot, admit_tick=now)
            self.active[slot] = st
            admitted.append(st)
        return admitted

    def retire(self, slot: int, now: int, reason: str) -> SlotState:
        st = self.active.pop(slot)
        st.finish_tick = now
        st.finish_reason = reason
        self._free_slots.append(slot)
        return st

    def active_slots(self) -> List[Tuple[int, SlotState]]:
        return sorted(self.active.items())
