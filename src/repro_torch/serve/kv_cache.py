"""Paged KV cache for the continuous-batching engine, from
``src/repro/serve/kv_cache.py``.

K/V live in a shared pool of fixed-size pages, ``(L, P, page_size, KVH,
D)`` per tensor, on the device; a per-slot page table maps token position
``j`` to page ``table[slot, j // ps]``, offset ``j % ps``.  Pages come from
a free-list allocator; page 0 is the trash page that inactive-slot decode
writes land in, so the step needs no branch on slot liveness.  Admission
reserves the request's whole worst-case budget (prompt + max_new_tokens,
rounded up to pages): an admitted sequence always runs to its budget, and
retirement returns every page at once.

The page table, sequence lengths and free list are host state (numpy and
Python ints), shipped to the device as small tensors each step.

``SlotCache`` -- the ssm, hybrid and audio families' native decode cache
(SSM state; window ring + SSM state; ring + the encoder's cross K/V,
written once at admission and read by every decode step) batched over the
engine's slots: admission writes a batch-1 prefill cache into its slot's
rows (``_insert_slot``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-int(n_tokens) // int(page_size))


class PageAllocator:
    """LIFO free list over pages ``1..num_pages-1`` (page 0 reserved)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None -- never a partial grant (admission is
        all-or-nothing, so a rejected request leaves no litter)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n == 0:
            return []  # NOT self._free[-0:], which would drain the pool
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1]
        del self._free[-n:]
        return got

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"bad page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(reversed(pages))


@dataclasses.dataclass
class PagedKVCache:
    """Pool + per-slot tables for one model's attention layers."""

    pages_k: torch.Tensor  # (L, P, ps, KVH, D) on the device
    pages_v: torch.Tensor
    page_table: np.ndarray  # (max_slots, MP) int32 host, -1 = unallocated
    seq_lens: np.ndarray  # (max_slots,) int32 host, tokens written
    allocator: PageAllocator
    page_size: int
    slot_pages: List[Optional[List[int]]]  # reservation ledger per slot

    @classmethod
    def build(
        cls, cfg, max_slots: int, page_size: int, num_pages: int,
        max_pages_per_seq: int, *, device,
    ) -> "PagedKVCache":
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        return cls(
            pages_k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            pages_v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            page_table=np.full((max_slots, max_pages_per_seq), -1, np.int32),
            seq_lens=np.zeros((max_slots,), np.int32),
            allocator=PageAllocator(num_pages),
            page_size=page_size,
            slot_pages=[None] * max_slots,
        )

    @property
    def capacity(self) -> int:  # max kv positions a slot can hold
        return self.page_table.shape[1] * self.page_size

    def admit(self, slot: int, total_tokens: int) -> Optional[np.ndarray]:
        """Reserve the full page budget for ``total_tokens``; returns the
        slot's page-id row (padded with -1) or None if the pool is short."""
        n = pages_needed(total_tokens, self.page_size)
        if n > self.page_table.shape[1]:
            raise ValueError(
                f"request needs {n} pages/slot > max_pages_per_seq "
                f"{self.page_table.shape[1]} (capacity {self.capacity} tokens)"
            )
        got = self.allocator.alloc(n)
        if got is None:
            return None
        row = np.full((self.page_table.shape[1],), -1, np.int32)
        row[:n] = got
        self.page_table[slot] = row
        self.seq_lens[slot] = 0
        self.slot_pages[slot] = got
        return row

    def retire(self, slot: int) -> int:
        """Free the slot's pages immediately; returns how many."""
        pages = self.slot_pages[slot]
        if pages is None:
            return 0
        self.allocator.free(pages)
        self.slot_pages[slot] = None
        self.page_table[slot] = -1
        self.seq_lens[slot] = 0
        return len(pages)

    def device_tables(self):
        """Copies of the page table and seq_lens on the pool's device.  They
        are copies even on the CPU: the engine mutates the host arrays right
        after it dispatches a step (the JAX version's ``jnp.asarray`` may
        alias them there and race with that step)."""
        dev = self.pages_k.device
        return (
            torch.from_numpy(self.page_table.copy()).to(dev),
            torch.from_numpy(self.seq_lens.copy()).to(dev),
        )


# ---------------------------------------------------------------------------
# Slot-batched family caches (SSM state / window ring + SSM state / ring +
# cross K/V)
# ---------------------------------------------------------------------------


def _leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a cache's (nested) NamedTuple fields in field
    order, with ``jax.tree_util.keystr``'s paths (``".ssm.state"``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for name, value in zip(tree._fields, tree):
        out.extend(_leaves_with_path(value, f"{prefix}.{name}"))
    return out


def _batch_axis(full: torch.Tensor, sub: torch.Tensor) -> Optional[int]:
    """The batch axis of a leaf, found structurally: the first axis where
    the slot-batched (max_slots) and batch-1 shapes differ."""
    return next((i for i, (a, b) in enumerate(zip(full.shape, sub.shape)) if a != b), None)


def _insert_slot(cache: Any, sub: Any, slot: int) -> None:
    """Write a batch-1 cache into one slot of a slot-batched cache, in
    place (kv_cache.py:163-193).  Leaves with identical shapes pass through
    untouched, as JAX's do (none has one while max_slots > 1)."""
    for (_, full), (_, s) in zip(_leaves_with_path(cache), _leaves_with_path(sub)):
        ax = _batch_axis(full, s)
        if ax is not None:
            full.narrow(ax, slot, 1).copy_(s.to(full.dtype))


class SlotCache:
    """Slot-batched wrapper over a family's native decode cache."""

    def __init__(self, model, max_slots: int, capacity: int):
        self.max_slots = max_slots
        self.capacity = capacity
        self.cache = model.init_cache(max_slots, capacity)

    def insert(self, sub_cache: Any, slot: int) -> None:
        _insert_slot(self.cache, sub_cache, slot)


def batch_axes(cache: Any, sub: Any) -> Dict[str, Optional[int]]:
    """Leaf path -> detected batch axis (kv_cache.py:196), for tests to
    hold the structural detection against the family layouts."""
    return {path: _batch_axis(full, s) for (path, full), (_, s)
            in zip(_leaves_with_path(cache), _leaves_with_path(sub))}
