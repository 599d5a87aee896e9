"""Serving engines, from ``src/repro/serve/engine.py``.

``ServeEngine`` -- the static batch: prefill a fixed batch of prompts,
decode everyone to ``max_new_tokens`` in lockstep against the ring cache.
``generate`` checks the cache capacity up front and, given ``eos_id``,
stops once every row has finished.

``ContinuousEngine`` -- continuous batching over a fixed set of decode
slots.  New prompts prefill into free slots while in-flight sequences keep
decoding; EOS or token-budget retirement frees the slot at once.  Per
family:

  * dense / moe / vlm -- K/V in the shared page pool (serve/kv_cache.py),
    decode through the paged step (serve/paged_decode.py) whose attention
    reads through the page table.  Admission reserves a request's whole
    page budget inside the scheduler's admission loop, so two queued
    requests that each fit but not together never both admit.  A vlm
    request's patch prefix enters the pages at prefill and counts in its
    KV length (``_kv_len``): the capacity check, the page budget and the
    slot's ``seq_lens``.
  * ssm / hybrid / audio -- the family's native cache (SSM state; window
    ring + SSM state; ring + the encoder's cross K/V) batched over the
    slots (``kv_cache.SlotCache``): admission writes a batch-1 prefill
    cache into its slot's rows and the model's own ``decode`` runs every
    slot in lockstep (decode is row-independent, so dead slots are ignored
    lanes).

A request's ``extras`` (vlm ``patch_embeds`` (P, D), audio
``frame_embeds`` (F, D), without the batch axis) reach its prefill with a
batch axis of 1.

Time advances in ticks, one decode step per tick; prefill occupies the
tick a request admits on (its first token is emitted then) and its first
decode step lands on the next tick.  Decoding is greedy.

Both engines cast the weights for serving once (``transformer.
serving_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import Model
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import paged_decode as pgd
from repro_torch.serve.scheduler import Request, Scheduler, SlotState

Params = Dict[str, Any]


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor  # (B, max_new_tokens) int32
    logits_last: torch.Tensor
    steps: int


def _prompt_kv_len(cfg, batch: Dict[str, Any]) -> int:
    """KV positions the prompt takes in the decoder's cache: a vlm patch
    prefix counts; audio frames feed the encoder, not the ring (JAX
    ``engine.py:61-67``)."""
    n = batch["tokens"].shape[1]
    if cfg.family == "vlm":
        n += batch["patch_embeds"].shape[1]
    return n


class ServeEngine:
    def __init__(self, model: Model, params: Params, capacity: int = 0):
        self.model = model
        self.params = tfm.serving_params(params, model.cfg)
        self.capacity = capacity

    def _check_capacity(self, batch: Dict[str, Any], max_new_tokens: int) -> None:
        cfg = self.model.cfg
        if cfg.family == "ssm" or cfg.attn_window:
            return  # no ring / a window-sized ring wraps by design
        prompt_kv = _prompt_kv_len(cfg, batch)
        required = prompt_kv + max_new_tokens
        effective = self.capacity or prompt_kv  # model_zoo prefill default
        if effective < required:
            raise ValueError(
                f"cache capacity {effective} cannot hold prompt ({prompt_kv})"
                f" + max_new_tokens ({max_new_tokens}): the ring would wrap and"
                f" overwrite the prompt. Construct ServeEngine(...,"
                f" capacity={required}) or reduce max_new_tokens."
            )

    def generate(
        self,
        batch: Dict[str, Any],
        max_new_tokens: int,
        *,
        eos_id: Optional[int] = None,
    ) -> GenerateResult:
        """Greedy decoding of a batch of equal-length prompts (with the
        family's extras: ``patch_embeds`` or ``frame_embeds``)."""
        batch = {k: torch.as_tensor(v, device=self.model.device) for k, v in batch.items()}
        self._check_capacity(batch, max_new_tokens)
        logits, cache = self.model.prefill(self.params, batch, self.capacity or None)
        b = batch["tokens"].shape[0]
        finished = np.zeros((b,), bool)
        outs: List[torch.Tensor] = []
        steps = 0
        for _ in range(max_new_tokens):
            tok = logits.argmax(dim=-1).to(torch.int32)
            if eos_id is not None:
                # rows already finished keep emitting eos, not samples
                done = torch.from_numpy(finished).to(tok.device)
                tok = torch.where(done, torch.full_like(tok, eos_id), tok)
                finished |= tok.cpu().numpy() == eos_id
            outs.append(tok)
            if eos_id is not None and finished.all():
                break  # early exit: no decode steps for an all-done batch
            logits, cache = self.model.decode(
                self.params, cache, {"token": tok[:, None]}
            )
            steps += 1
        if len(outs) < max_new_tokens:  # pad early-exited batches with eos
            pad = torch.full_like(outs[-1], eos_id)
            outs.extend([pad] * (max_new_tokens - len(outs)))
        return GenerateResult(
            tokens=torch.stack(outs, dim=1), logits_last=logits, steps=steps
        )


@dataclasses.dataclass
class ServedResult:
    """Per-request outcome of a continuous-batching run (ticks are decode
    steps; see module docstring)."""

    rid: int
    tokens: np.ndarray  # (n_emitted,) int32
    arrival: int
    admit_tick: int
    first_token_tick: int
    finish_tick: int
    token_ticks: List[int]
    finish_reason: str  # "eos" | "length"


class ContinuousEngine:
    def __init__(
        self,
        model: Model,
        params: Params,
        *,
        max_slots: int = 4,
        max_seq_len: int = 256,
        page_size: int = 16,
        num_pages: int = 0,
        eos_id: Optional[int] = None,
    ):
        self.model = model
        self.cfg = model.cfg
        self.params = tfm.serving_params(params, self.cfg)
        self.device = model.device
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.eos_id = eos_id
        self.paged = self.cfg.family in pgd.PAGED_FAMILIES
        self.sched = Scheduler(max_slots)
        self.occupancy_trace: List[float] = []
        self.total_ticks = 0
        self.decode_steps = 0
        self._pending: List[Request] = []
        self._results: Dict[int, ServedResult] = {}
        self._next_rid = 0
        self._tokens_next = np.zeros((max_slots,), np.int32)

        if self.paged:
            mpps = kvc.pages_needed(max_seq_len, page_size)
            if num_pages <= 0:
                # every slot can hold a full-length sequence, +1 trash page
                num_pages = max_slots * mpps + 1
            self.kv = kvc.PagedKVCache.build(
                self.cfg, max_slots, page_size, num_pages, mpps, device=self.device
            )
            self._step = pgd.make_paged_step(model)
        else:
            self.slot_cache = kvc.SlotCache(model, max_slots, max_seq_len)
            self.seq_lens = np.zeros((max_slots,), np.int32)

    # -- request intake ----------------------------------------------------

    def _kv_len(self, req: Request) -> int:
        n = len(req.tokens)
        if self.cfg.family == "vlm" and req.extras:
            n += req.extras["patch_embeds"].shape[0]
        return n

    def submit(self, tokens, max_new_tokens: int, *, arrival: int = 0,
               extras: Optional[Dict[str, Any]] = None) -> int:
        req = Request(
            rid=self._next_rid,
            tokens=np.asarray(tokens, np.int32),
            max_new_tokens=max_new_tokens,
            arrival=arrival,
            extras=extras,
        )
        n = self._kv_len(req)
        if n < 1 or max_new_tokens < 1:
            raise ValueError(
                f"degenerate request (prompt kv {n}, max_new_tokens"
                f" {max_new_tokens}): need a non-empty prompt and at least"
                f" one output token."
            )
        total = n + max_new_tokens
        capacity = self.kv.capacity if self.paged else self.max_seq_len
        # an SSM state is capacity-free and a window ring wraps by design
        if self.cfg.family not in ("ssm", "hybrid") and total > capacity:
            raise ValueError(
                f"request needs {total} kv positions (prompt {n} +"
                f" max_new_tokens {max_new_tokens}) but a slot holds"
                f" {capacity}; raise max_seq_len to {total} or"
                f" reduce the request."
            )
        self._next_rid += 1
        self._pending.append(req)
        return req.rid

    def _reserve(self, req: Request, slot: int) -> bool:
        """Scheduler callback: atomically check and reserve the request's
        worst-case page budget for ``slot``, inside the admission loop (a
        slot-cache family's budget is the free slot itself)."""
        if not self.paged:
            return True
        total = self._kv_len(req) + req.max_new_tokens
        return self.kv.admit(slot, total) is not None

    # -- engine steps ------------------------------------------------------

    def _admit(self, st: SlotState, now: int) -> None:
        req = st.req
        batch = {"tokens": torch.as_tensor(req.tokens, device=self.device)[None]}
        for k, v in (req.extras or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)[None]
        kv_len = self._kv_len(req)
        if self.paged:
            # default capacity: the exact prompt KV length, every position
            # for the page writer
            logits, cache = self.model.prefill(self.params, batch)
            # the page-table row was reserved by _reserve when the slot was granted
            row = torch.from_numpy(self.kv.page_table[st.slot].copy()).to(self.device)
            pgd.write_prompt(
                self.kv.pages_k, self.kv.pages_v,
                cache.k[:, 0], cache.v[:, 0], cache.pos[0], row,
            )
            self.kv.seq_lens[st.slot] = kv_len
        else:
            logits, cache = self.model.prefill(self.params, batch, self.max_seq_len)
            self.slot_cache.insert(cache, st.slot)
            self.seq_lens[st.slot] = kv_len
        self._emit(st, int(logits[0].argmax()), now)

    def _emit(self, st: SlotState, tok: int, now: int) -> None:
        st.out_tokens.append(tok)
        st.token_ticks.append(now)
        self._tokens_next[st.slot] = tok
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(st.slot, now, "eos")
        elif st.emitted >= st.req.max_new_tokens:
            self._retire(st.slot, now, "length")

    def _retire(self, slot: int, now: int, reason: str) -> None:
        st = self.sched.retire(slot, now, reason)
        if self.paged:
            self.kv.retire(slot)  # pages return to the pool this tick
        else:
            self.seq_lens[slot] = 0
        self._results[st.req.rid] = ServedResult(
            rid=st.req.rid,
            tokens=np.asarray(st.out_tokens, np.int32),
            arrival=st.req.arrival,
            admit_tick=st.admit_tick,
            first_token_tick=st.token_ticks[0],
            finish_tick=st.finish_tick,
            token_ticks=list(st.token_ticks),
            finish_reason=reason,
        )

    def _decode_tick(self, now: int) -> None:
        active = self.sched.active_slots()
        act = np.zeros((self.max_slots,), bool)
        act[[s for s, _ in active]] = True
        # copies of the host tables the step reads: the engine mutates them
        # right after the step is dispatched (ROADMAP queue 3, the JAX race)
        toks = torch.from_numpy(self._tokens_next.copy()).to(self.device)
        if self.paged:
            pt, sl = self.kv.device_tables()
            logits, _, _ = self._step(
                self.params, self.kv.pages_k, self.kv.pages_v, pt, sl,
                torch.from_numpy(act).to(self.device), toks,
            )
            self.kv.seq_lens[act] += 1
        else:
            logits, self.slot_cache.cache = self.model.decode(
                self.params, self.slot_cache.cache, {"token": toks[:, None]})
            self.seq_lens[act] += 1
        self.decode_steps += 1
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        for slot, st in active:
            self._emit(st, int(next_tokens[slot]), now)

    def _occupancy(self) -> float:
        if not self.paged:
            return len(self.sched.active) / self.max_slots
        alloc = self.kv.allocator
        return alloc.used_pages / max(alloc.num_pages - 1, 1)

    # -- run loop ----------------------------------------------------------

    def run(self) -> Dict[int, ServedResult]:
        """Drain all submitted requests; returns rid -> ServedResult."""
        pending = sorted(self._pending, key=lambda r: (r.arrival, r.rid))
        self._pending = []
        i = 0
        now = 0
        while i < len(pending) or self.sched.has_work:
            while i < len(pending) and pending[i].arrival <= now:
                self.sched.submit(pending[i])
                i += 1
            # decode BEFORE admitting: a slot admitted this tick spends the
            # tick on prefill and takes its first decode step next tick, and
            # slots retired by this decode free their pages for the
            # admissions below.
            worked = bool(self.sched.active)
            if worked:
                self._decode_tick(now)
            for st in self.sched.try_admit(now, self._reserve):
                self._admit(st, now)
            if worked or self.sched.active:
                self.occupancy_trace.append(self._occupancy())
                now += 1
            elif i < len(pending):
                now = max(now + 1, pending[i].arrival)  # idle: jump ahead
            elif self.sched.queue:
                # whole-budget admission on an empty engine always succeeds
                # for a request submit() accepted: reaching here is a bug
                raise RuntimeError("queue stalled with no active slots")
        self.total_ticks = now
        return dict(self._results)
