"""Continuous-batching admission control: slots, queueing, budget, pages
(the port of ``repro/serve/scheduler.py`` without its tracer and metrics
hooks).

The engine's KV cache is a fixed array of ``n_slots`` batch rows.  The
scheduler owns which request occupies which slot: submitted requests wait
in FIFO order, each engine step admits waiting requests into free slots
(a prefill each), and finished requests release their slot immediately —
the next waiting request reuses it on the following step while the other
slots keep decoding.

With a paged KV cache (``kv`` is a :class:`repro_torch.serve.kv.PageTable`)
admission also gates on **free pages**, allocating the request's initial
pages; ``release`` and ``preempt`` return every page to the pool.

The *token budget* (``max_tokens_per_step``) bounds the tokens one engine
step may inject: a decode step costs one token per decoding slot, an
admission the tokens its prefill runs (bucket-padded) plus its own decode
token this step.  When nothing else runs this step, one admission is
always allowed, so a prompt longer than the budget cannot deadlock the
queue.
"""

from __future__ import annotations

import time
from collections import deque

from repro_torch.serve.request import RequestState


class Scheduler:
    def __init__(
        self,
        n_slots: int,
        max_tokens_per_step: int | None = None,
        prompt_cost=None,
        kv=None,
        admit_tokens=None,
    ) -> None:
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_tokens_per_step = max_tokens_per_step
        #: budget tokens a waiting request's admission runs this step
        self.prompt_cost = prompt_cost or (
            lambda state: len(state.request.prompt) + len(state.tokens)
        )
        #: tokens a waiting request's admission must hold pages for
        self.admit_tokens = admit_tokens or (
            lambda state: len(state.request.prompt) + len(state.tokens)
        )
        #: page table (paged KV mode) — admission allocates, release frees
        self.kv = kv
        # pop() takes from the end: keep slot 0 first for readable traces
        self._free: list[int] = list(range(n_slots - 1, -1, -1))
        self.waiting: deque[RequestState] = deque()
        self.active: dict[int, RequestState] = {}
        #: admissions per slot over the scheduler's lifetime — any count > 1
        #: is an observed slot reuse (the continuous-batching signature)
        self.admitted_per_slot: dict[int, int] = {}
        #: preempted-and-requeued requests (paged mode under page pressure)
        self.preemptions = 0
        self._admit_seq = 0

    # -- queue side -----------------------------------------------------------
    def enqueue(self, state: RequestState) -> None:
        self.waiting.append(state)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    # -- per-step admission ----------------------------------------------------
    def admissions(self, spent: int | None = None) -> list[RequestState]:
        """Admit waiting requests into free slots for this engine step:
        FIFO, budget-capped and page-gated.  ``spent`` is the budget this
        step has already committed (default: one decode token per active
        slot).  Guaranteed to make progress when the engine is idle."""
        admitted: list[RequestState] = []
        budget = self.max_tokens_per_step
        if spent is None:
            spent = len(self.active)  # this step's decode tokens
        progressing = spent > 0
        while self.waiting and self._free:
            nxt = self.waiting[0]
            # +1: the admitted request decodes in this same step too
            cost = self.prompt_cost(nxt) + 1
            if budget is not None and spent + cost > budget:
                if progressing or self.active or admitted:
                    break  # decode / earlier admissions run first
                # idle engine: admit anyway — a prompt longer than the
                # budget must not wedge the queue
            if self.kv is not None and not self.kv.can_admit(self.admit_tokens(nxt)):
                # no pages: in-flight requests return theirs on release /
                # preemption; an idle pool always fits one request because
                # submit() rejects anything larger than the whole pool
                break
            self.waiting.popleft()
            slot = self._free.pop()
            nxt.slot = slot
            nxt.admit_seq = self._admit_seq
            self._admit_seq += 1
            if nxt.admitted_at is None:
                # first admission only: ttft_admitted compares the first
                # token against the first time the model saw the request
                nxt.admitted_at = time.perf_counter()
            if self.kv is not None:
                self.kv.alloc_slot(slot, self.admit_tokens(nxt))
            self.active[slot] = nxt
            self.admitted_per_slot[slot] = self.admitted_per_slot.get(slot, 0) + 1
            admitted.append(nxt)
            spent += cost
        return admitted

    def release(self, slot: int) -> RequestState:
        """Evict a finished request: free its slot for reuse and return
        its pages to the pool."""
        state = self.active.pop(slot)
        self._free.append(slot)
        if self.kv is not None:
            self.kv.free_slot(slot)
        return state

    def preempt(self, slot: int) -> RequestState:
        """Evict a *running* request under page pressure: pages return to
        the pool and the request requeues at the FRONT of the waiting
        queue with its generated tokens intact — re-admission re-prefills
        ``prompt + tokens`` and continues exactly where it stopped
        ((seed, token-index)-keyed sampling is batch-independent, so the
        continuation is token-identical)."""
        state = self.active.pop(slot)
        self._free.append(slot)
        if self.kv is not None:
            self.kv.free_slot(slot)
        state.slot = -1
        self.waiting.appendleft(state)
        self.preemptions += 1
        return state

    # -- reporting -------------------------------------------------------------
    @property
    def slot_reuses(self) -> int:
        """Admissions beyond each slot's first — > 0 proves continuous
        batching actually recomposed the batch."""
        return sum(max(0, n - 1) for n in self.admitted_per_slot.values())
