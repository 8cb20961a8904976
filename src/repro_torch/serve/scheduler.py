"""Continuous-batching admission control: slots, queueing, budget, pages (a
copy of ``repro/serve/scheduler.py``).

The engine's KV cache is a fixed array of ``n_slots`` batch rows.  The
scheduler owns which request occupies which slot: submitted requests wait
in FIFO order, each engine step admits waiting requests into free slots
(a prefill each), and finished requests release their slot immediately —
the next waiting request reuses it on the following step, while the other
slots keep decoding.  This is continuous batching: the batch recomposes
every step instead of draining entirely before refilling.

With a paged KV cache (``kv`` is a :class:`repro_torch.serve.kv.PageTable`)
admission additionally gates on **free pages**: a slot is only a batch
row, the tokens live in the shared pool, so what bounds concurrency is
pages — not ``n_slots x max_len``.  Admission allocates the request's
initial pages (the prompt, or just its first chunk under chunked
prefill), ``release`` and ``preempt`` return every page to the pool.

The *token budget* (``max_tokens_per_step``) bounds how much work one
engine step may inject, in tokens: a decode step costs one token per
decoding slot, an admission costs the tokens its first prefill program
call actually runs (bucket-padded, or one chunk) plus the admitted
request's own decode token this step.  A small budget keeps per-step
latency flat under bursty arrivals; a large budget maximises admission
throughput.  When no other work is running this step, one admission is
always allowed regardless of budget, so a prompt longer than the budget
cannot deadlock the queue.
"""

from __future__ import annotations

import time
from collections import deque

from repro_torch.obs import get_tracer
from repro_torch.serve.request import RequestState

#: Virtual trace-track ids for per-request lifecycle spans — offset far
#: above any real thread ident's low bits so request tracks sort together
#: in the exported timeline.
REQUEST_TRACK_BASE = 0x5E54_0000


def request_track(request_id: int) -> int:
    """The tracer track (Chrome `tid`) carrying one request's lifecycle."""
    return REQUEST_TRACK_BASE + request_id


class Scheduler:
    def __init__(
        self,
        n_slots: int,
        max_tokens_per_step: int | None = None,
        prompt_cost=None,
        kv=None,
        admit_tokens=None,
        tracer=None,
        metrics=None,
    ) -> None:
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_tokens_per_step = max_tokens_per_step
        #: maps a waiting RequestState to the budget tokens its admission
        #: runs this step — the engine passes bucket-padded context length,
        #: or one chunk under chunked prefill
        self.prompt_cost = prompt_cost or (
            lambda state: len(state.request.prompt) + len(state.tokens)
        )
        #: maps a waiting RequestState to the tokens its admission must
        #: hold *pages* for right now (full context, or the first chunk)
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
        #: request-lifecycle tracing (queue spans, kv-alloc/free, preempt)
        self.tracer = tracer if tracer is not None else get_tracer()
        self._admissions_c = self._preemptions_c = None
        if metrics is not None:
            self._admissions_c = metrics.counter(
                "serve_admissions_total",
                "requests admitted into a KV slot (re-admissions included)",
            )
            self._preemptions_c = metrics.counter(
                "serve_preemptions_total",
                "running requests evicted under page pressure and requeued",
            )

    # -- queue side -----------------------------------------------------------
    def enqueue(self, state: RequestState) -> None:
        if not state.queued_at:
            state.queued_at = state.submitted_at or time.perf_counter()
        self.waiting.append(state)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    # -- per-step admission ----------------------------------------------------
    def admissions(self, spent: int | None = None) -> list[RequestState]:
        """Admit waiting requests into free slots for this engine step.

        FIFO, budget-capped and page-gated.  ``spent`` is the budget this
        step has already committed (decode tokens + planned prefill
        chunks); defaults to one decode token per active slot.  Guaranteed
        to make progress when the engine is otherwise idle.
        """
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
                    break  # decode / chunks / earlier admissions run first
                # idle engine: admit anyway — a prompt longer than the
                # budget must not wedge the queue
            if self.kv is not None and not self.kv.can_admit(
                self.admit_tokens(nxt)
            ):
                # no pages: in-flight requests return theirs on release /
                # preemption; an idle pool always fits one request because
                # submit() rejects anything larger than the whole pool
                break
            self.waiting.popleft()
            slot = self._free.pop()
            nxt.slot = slot
            nxt.admit_seq = self._admit_seq
            self._admit_seq += 1
            now = time.perf_counter()
            if nxt.admitted_at is None:
                # first admission only: ttft_admitted compares the first
                # token against the first time the model saw the request
                nxt.admitted_at = now
            nxt.last_admitted_at = now
            tr = self.tracer
            track = request_track(nxt.request_id)
            tokens = self.admit_tokens(nxt)
            if tr.enabled:
                tr.name_track(track, f"req {nxt.request_id}")
                tr.add_span(
                    "queue", nxt.queued_at or nxt.submitted_at, now,
                    tid=track, request=nxt.request_id, slot=slot,
                )
            t0 = time.perf_counter()
            pages = (
                self.kv.alloc_slot(slot, tokens)
                if self.kv is not None
                else None
            )
            if tr.enabled:
                # contiguous mode "allocates" by reserving the slot row;
                # the span still marks where this request's KV came from
                tr.add_span(
                    "kv-alloc", t0, time.perf_counter(), tid=track,
                    request=nxt.request_id, slot=slot, tokens=tokens,
                    pages=len(pages) if pages is not None else 0,
                )
            if self._admissions_c is not None:
                self._admissions_c.inc()
            self.active[slot] = nxt
            self.admitted_per_slot[slot] = (
                self.admitted_per_slot.get(slot, 0) + 1
            )
            admitted.append(nxt)
            spent += cost
        return admitted

    def release(self, slot: int) -> RequestState:
        """Evict a finished request: free its slot for reuse and return
        its pages to the pool."""
        state = self.active.pop(slot)
        self._free.append(slot)
        freed = self.kv.free_slot(slot) if self.kv is not None else 0
        if self.tracer.enabled:
            self.tracer.event(
                "kv-free", tid=request_track(state.request_id),
                request=state.request_id, slot=slot, pages=freed,
            )
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
        freed = self.kv.free_slot(slot) if self.kv is not None else 0
        state.slot = -1
        state.queued_at = time.perf_counter()
        if self.tracer.enabled:
            self.tracer.event(
                "preempt", tid=request_track(state.request_id),
                request=state.request_id, slot=slot, pages=freed,
                generated=len(state.tokens),
            )
        self.waiting.appendleft(state)
        self.preemptions += 1
        if self._preemptions_c is not None:
            self._preemptions_c.inc()
        return state

    # -- reporting -------------------------------------------------------------
    @property
    def slot_reuses(self) -> int:
        """Admissions beyond each slot's first — > 0 proves continuous
        batching actually recomposed the batch."""
        return sum(max(0, n - 1) for n in self.admitted_per_slot.values())
