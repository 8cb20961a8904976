"""ServeEngine — request-level serving with continuous batching (the
scheduling core of ``repro/serve/engine.py``).

Callers ``submit()`` :class:`Request` objects at any time and drive the
engine with ``step()`` (one scheduling round: admit waiting requests into
free KV slots — a batch-1 prefill each, inserted into the slot — then one
decode step for every active slot) or ``run_until_idle()``; they get
streaming :class:`Token` events and a final :class:`Completion` per request.

* **Continuous batching** — the KV cache has ``n_slots`` rows with per-slot
  write positions; finished requests free their slot mid-flight and the
  next waiting request is prefilled into it while the others keep decoding.
* **Block-paged KV cache** — with ``page_size`` set, K/V lives in a shared
  pool of fixed-size pages; each slot holds a page list
  (:class:`repro_torch.serve.kv.PageTable`) and the decode step reads K/V
  through the page table, a device tensor re-uploaded only when the table
  changed.  Under page pressure the youngest request is preempted and later
  resumes token-identically.
* **Sampling on the device** — logits never leave the card; the per-step
  host transfer is the (B,) token ids.
* **Compiled steps** — the decode step of the whole slot batch and each
  admission's prefill, sampling fused into both, run as step programs
  (:mod:`repro_torch.serve.programs`), the counterpart of the reference's
  jitted ``decode`` and ``prefill``: on the card each key (sampling policy;
  for prefill the padded length too) runs eagerly once, is captured as a
  CUDA graph at its second call and replayed from then on.  Decode has at
  most three keys, one per policy, whatever the batch's composition.
  Prefill is graphed only with ``prefill_bucket``, where its lengths are
  few; exact lengths are too many to pay for their captures, so they run
  eagerly.  The prefill fills one static batch-1 cache, zeroed inside the
  program (the reference builds its zero cache inside the jitted prefill);
  the insert into the slot stays a few eager copies.
* **SSM and hybrid models** — Mamba-2 ('m') layers carry a recurrent state
  per slot with no sequence axis, so it stays slot-indexed in the paged
  layout too; a preempted request's state is rebuilt by re-prefilling its
  prompt and generated tokens.

Caches are updated in place (the reference donates them to its jitted
programs).  Weights are cast to the compute dtype once, at construction.
The per-step inputs reach the card in one copy (the program's pinned
staging buffer); the page table is a static device buffer rewritten only
when the table changed.

The engine runs on the CUDA card unless the caller passes ``device="cpu"``;
without CUDA it raises.  Not ported yet (they raise
``NotImplementedError``): chunked prefill, plan binding, meters, the tracer,
lint and capacity planning.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.attention import cache_seq_axes, insert_pages
from repro_torch.serve.kv import PagePool, PageTable, PoolExhausted, pages_for
from repro_torch.serve.programs import StepProgram
from repro_torch.serve.request import Completion, Request, RequestState, Token
from repro_torch.serve.sampler import Sampler, policy_of, sample_tokens
from repro_torch.serve.scheduler import Scheduler

PHASES = ("prefill", "decode")


def resolve_device(device: "torch.device | str") -> torch.device:
    """The serving device; a CUDA device without CUDA raises (only an
    explicit ``"cpu"`` runs on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch serves on the CUDA card; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    return device


@dataclasses.dataclass
class PhaseTelemetry:
    """Wall time and tokens of one phase, summed over its calls.  Every call
    ends in a device-to-host read of the sampled tokens, so the wall time
    covers the device work."""

    phase: str
    calls: int = 0
    seconds: float = 0.0
    tokens: int = 0

    def add(self, seconds: float, tokens: int) -> None:
        self.calls += 1
        self.seconds += seconds
        self.tokens += tokens

    @property
    def tokens_per_second(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (
            f"{self.phase}: {self.tokens} tok in {self.seconds:.2f}s "
            f"({self.tokens_per_second:.1f} tok/s, {self.calls} calls)"
        )


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One engine lifetime in numbers."""

    steps: int
    requests_submitted: int
    requests_completed: int
    prefill_calls: int
    decode_steps: int
    tokens_generated: int
    slot_reuses: int
    max_active: int
    preemptions: int = 0


class ServeEngine:
    """Request-level serving engine over the LM (dense, SSM or hybrid).

    ``cfg`` is an :class:`ArchConfig` or an arch name.  ``params`` (the
    port's parameter tree, e.g. from :mod:`repro_torch.bridge`) defaults to
    seeded random weights created on ``device``.  ``page_size`` switches the
    KV cache to the block-paged layout; ``n_pages`` sizes the pool (default:
    capacity-equivalent, ``n_slots * ceil(max_len / page_size)``) — a
    smaller pool over-commits, and preemption reclaims pages when it fills.
    ``prefill_bucket`` pads prompts up to a multiple of the bucket (the
    padded K/V rows are never attended: each decode step overwrites
    position ``index`` before the mask admits it); a pattern with SSM
    layers refuses it, since padding would run through the recurrence.
    On the card, prefill runs as CUDA graphs only with a bucket.
    """

    def __init__(
        self,
        cfg: ArchConfig | str,
        *,
        params: Any = None,
        n_slots: int = 4,
        max_len: int = 256,
        sampler: Sampler | None = None,
        max_tokens_per_step: int | None = None,
        prefill_bucket: int | None = None,
        page_size: int | None = None,
        n_pages: int | None = None,
        seed: int = 0,
        device: "torch.device | str" = "cuda",
        prefill_chunk: int | None = None,
        plan_dir: str | None = None,
        decode_impl: str = "auto",
        meter: Any = None,
        tracer: Any = None,
    ) -> None:
        asked = [
            name for name, value in (
                ("prefill_chunk", prefill_chunk), ("plan_dir", plan_dir),
                ("meter", meter), ("tracer", tracer),
            ) if value is not None
        ] + (["decode_impl"] if decode_impl != "auto" else [])
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: not ported to repro_torch yet"
            )
        if isinstance(cfg, str):
            cfg = get_config(cfg)
        if prefill_bucket is not None and "m" in cfg.pattern():
            raise ValueError(
                "prefill_bucket pads prompts, which corrupts recurrent SSM "
                f"state — unsupported for '{cfg.name}' "
                f"(pattern {cfg.pattern()!r})"
            )
        if n_pages is not None and page_size is None:
            raise ValueError("n_pages given without page_size")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler or Sampler.greedy()
        self.seed = seed
        self.prefill_bucket = prefill_bucket

        # -- KV memory ------------------------------------------------------
        self.paged = page_size is not None
        if self.paged:
            if page_size < 1:
                raise ValueError("page_size must be >= 1")
            max_pages = pages_for(max_len, page_size)
            if n_pages is None:
                n_pages = n_slots * max_pages
            self.kv: PageTable | None = PageTable(
                n_slots, max_pages, PagePool(n_pages, page_size)
            )
            self._slot_len = max_pages * page_size
            self._seq_axes = cache_seq_axes(cfg)  # read for attention groups only
        else:
            self.kv = None
            self._slot_len = max_len
        self._group_kinds = {g.key: g.kind for g in lm.groups_of(cfg)}
        self.cache = lm.init_cache(
            cfg, n_slots, max_len, page_size=page_size, n_pages=n_pages,
            device=self.device,
        )
        # the prefill program's batch-1 cache (mamba2-2.7b: ~170 MB of
        # state), shared by every prefill key and zeroed inside the program
        self._b1_cache = lm.init_cache(cfg, 1, self._slot_len, device=self.device)
        self.scheduler = Scheduler(
            n_slots, max_tokens_per_step, prompt_cost=self._admission_cost,
            kv=self.kv,
        )
        if params is None:
            params = lm.init_params(cfg, seed=seed, device=self.device)
        self.params = lm.cast_for_compute(params, cfg)

        # host-side per-slot state (uploaded each decode step)
        self._last_tok = np.zeros((n_slots, 1), np.int32)
        self._seeds = np.zeros((n_slots,), np.int32)
        self._gen_counts = np.zeros((n_slots,), np.int32)
        self._temps = np.zeros((n_slots,), np.float32)
        self._topks = np.zeros((n_slots,), np.int32)
        self._lengths = np.zeros((n_slots,), np.int64)  # resident tokens
        # the static device page table, rewritten only when the table changed
        self._pages_dev = (
            torch.tensor(self.kv.array(), device=self.device) if self.paged else None
        )
        self._pages_version = self.kv.version if self.paged else -1

        # the compiled steps; their graphs share one memory pool, which holds
        # about the largest key's activations (a graph's outputs stay live:
        # (1, V) f32 logits a prefill key), and never drop a graph: decode
        # has at most three keys, a bucketed prefill three per bucket
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.programs = {
            "decode": StepProgram("decode", self._decode_step, 5 * n_slots, self.device,
                                  pool=pool),
            "prefill": StepProgram("prefill", self._prefill_step, max_len + 5, self.device,
                                   pool=pool, graphs=prefill_bucket is not None),
        }

        self.telemetry = {p: PhaseTelemetry(p) for p in PHASES}
        self._decode_seconds: collections.deque = collections.deque(maxlen=256)
        self.completions: dict[int, Completion] = {}
        self._finished: list[Completion] = []
        self._next_id = 0
        self._steps = 0
        self._max_active = 0

    # -- admission policy ------------------------------------------------------
    @staticmethod
    def _ctx_len(state: RequestState) -> int:
        """Tokens an admission must (re-)prefill: the prompt, plus any
        tokens generated before a preemption."""
        return len(state.request.prompt) + len(state.tokens)

    def _admission_cost(self, state: RequestState) -> int:
        return self._padded_len(self._ctx_len(state))

    def _padded_len(self, length: int) -> int:
        if self.prefill_bucket:
            bucket = self.prefill_bucket
            length = min(-(-length // bucket) * bucket, self.max_len)
        return length

    def _request_knobs(self, state: RequestState) -> tuple[float, int]:
        return (state.request.sampling or self.sampler).knobs

    # -- the programs ------------------------------------------------------------
    def _prefill_step(self, last, seed, gen_step, temp, topk, tokens, *, policy: str):
        """The prefill program: ``tokens`` (1, Lp) through the blocks into
        the batch-1 cache, zeroed first (a stale SSM state would be the next
        prompt's ``h0``); only the last real position, ``last`` (1,),
        reaches the head.  ``gen_step`` is the sampled token's generation
        index: 0 for a fresh request, len(tokens) when a preempted request
        resumes.  Returns (sampled token (1,), logits (1, V)); the cache
        stays in ``_b1_cache``."""
        cache = self._b1_cache
        for key, group in cache.items():
            if key != "index":
                for leaf in group.values():
                    leaf.zero_()
        x, _ = lm.backbone(self.params, {"tokens": tokens}, self.cfg, "prefill", cache)
        logits = lm.head(self.params, x.index_select(1, last), self.cfg)
        logits = logits[:, 0, : self.cfg.vocab_size]
        cache["index"].copy_(last + 1)
        return sample_tokens(logits, seed, gen_step, temp, topk, policy=policy), logits

    def _decode_step(self, tokens, seeds, steps, temps, topks, *, policy: str):
        """The decode program: one step of the whole slot batch, tokens
        (B, 1), the cache's index advanced in place.  Returns (sampled
        tokens (B,), logits (B, V))."""
        cache = dict(self.cache, pages=self._pages_dev) if self.paged else self.cache
        logits, _ = lm.decode_step(self.params, tokens, self.cfg, cache)
        logits = logits[:, 0, : self.cfg.vocab_size]
        return sample_tokens(logits, seeds, steps, temps, topks, policy=policy), logits

    def _prefill(self, context: Sequence[int], state: RequestState) -> torch.Tensor:
        """Batch-1 prefill of ``context`` into ``_b1_cache``; returns the
        sampled token (1,)."""
        tokens = np.zeros((1, self._padded_len(len(context))), np.int32)
        tokens[0, : len(context)] = context
        temp, topk = self._request_knobs(state)
        i32 = lambda v: np.asarray([v], np.int32)  # noqa: E731
        tok, _ = self.programs["prefill"](
            [i32(len(context) - 1), i32(state.seed), i32(len(state.tokens)),
             np.asarray([temp], np.float32), i32(topk), tokens],
            policy=policy_of([temp], [topk]),
        )
        return tok

    def _sync_pages(self) -> None:
        """Rewrite the static device page table if the table changed."""
        if self._pages_version != self.kv.version:
            self._pages_dev.copy_(torch.tensor(self.kv.array()))
            self._pages_version = self.kv.version

    def _insert(self, slot: int) -> None:
        """Write the prefilled batch-1 cache into ``slot``: the slot row of
        the contiguous cache (and of every SSM state), or the slot's pages
        of the pool (entries past the allocation land in the null page)."""
        b1_cache = self._b1_cache
        if self.paged:
            self._sync_pages()
        for key, value in self.cache.items():
            if key == "index":
                value[slot] = b1_cache[key][0]
            elif self.paged and self._group_kinds[key] != "m":
                for leaf in value:
                    insert_pages(value[leaf], b1_cache[key][leaf], self._pages_dev[slot],
                                 self._seq_axes[leaf])
            else:
                for leaf in value:
                    value[leaf][:, slot] = b1_cache[key][leaf][:, 0]

    def _decode_inputs(self) -> list[np.ndarray]:
        return [self._last_tok, self._seeds, self._gen_counts, self._temps, self._topks]

    def _decode(self, active: Sequence[int]) -> torch.Tensor:
        """One decode step for the whole slot batch, its policy from the
        ``active`` slots' knobs; returns (B,) tokens."""
        if self.paged:
            self._sync_pages()
        slots = list(active)
        policy = policy_of(self._temps[slots], self._topks[slots])
        tok, _ = self.programs["decode"](self._decode_inputs(), policy=policy)
        return tok

    def graph_stats(self) -> dict:
        """Each step program's calls, eager calls, captures, replays,
        capture seconds and graph keys."""
        return {name: program.summary() for name, program in self.programs.items()}

    # -- public API ------------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its request id.  Admission happens on a
        later ``step()`` when a slot, budget and pages are available."""
        total = len(request.prompt) + request.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"request needs {total} cache positions "
                f"(prompt {len(request.prompt)} + {request.max_new_tokens} "
                f"new) but slots hold max_len={self.max_len}"
            )
        if self.kv is not None and self.kv.pages_needed(total) > self.kv.pool.n_pages:
            raise ValueError(
                f"request needs {self.kv.pages_needed(total)} pages "
                f"(prompt {len(request.prompt)} + {request.max_new_tokens} "
                f"new at page_size={self.kv.pool.page_size}) but the pool "
                f"holds {self.kv.pool.n_pages} — it could never be resident"
            )
        request_id = self._next_id
        self._next_id += 1
        seed = (
            request.seed
            if request.seed is not None
            else (self.seed * 1_000_003 + request_id) & 0x7FFFFFFF
        )
        self.scheduler.enqueue(
            RequestState(
                request_id=request_id,
                request=request,
                slot=-1,
                seed=seed,
                submitted_at=time.perf_counter(),
            )
        )
        return request_id

    @torch.no_grad()
    def step(self) -> list[Token | Completion]:
        """One scheduling round: admissions (a prefill each), then one
        decode step over every active slot.  Returns the streamed events in
        generation order."""
        if not self.scheduler.has_work:
            return []
        self._steps += 1
        events: list[Token | Completion] = []
        admitted = self.scheduler.admissions()
        # concurrency peaks right after admission, before same-step
        # finishes release their slots
        self._max_active = max(self._max_active, len(self.scheduler.active))
        for state in admitted:
            events.extend(self._admit(state))
        if self.scheduler.active:
            events.extend(self._decode_active())
        return events

    def run_until_idle(self, max_steps: int | None = None) -> list[Completion]:
        """Drive ``step()`` until every submitted request has completed;
        returns the completions in finish order."""
        start = len(self._finished)
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"engine still busy after {max_steps} steps "
                    f"({len(self.scheduler.active)} active, "
                    f"{len(self.scheduler.waiting)} waiting)"
                )
        return self._finished[start:]

    def stream(self, requests: Iterable[Request]) -> "Iterable[Token | Completion]":
        """Submit ``requests`` and yield events until idle."""
        for request in requests:
            self.submit(request)
        while self.scheduler.has_work:
            yield from self.step()

    @property
    def stats(self) -> EngineStats:
        return EngineStats(
            steps=self._steps,
            requests_submitted=self._next_id,
            requests_completed=len(self._finished),
            prefill_calls=self.telemetry["prefill"].calls,
            decode_steps=self.telemetry["decode"].calls,
            tokens_generated=sum(len(c.tokens) for c in self._finished)
            + sum(len(s.tokens) for s in self.scheduler.active.values()),
            slot_reuses=self.scheduler.slot_reuses,
            max_active=self._max_active,
            preemptions=self.scheduler.preemptions,
        )

    def median_decode_step(self) -> float:
        """Median wall seconds of the recent decode steps (0 before any)."""
        return statistics.median(self._decode_seconds) if self._decode_seconds else 0.0

    def lint(self, envelope: Any = None) -> list:
        raise NotImplementedError("lint: not ported to repro_torch yet")

    def plan_capacity(self, envelope: Any = None) -> Any:
        raise NotImplementedError("plan_capacity: not ported to repro_torch yet")

    # -- admission / decode ----------------------------------------------------
    def _preempt_for_pages(self, needy_slot: int) -> bool:
        """Reclaim pages by preempting the youngest other request, finally
        the needy slot itself (requeue beats deadlock).  Returns False when
        there is nothing left to preempt."""
        others = [s for s in self.scheduler.active if s != needy_slot]
        pool = others or ([needy_slot] if needy_slot in self.scheduler.active else [])
        if not pool:
            return False
        victim = max(pool, key=lambda s: self.scheduler.active[s].admit_seq)
        self.scheduler.preempt(victim)
        self._gen_counts[victim] = 0
        self._lengths[victim] = 0
        return True

    def _ensure_pages(self, slot: int, n_tokens: int) -> None:
        """Grow the slot to ``n_tokens`` of page capacity, preempting under
        pool pressure."""
        while True:
            try:
                self.kv.ensure(slot, n_tokens)
                return
            except PoolExhausted:
                if not self._preempt_for_pages(slot):
                    raise
                if slot not in self.scheduler.active:
                    return  # the needy slot preempted itself

    def _admit(self, state: RequestState) -> list[Token | Completion]:
        context = list(state.request.prompt) + list(state.tokens)
        t0 = time.perf_counter()
        tok = self._prefill(context, state)
        self._insert(state.slot)
        events: list[Token | Completion] = []
        self._commit_slot(state, int(tok[0]), events)  # syncs the device
        self.telemetry["prefill"].add(time.perf_counter() - t0, len(context))
        return events

    def _commit_slot(self, state: RequestState, first: int, events: list) -> None:
        """Record the prefill's sampled token and arm the slot for decode."""
        slot = state.slot
        temp, topk = self._request_knobs(state)
        gen_index = len(state.tokens)
        self._last_tok[slot, 0] = first
        self._seeds[slot] = state.seed
        self._gen_counts[slot] = gen_index + 1
        self._temps[slot] = temp
        self._topks[slot] = topk
        self._lengths[slot] = self._ctx_len(state)
        if state.first_token_at is None:
            state.first_token_at = time.perf_counter()
        state.tokens.append(first)
        events.append(Token(state.request_id, first, gen_index, "prefill", self._steps))
        if state.done:
            events.append(self._finish(slot))

    def _decode_active(self) -> list[Token | Completion]:
        if self.paged:
            # grow page capacity for this step's writes up front; under
            # pool pressure this preempts the youngest request
            for slot in sorted(self.scheduler.active):
                if slot in self.scheduler.active:  # not preempted meanwhile
                    self._ensure_pages(slot, int(self._lengths[slot]) + 1)
        active = dict(self.scheduler.active)
        if not active:
            return []
        t0 = time.perf_counter()
        toks = self._decode(active).cpu().numpy()  # the only device->host transfer
        elapsed = time.perf_counter() - t0
        self.telemetry["decode"].add(elapsed, len(active))
        self._decode_seconds.append(elapsed)

        events: list[Token | Completion] = []
        for slot, state in active.items():
            token = int(toks[slot])
            self._last_tok[slot, 0] = token
            self._gen_counts[slot] += 1
            self._lengths[slot] += 1
            index = len(state.tokens)
            state.tokens.append(token)
            events.append(Token(state.request_id, token, index, "decode", self._steps))
            if state.done:
                events.append(self._finish(slot))
        return events

    def _finish(self, slot: int) -> Completion:
        state = self.scheduler.release(slot)
        self._gen_counts[slot] = 0
        self._lengths[slot] = 0
        completion = Completion(
            request_id=state.request_id,
            prompt=state.request.prompt,
            tokens=tuple(state.tokens),
            finish_reason=state.finish_reason,
            submitted_at=state.submitted_at,
            first_token_at=state.first_token_at or time.perf_counter(),
            finished_at=time.perf_counter(),
            admitted_at=state.admitted_at,
        )
        self.completions[state.request_id] = completion
        self._finished.append(completion)
        return completion
