"""ServeEngine — request-level serving with continuous batching (the port
of ``repro/serve/engine.py``).

Callers ``submit()`` :class:`Request` objects at any time and drive the
engine with ``step()`` (one scheduling round: in-flight prefill chunks,
then admissions of waiting requests into free KV slots, then one decode
step for every decodable slot) or ``run_until_idle()``; they get
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
* **Chunked prefill** — ``prefill_chunk`` (attention-family archs only)
  splits prompts longer than one chunk into chunk-sized pieces run on
  consecutive steps, interleaved with the in-flight decodes, with the
  reference's scheduling: the same chunks run in the same steps, charge
  the same budget and preempt in the same order.  Each chunk extends the
  slot's own cache in place — through the slot's page row on the paged
  cache (the paged attention kernel's extend route at B=1, S=chunk), or
  the slot's row of the contiguous cache, picked by a device slot tensor.
  Every chunk is ``prefill_chunk`` wide: the final one covers the window
  ``[ctx - chunk, ctx)``, re-extending positions an earlier chunk wrote
  with the same values, and samples from its last position; the budget
  and telemetry still count the ``run`` new tokens, as the reference does.
  An MoE model's final chunk runs at its exact width instead, as the
  reference's: its router groups a chunk's tokens under a capacity set by
  the width, so a re-extended position would not keep its values (and
  ``extend_sample`` takes a key per final width).
  A mid-prefill slot's row of the decode step's page table is the null
  row, so decode's write for it lands in the null page.
* **Sampling on the device** — logits never leave the card; the per-step
  host transfer is the (B,) token ids.
* **Compiled steps** — the decode step of the whole slot batch, each
  admission's prefill, and the chunk programs ``extend`` and
  ``extend_sample``, sampling fused in where a token is drawn, run as step
  programs (:mod:`repro_torch.serve.programs`), the counterparts of the
  reference's jitted programs: on the card each key (sampling policy; for
  prefill the padded length too) runs eagerly once, is captured as a CUDA
  graph at its second call and replayed from then on.  Decode has at most
  three keys, one per policy, whatever the batch's composition; so has
  ``extend_sample``, and ``extend`` has one.  Prefill is graphed only with
  ``prefill_bucket``, where its lengths are few; exact lengths are too
  many to pay for their captures, so they run eagerly.  The prefill fills
  one static batch-1 cache, zeroed inside the program; the insert into the
  slot stays a few eager copies.
* **MoE and MLA models** (arctic, deepseek-v2) — bucket pads route and
  take expert capacity as the reference's do; an MLA cache holds the
  latent ``c`` and rope key ``kr`` per position (page inserts and seq axes
  per leaf).  A patch-embed frontend (pixtral) has no token prompt and is
  refused, as by the reference.
* **SSM and hybrid models** — Mamba-2 ('m') layers carry a recurrent state
  per slot with no sequence axis, so it stays slot-indexed in the paged
  layout too; a preempted request's state is rebuilt by re-prefilling its
  prompt and generated tokens.
* **Observability** — request-lifecycle spans and events on a
  :class:`repro_torch.obs.Tracer` (disabled unless one is passed), a
  :class:`repro_torch.obs.MetricsRegistry` fed by per-phase
  :class:`PhaseTelemetry`, the scheduler and a decode
  :class:`~repro_torch.runtime.monitor.StepMonitor`, and
  :meth:`ServeEngine.metrics` for KV-pool utilization, stranded capacity
  and page fragmentation.
* **Plan binding** — ``plan_dir`` / ``plan_keys`` bind each phase
  (prefill, which covers the chunk programs, and decode) to a committed
  offload plan (:func:`repro_torch.offload.zoo.plan_zoo`), and
  ``decode_impl`` pins decode's ``paged_attention`` target.  Each program
  call runs under its phase's binding; the binding is part of a program's
  key, so a bound phase captures its own graphs.

Caches are updated in place (the reference donates them to its jitted
programs).  Weights are cast to the compute dtype once, at construction.
The per-step inputs reach the card in one copy (the program's pinned
staging buffer); the page table is a static device buffer rewritten only
when the table changed.

The engine runs on the CUDA card unless the caller passes ``device="cpu"``;
without CUDA it raises.  Not ported yet (they raise
``NotImplementedError``): meters, lint and capacity planning.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import blocks as blocks_mod
from repro_torch.models import lm
from repro_torch.models.attention import cache_seq_axes, insert_pages
from repro_torch.obs import MetricsRegistry, Tracer, get_tracer
from repro_torch.offload.session import stored_binding
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.serve.kv import PagePool, PageTable, PoolExhausted, pages_for
from repro_torch.serve.programs import StepProgram
from repro_torch.serve.request import Completion, Request, RequestState, Token
from repro_torch.serve.sampler import Sampler, policy_of, sample_tokens
from repro_torch.serve.scheduler import Scheduler, request_track

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


def _i32(value: int) -> np.ndarray:
    return np.asarray([value], np.int32)


@dataclasses.dataclass
class PhaseTelemetry:
    """Wall time and tokens of one phase, summed over its calls.  Every call
    ends in a device-to-host read of the sampled tokens or a device
    synchronisation, so the wall time covers the device work.

    With a ``registry`` (a :class:`repro_torch.obs.MetricsRegistry`), every
    :meth:`add` also writes through to the
    ``serve_phase_{calls,seconds,tokens,joules}_total{phase=...}`` counters:
    one observation feeds both views.  ``joules`` and ``provenance`` stay
    None: the port has no power meter yet.
    """

    phase: str
    calls: int = 0
    seconds: float = 0.0
    tokens: int = 0
    joules: float | None = None
    provenance: str | None = None
    registry: Any = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        self._counters = None
        if self.registry is not None:
            lab = {"phase": self.phase}
            reg = self.registry
            self._counters = (
                reg.counter("serve_phase_calls_total",
                            "phase program invocations", ("phase",)).labels(**lab),
                reg.counter("serve_phase_seconds_total",
                            "wall seconds inside phase programs", ("phase",)).labels(**lab),
                reg.counter("serve_phase_tokens_total",
                            "tokens processed per phase", ("phase",)).labels(**lab),
                # registered for the exposition's schema; fed once a meter is
                reg.counter("serve_phase_joules_total",
                            "metered energy per phase", ("phase",)).labels(**lab),
            )

    def add(self, seconds: float, tokens: int) -> None:
        self.calls += 1
        self.seconds += seconds
        self.tokens += tokens
        if self._counters is not None:
            calls_c, seconds_c, tokens_c, _ = self._counters
            calls_c.inc()
            seconds_c.inc(max(seconds, 0.0))
            tokens_c.inc(tokens)

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
    prefill_chunks: int = 0


@dataclasses.dataclass
class _PrefillProgress:
    """One request mid-chunked-prefill: its context and how much of it the
    slot's cache holds."""

    state: RequestState
    context: list[int]
    pos: int = 0


class ServeEngine:
    """Request-level serving engine over the LM (dense, MoE, MLA, SSM or hybrid).

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
    ``prefill_chunk`` enables chunked prefill (attention-family archs only:
    a recurrent SSM scan cannot resume across chunk boundaries).

    ``plan_dir``/``plan_keys`` bind each phase to a committed offload plan:
    with ``plan_dir`` alone the stored ``zoo:<arch>:prefill`` /
    ``zoo:<arch>:decode`` plans are bound when present (and compatible with
    this environment); ``plan_keys`` may name one key for both phases or a
    ``{phase: key}`` map, and a named key that cannot bind raises.
    ``decode_impl`` (``auto|torch|cuda``, paged cache only) pins the decode
    step's ``paged_attention`` target over whatever the decode plan picked.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`; default the process
    tracer, disabled) records request-lifecycle spans; ``registry`` (a
    :class:`repro_torch.obs.MetricsRegistry`; default a fresh one) holds
    the ``serve_*`` metric families; ``monitor`` (a
    :class:`~repro_torch.runtime.monitor.StepMonitor`) times decode steps
    into ``serve_step_seconds``.
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
        prefill_chunk: int | None = None,
        page_size: int | None = None,
        n_pages: int | None = None,
        seed: int = 0,
        device: "torch.device | str" = "cuda",
        monitor: StepMonitor | None = None,
        tracer: Tracer | None = None,
        registry: MetricsRegistry | None = None,
        plan_dir: str | None = None,
        plan_keys: "dict[str, str | None] | str | None" = None,
        decode_impl: str = "auto",
        meter: Any = None,
        quiet: bool = True,
    ) -> None:
        if meter is not None:
            raise NotImplementedError("meter: not ported to repro_torch yet")
        if isinstance(cfg, str):
            cfg = get_config(cfg)
        if cfg.frontend == "patch_embed":
            raise ValueError(
                f"{cfg.name}: patch-embed frontends have no token prompt "
                "path; the serving engine takes token-id requests"
            )
        if prefill_bucket is not None and "m" in cfg.pattern():
            raise ValueError(
                "prefill_bucket pads prompts, which corrupts recurrent SSM "
                f"state — unsupported for '{cfg.name}' "
                f"(pattern {cfg.pattern()!r})"
            )
        if prefill_chunk is not None and "m" in cfg.pattern():
            raise ValueError(
                "prefill_chunk resumes the sequence mid-prompt, which an "
                f"SSM scan cannot do — unsupported for '{cfg.name}' "
                f"(pattern {cfg.pattern()!r})"
            )
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if n_pages is not None and page_size is None:
            raise ValueError("n_pages given without page_size")
        if decode_impl not in ("auto", "torch", "cuda"):
            raise ValueError(
                f"decode_impl must be auto|torch|cuda, got {decode_impl!r}"
            )
        if decode_impl != "auto" and page_size is None:
            raise ValueError(
                "decode_impl pins the paged_attention binding — it requires "
                "the paged KV cache (page_size)"
            )
        self.decode_impl = decode_impl
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler or Sampler.greedy()
        self.seed = seed
        self.prefill_bucket = prefill_bucket
        self.prefill_chunk = prefill_chunk

        # -- observability -------------------------------------------------
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry = registry if registry is not None else MetricsRegistry()
        self._queue_depth_g = self.registry.gauge(
            "serve_queue_depth", "requests waiting for a slot")
        self._active_slots_g = self.registry.gauge(
            "serve_active_slots", "requests resident in KV slots")
        self._kv_util_g = self.registry.gauge(
            "serve_kv_utilization_pct", "KV pool/slot utilization")
        self._kv_stranded_g = self.registry.gauge(
            "serve_kv_stranded_pct", "reserved-but-unused KV capacity")
        self._kv_frag_g = self.registry.gauge(
            "serve_kv_fragmentation_pct", "partial-page fragmentation")
        self._submitted_c = self.registry.counter(
            "serve_requests_submitted_total", "requests accepted by submit()")
        self._completed_c = self.registry.counter(
            "serve_requests_completed_total", "requests finished")
        self._generated_c = self.registry.counter(
            "serve_tokens_generated_total", "tokens sampled across requests")
        self._step_hist = self.registry.histogram(
            "serve_step_seconds", "fused decode step latency")
        self.monitor = monitor or StepMonitor()
        if self.monitor.histogram is None:
            self.monitor.histogram = self._step_hist

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
            kv=self.kv, admit_tokens=self._admission_tokens,
            tracer=self.tracer, metrics=self.registry,
        )
        if params is None:
            params = lm.init_params(cfg, seed=seed, device=self.device)
        self.params = lm.cast_for_compute(params, cfg)

        # -- plan-aware phase dispatch ------------------------------------
        # keys the caller named explicitly must fail loudly when they
        # cannot bind (an explicit request is a contract, not a hint);
        # store-derived defaults degrade with a message
        explicit = plan_keys is not None
        if explicit and not plan_dir:
            raise ValueError(
                "plan_keys given without plan_dir — both are required to "
                "bind a committed plan"
            )
        self.plan_keys = self._resolve_plan_keys(plan_dir, plan_keys)
        self._bindings: dict[str, dict[str, str] | None] = {}
        for phase in PHASES:
            key = self.plan_keys[phase]
            mapping = stored_binding(plan_dir, key) if plan_dir and key else None
            if key and mapping is None:
                if explicit:
                    raise ValueError(
                        f"plan '{key}' for phase '{phase}' not "
                        f"found/compatible in {plan_dir}"
                    )
                if not quiet:
                    print(
                        f"serve: plan '{key}' not found/compatible in "
                        f"{plan_dir}; {phase} runs on default bindings"
                    )
            elif mapping and not quiet:
                print(f"serve: {phase} bound to plan '{key}': {mapping}")
            self._bindings[phase] = mapping
        # an explicit decode_impl overrides whatever the stored decode plan
        # (or the device's default) would pick for the hot loop's
        # paged_attention block; "auto" leaves the planner's choice alone
        if decode_impl != "auto":
            base = self._bindings.get("decode") or {}
            self._bindings["decode"] = {**base, "paged_attention": decode_impl}

        # host-side per-slot state (uploaded each decode step)
        self._last_tok = np.zeros((n_slots, 1), np.int32)
        self._seeds = np.zeros((n_slots,), np.int32)
        self._gen_counts = np.zeros((n_slots,), np.int32)
        self._temps = np.zeros((n_slots,), np.float32)
        self._topks = np.zeros((n_slots,), np.int32)
        self._lengths = np.zeros((n_slots,), np.int64)  # resident tokens
        #: slots mid-chunked-prefill (slot -> _PrefillProgress); these hold
        #: a slot and pages but sit out decode until the final chunk
        #: samples their first token
        self._prefilling: dict[int, _PrefillProgress] = {}
        # the static device page table, rewritten only when the table or
        # the set of mid-prefill slots (null rows there) changed
        self._pages_dev = (
            torch.tensor(self.kv.array(), device=self.device) if self.paged else None
        )
        self._pages_key: tuple | None = (self.kv.version, ()) if self.paged else None

        # the compiled steps; their graphs share one memory pool, which holds
        # about the largest key's activations (a graph's outputs stay live:
        # (1, V) f32 logits a prefill key), and never drop a graph: decode
        # has at most three keys, a bucketed prefill three per bucket, the
        # chunk programs four
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.programs = {
            "decode": StepProgram("decode", self._decode_step, 5 * n_slots, self.device,
                                  pool=pool),
            "prefill": StepProgram("prefill", self._prefill_step, max_len + 5, self.device,
                                   pool=pool, graphs=prefill_bucket is not None),
        }
        if prefill_chunk is not None:
            words = 6 + prefill_chunk + (self.kv.max_pages if self.paged else 1)
            self.programs["extend"] = StepProgram(
                "extend", self._extend_step, words, self.device, pool=pool)
            self.programs["extend_sample"] = StepProgram(
                "extend_sample", self._extend_sample_step, words, self.device, pool=pool)

        self.telemetry = {p: PhaseTelemetry(p, registry=self.registry) for p in PHASES}
        self.completions: dict[int, Completion] = {}
        self._finished: list[Completion] = []
        self._next_id = 0
        self._submitted = 0
        self._steps = 0
        self._max_active = 0
        self._chunk_calls = 0
        #: positions the final chunks re-extended beyond their ``run`` new
        #: tokens (each final chunk covers ``prefill_chunk`` positions)
        self.overlap_tokens = 0
        # per-step KV-health samples (while requests were resident):
        # (utilization_pct, stranded_pct, fragmentation_pct) running sums
        self._kv_samples = 0
        self._kv_sums = [0.0, 0.0, 0.0]

    # -- admission policy ------------------------------------------------------
    @staticmethod
    def _ctx_len(state: RequestState) -> int:
        """Tokens an admission must (re-)prefill: the prompt, plus any
        tokens generated before a preemption."""
        return len(state.request.prompt) + len(state.tokens)

    def _is_chunked(self, ctx: int) -> bool:
        return self.prefill_chunk is not None and ctx > self.prefill_chunk

    def _admission_cost(self, state: RequestState) -> int:
        """Budget tokens the admission's first program call runs."""
        ctx = self._ctx_len(state)
        if self._is_chunked(ctx):
            return self.prefill_chunk
        return self._padded_len(ctx)

    def _admission_tokens(self, state: RequestState) -> int:
        """Tokens the admission must hold pages for right now."""
        ctx = self._ctx_len(state)
        if self._is_chunked(ctx):
            return min(ctx, self.prefill_chunk)
        return ctx

    # -- plan resolution ------------------------------------------------------
    def _resolve_plan_keys(
        self,
        plan_dir: str | None,
        plan_keys: "dict[str, str | None] | str | None",
    ) -> dict[str, str | None]:
        if isinstance(plan_keys, str):
            return {p: plan_keys for p in PHASES}
        if plan_keys is not None:
            unknown = set(plan_keys) - set(PHASES)
            if unknown:
                raise KeyError(
                    f"unknown serve phases {sorted(unknown)}; known: {PHASES}"
                )
            return {p: plan_keys.get(p) for p in PHASES}
        if plan_dir:
            from repro_torch.offload.zoo import default_plan_key

            # zoo plans are keyed by the *base* arch — a reduced config
            # (verification-environment shape) binds the same plans
            arch = self.cfg.name.removesuffix("-reduced")
            return {p: default_plan_key(plan_dir, arch, p) for p in PHASES}
        return {p: None for p in PHASES}

    def _phase(self, phase: str):
        """The scope of ``phase``'s binding (none when it has no plan)."""
        mapping = self._bindings.get(phase)
        if not mapping:
            return contextlib.nullcontext()
        return blocks_mod.registry.bind(mapping)

    def bindings(self) -> dict[str, dict[str, str] | None]:
        """Each phase's bound mapping (None: the default bindings)."""
        return {phase: (dict(m) if m else None) for phase, m in self._bindings.items()}

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

    def _chunk_forward(self, slot, start, pages, tokens) -> torch.Tensor:
        """One prefill chunk, ``tokens`` (1, C) at positions ``start`` (1,)
        on, extended into slot ``slot`` (1,) of the engine cache in place:
        through the slot's page row ``pages`` (1, max_pages) on the paged
        cache (unused on the contiguous one).  The slot's index becomes the
        next write position, ``start + C``.  Returns the hidden states."""
        cache = {key: value for key, value in self.cache.items() if key != "index"}
        cache["index"] = start
        if self.paged:
            cache["pages"] = pages
        else:
            cache["slots"] = slot
        x, _ = lm.backbone(self.params, {"tokens": tokens}, self.cfg, "extend", cache)
        self.cache["index"].index_copy_(0, slot.long(), start + tokens.shape[1])
        return x

    def _extend_step(self, slot, start, pages, tokens) -> None:
        """The ``extend`` program: a non-final chunk, no head, no sampling."""
        self._chunk_forward(slot, start, pages, tokens)

    def _extend_sample_step(self, slot, start, pages, seed, gen_step, temp, topk, tokens, *,
                            policy: str):
        """The ``extend_sample`` program: the final chunk, whose last
        position is the context's last; projects only that position and
        samples the request's next token.  Returns (token (1,), logits
        (1, V))."""
        x = self._chunk_forward(slot, start, pages, tokens)
        logits = lm.head(self.params, x[:, -1:], self.cfg)[:, 0, : self.cfg.vocab_size]
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
        with self._phase("prefill"):
            tok, _ = self.programs["prefill"](
                [_i32(len(context) - 1), _i32(state.seed), _i32(len(state.tokens)),
                 np.asarray([temp], np.float32), _i32(topk), tokens],
                policy=policy_of([temp], [topk]),
            )
        return tok

    def _sync_pages(self) -> None:
        """Rewrite the static device page table if the table or the set of
        mid-prefill slots changed; a mid-prefill slot's row is the null row
        (decode's write for it lands in the null page)."""
        key = (self.kv.version, tuple(sorted(self._prefilling)))
        if key != self._pages_key:
            table = self.kv.array()
            if self._prefilling:
                table = table.copy()
                table[list(self._prefilling)] = self.kv.pool.null_page
            self._pages_dev.copy_(torch.tensor(table))
            self._pages_key = key

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
        with self._phase("decode"):
            tok, _ = self.programs["decode"](self._decode_inputs(), policy=policy)
        return tok

    def _synchronize(self) -> None:
        """Wait for the card (a chunk's wall time then covers its work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        self._submitted += 1
        self._submitted_c.inc()
        seed = (
            request.seed
            if request.seed is not None
            else (self.seed * 1_000_003 + request_id) & 0x7FFFFFFF
        )
        submitted_at = time.perf_counter()
        if self.tracer.enabled:
            self.tracer.event(
                "submit", tid=request_track(request_id),
                request=request_id, prompt=len(request.prompt),
                max_new=request.max_new_tokens,
            )
        self.scheduler.enqueue(
            RequestState(
                request_id=request_id,
                request=request,
                slot=-1,
                seed=seed,
                submitted_at=submitted_at,
            )
        )
        return request_id

    @torch.no_grad()
    def step(self) -> list[Token | Completion]:
        """One scheduling round: in-flight prefill chunks, admissions (a
        prefill — or a first chunk — each), then one decode step over every
        decodable slot.  Returns the streamed events in generation order."""
        if not self.scheduler.has_work:
            return []
        self._steps += 1
        events: list[Token | Completion] = []

        decoding = sum(1 for slot in self.scheduler.active if slot not in self._prefilling)
        planned, reserved = self._plan_chunks(decoding)
        spent = decoding + sum(run for _, run in planned) + reserved
        for slot, run in planned:
            self._run_chunk(slot, run, events)

        admitted = self.scheduler.admissions(spent=spent)
        # concurrency peaks right after admission, before same-step
        # finishes release their slots
        self._max_active = max(self._max_active, len(self.scheduler.active))
        for state in admitted:
            events.extend(self._admit(state))
        if any(slot not in self._prefilling for slot in self.scheduler.active):
            events.extend(self._decode_active())
        self._sample_kv_health()
        self._queue_depth_g.set(len(self.scheduler.waiting))
        self._active_slots_g.set(len(self.scheduler.active))
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

    def reset_stats(self) -> None:
        """Zero every lifetime counter — telemetry, monitor, scheduler
        reuse accounting, completions, the registry and the tracer's
        records — without touching the step programs or the cache.  For
        load generators that warm the programs up front and must not report
        the warmup as served traffic.  Only valid on an idle engine."""
        if self.scheduler.has_work:
            raise RuntimeError("reset_stats on a busy engine")
        # the registry resets in place (child handles stay valid)
        self.registry.reset()
        self.tracer.clear()
        self.telemetry = {p: PhaseTelemetry(p, registry=self.registry) for p in PHASES}
        self.monitor = StepMonitor(
            window=self.monitor.window.maxlen or 32,
            threshold=self.monitor.threshold,
            patience=self.monitor.patience,
            on_straggler=self.monitor.on_straggler,
            histogram=self._step_hist,
        )
        self.scheduler.admitted_per_slot.clear()
        self.scheduler.preemptions = 0
        if self.kv is not None:
            self.kv.pool.peak_used = self.kv.pool.used_pages
        self.completions.clear()
        self._finished.clear()
        self._submitted = 0
        self._steps = 0
        self._max_active = 0
        self._chunk_calls = 0
        self.overlap_tokens = 0
        self._kv_samples = 0
        self._kv_sums = [0.0, 0.0, 0.0]

    @property
    def stats(self) -> EngineStats:
        return EngineStats(
            steps=self._steps,
            requests_submitted=self._submitted,
            requests_completed=len(self._finished),
            prefill_calls=self.telemetry["prefill"].calls,
            decode_steps=self.telemetry["decode"].calls,
            tokens_generated=sum(len(c.tokens) for c in self._finished)
            + sum(len(s.tokens) for s in self.scheduler.active.values()),
            slot_reuses=self.scheduler.slot_reuses,
            max_active=self._max_active,
            preemptions=self.scheduler.preemptions,
            prefill_chunks=self._chunk_calls,
        )

    def median_decode_step(self) -> float:
        """Median wall seconds of the monitor's recent decode steps (0
        before any)."""
        return self.monitor.median_step()

    def _kv_snapshot(self) -> tuple[float, float, float]:
        """(utilization %, stranded %, fragmentation %) right now."""
        if self.kv is not None:
            pool = self.kv.pool
            return (
                100.0 * pool.used_pages / pool.n_pages,
                self.kv.stranded_pct,
                self.kv.fragmentation_pct,
            )
        active = len(self.scheduler.active)
        resident = int(sum(self._lengths[slot] for slot in self.scheduler.active))
        reserved = active * self.max_len
        return (
            100.0 * reserved / (self.n_slots * self.max_len),
            100.0 * (reserved - resident) / reserved if reserved else 0.0,
            0.0,
        )

    def _sample_kv_health(self) -> None:
        if not self.scheduler.active:
            return
        util, stranded, frag = self._kv_snapshot()
        self._kv_samples += 1
        self._kv_sums[0] += util
        self._kv_sums[1] += stranded
        self._kv_sums[2] += frag
        self._kv_util_g.set(util)
        self._kv_stranded_g.set(stranded)
        self._kv_frag_g.set(frag)

    def metrics(self) -> dict:
        """KV memory health: pool utilization, stranded capacity and page
        fragmentation (paged), or the contiguous equivalents.  The
        ``mean_*`` keys average one sample per engine step taken while
        requests were resident; ``programs`` is :meth:`graph_stats`."""
        active = len(self.scheduler.active)
        resident = int(sum(self._lengths[slot] for slot in self.scheduler.active))
        n = max(self._kv_samples, 1)
        out: dict = {
            "mode": "paged" if self.paged else "contiguous",
            "n_slots": self.n_slots,
            "max_len": self.max_len,
            "active": active,
            "waiting": len(self.scheduler.waiting),
            "preemptions": self.scheduler.preemptions,
            "prefill_chunks": self._chunk_calls,
            "mean_utilization_pct": self._kv_sums[0] / n,
            "mean_stranded_pct": self._kv_sums[1] / n,
            "mean_fragmentation_pct": self._kv_sums[2] / n,
        }
        out["programs"] = self.graph_stats()
        if self.kv is not None:
            out["kv"] = self.kv.stats()
        else:
            util, stranded, _ = self._kv_snapshot()
            out["kv"] = {
                "token_capacity": self.n_slots * self.max_len,
                "resident_tokens": resident,
                "reserved_tokens": active * self.max_len,
                "utilization_pct": util,
                "stranded_pct": stranded,
            }
        return out

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """Expose this engine's :class:`~repro_torch.obs.MetricsRegistry`
        over HTTP (Prometheus text at ``/metrics``) on a daemon thread.
        ``port=0`` picks a free port.  Returns the
        :class:`~repro_torch.obs.MetricsServer`; ``.close()`` stops it."""
        from repro_torch.obs import MetricsServer

        return MetricsServer(self.registry, port=port, host=host)

    def profile_steps(self, n_steps: int, logdir: str) -> bool:
        """Drive ``step()`` ``n_steps`` times under a ``torch.profiler``
        window whose Chrome trace is written to ``logdir``.  Returns False
        (and still runs the steps) when the profiler is unavailable."""
        from repro_torch.obs import profile_window

        with profile_window(logdir, tracer=self.tracer, name="serve-steps") as captured:
            for _ in range(n_steps):
                if not self.scheduler.has_work:
                    break
                self.step()
        return captured

    def lint(self, envelope: Any = None) -> list:
        raise NotImplementedError("lint: not ported to repro_torch yet")

    def plan_capacity(self, envelope: Any = None) -> Any:
        raise NotImplementedError("plan_capacity: not ported to repro_torch yet")

    # -- pages -------------------------------------------------------------------
    def _preempt_for_pages(self, needy_slot: int) -> bool:
        """Reclaim pages by preempting the youngest other request —
        decoding victims first, then mid-prefill ones, finally the needy
        slot itself (requeue beats deadlock).  Returns False when there is
        nothing left to preempt."""
        decoding = [
            slot for slot in self.scheduler.active
            if slot not in self._prefilling and slot != needy_slot
        ]
        prefilling = [slot for slot in self._prefilling if slot != needy_slot]
        pool = decoding or prefilling or (
            [needy_slot] if needy_slot in self.scheduler.active else []
        )
        if not pool:
            return False
        victim = max(pool, key=lambda s: self.scheduler.active[s].admit_seq)
        self._prefilling.pop(victim, None)
        self.scheduler.preempt(victim)
        self._gen_counts[victim] = 0
        self._lengths[victim] = 0
        return True

    def _ensure_pages(self, slot: int, n_tokens: int) -> None:
        """Grow the slot to ``n_tokens`` of page capacity, preempting under
        pool pressure."""
        if self.kv is None:
            return
        while True:
            try:
                added = self.kv.ensure(slot, n_tokens)
                if added and self.tracer.enabled and slot in self.scheduler.active:
                    state = self.scheduler.active[slot]
                    self.tracer.event(
                        "kv-grow", tid=request_track(state.request_id),
                        request=state.request_id, slot=slot, pages=len(added),
                    )
                return
            except PoolExhausted:
                if not self._preempt_for_pages(slot):
                    raise
                if slot not in self.scheduler.active:
                    return  # the needy slot preempted itself

    # -- chunked prefill -------------------------------------------------------
    def _plan_chunks(self, decoding: int) -> tuple[list[tuple[int, int]], int]:
        """Pick which mid-prefill slots run a chunk this step, and how many
        new tokens each: budget-capped, but guaranteed progress when nothing
        else runs this step.  Returns ``(planned, reserved)`` — skipped
        chunks reserve their budget tokens so this step's admissions cannot
        refill the budget and starve an in-flight prefill forever."""
        budget = self.scheduler.max_tokens_per_step
        planned: list[tuple[int, int]] = []
        reserved = 0
        spent = decoding
        for slot in sorted(self._prefilling):
            prog = self._prefilling[slot]
            run = min(self.prefill_chunk, len(prog.context) - prog.pos)
            if budget is not None and spent + reserved + run > budget:
                if spent or planned:
                    reserved += run  # held against new admissions
                    continue  # decode / earlier chunks run first
                # nothing else runs this step: progress beats the budget
            planned.append((slot, run))
            spent += run
        return planned, reserved

    def _run_chunk(self, slot: int, run: int, events: list[Token | Completion]) -> None:
        """Extend one request's slot by one chunk of ``run`` new tokens; the
        final chunk samples the next token and arms the slot for decode."""
        if slot not in self._prefilling:
            return  # preempted by an earlier slot's page-ensure this step
        prog = self._prefilling[slot]
        state = prog.state
        ctx = len(prog.context)
        final = prog.pos + run >= ctx
        self._ensure_pages(slot, prog.pos + run)
        if slot not in self._prefilling:
            return  # self-preempted under extreme pool pressure
        # every chunk is prefill_chunk wide (one graph key): the final one
        # ends at the context's end, re-extending the positions before
        # prog.pos that an earlier chunk wrote (ctx > chunk, so it fits).
        # An MoE routes each chunk's tokens as one group under a capacity
        # set by its width, so a token's value depends on its chunk: there
        # the final chunk runs at its exact width, as the reference's does
        width = run if final and self.cfg.moe is not None else self.prefill_chunk
        start = ctx - width if final else prog.pos
        tokens = np.asarray([prog.context[start : start + width]], np.int32)
        pages = (self.kv.array()[slot : slot + 1] if self.paged
                 else np.zeros((1, 1), np.int32))  # unused operand
        head = [_i32(slot), _i32(start), pages]
        self._chunk_calls += 1
        t0 = time.perf_counter()
        if final:
            temp, topk = self._request_knobs(state)
            with self._phase("prefill"):
                tok, _ = self.programs["extend_sample"](
                    head + [_i32(state.seed), _i32(len(state.tokens)),
                            np.asarray([temp], np.float32), _i32(topk), tokens],
                    policy=policy_of([temp], [topk]),
                )
            self.overlap_tokens += width - run
            del self._prefilling[slot]
            self._commit_slot(state, int(tok[0]), events)  # syncs the device
        else:
            with self._phase("prefill"):
                self.programs["extend"](head + [tokens])
            self._synchronize()
            prog.pos += run
        self.telemetry["prefill"].add(time.perf_counter() - t0, run)
        if self.tracer.enabled:
            self.tracer.add_span(
                "prefill-chunk", t0, time.perf_counter(),
                tid=request_track(state.request_id),
                request=state.request_id, slot=slot, tokens=run,
                final=final, step=self._steps,
            )

    # -- admission / decode ----------------------------------------------------
    def _admit(self, state: RequestState) -> list[Token | Completion]:
        context = list(state.request.prompt) + list(state.tokens)
        events: list[Token | Completion] = []
        if self._is_chunked(len(context)):
            self._prefilling[state.slot] = _PrefillProgress(state, context)
            self._run_chunk(state.slot, self.prefill_chunk, events)
            return events
        t0 = time.perf_counter()
        tok = self._prefill(context, state)
        self._insert(state.slot)
        self._commit_slot(state, int(tok[0]), events)  # syncs the device
        self.telemetry["prefill"].add(time.perf_counter() - t0, len(context))
        return events

    def _commit_slot(self, state: RequestState, first: int, events: list) -> None:
        """Record the prefill's sampled token and arm the slot for decode."""
        slot = state.slot
        context = self._ctx_len(state)
        temp, topk = self._request_knobs(state)
        gen_index = len(state.tokens)
        self._last_tok[slot, 0] = first
        self._seeds[slot] = state.seed
        self._gen_counts[slot] = gen_index + 1
        self._temps[slot] = temp
        self._topks[slot] = topk
        self._lengths[slot] = context
        now = time.perf_counter()
        if self.tracer.enabled:
            track = request_track(state.request_id)
            # the prefill span covers admission -> first token, including
            # every chunk for chunked prompts (chunk sub-spans sit inside)
            self.tracer.add_span(
                "prefill", state.last_admitted_at or now, now, tid=track,
                request=state.request_id, slot=slot, tokens=context,
                step=self._steps,
            )
            if state.first_token_at is None:
                self.tracer.event(
                    "first-token", tid=track, request=state.request_id, token=first,
                )
        if state.first_token_at is None:
            state.first_token_at = now
        state.tokens.append(first)
        events.append(Token(state.request_id, first, gen_index, "prefill", self._steps))
        if state.done:
            events.append(self._finish(slot))

    def _decode_active(self) -> list[Token | Completion]:
        if self.paged:
            # grow page capacity for this step's writes up front; under
            # pool pressure this preempts the youngest request
            for slot in sorted(self.scheduler.active):
                if slot in self._prefilling:
                    continue
                if slot in self.scheduler.active:  # not preempted meanwhile
                    self._ensure_pages(slot, int(self._lengths[slot]) + 1)
        active = {
            slot: state for slot, state in self.scheduler.active.items()
            if slot not in self._prefilling
        }
        if not active:
            return []
        t0 = time.perf_counter()
        self.monitor.start()
        toks = self._decode(active).cpu().numpy()  # the only device->host transfer
        self.monitor.stop(self._steps)
        t1 = time.perf_counter()
        self.telemetry["decode"].add(t1 - t0, len(active))
        if self.tracer.enabled:
            # one fused-step span on the engine track, mirrored onto each
            # participating request's track
            self.tracer.add_span("decode", t0, t1, batch=len(active), step=self._steps)
            for state in active.values():
                self.tracer.add_span(
                    "decode", t0, t1, tid=request_track(state.request_id),
                    request=state.request_id, step=self._steps,
                )

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
        self._completed_c.inc()
        self._generated_c.inc(len(completion.tokens))
        if self.tracer.enabled:
            self.tracer.event(
                "complete", tid=request_track(state.request_id),
                request=state.request_id, tokens=len(completion.tokens),
                reason=completion.finish_reason,
            )
        self.completions[state.request_id] = completion
        self._finished.append(completion)
        return completion
