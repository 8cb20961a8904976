"""Request-level serving types: what callers submit and what they get back
(a copy of ``repro/serve/request.py``).

A ``Request`` is one generation job (prompt token ids + budget + sampling
overrides).  While it runs, the engine emits streaming ``Token`` events —
one per generated token, in generation order — and when it finishes (token
budget exhausted or stop token hit) a final ``Completion`` with the full
token list and latency breakdown.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.serve.sampler import Sampler


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation job.

    ``sampling=None`` inherits the engine's default sampler; ``seed=None``
    derives a per-request seed from the engine seed and the request id (so
    a replayed trace is reproducible without the caller choosing seeds).
    """

    prompt: tuple[int, ...]
    max_new_tokens: int = 16
    sampling: Sampler | None = None
    seed: int | None = None
    stop_token: int | None = None

    def __init__(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 16,
        sampling: Sampler | None = None,
        seed: int | None = None,
        stop_token: int | None = None,
    ) -> None:
        object.__setattr__(self, "prompt", tuple(int(t) for t in prompt))
        object.__setattr__(self, "max_new_tokens", int(max_new_tokens))
        object.__setattr__(self, "sampling", sampling)
        object.__setattr__(self, "seed", seed)
        object.__setattr__(self, "stop_token", stop_token)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass(frozen=True)
class Token:
    """One streamed token event."""

    request_id: int
    token_id: int
    index: int  # position in the generated sequence (0 = first new token)
    phase: str  # "prefill" (the token sampled off the prompt) | "decode"
    engine_step: int  # engine step() call that produced it


@dataclasses.dataclass(frozen=True)
class Completion:
    """Terminal event for one request."""

    request_id: int
    prompt: tuple[int, ...]
    tokens: tuple[int, ...]
    finish_reason: str  # "length" | "stop"
    submitted_at: float  # engine clock (time.perf_counter) timestamps
    first_token_at: float
    finished_at: float
    #: when the scheduler last placed the request into a slot (None for
    #: completions built before the scheduler stamped it)
    admitted_at: float | None = None

    @property
    def ttft(self) -> float:
        """Time from submit to first token (includes the queue wait)."""
        return self.first_token_at - self.submitted_at

    @property
    def ttft_admitted(self) -> float:
        """Time from *admission* to first token — the model-side prefill
        latency with the scheduler's queue wait subtracted out.  Folding
        queue wait into TTFT hides scheduler effects; this is the number
        that isolates them."""
        return self.first_token_at - (
            self.admitted_at
            if self.admitted_at is not None
            else self.submitted_at
        )

    @property
    def queue_wait(self) -> float:
        """Time from submit to (the last) admission."""
        if self.admitted_at is None:
            return 0.0
        return self.admitted_at - self.submitted_at

    @property
    def latency(self) -> float:
        """Time from submit to the final token."""
        return self.finished_at - self.submitted_at


@dataclasses.dataclass
class RequestState:
    """Engine-internal per-request bookkeeping (one per active slot)."""

    request_id: int
    request: Request
    slot: int
    seed: int
    submitted_at: float
    first_token_at: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    #: monotonic admission order (preemption evicts the youngest first)
    admit_seq: int = -1
    #: when the request (re-)entered the waiting queue — submit time, or
    #: the preemption time after a requeue (feeds the "queue" trace span)
    queued_at: float = 0.0
    #: when the scheduler *first* placed the request into a slot (fixed
    #: across preemptions — feeds ``Completion.ttft_admitted``)
    admitted_at: float | None = None
    #: the most recent admission (re-stamped on resume — anchors the
    #: "prefill" trace span, which covers this admission's work only)
    last_admitted_at: float = 0.0

    @property
    def done(self) -> bool:
        if self.tokens and self.request.stop_token is not None and (
            self.tokens[-1] == self.request.stop_token
        ):
            return True
        return len(self.tokens) >= self.request.max_new_tokens

    @property
    def finish_reason(self) -> str:
        if self.request.stop_token is not None and self.tokens and (
            self.tokens[-1] == self.request.stop_token
        ):
            return "stop"
        return "length"
