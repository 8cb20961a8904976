"""Token sampling on the device (the port of ``repro/serve/sampler.py``).

:func:`sample_tokens` reduces the (B, V) logits to (B,) token ids on the
logits' device, so the per-step host transfer is token ids only.  The
per-slot knobs — ``temperature`` and ``top_k`` — are (B,) tensors, so a
batch mixes greedy and top-k requests in one call.  Greedy is
``temperature == 0``; ``top_k == 0`` disables the top-k filter.

Random draws are the reference's ``jax.random`` draws, bit for bit: the
key of a slot is ``fold_in(fold_in(PRNGKey(0), seed), step)`` and the
token is ``categorical`` over ``logits / temperature``, i.e. the argmax of
the logits plus Gumbel noise made from threefry2x32 random bits (JAX's
default ``threefry_partitionable`` layout).  The generator is written in
int64 tensor ops masked to 32 bits, on the logits' device, with no loop
over the vocabulary.  A draw depends only on (request seed, token index,
vocab id) — not the slot, the engine step or the other requests in the
batch — so a request replayed under another batch composition samples the
identical tokens, and a sampled trace matches the JAX engine's.

The reference gates the top-k sort and the draw on ``lax.cond`` over
``any(temperature > 0)`` and ``any(top_k > 0)``.  Here the caller names
the batch's :data:`POLICIES` entry instead (:func:`policy_of` picks it
from the knobs on the host), so :func:`sample_tokens` reads nothing on the
host and a CUDA graph captures it; the tokens are the same for any policy
at least as wide as the batch needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NEG = -1e30
_M32 = 0xFFFFFFFF
#: what a batch's sampling does, narrowest first: argmax only; a draw at
#: each row's temperature; a draw after each row's top-k filter
POLICIES = ("greedy", "temperature", "top_k")


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Sampling policy: greedy / temperature / top-k.

    ``kind`` exists for readability; the engine lowers every policy to the
    (temperature, top_k) pair consumed by :func:`sample_tokens`.
    """

    kind: str = "greedy"  # "greedy" | "temperature" | "top_k"
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("greedy", "temperature", "top_k"):
            raise ValueError(
                f"unknown sampler kind '{self.kind}'; "
                "known: greedy, temperature, top_k"
            )
        if self.kind == "greedy" and self.temperature:
            raise ValueError("greedy sampling takes no temperature")
        if self.kind != "greedy" and self.temperature <= 0:
            raise ValueError(f"{self.kind} sampling needs temperature > 0")
        if self.kind == "top_k" and self.top_k < 1:
            raise ValueError("top_k sampling needs top_k >= 1")
        if self.kind != "top_k" and self.top_k:
            raise ValueError(f"{self.kind} sampling takes no top_k")

    @classmethod
    def greedy(cls) -> "Sampler":
        return cls("greedy")

    @classmethod
    def with_temperature(cls, temperature: float) -> "Sampler":
        return cls("temperature", temperature=temperature)

    @classmethod
    def with_top_k(cls, top_k: int, temperature: float = 1.0) -> "Sampler":
        return cls("top_k", temperature=temperature, top_k=top_k)

    @classmethod
    def parse(cls, spec: str) -> "Sampler":
        """CLI spelling: ``greedy`` | ``temperature:0.8`` | ``top_k:40:0.8``."""
        parts = spec.split(":")
        if parts == ["greedy"]:
            return cls.greedy()
        if parts[0] == "temperature" and len(parts) == 2:
            return cls.with_temperature(float(parts[1]))
        if parts[0] in ("top_k", "top-k") and len(parts) in (2, 3):
            t = float(parts[2]) if len(parts) > 2 else 1.0
            return cls.with_top_k(int(parts[1]), t)
        raise ValueError(f"unknown sampler spec '{spec}'")

    @property
    def knobs(self) -> tuple[float, int]:
        """The (temperature, top_k) pair for :func:`sample_tokens`."""
        return (float(self.temperature), int(self.top_k))


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds), as ``jax.random``'s default PRNG
    implements it, on int64 tensors holding 32-bit words (broadcast
    together).  Sums wrap through the ``& _M32`` mask."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def slot_keys(seeds: torch.Tensor, steps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) key words of ``fold_in(fold_in(PRNGKey(0), seed), step)``;
    ``fold_in(key, d)`` hashes the counter pair (0, d) under ``key``."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    k0, k1 = threefry2x32(zero, zero, zero, seeds.long() & _M32)
    return threefry2x32(k0, k1, zero, steps.long() & _M32)


def gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) standard Gumbel noise, ``jax.random.gumbel`` under each
    slot's key: random bits over the counters (0, vocab id), a float in
    [1, 2) from their top 23 bits, shifted into [tiny, 1), then
    ``-log(-log(u))``."""
    k0, k1 = slot_keys(seeds, steps)
    ids = torch.arange(vocab, dtype=torch.int64, device=seeds.device)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(ids), ids)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(u * (1.0 - tiny) + tiny, min=tiny)
    return -torch.log(-torch.log(u))


def policy_of(temperatures: np.ndarray, top_ks: np.ndarray) -> str:
    """The narrowest policy that samples the rows of these host-side knobs
    as the reference does: greedy unless a row has a temperature, top-k if
    such a row has a k."""
    drawn = np.asarray(temperatures) > 0
    if not drawn.any():
        return "greedy"
    return "top_k" if (np.asarray(top_ks)[drawn] > 0).any() else "temperature"


def sample_tokens(
    logits: torch.Tensor,  # (B, V) float
    seeds: torch.Tensor,  # (B,) int: per-request sampling seed
    steps: torch.Tensor,  # (B,) int: per-request token index
    temperatures: torch.Tensor,  # (B,) float: 0 = greedy
    top_ks: torch.Tensor,  # (B,) int: 0 = no top-k filter
    policy: str | None = None,
) -> torch.Tensor:
    """(B,) int32 sampled token ids; argmax takes the first index on ties.

    ``policy`` (one of :data:`POLICIES`) says what the batch needs, and the
    call reads nothing on the host: greedy skips the sort and the draw,
    temperature skips the sort.  Without it the call reads the two
    predicates from the knobs (a device-to-host read each), as an eager
    caller may."""
    if policy is None:
        policy = "greedy"
        if bool((temperatures > 0).any()):
            policy = "top_k" if bool((top_ks > 0).any()) else "temperature"
    elif policy not in POLICIES:
        raise ValueError(f"unknown sampling policy '{policy}'; known: {POLICIES}")
    v = logits.shape[-1]
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    if policy == "greedy":
        return greedy
    if policy == "top_k":
        # top-k with per-row k: threshold at the k-th largest logit
        sorted_desc = torch.sort(lf, dim=-1, descending=True).values
        kth = torch.clamp(top_ks.long() - 1, 0, v - 1)
        thresh = torch.gather(sorted_desc, 1, kth[:, None])
        drop = (top_ks[:, None] > 0) & (lf < thresh)
        lf = torch.where(drop, torch.full_like(lf, _NEG), lf)
    temps = torch.clamp(temperatures.float(), min=1e-6)[:, None]
    noisy = lf / temps + gumbel_noise(seeds, steps, v)
    sampled = torch.argmax(noisy, dim=-1).to(torch.int32)
    return torch.where(temperatures <= 0, greedy, sampled)
