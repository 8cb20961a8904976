"""Token sampling on the device (the port of ``repro/serve/sampler.py``).

:func:`sample_tokens` reduces the (B, V) logits to (B,) token ids on the
logits' device, so the per-step host transfer is token ids only.  The
per-slot knobs — ``temperature`` and ``top_k`` — are (B,) tensors, so a
batch mixes greedy and top-k requests in one call.  Greedy is
``temperature == 0``; ``top_k == 0`` disables the top-k filter.

Random draws are Gumbel-max over a counter-based integer hash of (request
seed, token index, vocab id), written in plain torch ops: a draw depends on
nothing else — not the slot, the engine step or the other requests in the
batch — so a request replayed under another batch composition samples the
identical tokens.  The bits differ from the reference's ``jax.random``
draws; greedy decoding is identical.
"""

from __future__ import annotations

import dataclasses

import torch

_NEG = -1e30
_M32 = 0xFFFFFFFF


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


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding 32-bit values
    (products wrap in int64; the mask keeps the exact low 32 bits)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) standard Gumbel noise, a pure function of
    (seed, step, vocab id) per element."""
    dev = seeds.device
    key = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)
    key = _mix32((key + (steps.long() & _M32) * 0x632BE5AB) & _M32)  # (B,)
    ids = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = _mix32((key[:, None] + ids[None, :] * 0x9E3779B1) & _M32)
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # (B, V) float
    seeds: torch.Tensor,  # (B,) int: per-request sampling seed
    steps: torch.Tensor,  # (B,) int: per-request token index
    temperatures: torch.Tensor,  # (B,) float: 0 = greedy
    top_ks: torch.Tensor,  # (B,) int: 0 = no top-k filter
) -> torch.Tensor:
    """(B,) int32 sampled token ids; argmax takes the first index on ties.
    An all-greedy batch skips the sort and the draw."""
    v = logits.shape[-1]
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    if not bool((temperatures > 0).any()):
        return greedy
    if bool((top_ks > 0).any()):
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
