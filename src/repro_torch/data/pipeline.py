"""Deterministic synthetic data pipeline (the port's own copy of
``repro/data/pipeline.py``; numpy only, batches bit-identical to the
reference's).

Design constraints it satisfies (the same ones a real pipeline must):
  * deterministic per (seed, step) — a restarted job resumes mid-stream with
    identical batches (required by the fault-tolerance path);
  * host-shardable — ``host_local_slice`` carves the per-host slice of the
    global batch exactly as a multi-host loader would;
  * learnable — tokens follow a noisy affine-recurrence language so a small
    model's loss visibly decreases within a few hundred steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.85  # probability a token follows the recurrence

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The full global batch for one step (deterministic)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 0xD0C]))
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab_size
        # affine recurrence with per-sequence parameters + noise
        a = rng.integers(3, 23, (b, 1))
        c = rng.integers(1, v - 1, (b, 1))
        toks = np.empty((b, s), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) > self.structure
        rand = rng.integers(0, v, (b, s))
        for t in range(1, s):
            nxt = (toks[:, t - 1] * a[:, 0] + c[:, 0]) % v
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def embeds_batch_at(self, step: int, d_model: int) -> dict[str, np.ndarray]:
        """Frontend-stub variant: precomputed patch/frame embeddings."""
        base = self.batch_at(step)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 0xE58]))
        embeds = rng.standard_normal((self.global_batch, self.seq_len, d_model)).astype(np.float32)
        return {"embeds": embeds, "labels": base["labels"]}


def host_local_slice(
    batch: dict[str, np.ndarray], host_id: int, n_hosts: int
) -> dict[str, np.ndarray]:
    """The slice of the global batch this host is responsible for loading."""
    out = {}
    for k, v in batch.items():
        gb = v.shape[0]
        if gb % n_hosts:
            raise ValueError(f"global batch {gb} does not split over {n_hosts} hosts")
        per = gb // n_hosts
        out[k] = v[host_id * per:(host_id + 1) * per]
    return out
