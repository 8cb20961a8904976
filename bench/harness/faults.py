"""Faults planted under the timed path, to see ``correct`` come out false.

Each fault of a served model's cell, as a function of ``patch(obj, name,
value)`` (pytest's ``monkeypatch.setattr``, or plain ``setattr`` in a
process that ends after the run), applied before the engine is built so
that its captured programs hold it:

* ``altered_token``: a token altered where it is sampled;
* ``state_unchanged``: a decode step that leaves the cache's positions
  where it found them (the next step writes and reads there again);
* ``half_batch``: half the decode batch left out, its rows given the other
  half's logits.

One card: there is no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Callable

import torch


def altered_token(patch: Callable) -> None:
    import repro_torch.serve.engine as engine_mod

    orig = engine_mod.sample_tokens

    def sample(logits, *args, **kwargs):
        return (orig(logits, *args, **kwargs) + 1) % logits.shape[-1]

    patch(engine_mod, "sample_tokens", sample)


def state_unchanged(patch: Callable) -> None:
    import repro_torch.serve.engine as engine_mod

    orig = engine_mod.lm.decode_step

    def decode_step(params, tokens, cfg, cache):
        logits, cache = orig(params, tokens, cfg, cache)
        cache["index"].sub_(1)
        return logits, cache

    patch(engine_mod.lm, "decode_step", decode_step)


def half_batch(patch: Callable) -> None:
    import repro_torch.serve.engine as engine_mod

    orig = engine_mod.lm.decode_step

    def decode_step(params, tokens, cfg, cache):
        logits, cache = orig(params, tokens, cfg, cache)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:logits.shape[0] - half]]), cache

    patch(engine_mod.lm, "decode_step", decode_step)


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged, half_batch)}
