"""The one traffic generator: every mix is a data file of parameters.

A mix (``bench/traffic/<name>.json``) gives integer ranges for prompt and
output lengths and an arrival process:

* ``"backlog"``: work dispatched ahead, a new request whenever one
  finishes; the first cohort fills every slot, its output lengths drawn
  from ``first_output_len`` so that slots free at staggered steps;
* ``"poisson"``: open-loop arrivals at ``rate_per_s``.

Everything is drawn from ``--seed``: each request's lengths independently
and uniformly from the mix's ranges, its token ids uniformly over the
vocabulary.  Poisson arrivals over a stream's ``horizon`` (a rate cell's
ramp and window) are the Poisson process given its count there: exactly
``round(rate * horizon)`` arrival times drawn uniformly over the horizon
and sorted, so every seed offers the same load to the window and bursts of
any length can happen inside it.  Past the horizon (the drain) the gaps
are independent exponentials of mean ``1 / rate``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: independent streams drawn from one seed; a stream's token ids are
#: stream ``IDS`` further on
STREAM_MAIN, STREAM_WARM, STREAM_FIRST, STREAM_SAMPLE = 1, 2, 3, 4
IDS = 16


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for ``stream`` of ``seed`` (any integer)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, stream]))


def poisson_gaps(rate: float, horizon: float, rng: np.random.Generator) -> list[float]:
    """The gaps before each arrival of a Poisson process at ``rate`` given
    ``round(rate * horizon)`` arrivals in ``[0, horizon)``, and last the gap
    to the first arrival past the horizon."""
    times = np.sort(rng.uniform(0.0, horizon, int(round(rate * horizon))))
    gaps = np.diff(times, prepend=0.0).tolist()
    last = float(times[-1]) if len(times) else 0.0
    return gaps + [horizon - last + float(rng.exponential(1.0 / rate))]


@dataclasses.dataclass
class Draw:
    prompt: list[int]
    out_len: int
    #: seconds after the previous arrival (poisson); 0 for backlog
    gap: float = 0.0


class Stream:
    """An endless stream of requests of one mix, drawn from the seed;
    ``horizon``: seconds over which a Poisson stream's count is fixed."""

    def __init__(self, mix: dict, vocab: int, seed: int, stream: int = STREAM_MAIN,
                 horizon: float = 0.0) -> None:
        self.mix = mix
        self.vocab = vocab
        self.rng = rng_for(seed, stream)  # lengths and gaps
        self.ids = rng_for(seed, stream + IDS)  # the token ids
        self.rate = float(mix["rate_per_s"]) if mix["arrivals"] == "poisson" else 0.0
        self._gaps = poisson_gaps(self.rate, horizon, self.rng)[::-1] if self.rate else []

    def _gap(self) -> float:
        if not self.rate:
            return 0.0
        if self._gaps:
            return self._gaps.pop()
        return float(self.rng.exponential(1.0 / self.rate))

    def next(self) -> Draw:
        gap = self._gap()
        lo, hi = self.mix["prompt_len"]
        n = int(self.rng.integers(lo, hi + 1))
        lo, hi = self.mix["output_len"]
        out = int(self.rng.integers(lo, hi + 1))
        return Draw(self.ids.integers(0, self.vocab, n).tolist(), out, gap)


def first_cohort(mix: dict, vocab: int, seed: int, n: int) -> list[Draw]:
    """A backlog's first ``n`` requests: the mix's prompts, outputs from
    ``first_output_len``."""
    rng = rng_for(seed, STREAM_FIRST)
    ids = rng_for(seed, STREAM_FIRST + IDS)
    prompts = rng.integers(mix["prompt_len"][0], mix["prompt_len"][1] + 1, n)
    outs = rng.integers(mix["first_output_len"][0], mix["first_output_len"][1] + 1, n)
    return [Draw(ids.integers(0, vocab, int(p)).tolist(), int(o)) for p, o in zip(prompts, outs)]
