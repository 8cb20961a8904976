"""The generator: the same seed gives the same requests; each seed draws
its own sizes and its own Poisson arrivals, with the count over the
horizon fixed."""

from __future__ import annotations

import numpy as np
import pytest

from bench.harness import loadgen

MIX = {"arrivals": "poisson", "rate_per_s": 4.0, "prompt_len": [100, 199],
       "output_len": [10, 19], "first_output_len": [1, 19]}
HORIZON = 50.0


def _draws(seed: int, n: int = 64, mix: dict = MIX, horizon: float = HORIZON):
    s = loadgen.Stream(mix, 1000, seed, horizon=horizon)
    return [s.next() for _ in range(n)]


def test_same_seed_same_requests():
    a, b = _draws(2**31 + 5), _draws(2**31 + 5)
    assert [(d.prompt, d.out_len, d.gap) for d in a] == [(d.prompt, d.out_len, d.gap) for d in b]


def test_seeds_draw_their_own_sizes_and_gaps():
    a, b = _draws(1), _draws(2)
    assert sorted(len(d.prompt) for d in a) != sorted(len(d.prompt) for d in b)
    assert sorted(d.gap for d in a) != pytest.approx(sorted(d.gap for d in b))


def test_sizes_are_uniform_over_the_range():
    draws = _draws(3, n=4000)
    prompts = np.array([len(d.prompt) for d in draws])
    outs = np.array([d.out_len for d in draws])
    assert prompts.min() == 100 and prompts.max() == 199
    assert outs.min() == 10 and outs.max() == 19
    assert prompts.mean() == pytest.approx(149.5, abs=1.5)
    assert all(0 <= t < 1000 for d in draws[:50] for t in d.prompt)


@pytest.mark.parametrize("seed", [5, 2**31 + 9, 2**40 + 1])
def test_the_horizon_holds_rate_times_horizon_arrivals(seed):
    n = int(MIX["rate_per_s"] * HORIZON)
    times = np.cumsum([d.gap for d in _draws(seed, n=n + 200)])
    assert (times < HORIZON).sum() == n
    # past the horizon the arrivals go on at the rate
    assert (times[n:] >= HORIZON).all()
    assert np.diff(times[n:]).mean() == pytest.approx(1 / MIX["rate_per_s"], rel=0.25)


def test_arrivals_are_poisson_with_bursts_unbounded():
    # over many seeds: the counts in 5 s bins of the horizon spread as a
    # Poisson count given the total does (binomial), not fixed
    counts = []
    for seed in range(200):
        times = np.cumsum([d.gap for d in _draws(seed, n=int(4.0 * HORIZON))])
        counts.extend(np.histogram(times, bins=10, range=(0, HORIZON))[0].tolist())
    counts = np.array(counts)
    assert counts.mean() == pytest.approx(20.0, rel=0.01)
    assert counts.var() == pytest.approx(20.0 * 0.9, rel=0.15)  # binomial(200, 0.1)
    assert counts.max() >= 32  # a burst of 1.6 times the rate for 5 s


def test_backlog_has_no_gaps():
    mix = dict(MIX, arrivals="backlog")
    assert all(d.gap == 0.0 for d in _draws(4, mix=mix))


def test_first_cohort_staggers_outputs():
    cohort = loadgen.first_cohort(MIX, 1000, 9, 400)
    outs = np.array([d.out_len for d in cohort])
    assert outs.min() == 1 and outs.max() == 19
    assert len(set(outs.tolist())) == 19
    assert all(100 <= len(d.prompt) <= 199 for d in cohort)
    assert all(0 <= t < 1000 for d in cohort for t in d.prompt)
