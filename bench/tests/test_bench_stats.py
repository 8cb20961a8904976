"""Percentiles over all requests and rates over the window, against cases
worked by hand, and a stall that must move them."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from bench.harness import driver, stats, work

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"m_{name.replace('.', '_')}",
                                                  METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_percentile_nearest_rank():
    # 20 values: rank ceil(0.95 * 20) = 19
    assert stats.percentile(range(1, 21), 95) == 19
    # 100 values: the 95th
    assert stats.percentile(range(100, 0, -1), 95) == 95
    # 10 values: rank ceil(9.5) = 10, the maximum
    assert stats.percentile([3, 1, 2, 9, 4, 5, 6, 7, 8, 10], 95) == 10
    assert stats.percentile([], 95) is None
    assert stats.percentile([7.5], 50) == 7.5


def test_rate_and_window_counts():
    assert stats.rate(30, 10.0, 12.0) == 15.0
    assert stats.rate(1, 5.0, 5.0) is None
    assert stats.tokens_in([0.5, 1.0, 1.5, 2.0, 2.5], 1.0, 2.0) == 2  # (1, 2]
    assert stats.gaps([1.0, 1.25, 2.0]) == [0.25, 0.75]
    # (q3 - q1) / median of 1..8 with statistics.quantiles: (6.75 - 2.25) / 4.5
    assert stats.quartile_spread([1, 2, 3, 4, 5, 6, 7, 8]) == pytest.approx(1.0)


def _run(stalls: tuple = (), stall_s: float = 0.0, n_req: int = 20) -> driver.Run:
    """A rate run with a step every 50 ms from 25 ms: request i is due at
    0.1 i + 0.01 and gets a token at each of the four step ends after that;
    every step end after each of ``stalls`` comes ``stall_s`` later."""
    dims = work.Dims(d_model=8, n_layers=1, pattern="a", n_heads=1, n_kv_heads=1,
                     d_head=8, d_ff=8, vocab=16)
    ends = [0.025 + 0.05 * k for k in range(80)]
    ends = [t + stall_s * sum(t >= at for at in stalls) for t in ends]
    reqs = []
    for i in range(n_req):
        due = 0.1 * i + 0.01
        times = [t for t in ends if t >= due][:4]
        reqs.append(driver.RequestRecord(prompt=[1], out_len=4, due=due, submitted=due,
                                         tokens=[0] * len(times), times=times))
    steps = [driver.StepRecord(a, b, [], []) for a, b in zip([0.0] + ends, ends)]
    return driver.Run(cell="x", dims=dims, traffic={"arrivals": "poisson"}, setup_s=1.0,
                      t0=0.0, t1=2.0, requests=reqs, steps=steps,
                      telemetry={"decode": {"calls": 0, "seconds": 0.0, "tokens": 0}},
                      kv_stranded_pct=None)


def test_ttft_itl_and_rate_by_hand():
    run = _run()
    # request i's tokens at 0.1 i + 0.025, + 0.075, + 0.125, + 0.175: every
    # TTFT is 15 ms, every gap 50 ms
    assert reader("ttft_p95_ms")(run) == pytest.approx(15.0, abs=1e-6)
    assert reader("itl_p95_ms")(run) == pytest.approx(50.0, abs=1e-6)
    # in (0, 2]: requests 0-18 all four tokens, request 19 two (1.925,
    # 1.975): 78 tokens over 2 s
    assert reader("out_tok_s")(run) == pytest.approx(39.0)


def test_a_stall_moves_the_tails_and_the_rate():
    a = _run()
    b = _run(stalls=(0.5,), stall_s=0.6)  # one 650 ms step at 0.5 s
    # requests 5-10 (due 0.51-1.01) each wait past the stall: 6 of 20, so the
    # p95 TTFT is one of them; every token after it is 0.6 s later
    assert reader("ttft_p95_ms")(b) > reader("ttft_p95_ms")(a) + 400
    # a stall puts a 350 ms gap into the one request that straddles it: one
    # of 60 gaps is under the p95; eight stalls, 200 ms apart, put one in
    # eight of the 60 (over one in twenty)
    assert reader("itl_p95_ms")(b) == pytest.approx(50.0)
    c = _run(stalls=tuple(0.25 + 0.2 * i for i in range(8)), stall_s=0.3)
    assert reader("itl_p95_ms")(c) == pytest.approx(350.0)


def test_a_stall_moves_a_backlog_rate():
    """Eight requests in flight, a token each a step: the stall's 0.6 s
    hold 12 steps' tokens out of the 2 s window."""
    def backlog(stall_s):
        run = _run()
        ends = [0.025 + 0.05 * k + (stall_s if k >= 10 else 0.0) for k in range(40)]
        run.requests = [driver.RequestRecord([1], 40, 0.0, 0.0, [0] * 40, list(ends))
                        for _ in range(8)]
        return run

    # 40 step ends in (0, 2] by hand: 8 x 40 / 2 s; with the stall, 28
    assert reader("out_tok_s")(backlog(0.0)) == pytest.approx(160.0)
    assert reader("out_tok_s")(backlog(0.6)) == pytest.approx(8 * 28 / 2.0)


def test_a_failed_request_misses_every_limit():
    run = _run()
    for r in run.requests[:2]:
        r.failed, r.times, r.tokens = "refused", [], []
    # two of 20 failed: p95 (the 19th of 20) is a give-up wait, ~3 s
    assert reader("ttft_p95_ms")(run) > 2000
