"""The port's store-diff report (``repro_torch.metering.report``) against the
reference's (``repro.metering.report``) on the CPU: the same two plan
stores give equal rows, the same table text and the same JSON; the same
search gives the same Fig. 4 trace; both CLIs' ``--selftest`` pass with
the same table on a fake clock (``time.sleep`` advances it; nothing sleeps).
"""

import json
import time

import pytest

from repro.core import planner as jplanner
from repro.metering import report as jreport
from repro_torch.core import planner as tplanner
from repro_torch.metering import report as treport

PKG = {"ref": (jplanner, jreport), "port": (tplanner, treport)}

#: (key, mapping, best seconds, joules, provenance, objective) per store
STORE_A = [
    ("zoo:llama:train", {"attention": "cuda"}, 0.01, 5.0, "measured", "latency"),
    ("zoo:llama:decode", {}, 0.01, 1.0, None, "latency"),  # only in A
    ("zoo:mamba:prefill", {"ssd_scan": "cuda", "rmsnorm": "torch"}, 0.004, None, None,
     "latency"),
    ("fft-app", {"fft2d": "cuda"}, 0.002, 0.3, "estimated", "latency"),
]
STORE_B = [
    ("zoo:llama:train", {"attention": "torch"}, 0.02, 2.0, "estimated", "perf_per_watt"),
    ("zoo:mamba:prefill", {"ssd_scan": "cuda", "rmsnorm": "torch"}, 0.005, 0.7, "measured",
     "perf_per_watt"),
    ("fft-app", {"fft2d": "cuda"}, 0.002, 0.3, "weird", "perf_per_watt"),
    ("zoo:zamba:decode", {}, 0.5, 9.0, "measured", "perf_per_watt"),  # only in B
]


def make_plan(planner, key, mapping, seconds, joules, provenance, objective):
    return planner.Plan(
        key=key, space="TestSpace()", mapping=dict(mapping), pattern=tuple(sorted(mapping)),
        baseline_seconds=0.1, best_seconds=seconds, speedup=0.1 / seconds,
        strategy="exhaustive", evaluations=4, search_seconds=1.0,
        fingerprint=planner.environment_fingerprint(), objective=objective,
        best_energy_joules=joules, best_energy_provenance=provenance,
    )


def stores(tmp_path, name):
    planner, _ = PKG[name]
    dirs = []
    for label, plans in (("a", STORE_A), ("b", STORE_B)):
        store = planner.PlanStore(tmp_path / name / label)
        for spec in plans:
            store.save(make_plan(planner, *spec))
        dirs.append(str(tmp_path / name / label))
    return dirs


def test_diff_rows_and_table_equal(tmp_path):
    out = {}
    for name, (_, report) in PKG.items():
        a, b = stores(tmp_path, name)
        rows = report.diff_stores(a, b)
        out[name] = ([r.to_json() for r in rows],
                     report.render_table(rows, label_a="latency", label_b="perf_per_watt"),
                     report.render_table([]))
    assert out["port"] == out["ref"]
    rows, table, empty = out["port"]
    assert [(r["arch"], r["kind"]) for r in rows] == [
        ("fft-app", "-"), ("llama", "train"), ("mamba", "prefill")]
    llama = rows[1]
    assert not llama["agree"] and llama["seconds_delta_pct"] == pytest.approx(100.0)
    assert llama["joules_delta_pct"] == pytest.approx(-60.0)
    assert rows[2]["joules_delta_pct"] is None  # A has no joules
    for cell in ("cuda", "(same)", "5J*", "2J~", "0.3J?", "+100.0%", "-60.0%"):
        assert cell in table
    assert "(no keys present in both stores)" in empty


def test_diff_selected_keys_and_plan_score(tmp_path):
    for name, (planner, report) in PKG.items():
        a, b = stores(tmp_path, name)
        (row,) = report.diff_stores(a, b, keys=["zoo:llama:train", "zoo:llama:decode"])
        assert row.key == "zoo:llama:train"
        plan = planner.PlanStore(a).load("zoo:llama:train", match_fingerprint=False)
        assert report.plan_score(plan) == pytest.approx(0.01)  # its own objective
        assert report.plan_score(plan, "perf_per_watt") == pytest.approx(5.0)
        assert report.parse_zoo_key("zoo:a:b") == ("a", "b")
        assert report.parse_zoo_key("a:b") == ("a:b", "-")


def test_search_trace_equal_from_report_and_cache(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    costs = {frozenset(): 0.040, frozenset({"a"}): 0.020, frozenset({"b"}): 0.030,
             frozenset({"a", "b"}): 0.008}

    def build(subset):
        def fn(x):
            clock[0] += costs[frozenset(subset)]
            return x

        return fn

    out = {}
    for name, (planner, report) in PKG.items():
        clock[0] = 100.0
        cache = planner.MeasurementCache()
        space = planner.SubsetSpace(build, ["a", "b"], tag="trace")
        rep = planner.ExhaustiveSearch().search(space, (0,), cache=cache, repeats=1)
        again = planner.ExhaustiveSearch().search(space, (0,), cache=cache, repeats=1)
        points = report.search_trace(rep)
        cached = report.search_trace(again.trials)
        from_cache = report.search_trace(cache)
        out[name] = ([tuple(vars(p).values()) for p in points + cached + from_cache],
                     report.render_trace(points + cached), report.render_trace(from_cache))
        assert points[-1].best_seconds == min(t.seconds for t in rep.trials)
        assert all(p.cached for p in cached) and len(from_cache) == cache.misses == 4
        assert all(p.pattern for p in from_cache)
        assert any("a=offload" in p.pattern for p in from_cache)
    assert out["port"] == out["ref"]


def test_report_cli_json_and_fail_empty(tmp_path, capsys):
    out = {}
    for name, (_, report) in PKG.items():
        a, b = stores(tmp_path, name)
        assert report.main([a, b, "--json"]) == 0
        out[name] = json.loads(capsys.readouterr().out)
        assert report.main([a, b, "--label-a", "lat", "--label-b", "ppw"]) == 0
        assert "winner[lat]" in capsys.readouterr().out
        (tmp_path / name / "empty").mkdir()
        empty = str(tmp_path / name / "empty")
        assert report.main([a, empty, "--fail-empty"]) == 1
        assert report.main([a, empty]) == 0
        capsys.readouterr()
        with pytest.raises(SystemExit):
            report.main([a])
    assert out["port"] == out["ref"]
    assert [r["agree"] for r in out["port"]] == [True, False, True]


def test_report_selftest_same_table(monkeypatch, capsys):
    """The selftest searches two tiny stores with a fake power model and
    diffs them; on a fake clock both packages print the same table."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(time, "sleep", lambda s: clock.__setitem__(0, clock[0] + s))
    out = {}
    for name, (_, report) in PKG.items():
        clock[0] = 100.0
        assert report.main(["--selftest"]) == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert out["port"].rstrip().endswith("selftest OK")
    assert "fft=offload" in out["port"] and "lu=offload" in out["port"]
    assert "J*" in out["port"]
