"""Unit tests for bench.py's cell schedule and JSON payload.

The schedule logic runs with a mocked cell subprocess, so CI checks it
without a device:

* the headline cell runs first, every cell runs exactly once;
* a cell that cannot fit the remaining budget is not launched;
* the payload carries the throughput cell and excludes it from geomean.
"""

import importlib
import json
import sys
import time

import pytest


@pytest.fixture()
def bench(monkeypatch):
    sys.path.insert(0, ".")
    mod = importlib.import_module("bench")
    importlib.reload(mod)
    mod._STATE.update({"cells": {}, "emitted": False, "child": None,
                       "t_start": time.perf_counter()})
    monkeypatch.setattr(mod.signal, "alarm", lambda s: None)
    monkeypatch.setattr(mod.signal, "signal", lambda *a: None)
    monkeypatch.delenv("GGP_BENCH_FULL", raising=False)
    monkeypatch.delenv("GGP_BENCH_SGHMC", raising=False)
    yield mod
    sys.path.remove(".")


def test_payload_throughput_cell(bench):
    bench._STATE["cells"][bench.HEADLINE] = {
        "model": "SGPR+HMC", "dataset": "boston-shaped",
        "sampling_s": 1.0, "min_ess_per_s": 100.0, "healthy": True,
        "reference_s": 14.57, "speedup": 14.57}
    bench._STATE["cells"][bench.THROUGHPUT] = {
        "model": "HMC-C8", "dataset": "boston-shaped",
        "sampling_s": 1.76, "min_ess_per_s": 2455.0, "healthy": True}
    payload = bench._build_payload()
    payload = json.loads(json.dumps(payload))    # must be serialisable
    assert payload["metric"] == \
        "bayesian_sgpr_hmc_sampling_seconds_boston_shaped"
    assert payload["vs_baseline"] == 14.57
    assert payload["min_ess_per_s_c8"] == 2455.0
    assert "probes" not in payload
    # throughput cell has no reference seconds -> geomean over the one
    # healthy matrix cell only
    assert payload["matrix_geomean_speedup"] == 14.57
    thr = [c for c in payload["cells"] if c["model"] == "HMC-C8"]
    assert len(thr) == 1 and "speedup" not in thr[0]


def test_schedule_runs_each_cell_once_headline_first(bench, monkeypatch,
                                                     capsys):
    launched = []

    def fake_cell(model, ds, budget):
        launched.append((model, ds))
        return {"model": model, "dataset": f"{ds}-shaped", "healthy": True,
                "sampling_s": 1.0, "min_ess_per_s": 10.0, "speedup": 2.0}

    monkeypatch.setattr(bench, "_run_cell_subprocess", fake_cell)
    bench.main()
    assert launched[0] == bench.HEADLINE
    assert len(launched) == len(set(launched)) == len(bench.BASELINES) + 1
    assert bench.THROUGHPUT in launched
    assert bench.SGHMC_1M not in launched
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["value"] == 1.0
    assert all("path" not in c for c in payload["cells"])


def test_schedule_stops_when_budget_is_spent(bench, monkeypatch, capsys):
    launched = []
    monkeypatch.setenv("GGP_BENCH_BUDGET_S", "50")
    monkeypatch.setattr(bench, "_run_cell_subprocess",
                        lambda m, d, b: launched.append((m, d)))
    bench.main()
    assert launched == []
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["value"] == -1.0
    assert all(c["error"].startswith("not reached")
               for c in payload["cells"])
