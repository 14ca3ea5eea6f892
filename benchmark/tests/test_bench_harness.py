"""The harness is driven by data: BENCHMARK.json keeps to the contract's
names, units and files, and a configuration, a traffic mix, a metric and a
cell's limits added as files of their own are found by name and run, with
no edit to a file that is there."""

from __future__ import annotations

import json
import re
import shutil

from conftest import ROOT

from benchmark.harness import HERE, load_spec, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + cells + metrics + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics) and "setup_s" in e2e
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        spec = load_spec(w["name"])
        assert spec.limits, f"{w['name']} has no limits"
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_added_files_are_found_by_name(tmp_path):
    """A new configuration, traffic, metric and cell, each a new file, run
    on the CPU with the harness as it is."""
    root = tmp_path / "benchmark"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg = json.loads((root / "configs" / "cavity_ne85184.json").read_text())
    cfg["deck"]["args"] = [3]
    cfg["solver"]["setup_cache"] = None
    (root / "configs" / "cavity_tiny.json").write_text(json.dumps(cfg))
    trf = json.loads((root / "traffic" / "developed.fused_cg.json").read_text())
    trf["segment_steps"] = 3
    trf["warmup_steps"] = 1
    trf["start"]["developed_steps"] = 2
    trf["check"].update(first_steps=1, sampled=1)
    (root / "traffic" / "developed.short.json").write_text(json.dumps(trf))
    (root / "metrics" / "steps_traced.py").write_text("def read(ctx):\n    return ctx.steps\n")
    (root / "limits" / "cavity_tiny.short.json").write_text(
        (root / "limits" / "cavity_ne85184.explicit.json").read_text())
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(BENCH["configs"][0], name="cavity_tiny",
                                                file="benchmark/configs/cavity_tiny.json")]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "cavity_tiny.short", "config": "cavity_tiny", "traffic": "developed.short",
         "chips": 1, "why": "a test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "steps_traced", "unit": "steps", "better": "higher", "source": "host_clock",
         "layer": "test", "moves": "ms_per_step", "workloads": ["cavity_tiny.short"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = load_spec("cavity_tiny.short", root=root, bench=tmp_path / "BENCHMARK.json")
    assert spec.config["deck"]["args"] == [3] and spec.traffic["segment_steps"] == 3
    out = run_cell("cavity_tiny.short", 11, 0.01, True, device="cpu", spec=spec,
                   log=lambda *a, **k: None)
    assert out["metrics"]["steps_traced"]["value"] == 6     # the two traced segments
    assert out["attempted"] >= 9 and out["failed"] == 0
    out = run_cell("cavity_tiny.short", 11, 0.01, False, device="cpu", spec=spec,
                   log=lambda *a, **k: None)
    assert set(out["metrics"]) == {"ms_per_step", "setup_s"}
    assert list(out)[-1] == "check" and out["correct"] is True
