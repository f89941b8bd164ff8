"""A short CPU rehearsal of each cell prints a well-formed result line,
and a new cell and metric are picked up from new files alone."""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402

from perfbench import harness, run  # noqa: E402

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _rehearse(capsys, cell, traced, **kw):
    line = harness.run(cell, 2**31 + 77, 1.5, traced, time.perf_counter(),
                       device="cpu", scale=0.01, **kw)
    run.emit(line)
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line(capsys, cell, traced):
    res, err = _rehearse(capsys, cell, traced)
    keys = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(res) == keys
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    c = harness.load_cell(cell)
    want = {m["name"]: m["unit"]
            for m in (c.per_layer if traced else c.end_to_end)}
    for name, m in res["metrics"].items():
        assert want[name] == m["unit"] and isinstance(m["value"], float)
    if not traced:
        assert set(res["metrics"]) == set(want)
    else:
        # device metrics are not read from a CPU run
        assert {"query_p50_s", "scan_phase_s"} <= set(res["metrics"])
        assert "device_idle_share" not in res["metrics"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in last] == list(res["checks"])


def test_new_cell_and_metric_from_new_files(tmp_path, capsys):
    """A cell and a per-layer metric that exist only as new files and new
    BENCHMARK.json entries are run and read with no edit elsewhere."""
    base = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    config = next(c["name"] for c in bench["configs"]
                  if c["name"].startswith("tpch"))
    (base / "workloads" / "tpch.q5only.json").write_text(json.dumps({
        "name": "tpch.q5only", "config": config,
        "traffic": {"loop": "closed", "clients": 2, "templates": {"q5": 1}},
        "limits": {"bad_cells": 0, "float_rel_err": 1e-9}, "why": "test"}))
    (base / "metrics" / "answered.py").write_text(
        "def read(r):\n    return float(r.completed)\n")
    bench["workloads"].append({"name": "tpch.q5only",
                               "config": config, "traffic": "q5only",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "answered", "unit": "queries",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["tpch.q5only"]})
    res, _ = _rehearse(capsys, "tpch.q5only", True, bench=bench,
                       base=base)
    assert res["correct"] is True
    assert res["metrics"]["answered"]["value"] == res["attempted"] > 0
