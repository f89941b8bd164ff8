"""The comparison that decides `correct` fails its controls and the
faults a query-serving cell can have: the reference in float32 in the
program's place (summed serially and pairwise), an answer altered where
it is produced, and half of a scan's rows left out."""
import pytest

pytest.importorskip("torch")

import time  # noqa: E402

import numpy as np  # noqa: E402

from perfbench import control, harness  # noqa: E402

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed):
    res = control.control(harness.load_cell(cell), seed, scale=0.05)
    assert [r["control"] for r in res] == ["serial", "pairwise"]
    for r in res:
        assert r["correct"] is False, r


def _run(cell):
    return harness.run(cell, 12345, 1.0, False, time.perf_counter(),
                       device="cpu", scale=0.01)


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_fails(monkeypatch, cell):
    from repro_torch.relational.executor import Executor
    from repro_torch.relational.table import Column, Table
    execute = Executor.execute

    def altered(self, plan, ctx=None):
        table, stats = execute(self, plan, ctx)
        if ctx is not None and len(table):       # a served query
            name = table.names[-1]
            data = table[name].data.copy()
            data[0] = data[0] + 1
            table = table.with_column(name, Column(data))
            assert isinstance(table, Table)
        return table, stats

    monkeypatch.setattr(Executor, "execute", altered)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_fails(monkeypatch, cell):
    from repro_torch.relational.executor import Executor
    resolve = Executor._resolve_leaf

    def half(self, leaf, stats, needed):
        v = resolve(self, leaf, stats, needed)
        if len(v.mask) > 1000:                   # the fact table's scans
            v.mask = v.mask.copy()
            v.mask[1::2] = False
        return v

    monkeypatch.setattr(Executor, "_resolve_leaf", half)
    line = _run(cell)
    assert line["correct"] is False
    assert line["checks"]["bad_cells"]["value"] > 0 or \
        line["checks"].get("float_rel_err", {"value": 0})["value"] > 0
    assert np.isfinite(line["attempted"])
