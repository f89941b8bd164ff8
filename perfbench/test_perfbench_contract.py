"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to a file of the benchmark."""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w
            assert (ROOT / w).exists()


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert _line(e[k]), (e["name"], k)
        if section in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            for w in e.get("workloads", []):
                assert w in CELLS
        if section == "per_layer":
            assert _line(e["layer"])
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_layers_named_alike():
    # metrics of one layer give the same name, and moves is end to end
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert all(by_layer.values())


def test_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and any(cfg["file"].startswith(p + "/")
                                  for p in BENCH["paths"])
    assert re.fullmatch(r"[A-Za-z0-9_./-]+", cfg["file"])
    assert _line(cfg["source"]) and _line(cfg["why"])
    assert len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert _line(data["source"])
    assert data["chips"] in (1, 4)
    for k in cfg["reduced"]:
        assert k in data["generator"] or k in data, k
    assert (HERE / "data" / f"{data['generator']['family']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    assert _line(entry["why"])
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    assert config["chips"] == entry["chips"]
    work = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert work["name"] == cell and work["config"] == entry["config"]
    family = config["generator"]["family"]
    for t in work["traffic"]["templates"]:
        src = (HERE / "queries" / family / f"{t}.py").read_text()
        for part in ("def plan(", "def reference(", "ORDER_BY"):
            assert part in src, (t, part)
    assert set(work["limits"]) <= {"bad_cells", "float_rel_err"}
    reported = [m for m in METRICS if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in BENCH["end_to_end"] if m in reported}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m["moves"] in e2e for m in BENCH["per_layer"]
               if m in reported)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_reader(metric):
    src = (HERE / "metrics" / f"{metric}.py").read_text()
    assert "def read(" in src


def test_file_names():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
