"""Nothing of the benchmark imports JAX or the JAX package, and the
references import nothing of the program."""
import pytest

pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
#: modules of the yardstick that must not touch the program at all
PLAIN = ["reflib.py", "compare.py", "traffic.py", "data/tpch.py",
         "data/ssb.py"]


def _imports(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Import):
            yield from (a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(HERE)
                         .as_posix())
def test_no_jax(path):
    found = set(_imports(ast.parse(path.read_text()))) & FORBIDDEN
    assert not found, found


@pytest.mark.parametrize("rel", PLAIN)
def test_plain_modules(rel):
    tree = ast.parse((HERE / rel).read_text())
    assert "repro_torch" not in set(_imports(tree))


@pytest.mark.parametrize("path", sorted((HERE / "queries").rglob("q*.py")),
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_reference_plain(path):
    """A template imports the program inside `plan` only."""
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                   ast.ImportFrom))]
    assert "repro_torch" not in {m for n in top for m in _imports(n)}
    ref = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "reference")
    assert "repro_torch" not in set(_imports(ref))


def test_loaded_modules():
    """Everything a run loads, loaded in a fresh process: no JAX."""
    code = (
        "import sys, pathlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from perfbench import harness, adapter, trace, control, compare\n"
        "import perfbench.run\n"
        "from repro_torch.serve import QueryServer\n"
        "for cell in [w['name'] for w in harness.load_json(\n"
        "        harness.ROOT / 'BENCHMARK.json')['workloads']]:\n"
        "    c = harness.load_cell(cell)\n"
        "    c.generator()\n"
        "    for t in c.workload['traffic']['templates']:\n"
        "        c.template(t).plan(0.01)\n"
        "    for m in c.end_to_end + c.per_layer:\n"
        "        c.metric(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        f" & set({sorted(FORBIDDEN)!r})))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a CUDA device the command exits nonzero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "ssb-sf10.star", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
