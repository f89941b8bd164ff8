"""Each template's plain reference against the program's answer, at SF
0.01 on the CPU (the kernels' plain versions), and the generators'
determinism by seed."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from perfbench import adapter, compare, harness  # noqa: E402

SF = 0.01
CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
# every template file of each family, with the first cell of the family
FAMILY_CELL = {}
for _c in CELLS:
    FAMILY_CELL.setdefault(harness.load_cell(_c).family, _c)
CASES = [(c, p.stem) for fam, c in FAMILY_CELL.items()
         for p in sorted((harness.HERE / "queries" / fam).glob("*.py"))]


@pytest.fixture(scope="module")
def databases():
    out = {}
    for c in FAMILY_CELL.values():
        cell = harness.load_cell(c)
        db = cell.generator().generate(SF, 20261019)
        out[c] = (cell, db, adapter.catalog(db))
    return out


@pytest.mark.parametrize("cell,template", CASES)
def test_reference_equals_program(databases, cell, template):
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational.executor import ExecConfig, Executor
    c, db, cat = databases[cell]
    server = c.config["server"]
    tpl = c.template(template)
    table, _ = Executor(cat, ExecConfig(
        strategy=make_strategy(server["strategy"],
                               backend=server["join_backend"],
                               device="cpu"),
        join_backend=server["join_backend"], torch_device="cpu")).execute(
            tpl.plan(SF))
    ref = tpl.reference(db, np.float64)
    bad, err = compare.compare(adapter.answer(table), ref, tpl.ORDER_BY)
    assert bad == 0
    assert err <= c.workload["limits"].get("float_rel_err", 0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_generator_deterministic(cell):
    gen = harness.load_cell(cell).generator()
    a, b, other = gen.generate(SF, 7), gen.generate(SF, 7), gen.generate(SF, 8)

    def flat(db):
        return {(t, k): (v.decode() if hasattr(v, "vocab") else v)
                for t, cols in db.items() for k, v in cols.items()}
    fa, fb, fo = flat(a), flat(b), flat(other)
    assert fa.keys() == fb.keys() == fo.keys()
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert not all(np.array_equal(fa[k], fo[k]) if len(fa[k]) == len(fo[k])
                   else False for k in fa)


def test_compare_catches_order_and_values():
    ref = {"k": np.array(["a", "b", "c"]), "v": np.array([3.0, 2.0, 1.0])}
    order = [("v", False)]
    assert compare.compare(dict(ref), ref, order) == (0, 0.0)
    swapped = {"k": ref["k"][::-1], "v": ref["v"][::-1]}
    assert compare.compare(swapped, ref, order)[0] > 0
    off = {"k": ref["k"], "v": ref["v"] * (1 + 1e-6)}
    assert compare.compare(off, ref, order)[1] > 1e-7
    short = {"k": ref["k"][:2], "v": ref["v"][:2]}
    assert compare.compare(short, ref, order)[0] > 0


def _same(a, b):
    return (a.vocab.dtype == b.vocab.dtype and a.codes.dtype == b.codes.dtype
            and np.array_equal(a.vocab, b.vocab)
            and np.array_equal(a.codes, b.codes))


@pytest.mark.parametrize("n", [9, 10, 11, 100, 1001, 150_000])
def test_tpch_strings_spelled_once_equal_row_by_row(n):
    """The TPC-H generator's string columns equal `reflib.strings` over
    the rows' values, the form they replace."""
    from perfbench import reflib
    tpch = harness.load_module(harness.HERE / "data" / "tpch.py")
    keys = np.arange(1, n + 1, dtype=np.int64)
    assert _same(tpch._numbered("Customer#", keys), reflib.strings(
        np.char.add("Customer#", keys.astype("U9"))))
    assert _same(tpch._modulo("addrS", keys, 997), reflib.strings(
        np.char.add("addrS", (keys % 997).astype("U4"))))
    rng = np.random.default_rng(n)
    nation = rng.integers(0, 25, n)
    suffix = np.random.default_rng(n + 1).integers(0, 40, n)
    plain = reflib.strings(np.char.add(np.char.add(
        (10 + nation).astype("U2"), "-555-000-"),
        (1000 + suffix).astype("U4")))
    assert _same(tpch._phones(np.random.default_rng(n + 1), nation), plain)
    vocab = np.array(["b", "a", "d", "c", "a2"])
    codes = rng.integers(0, 4, n)
    assert _same(tpch.categorical(codes, vocab),
                 reflib.categorical(codes, vocab))
    assert _same(tpch.categorical(codes, vocab),
                 reflib.strings(vocab[codes]))
