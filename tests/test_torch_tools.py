"""The design-reading tools (`tools/k3_floor.py`, `tools/k5_passes.py`,
`tools/k7_floor.py`) and `chip_smoke.py`'s input and bound helpers, on
the CPU.

The tools build their variant kernels from copies of the port's CUDA
sources, cut and pasted by text: these tests hold each cut against the
sources as they stand (one launcher, the variant's kernel in place, no
placeholder left), so an edit of a source that breaks a tool shows here
and not first on the card. The helpers' arithmetic (the 32-byte sectors
a gather reads, the path-shape inputs) is checked on small tensors."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.semijoin import ops as sj

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K3_FLOOR = _tool("k3_floor")
K5_PASSES = _tool("k5_passes")
K7_FLOOR = _tool("k7_floor")


@pytest.mark.parametrize("name", sorted(K3_FLOOR.VARIANTS))
def test_k3_floor_variant_sources(name):
    """Each K3 variant: `bloom.cu` with one `bloom_probe`, which launches
    the added `floor_kernel`, every placeholder filled, and K1-K7's own
    kernels still in place."""
    text = build.SOURCES["bloom"].read_text()
    src = K3_FLOOR.replace_k3(text, K3_FLOOR.VARIANTS[name])
    assert src.count("int bloom_probe(") == 1
    launcher = src[src.index("int bloom_probe("):]
    assert "floor_kernel<<<" in launcher.split("\n}\n")[0]
    added = src[src.index("tools/k3_floor.py's variant of K3"):
                src.index("// ORs the key with hash h into its block")]
    for mark in ("ROWS", "PROBE\n", "LOAD(", "STORE;"):
        assert mark not in added, mark
    for kernel in ("multi_probe_kernel", "slice_build_kernel",
                   "transfer_kernel", "__global__ void probe_kernel"):
        assert kernel in src, kernel


@pytest.mark.parametrize("name", sorted(K7_FLOOR.VARIANTS))
def test_k7_floor_variant_sources(name):
    """Each K7 variant: `bloom.cu` with one `bloom_transfer`, which zeroes
    the outgoing filter and launches the added `floor_kernel` (`memset`:
    no kernel), added inside the anonymous namespace with every
    placeholder filled, and K1-K7's own kernels still in place."""
    text = build.SOURCES["bloom"].read_text()
    src = K7_FLOOR.replace_k7(text, K7_FLOOR.VARIANTS[name])
    assert src.count("int bloom_transfer(") == 1
    launcher = src[src.index("int bloom_transfer("):].split("\n}\n")[0]
    assert "zero_words(" in launcher
    assert ("floor_kernel<<<" in launcher) == (name != "memset")
    if name != "memset":
        at = src.index("tools/k7_floor.py's variant of K7")
        added = src[at:src.index("}  // namespace")]
        assert "__global__" in added and "floor_kernel(" in added
        for mark in ("ROWS", "PROBE", "INSERT", "ADJACENT", "RR", "EARLY"):
            assert mark not in added, mark
    for kernel in ("multi_probe_kernel", "slice_build_kernel",
                   "__global__ void probe_kernel", "build_kernel(",
                   "transfer_kernel(TransferArgs a)",
                   "transfer_compact_kernel("):
        assert kernel in src, kernel


def test_transfer_cases_and_plan_codes():
    """K7's cases from small catalog columns: case C's incoming filter is
    sized for the Q5 rows, its outgoing one for every lineitem row, the
    distinct case's outgoing keys are distinct, "2^20 case C rows" takes
    case C's first rows (all of them here) into a filter sized for them,
    "5003 ragged" goes into 8 blocks; `transfer_route` names
    `bloom_transfer_plan`'s route and `transfer_routes` each route the
    sweep forces."""
    import types
    from repro_torch.core import bloom
    from repro_torch.kernels.bloom import ops as kb
    rng = np.random.default_rng(5)
    api = {"o_orderkey": np.arange(4000, dtype=np.int64) * 4,
           "q5": rng.random(4000) < 0.15,
           "l_orderkey": np.sort(rng.integers(0, 4000, 9000)) * 4,
           "l_suppkey": rng.integers(0, 100, 9000)}
    cases = chip_smoke.transfer_cases(torch, np, kb, bloom,
                                      torch.device("cpu"), api)
    assert list(cases) == ["SF 1 case C", "case C distinct",
                           "2^20 case C rows", "5003 ragged"]
    c, d, f, r = cases.values()
    assert c[0].shape[0] == bloom.blocks_for(int(api["q5"].sum()))
    assert c[6] == d[6] == bloom.blocks_for(9000) and bool(c[5].all())
    assert len(torch.unique(d[3])) == 9000
    assert all(torch.equal(x, y) for x, y in zip(f[:6], c[:6]))
    assert f[6] == bloom.blocks_for(9000)
    assert r[6] == 8 and r[1].shape[0] == 5003
    ok, words = kb.transfer(*c)
    assert words.shape == (c[6], 8) and int(ok.sum()) > 0
    lib = types.SimpleNamespace(
        bloom_transfer_plan=lambda n, log2nb: 3 if log2nb > 6 else 2)
    assert chip_smoke.transfer_route(lib, 5, 1024) == "partitioned"
    assert chip_smoke.transfer_route(lib, 5, 64) == "tiny"
    assert all(nb is None or nb <= 64 for _, nb in chip_smoke.TRANSFER_SWEEP)
    assert chip_smoke.transfer_routes(8) == {1: "l2", 2: "tiny"}
    assert chip_smoke.transfer_routes(4096) == {1: "l2", 3: "partitioned"}


def test_k5_passes_source():
    """The pass route: `semijoin.cu` with one `launch_probe`, which
    launches `pass_kernel`, inside the anonymous namespace, and the force
    entry points inside `extern "C"`."""
    text = build.SOURCES["semijoin"].read_text()
    src = K5_PASSES.pass_source(text)
    assert src.count("int launch_probe(") == 1
    launch = src[src.index("int launch_probe("):].split("\n}\n")[0]
    assert "pass_kernel<kRows, Out, false><<<" in launch
    assert src.index("pass_kernel(") < src.index("}  // namespace")
    tail = src[src.index('extern "C" {'):]
    for fn in ("int joinmap_lookup_force(", "int joinmap_lookup_passes("):
        assert fn in tail, fn


def test_gathered_sector_bytes():
    """32 bytes for each 8-row sector of a 4-byte column that holds a row
    read: the live rows themselves, or the rows their survivor ids name."""
    live = torch.tensor([True, False, False, True] + [False] * 12 + [True])
    assert chip_smoke.gathered_sector_bytes(torch, live, None, 17) == 64
    idx = torch.tensor([0, 9, 17, 40, 41], dtype=torch.int32)
    live = torch.tensor([True, True, False, True, True])
    assert chip_smoke.gathered_sector_bytes(torch, live, idx, 48) == 96
    assert chip_smoke.gathered_sector_bytes(
        torch, torch.zeros(5, dtype=torch.bool), idx, 48) == 0


def test_lookup_case_inputs():
    """K5's cases: the path shape is 4,096 probes into 512 slots, one in
    8 a miss; "SF 1 lineitem" is 6,001,215 probes of orders' keys, one in
    8 outside the orders domain."""
    keys, probe = chip_smoke.k5_path_keys(np)
    assert len(probe) == 4096 and sj.capacity_for(len(keys)) == 512
    assert np.isin(probe[1::8], keys).all()
    assert not np.isin(probe[::8], keys).any()
    rng = np.random.default_rng(1)
    orders = rng.choice(6_000_000, chip_smoke.KEYS_ORDERS, replace=False)
    probe = chip_smoke.sf1_lookup_probe(np, rng, orders)
    assert len(probe) == 6_001_215
    assert (probe[::8] >= 6_000_000).all()
    assert (probe[1::8] < 6_000_000).all()


def test_teacher_forced_gap_replays_and_counts_routes():
    """`chip_smoke`'s serve check on deepseek-v2-lite's smoke config on
    the CPU: the routes recorded in a flash run are the MoE layers' calls
    in order (2 a step: the first layer is dense); replayed into the dense
    run, no routing choice differs and the logits agree as closely as
    attention's rounding allows; the wrapper is taken off after each
    run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    inner = L.moe_route
    routes, restore = chip_smoke.record_routes(L)
    try:
        res = serve.generate(model, params, prompt, 3, 32)
    finally:
        restore()
    assert L.moe_route is inner and len(routes) == 2 * (1 + 3)
    assert [tuple(r.top_e.shape) for r in routes[:3]] == [(48, 2), (48, 2),
                                                           (2, 2)]
    res.update(model=model, params=params, prompt=prompt, cap=32)
    free = chip_smoke.teacher_forced_gap(torch, L, fa, serve, res, routes)
    held = chip_smoke.teacher_forced_gap(torch, L, fa, serve, res, routes,
                                         replay=True)
    assert L.moe_route is inner and L._SDPA_BACKEND == "flash"
    assert held["routes_replayed"] and held["route_choices_differing"] == 0
    assert held["route_choices"] == free["route_choices"] == 2 * (48 + 3 * 2)
    assert 0 <= free["route_differing_share"] <= 1
    assert len(held["steps"]) == 4 and held["max_abs"] < 0.25
    assert chip_smoke.route_differences(routes, routes) == (0, 108)


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_serve_launch_expectations_and_check_take_the_stub_inputs(
        arch, monkeypatch):
    """`chip_smoke.expected_launches` counts what the serving launcher
    calls K8 for: on the CPU the smoke config through `serve.serve_config`
    calls `layers.flash_attention` (here counted by Sq) once a
    self-attention layer, once a cross-attention layer and, per prefill
    call, twice an encoder layer (whisper's prefill encodes, and
    `generate` once more); `teacher_forced_gap` feeds the run's own stub
    embeddings to the dense run, so in f32 the two agree within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    calls = {"flash_prefill": 0, "flash_decode": 0}
    inner = L.flash_attention

    def counted(q, *args, **kw):
        calls["flash_decode" if q.shape[1] == 1 else "flash_prefill"] += 1
        return inner(q, *args, **kw)
    monkeypatch.setattr(L, "flash_attention", counted)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    res = serve.serve_config(cfg, 2, 12, 3, torch.device("cpu"))
    assert calls == chip_smoke.expected_launches(cfg, 3, len(res["passes"]))
    if arch == "whisper-base":
        assert calls == {"flash_prefill": 2 * (2 + 2 + 2 * 2),
                         "flash_decode": 2 * 3 * (2 + 2)}
    gap = chip_smoke.teacher_forced_gap(torch, L, fa, serve, res)
    assert len(gap["steps"]) == 4 and gap["max_abs"] < 1e-4
    assert L._SDPA_BACKEND == "flash"


@pytest.mark.parametrize("mesh,batch,prompt,gen", [("1x8", 2, 16, 8),
                                                   ("2x2", 1, 16, 6)])
def test_tf_gap_takes_batch_one_and_a_model_axis_of_eight(
        mesh, batch, prompt, gen, capsys):
    """`tools/tf_gap.py --mesh` on qwen1.5-4b's smoke config on the CPU
    at the two layouts context parallelism adds: a (1, 8) mesh (its 4
    heads split by sequence; the cap, 32, split 4 slots a point) and
    batch 1 on (2, 2) (the cache's length split over "data"): one JSON
    line a depth, its bf16 sharded gap within a tenth of the smoke
    logits' scale (a sum or a slot range gone wrong moves them by about
    their own)."""
    import json
    tool = _tool("tf_gap")
    assert tool.main(["--arch", "qwen1.5-4b", "--config", "smoke",
                      "--layers", "1", "2", "--mesh", mesh, "--batch",
                      str(batch), "--prompt-len", str(prompt),
                      "--gen-tokens", str(gen), "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["layers"] for x in lines] == [1, 2]
    for x in lines:
        assert x["mesh"] == mesh and x["batch"] == batch
        assert x["max_abs"] < 0.05 and x["mean_abs"] < 0.01
