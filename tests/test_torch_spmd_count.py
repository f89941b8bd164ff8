"""One mesh point's collectives counted on the meta device
(`parallel.spmd.counting`, `launch.collectives`) against real sharded
runs on the CPU, for dense attention (qwen1.5-4b's smoke config, its
heads split over "model").

For each layout (`LAYOUTS`: (2, 2) with FSDP on and off, (1, 4), (2, 1,
2) with "pod", batch 1 on (2, 2)) and call (a prefill, one decode step,
one train step of two microbatches), the count of every point is point
0's, the count times the mesh's size is `spmd.COMM` of the same call
run for real on a mesh of `["cpu"] * n` (a decode step's: a prefill and
the step, less the prefill), and each kind's counted output bytes
(the reference's rule) are the bytes of the tensors the collectives
returned. A served pass (`serve.generate_sharded`) counted by
`collectives.count_serve` is the real pass's COMM too. The mode raises
on a tensor off "meta", and the formulas `spmd.serve_comm` and
`spmd.train_comm` equal the count where they model the case, on the
production meshes too. The other block kinds are in
tests/test_torch_spmd_count_*.py: the sequence split (`_seq`), the MoE
(`_moe`), MLA (`_mla`), Mamba-2 (`_ssm`), jamba's hybrid stack
(`_hybrid`, its train step in `_hybrid_train`), whisper (`_encdec`) and
llava (`_vlm`)."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
from repro_torch.launch import collectives as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.train.step import TrainConfig, build_train_step

#: tag -> (mesh shape, axes, fsdp, global batch)
LAYOUTS = {"2x2-fsdp": ((2, 2), ("data", "model"), True, 4),
           "2x2": ((2, 2), ("data", "model"), False, 4),
           "1x4": ((1, 4), ("data", "model"), False, 4),
           "2x1x2-pod": ((2, 1, 2), ("pod", "data", "model"), True, 4),
           "2x2-b1": ((2, 2), ("data", "model"), False, 1),
           "1x8": ((1, 8), ("data", "model"), False, 4)}
#: the layouts every block kind's file counts (`cases`)
CASE_LAYOUTS = ("2x2-fsdp", "2x2", "1x4", "2x1x2-pod", "2x2-b1")
CALLS = ("prefill", "decode", "train")
SEQ = 16                # a call's positions (a decode step's cache slots)
GEN = 3                 # a served pass's decode steps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cases(archs, calls=CALLS, layouts=CASE_LAYOUTS):
    return [(arch, layout, call) for arch in archs for layout in layouts
            for call in calls]


def _setup(arch, layout):
    shape, axes, fsdp, batch = LAYOUTS[layout]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    mesh = make_test_mesh(shape, axes, devices=["cpu"] * math.prod(shape))
    return cfg, mesh, fsdp, batch


def _train_config(batch):
    return TrainConfig(microbatches=2 if batch % 2 == 0 else 1,
                       loss_chunk=SEQ)


def _real_like(cfg, t, rng):
    """Seeded values of a meta tensor's shape and dtype: token ids for an
    integer one, N(0, 1) otherwise."""
    if t is None:
        return None
    if not t.dtype.is_floating_point:
        return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             tuple(t.shape))).to(t.dtype)
    return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)).to(t.dtype)


def _sharded_params(cfg, mesh, fsdp):
    model = Model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    return model, SP.shard_tree(full, S.param_specs(cfg, mesh, fsdp), mesh)


def real_comm(cfg, mesh, fsdp, spec, tc=None, opt=None):
    """`spmd.COMM` of the call of `spec` run for real on `mesh` (random
    weights and inputs of the count's shapes)."""
    model, params = _sharded_params(cfg, mesh, fsdp)
    _, args, _ = input_specs(cfg.name, spec, make_test_mesh((1, 1)), cfg)
    rng = np.random.default_rng(1)
    ways = serve.batch_ways(mesh, spec.global_batch)
    if spec.kind == "train":
        batch = Batch(*(_real_like(cfg, t, rng) for t in args[0]))
        state = SP.init_state(opt.init, params, D.opt_shardings)
        SP.reset_counts()
        build_train_step(model, opt, tc, mesh=mesh)(params, state, batch)
        return dict(SP.COMM)
    if spec.kind == "prefill":
        batch = Batch(*(serve.split_rows(mesh, _real_like(cfg, t, rng))
                        for t in args[0]))
        SP.reset_counts()
        with torch.no_grad():
            SP.run(mesh, model.prefill, params, batch, spec.seq_len,
                   batch_ways=ways)
        return dict(SP.COMM)
    # a decode step: a served pass of one step into seq_len slots, less
    # the pass without it
    n = serve.stub_len(cfg)
    extra = None if n is None else torch.from_numpy(rng.standard_normal(
        (spec.global_batch, n, cfg.d_model)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        spec.global_batch,
        spec.seq_len - 1 - serve.prefix_len(cfg, extra))))
    got = []
    for steps in (0, 1):
        SP.reset_counts()
        with torch.no_grad():
            serve.generate_sharded(model, params, prompt, steps,
                                   spec.seq_len, mesh, extra=extra)
        got.append(dict(SP.COMM))
    return {k: got[1][k] - got[0][k] for k in SP.COMM}


def _outputs(monkeypatch):
    """Each kind's bytes of the tensors the collectives return, recorded
    around `spmd`'s own functions (a call that exchanged nothing, such as
    a gather's backward over axes that do not split the batch, adds
    none)."""
    made, out = [], {k: 0 for k in ("all_reduce", "all_gather",
                                    "reduce_scatter")}
    exchange = SP._exchange

    def counted_exchange(*a, **k):
        made.append(1)
        return exchange(*a, **k)
    monkeypatch.setattr(SP, "_exchange", counted_exchange)
    for name, kind in (("_reduce", "all_reduce"),
                       ("all_gather", "all_gather"),
                       ("_scatter", "reduce_scatter")):
        def wrapped(*a, _f=getattr(SP, name), _kind=kind, **k):
            before = len(made)
            t = _f(*a, **k)
            if len(made) > before:
                out[_kind] += t.numel() * t.element_size()
            return t
        monkeypatch.setattr(SP, name, wrapped)
    return out


def check_call(arch, layout, call, monkeypatch):
    """The count of `call` on `layout` against the real run (the
    module's note)."""
    cfg, mesh, fsdp, batch = _setup(arch, layout)
    spec = ShapeSpec(call, SEQ, batch, call)
    tc = _train_config(batch) if call == "train" else None

    def count(point):
        return C.count(cfg, spec, mesh, fsdp=fsdp, tc=tc,
                       optimizer=D.make_optimizer(arch)
                       if call == "train" else None, point=point)
    with monkeypatch.context() as mp:
        outputs = _outputs(mp)
        first = count(0)
    assert {k: first[k + "_output_bytes"] for k in outputs} == outputs
    assert first["all_reduce"] + first["all_gather"] > 0
    for p in range(1, mesh.size):
        assert count(p) == first, p
    want = real_comm(cfg, mesh, fsdp, spec, tc, D.make_optimizer(arch))
    assert {k: first[k] * mesh.size for k in SP.COMM} == want


def check_serve(arch, layout, cap=SEQ + GEN + 8):
    """`collectives.count_serve` of a served pass (into `cap` slots)
    against the real pass's `spmd.COMM`; returns the count."""
    cfg, mesh, fsdp, batch = _setup(arch, layout)
    model, params = _sharded_params(cfg, mesh, fsdp)
    rng = np.random.default_rng(1)
    n = serve.stub_len(cfg)
    extra = None if n is None else torch.from_numpy(rng.standard_normal(
        (batch, n, cfg.d_model)).astype(np.float32))
    prompt_len = SEQ - serve.prefix_len(cfg, extra)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len)))
    SP.reset_counts()
    with torch.no_grad():
        serve.generate_sharded(model, params, prompt, GEN, cap, mesh,
                               extra=extra)
    got = C.count_serve(cfg, mesh, batch, prompt_len, GEN, cap, fsdp)
    assert {k: got[k] * mesh.size for k in SP.COMM} == dict(SP.COMM)
    return got


ARCHS = ("qwen1.5-4b",)


@pytest.mark.parametrize("arch,layout,call", cases(ARCHS))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)


@pytest.mark.parametrize("layout", ("2x2", "2x2-b1", "1x4"))
@pytest.mark.parametrize("arch", ARCHS)
def test_count_serve_is_the_real_pass_comm(arch, layout):
    check_serve(arch, layout)


def test_counting_raises_on_a_tensor_off_meta():
    """A count's collectives meet no one, so their values are not real:
    a tensor on the CPU that reaches one raises, and the counts keep
    nothing of it."""
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with SP.counting() as counts:
        with pytest.raises(RuntimeError, match="only meta tensors"):
            SP.run(mesh, lambda: SP.all_reduce(torch.ones(3), "model"))
        with pytest.raises(RuntimeError, match="already counting"):
            with SP.counting():
                pass
    assert counts["all_reduce"] == 0
    assert SP.context() is None


def test_counting_builds_the_counted_point_alone():
    """On the (2, 32, 8) production mesh (abstract: no devices) a leaf
    sharded while counting holds the counted point's slice on "meta",
    one tensor for the 512 points, and `run` calls its function once,
    on this thread, with that point's coordinates."""
    mesh = make_production_mesh(multi_pod=True)
    full = torch.empty((64, 16), dtype=torch.bfloat16, device="meta")
    seen = []
    with SP.counting(point=9) as counts:
        x = SP.shard_leaf(full, S.P(("pod", "data"), "model"), mesh)
        out = SP.run(mesh, lambda t: seen.append(
            (SP.context().coords, t.shape)) or SP.all_gather(t, "model", 1),
            x)
    assert len(set(map(id, x.shards))) == 1 and len(x.shards) == 512
    assert x.shards[0].device.type == "meta"
    assert seen == [({"pod": 0, "data": 1, "model": 1}, (1, 2))]
    assert len(out) == 512 and tuple(out[0].shape) == (1, 16)
    assert counts["all_gather"] == 1
    assert counts["all_gather_bytes"] == 7 * 2 * 2       # 7 others' 2
    assert counts["all_gather_output_bytes"] == 16 * 2
    assert SP.run(make_test_mesh((2,), ("data",), devices=["cpu"] * 2),
                  lambda: SP.context().point) == [0, 1]


FORMULA_LAYOUTS = ("2x2-fsdp", "2x2", "1x4", "2x1x2-pod")


@pytest.mark.parametrize("layout", FORMULA_LAYOUTS)
def test_train_comm_is_the_count(layout):
    """`spmd.train_comm` (a dense model, FSDP over "data", the batch over
    "pod" and "data") equals the count of the train step."""
    cfg, mesh, fsdp, batch = _setup("qwen1.5-4b", layout)
    tc = _train_config(batch)
    got = C.count(cfg, ShapeSpec("t", SEQ, batch, "train"), mesh, fsdp=fsdp,
                  tc=tc, optimizer=D.make_optimizer("qwen1.5-4b"))
    assert SP.train_comm(cfg, mesh, batch, SEQ, tc, fsdp) == {
        k: got[k] * mesh.size for k in SP.COMM}


@pytest.mark.parametrize("multi", (False, True))
@pytest.mark.parametrize("fsdp", (True, False))
def test_formulas_are_the_count_on_the_production_meshes(multi, fsdp):
    """A narrow dense config (qwen1.5-4b's widths cut to 128, its 32
    heads of 8 dims, 2 layers) on (32, 8) and (2, 32, 8): `train_comm`
    equals the count of a train step, and `serve_comm` (fsdp off) that of
    a served pass, at a batch the data axes divide and at batch 1."""
    full = get_config("qwen1.5-4b")
    cfg = dataclasses.replace(
        full, n_layers=2, d_model=128, d_ff=256, vocab_size=1024,
        attn=dataclasses.replace(full.attn, num_heads=16, num_kv_heads=16,
                                 head_dim=8))
    mesh = make_production_mesh(multi_pod=multi)
    tc = TrainConfig(microbatches=2, loss_chunk=SEQ)
    batch = 256
    got = C.count(cfg, ShapeSpec("t", SEQ, batch, "train"), mesh, fsdp=fsdp,
                  tc=tc, optimizer=D.make_optimizer("qwen1.5-4b"))
    assert SP.train_comm(cfg, mesh, batch, SEQ, tc, fsdp) == {
        k: got[k] * mesh.size for k in SP.COMM}
    if fsdp:
        return
    for b in (128, 1):
        got = C.count_serve(cfg, mesh, b, SEQ, GEN, 64, fsdp=False)
        assert SP.serve_comm(cfg, mesh, b, SEQ, GEN, 64) == {
            k: got[k] * mesh.size for k in SP.COMM}
