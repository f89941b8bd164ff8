"""The port's launch layer (`repro_torch.launch.{analytic,specs,dryrun,
roofline,mesh}`), `ModelConfig.active_param_count` and the multi-pod
filter transfer (`repro_torch.core.distributed`) against the reference,
on the CPU.

* The cost model's four counts equal the reference's `cell_cost` to a
  relative 1e-12 for every arch x shape that runs, on both packages'
  production meshes and on (1, 1), with the port's serving threshold
  set to the reference's 12e9 (the port's default is 75% of an H100's
  80 GB); the port's defaults are the H100's constants.
* `TRAIN_SETTINGS`, `microbatches_for` and `input_specs` equal the
  reference's (shapes, dtypes, specs).
* The dry run's per-device argument bytes on the single mesh equal a sum
  over the reference's own `input_specs`, `param_specs` and
  `opt_shardings` leaves (each leaf's shard shape on an abstract (32, 8)
  mesh), computed in a subprocess that imports the reference's dry run
  (it forces 512 XLA host devices at import); the ring cursors, which
  the port keeps as host ints, are left out of both.
* The roofline over reports written to a temporary directory has 40 rows
  a mesh, skip rows where `shape_skip_reason` says so.
* The pod-axis transfer on a (2, 4) ("pod", "data") mesh of CPU shards
  equals the reference's `make_distributed_transfer` on a (2, 4) mesh of
  8 forced XLA host devices (a subprocess): every shard's words (the
  reference's words through its own `_or_all_reduce`/
  `_or_all_reduce_tree` over "pod" then "data") and the mask, with the
  gather OR and the tree OR."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.launch import analytic as RA
from repro.launch import specs as RSP
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_skip_reason
from repro_torch.core import distributed
from repro_torch.core.engine_bloom import get_engine
from repro_torch.launch import analytic as A
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (
    Mesh, get_abstract_mesh, make_data_mesh, make_production_mesh,
    make_test_mesh, set_mesh,
)
from repro_torch.models.model import build_model, Model

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_ENV = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH_SHAPES = {
    "ref-single": {"data": 16, "model": 16},
    "ref-multi": {"pod": 2, "data": 16, "model": 16},
    "single": {"data": 32, "model": 8},
    "multi": {"pod": 2, "data": 32, "model": 8},
    "one": {"data": 1, "model": 1},
}


@pytest.fixture(scope="module", autouse=True)
def memo_eval_shape():
    """The reference's `param_count` (called inside every `cell_cost`)
    runs `jax.eval_shape` of its init on a fresh lambda each time; the
    same code over the same closure gives the same shapes, so keep them
    for the module."""
    inner, memo = jax.eval_shape, {}

    def cached(fn, *args, **kw):
        if args or kw or fn.__closure__ is None:
            return inner(fn, *args, **kw)
        key = (fn.__code__,
               tuple(c.cell_contents for c in fn.__closure__))
        if key not in memo:
            memo[key] = inner(fn)
        return memo[key]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "eval_shape", cached)
    yield
    mp.undo()


# -- the reference's subprocesses, started together -----------------------

_REF_BYTES = r"""
import json
import repro.launch.dryrun as D      # forces 512 XLA host devices
import jax, numpy as np
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, SHAPES, get_config, shape_skip_reason
from repro.launch.specs import TRAIN_SETTINGS, input_specs
from repro.models.model import Model
from repro.parallel import sharding as S
from repro.train import optim as O
mesh = AbstractMesh((32, 8), ("data", "model"))
_inner, _memo = jax.eval_shape, {}
def _cached(fn, *a, **kw):           # same code, same closure: same shapes
    if a or kw or fn.__closure__ is None:
        return _inner(fn, *a, **kw)
    key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__))
    if key not in _memo:
        _memo[key] = _inner(fn)
    return _memo[key]
jax.eval_shape = _cached
def total(tree, shs, skip=()):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sflat = jax.tree_util.tree_leaves(
        shs, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))
    assert len(flat) == len(sflat)
    n = 0
    for (path, leaf), sh in zip(flat, sflat):
        if any(getattr(k, "name", None) in skip for k in path):
            continue
        sh = sh if isinstance(sh, NamedSharding) else NamedSharding(mesh, sh)
        n += int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return n
out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    pshapes = jax.eval_shape(lambda: Model(cfg).init(jax.random.PRNGKey(0)))
    for shape in SHAPES:
        if shape_skip_reason(cfg, shape):
            continue
        kind, args, specs = input_specs(arch, shape, mesh, cfg)
        fsdp = TRAIN_SETTINGS[arch].fsdp if kind == "train" else \
            cfg.param_count() * 2.0 / 8 > 12e9
        pspecs = S.param_specs(cfg, mesh, fsdp=fsdp)
        n = total(pshapes, pspecs)
        if kind == "train":
            ts = TRAIN_SETTINGS[arch]
            opt = O.make_optimizer(ts.optimizer,
                                   O.cosine_schedule(3e-4, 100, 10_000),
                                   state_dtype=ts.opt_state_dtype)
            oshapes = jax.eval_shape(opt.init, pshapes)
            n += total(oshapes, D.opt_shardings(oshapes, pspecs, mesh))
        if kind == "decode":
            tok, caches, pos, *enc = args
            n += total(tok, specs[0]) + total(caches, specs[1],
                                              skip=("index",))
            if enc:
                n += total(enc[0], specs[3])
        else:
            n += total(args[0], specs[0])
        out[arch + "|" + shape] = [n, bool(fsdp)]
print("JSON" + json.dumps(out))
"""

_REF_POD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
assert jax.device_count() == 8
from repro.core import bloom, hashing
from repro.core.distributed import (
    _or_all_reduce, _or_all_reduce_tree, make_distributed_transfer)
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh((2, 4), ("pod", "data"))
spec = P(("pod", "data"))
data = np.load(sys.argv[1])
nblocks = int(data["nblocks"])
put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
b = [put(data[k]) for k in ("blo", "bhi", "bm")]
p = [put(data[k]) for k in ("plo", "phi", "pm")]
out = {}
for tree in (False, True):
    def words_fn(lo, hi, m):
        w = bloom.build(lo, hi, m, nblocks)
        for a in ("pod", "data"):
            w = _or_all_reduce_tree(w, a, mesh.shape[a]) if tree \
                else _or_all_reduce(w, a)
        return w[None]
    fn = jax.jit(jax.shard_map(words_fn, mesh=mesh, in_specs=(spec,) * 3,
                               out_specs=spec))
    out[f"words{int(tree)}"] = np.asarray(fn(*b))
    out[f"mask{int(tree)}"] = np.asarray(make_distributed_transfer(
        mesh, nblocks, tree_or=tree)(*b, *p))
np.savez(sys.argv[2], **out)
"""


def _pod_inputs():
    rng = np.random.default_rng(11)
    bkeys = rng.integers(-10**6, 10**6, 3001).astype(np.int64)
    pkeys = np.concatenate([bkeys[:1500], rng.integers(
        2 * 10**6, 3 * 10**6, 2503).astype(np.int64)])
    return bkeys, rng.permutation(pkeys)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Both reference subprocesses, run side by side: the argument bytes
    and the pod-mesh transfer (on the port's own shard layout)."""
    tmp = tmp_path_factory.mktemp("launch")
    bkeys, pkeys = _pod_inputs()
    mesh = make_test_mesh((2, 4), ("pod", "data"), devices=["cpu"] * 8)
    b = distributed.shard_table_arrays(bkeys, mesh)
    p = distributed.shard_table_arrays(pkeys, mesh)
    cat = lambda xs: np.concatenate([x.numpy() for x in xs])
    np.savez(tmp / "in.npz", nblocks=kb_blocks(bkeys),
             **{k: cat(v) for k, v in zip(("blo", "bhi", "bm", "plo", "phi",
                                           "pm"), (*b, *p))})
    procs = {
        "bytes": subprocess.Popen([sys.executable, "-c", _REF_BYTES],
                                  env=_ENV, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True),
        "pod": subprocess.Popen([sys.executable, "-c", _REF_POD,
                                 str(tmp / "in.npz"), str(tmp / "out.npz")],
                                env=_ENV, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
    }
    outs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{name}:\n{err[-4000:]}"
        outs[name] = out
    line = [ln for ln in outs["bytes"].splitlines() if ln.startswith("JSON")]
    return {"bytes": json.loads(line[-1][4:]),
            "pod": dict(np.load(tmp / "out.npz"))}


def kb_blocks(bkeys) -> int:
    from repro_torch.core import bloom
    return bloom.blocks_for(len(bkeys))


# -- configs and the cost model --------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    cfg, rcfg = get_config(arch), rget_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert (cfg.active_param_count() < cfg.param_count()) == (
        cfg.moe is not None)
    assert type(build_model(cfg)) is Model and build_model(cfg).cfg is cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_have_the_init_layout(arch):
    """The dry run's meta parameters (`abstract_params`, drawn from
    nothing) have `init_params`' tree, shapes and dtypes (the smoke
    config's real draw; the full config's shapes through the specs)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import abstract_params, init_params
    from repro_torch.train.tree import leaves
    cfg = get_smoke_config(arch)
    got = leaves(abstract_params(cfg))
    want = leaves(init_params(torch.Generator().manual_seed(0), cfg))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def _train_args(arch, mesh_shape):
    """The roofline's training arguments of `cell_cost`, from the port's
    settings (equal to the reference's: test below)."""
    ts = SP.TRAIN_SETTINGS[arch]
    opt_bpp = {"adamw": 8.0 if ts.opt_state_dtype == torch.float32 else 4.0,
               "adafactor": 0.1}[ts.optimizer]
    return dict(microbatches=SP.microbatches_for(
        arch, get_config(arch), FakeMesh(mesh_shape), SHAPES["train_4k"]),
        optimizer=ts.optimizer, opt_bytes_per_param=opt_bpp, fsdp=ts.fsdp,
        accum_bytes=4.0 if ts.accum_dtype == torch.float32 else 2.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_equals_reference(arch, monkeypatch):
    monkeypatch.setattr(A, "SERVE_FIT_BYTES", 12e9)
    cfg, rcfg = get_config(arch), rget_config(arch)
    n = 0
    for shape in SHAPES:
        if shape_skip_reason(cfg, shape):
            continue
        for mesh_shape in MESH_SHAPES.values():
            kw = _train_args(arch, mesh_shape) if shape == "train_4k" \
                else {}
            got = A.cell_cost(cfg, shape, mesh_shape, **kw)
            want = RA.cell_cost(rcfg, shape, mesh_shape, **kw)
            for f in ("flops", "hbm_bytes", "coll_bytes", "model_flops"):
                np.testing.assert_allclose(getattr(got, f),
                                           getattr(want, f), rtol=1e-12,
                                           err_msg=f"{arch} {shape} {f}")
            n += 1
    assert n == 5 * (4 if cfg.context_class != "full" else 3)


def test_cost_model_defaults_are_the_h100s():
    """Datasheet constants; the roofline's terms use them; the serving
    threshold is 75% of 80 GB."""
    assert (A.PEAK_FLOPS, A.HBM_BW, A.HBM_BYTES, A.LINK_BW) == (
        989e12, 3.35e12, 80e9, 50e9)
    assert A.SERVE_FIT_BYTES == 0.75 * 80e9
    c = A.Cost(989e12, 3.35e12, 50e9, 1.0)
    assert c.terms() == {"compute_s": 1.0, "memory_s": 1.0,
                         "collective_s": 1.0}
    # deepseek-v2-lite's 31.4 GB of bf16 stays resident on one H100 of a
    # data-only mesh (under 60 GB), where the reference's 12 GB rule
    # re-gathers it every step
    dp4 = {"data": 4, "model": 1}
    got = A.prefill_cost(get_config("deepseek-v2-lite-16b"),
                         SHAPES["prefill_32k"], dp4)
    want = RA.prefill_cost(rget_config("deepseek-v2-lite-16b"),
                           RSHAPES["prefill_32k"], dp4)
    assert got.coll_bytes == 0 and want.coll_bytes > 0


# -- launch settings and input specs ---------------------------------------


def test_train_settings_equal_reference():
    assert list(SP.TRAIN_SETTINGS) == list(RSP.TRAIN_SETTINGS)
    for arch, ts in SP.TRAIN_SETTINGS.items():
        rts = RSP.TRAIN_SETTINGS[arch]
        for f in dataclasses.fields(ts):
            got, want = getattr(ts, f.name), getattr(rts, f.name)
            if f.name.endswith("dtype"):
                got, want = str(got).split(".")[-1], jnp.dtype(want).name
            assert got == want, (arch, f.name)
        for mesh_shape in MESH_SHAPES.values():
            for spec in SHAPES.values():
                assert SP.microbatches_for(
                    arch, get_config(arch), FakeMesh(mesh_shape), spec) == \
                    RSP.microbatches_for(arch, rget_config(arch),
                                         FakeMesh(mesh_shape),
                                         RSHAPES[spec.name])


def _flat(tree, path=""):
    """{path: leaf} over dicts, lists, tuples, NamedTuples and cache
    records; a spec, a tensor, a ShapeDtypeStruct, an int or None is a
    leaf."""
    if type(tree).__name__ in ("P", "PartitionSpec") or not isinstance(
            tree, (dict, list, tuple)) and not dataclasses.is_dataclass(tree):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("mesh", ["single", "ref-multi", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, mesh):
    m = FakeMesh(MESH_SHAPES[mesh])
    for shape in SHAPES:
        kind, args, specs = SP.input_specs(arch, shape, m)
        rkind, rargs, rspecs = RSP.input_specs(arch, shape, m)
        assert kind == rkind
        got, want = _flat(args), _flat(rargs)
        # the port's ring cursors are host ints (the reference's int32)
        cursors = [k for k in want if k.endswith("/index")]
        assert all(isinstance(got[k], int) for k in cursors)
        # and its cache records carry the slot range a mesh point holds
        # (`layers.KVCache`: start, the ring's slots, the split axes),
        # which the reference leaves to GSPMD: outside `spmd.run` every
        # slot of the ring, split over no axis
        # (an empty `axes` flattens to no key; a split one would show)
        ranges = {k: got.pop(k) for k in list(got)
                  if k.rsplit("/", 1)[-1] in ("start", "slots")}
        for k in cursors:
            rec = k[:-len("/index")]
            assert ranges.pop(rec + "/start") == 0, (shape, rec)
            slot_dim = 2 if "/slots/" in rec else 1     # a stacked record
            assert ranges.pop(rec + "/slots") == \
                got[rec + "/k"].shape[slot_dim], (shape, rec)
        assert not ranges, ranges
        assert set(got) == set(want)
        for k in set(want) - set(cursors):
            if want[k] is None:
                assert got[k] is None, k
                continue
            assert tuple(got[k].shape) == tuple(want[k].shape), (shape, k)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).split(".")[-1] == \
                jnp.dtype(want[k].dtype).name, (shape, k)
        gs, ws = _flat(specs), _flat(rspecs)
        # the spec tree's cache records hold the range fields as host ints
        for k in [k for k in gs if k.rsplit("/", 1)[-1] in ("start",
                                                            "slots")]:
            assert isinstance(gs.pop(k), int), k
        assert {k: None if v is None else tuple(v) for k, v in gs.items()} \
            == {k: None if v is None else tuple(v) for k, v in ws.items()}, \
            (arch, shape)


def test_input_specs_take_a_shape_spec():
    from repro_torch.configs import ShapeSpec
    kind, args, _ = SP.input_specs(
        "qwen1.5-4b", ShapeSpec("serve", 2088, 4, "decode"),
        make_test_mesh((1, 1)))
    assert kind == "decode" and args[1]["slots"][0].k.shape[2] == 2088
    named = SP.named(make_test_mesh((1, 1)), SP.input_specs(
        "qwen1.5-4b", "prefill_32k", make_test_mesh((1, 1)))[2])
    # one device: the data axis (size 1) divides every batch
    assert named[0].tokens.spec == ("data", None)
    assert named[0].extra is None


# -- the dry run and the roofline -----------------------------------------


def test_argument_bytes_equal_reference_leaves(reference_runs):
    want = reference_runs["bytes"]
    mesh = make_production_mesh()
    n = 0
    for arch in ARCHS:
        for shape in SHAPES:
            if shape_skip_reason(get_config(arch), shape):
                assert f"{arch}|{shape}" not in want
                continue
            got = D.argument_bytes(arch, shape, mesh)
            assert [got["argument_bytes"], got["fsdp"]] == \
                want[f"{arch}|{shape}"], (arch, shape)
            assert got["argument_bytes"] == sum(got["parts"].values())
            n += 1
    assert n == len(want) == 33


def test_dryrun_and_roofline_write_40_rows_a_mesh(tmp_path, monkeypatch):
    """`dryrun.main` over every cell and both meshes (the FLOP trace and
    the collectives' count replaced by stand-ins: `test_traced_flops_*`
    and tests/test_torch_spmd_count*.py hold them), then the roofline
    over those reports: 40 rows a mesh, the skip rows where
    `shape_skip_reason` says so, the reference's five collective kinds
    in each cell that runs with their bytes summed, nothing under the
    reference's reports/dryrun."""
    from repro_torch.launch import collectives as C
    from repro_torch.parallel import spmd
    calls = []

    def fake_flops(arch, shape, m=1, cfg=None, mesh=None):
        calls.append((arch, shape, m))
        return {"flops": 1e18, "trace_seconds": 0.0, "flops_note": None}

    def fake_count(arch, shape, mesh, cfg=None, point=0):
        return {k: 3 for k in spmd.COUNTED}
    monkeypatch.setattr(D, "step_flops", fake_flops)
    monkeypatch.setattr(C, "count_cell", fake_count)
    assert D.main(["--mesh", "both", "--reports", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path / "dryrun"))
    assert len(files) == 80
    for tag in ("single", "multi"):
        assert R.main(["--mesh", tag, "--reports", str(tmp_path)]) == 0
        rows = R.build_table(tag, str(tmp_path))
        assert len(rows) == 40
        for r in rows:
            skip = shape_skip_reason(get_config(r["arch"]), r["shape"])
            assert ("skip" in r) == (skip is not None)
            if skip is None:
                assert r["devices"] == (256 if tag == "single" else 512)
                assert r["bottleneck"] in ("compute", "memory",
                                           "collective")
                assert 0 < r["roofline_fraction"] <= 1.0
                assert r["traced_flops_per_dev"] == 1e18 / r["devices"]
                assert r["coll_bytes_per_dev_counted"] == 3 * 3
                assert r["coll_received_bytes_per_dev_counted"] == 3 * 3
                assert r["coll_bytes_per_dev_analytic"] >= 0
        assert (tmp_path / f"roofline_{tag}.md").read_text().count(
            "\n") == 42
        rep = json.loads((tmp_path / "dryrun" /
                          f"qwen1.5-4b__decode_32k__{tag}.json").read_text())
        assert rep["compile_seconds"] is None
        assert rep["collectives"] == {
            "all-gather": {"count": 3, "bytes": 3},
            "all-reduce": {"count": 3, "bytes": 3},
            "reduce-scatter": {"count": 3, "bytes": 3},
            "all-to-all": {"count": 0, "bytes": 0},
            "collective-permute": {"count": 0, "bytes": 0}}
        assert rep["collective_bytes_per_device"] == sum(
            v["bytes"] for v in rep["collectives"].values())
        assert rep["collective_received_bytes_per_device"] == 3 * 3
        assert "collectives" not in rep["not_measured"]
        assert "collective_bytes_per_device" not in rep["not_measured"]
        assert "memory.temp_bytes" in rep["not_measured"]
    # a cell's FLOPs are traced once for both meshes when the
    # microbatches agree (every serving cell but a MoE's: its groups
    # follow the data-parallel ways)
    assert len(calls) < 66
    # the port's reports live apart from the reference's reports/dryrun
    for root in (D.REPORT_DIR, R.REPORT_DIR):
        assert os.path.normpath(root).endswith(os.path.join("reports",
                                                            "torch"))


def test_traced_flops_count_the_chunked_attention_products():
    """The dry run traces "auto" attention unchunked: at lengths that are
    multiples of the chunks, FlopCounterMode counts the same products
    as the chunked form."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import layers as L
    rng = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 16, generator=rng)
    kv = torch.randn(1, 128, 2, 16, generator=rng)
    pos = torch.arange(128)[None]
    counts = []
    for unchunked in (False, True):
        with FlopCounterMode(display=False) as fc, \
                L.attention_backend("auto"):
            if unchunked:
                with D._unchunked():
                    L._sdpa(q, kv, kv, pos[:, :64], pos,
                            torch.ones(1, 128, dtype=torch.bool),
                            causal=True, window=None)
            else:
                saved = (L._SDPA_CHUNK_THRESHOLD, L._Q_CHUNK, L._KV_CHUNK)
                L._SDPA_CHUNK_THRESHOLD, L._Q_CHUNK, L._KV_CHUNK = 0, 16, 32
                try:
                    L._sdpa(q, kv, kv, pos[:, :64], pos,
                            torch.ones(1, 128, dtype=torch.bool),
                            causal=True, window=None)
                finally:
                    (L._SDPA_CHUNK_THRESHOLD, L._Q_CHUNK,
                     L._KV_CHUNK) = saved
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] == 2 * 2 * 64 * 128 * 4 * 16


def test_traced_flops_of_a_small_cell():
    """`step_flops` at a small shape of qwen's smoke config: prefill,
    decode and a train step (one microbatch times m) on the meta device;
    the train step's count is three times the loss's forward and more
    (backward 2x, remat recomputation 1x)."""
    from repro_torch.configs import ShapeSpec, get_smoke_config
    cfg = get_smoke_config("qwen1.5-4b")
    pre = D.step_flops("qwen1.5-4b", ShapeSpec("p", 64, 4, "prefill"),
                       cfg=cfg)
    dec = D.step_flops("qwen1.5-4b", ShapeSpec("d", 64, 4, "decode"),
                       cfg=cfg)
    tr1 = D.step_flops("qwen1.5-4b", ShapeSpec("t", 64, 4, "train"), 1,
                       cfg=cfg)
    tr2 = D.step_flops("qwen1.5-4b", ShapeSpec("t", 64, 4, "train"), 2,
                       cfg=cfg)
    assert 0 < dec["flops"] < pre["flops"] < tr1["flops"]
    assert tr2["flops"] == tr1["flops"] and tr2["flops_note"].endswith("m=2")
    assert pre["flops_note"] is None


# -- meshes and the pod-axis transfer --------------------------------------


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert multi.devices is None and multi.axis_names[0] == "pod"
    t = make_test_mesh()
    assert t.shape == {"data": 2, "model": 2} and t.devices is None
    d = make_test_mesh((2, 4), ("pod", "data"), devices=["cpu"] * 8)
    assert len(d.devices) == 8 and d.devices[0] == torch.device("cpu")
    with pytest.raises(ValueError):
        Mesh(("data",), (2,), (torch.device("cpu"),))
    with pytest.raises(ValueError):
        make_test_mesh((2,), ("data", "model"))
    assert get_abstract_mesh() is None
    with set_mesh(single):
        assert get_abstract_mesh() is single
        with set_mesh(None):
            assert get_abstract_mesh() is None
        assert get_abstract_mesh() is single
    assert get_abstract_mesh() is None


def test_make_test_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_test_mesh((2, 4), ("pod", "data"), devices=["cuda:0"] * 8)


@pytest.mark.parametrize("tree_or", [False, True])
def test_pod_transfer_equals_reference(tree_or, reference_runs):
    ref = reference_runs["pod"]
    bkeys, pkeys = _pod_inputs()
    nblocks = kb_blocks(bkeys)
    mesh = make_test_mesh((2, 4), ("pod", "data"), devices=["cpu"] * 8)
    b = distributed.shard_table_arrays(bkeys, mesh)
    p = distributed.shard_table_arrays(pkeys, mesh)
    words = distributed.distributed_bloom_build(*b, nblocks, mesh,
                                                tree_or=tree_or)
    assert len(words) == 8
    for s, w in enumerate(words):
        np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                      ref[f"words{int(tree_or)}"][s])
    # one OR over all 8 shards (the 1-D mesh) gives the same words
    flat = make_data_mesh(8, devices=["cpu"] * 8)
    for w in distributed.distributed_bloom_build(*b, nblocks, flat,
                                                 tree_or=tree_or):
        assert torch.equal(w, words[0])
    mask = distributed.make_distributed_transfer(mesh, nblocks,
                                                 tree_or=tree_or)(*b, *p)
    got = np.concatenate([m.numpy() for m in mask])
    np.testing.assert_array_equal(got, ref[f"mask{int(tree_or)}"])
    assert got[:len(pkeys)][np.isin(pkeys, bkeys)].all()
    # the engine's hook takes the same mesh
    eng = get_engine("cuda", device="cpu")
    fn = eng.make_distributed_transfer(mesh, live_keys=len(bkeys),
                                       tree_or=tree_or)
    sb, sp = eng.shard_keys(bkeys, mesh), eng.shard_keys(pkeys, mesh)
    assert len(sb[0]) == 8
    got = np.concatenate([m.numpy() for m in fn(*sb, *sp)])
    np.testing.assert_array_equal(got[:len(pkeys)], ref[
        f"mask{int(tree_or)}"][:len(pkeys)])


def test_pod_groups_and_bad_meshes():
    mesh = make_test_mesh((2, 4), ("pod", "data"), devices=["cpu"] * 8)
    assert distributed._axis_groups(mesh, "pod") == [[0, 4], [1, 5],
                                                     [2, 6], [3, 7]]
    assert distributed._axis_groups(mesh, "data") == [[0, 1, 2, 3],
                                                      [4, 5, 6, 7]]
    assert distributed.shard_axes(mesh) == ("pod", "data")
    for bad in (make_test_mesh((2, 4)),
                make_test_mesh((2, 2), devices=["cpu"] * 4),
                make_test_mesh((2, 4), ("pod", "data"))):
        with pytest.raises(ValueError):
            distributed.make_distributed_transfer(bad, 8)
