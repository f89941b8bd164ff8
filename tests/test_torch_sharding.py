"""Port parity of the sharding rules (`repro_torch.parallel.sharding`)
and the hints' mesh reads (`repro_torch.parallel.hints`) against the
reference, on duck-typed meshes (`.shape` and `.axis_names` only, as
the reference's own tests/test_sharding.py::FakeMesh).

Every spec of every architecture's parameters (fsdp on and off) and
caches (a batch the data axes divide, batch 1 with and without KV
sequence sharding) must equal the reference's, leaf for leaf by path,
on the four meshes below; so must `batch_spec`, `fit_spec` and the
hints' `tp_size`, `dp_size` and `attn_layout` under the same meshes."""
import jax
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec

from repro.configs import ARCHS as RARCHS
from repro.configs import get_config as rget_config
from repro.parallel import hints as RHT
from repro.parallel import sharding as RS
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh, set_mesh
from repro_torch.models import layers as L
from repro_torch.parallel import hints as HT
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import P


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
    "32x8": {"data": 32, "model": 8},
    "2x2": {"data": 2, "model": 2},
}


@pytest.fixture(scope="module", autouse=True)
def memo_eval_shape():
    """The reference's spec builders call `jax.eval_shape` on a fresh
    lambda each time; the same code over the same closure gives the same
    shapes, so keep them for the module (its run stays well under a
    minute)."""
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


def _ref_flat(tree):
    """{path: spec as a tuple} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, spec in flat:
        keys = []
        for k in path:
            keys.append(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name",
                                                              k)))))
        out["/".join(keys)] = tuple(spec)
    return out


def _port_flat(tree, path=()):
    out = {}
    if isinstance(tree, P):
        out["/".join(path)] = tuple(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_flat(v, path + (str(i),)))
    else:                                   # a cache record
        for f in ("k", "v", "index", "conv", "ssm"):
            if hasattr(tree, f):
                out.update(_port_flat(getattr(tree, f), path + (f,)))
    return out


def test_archs_match():
    assert ARCHS == RARCHS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    for fsdp in (True, False):
        want = _ref_flat(RS.param_specs(rget_config(arch), m, fsdp=fsdp))
        got = _port_flat(S.param_specs(get_config(arch), m, fsdp=fsdp))
        assert got == want, (arch, mesh, fsdp)
        assert any(v != (None,) * len(v) for v in got.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equal_reference(arch, mesh):
    """A batch the data axes divide, and batch 1 with the KV length
    sharded over data and without."""
    m = FakeMesh(MESHES[mesh])
    dp = MESHES[mesh].get("pod", 1) * MESHES[mesh]["data"]
    for batch, seq in ((2 * dp, True), (1, True), (1, False)):
        want = _ref_flat(RS.cache_spec(rget_config(arch), m, batch,
                                       shard_seq_when_b1=seq))
        got = _port_flat(S.cache_spec(get_config(arch), m, batch,
                                      shard_seq_when_b1=seq))
        assert got == want, (arch, mesh, batch, seq)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_and_fit_spec_equal_reference(mesh):
    m = FakeMesh(MESHES[mesh])
    assert S.batch_axes(m) == RS.batch_axes(m)
    for batch in (1, 2, 4, 32, 64, 96, 256):
        for extra in (0, 1, 2):
            assert tuple(S.batch_spec(m, batch, extra)) == tuple(
                RS.batch_spec(m, batch, extra)), (batch, extra)
    specs = [(), ("data",), ("model", None), (None, "model"),
             (("pod", "data"), "model"), ("data", "model", None),
             (("data", "model"),)]
    shapes = [(64,), (48, 16), (51865, 512), (2, 3), (512, 8, 24),
              (1, 1, 1)]
    for sp in specs:
        for sh in shapes:
            assert tuple(S.fit_spec(P(*sp), sh, m)) == tuple(
                RS.fit_spec(PartitionSpec(*sp), sh, m)), (sp, sh)


def test_partition_spec_normalises_one_tuples():
    assert P(("data",), None) == P("data", None) == ("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)
    assert P() != P(None)
    assert tuple(PartitionSpec(("data",), None)) == P(("data",), None)


def test_param_shardings_wrap_specs():
    m = FakeMesh(MESHES["32x8"])
    sh = S.param_shardings(get_config("qwen1.5-4b"), m, fsdp=False)
    assert sh["embed"].mesh is m
    assert sh["embed"].spec == S.param_specs(get_config("qwen1.5-4b"), m,
                                             fsdp=False)["embed"]


@pytest.mark.parametrize("mesh", [None, *MESHES])
def test_hints_read_the_mesh_as_the_reference(mesh, monkeypatch):
    """Under the same mesh (the reference's `get_abstract_mesh` patched
    to return it; the port's made ambient by `set_mesh`), `tp_size`,
    `dp_size` and `attn_layout` answer as the reference's."""
    m = None if mesh is None else FakeMesh(MESHES[mesh])
    monkeypatch.setattr(RHT, "get_abstract_mesh", lambda: m)
    with set_mesh(m):
        assert HT.tp_size() == RHT.tp_size()
        assert HT.dp_size() == RHT.dp_size()
        for heads in (8, 16, 20, 32, 40, 64):
            for seq in (1, 2, 24, 2048):
                assert HT.attn_layout(heads, seq) == RHT.attn_layout(
                    heads, seq)
    assert HT.dp_size() == 1 and HT.tp_size() == 1


def test_hint_returns_its_tensor_and_mesh_is_per_thread():
    import threading
    x = torch.ones(4, 2)
    seen = []
    with set_mesh(make_production_mesh(multi_pod=True)):
        assert HT.hint(x, "batch", "model") is x
        assert HT.dp_size() == 64 and HT.tp_size() == 8
        t = threading.Thread(target=lambda: seen.append(HT.dp_size()))
        t.start()
        t.join()
        q, k, v = HT.hint_qkv(x, x, x, "heads")
        assert q is x and HT.hint_attn_out(x, "seq") is x
    assert seen == [1] and L.HT is HT
