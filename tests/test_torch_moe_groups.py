"""The MoE's per-shard token groups against the reference, on the CPU.

The reference's `moe` splits the T tokens into G = dp_size() groups
(the data-parallel ways of the ambient mesh), each with its own
capacity int(cf * Tg * k / E) and its own queue positions
(`repro/models/layers.py::moe`). So under a data-parallel mesh the
numbers change whenever capacity binds. The port groups as the
reference does (`repro_torch.models.layers.moe_route`), reading the mesh
that `repro_torch.launch.mesh.set_mesh` makes ambient.

The reference runs in a subprocess under 4 forced XLA host devices and
`jax.set_mesh(make_test_mesh((2, 2)))` (data 2, model 2), as
tests/test_distributed.py runs its meshes; the port runs here under
`set_mesh(make_test_mesh((2, 2)))`, on the same weights (the reference's
init, carried across with `params_from_arrays`) and tokens. The smoke
configs' own capacity factor (4.0) never binds, so the tests lower it
to 0.5, where it does: prefill and teacher-forced decode logits must
agree within the model tests' 2e-4 / 3e-4, the loss within rel 1e-5,
and each package's prefill logits under the mesh must differ from its
own without a mesh by more than 1e-2 (0.335 on the reference)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import Model as RModel
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_arrays
from repro_torch.launch.mesh import make_test_mesh, set_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model

_ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b")
CF = 0.5
B, S, T0, SEED = 4, 24, 16, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(vocab):
    rng = np.random.default_rng(SEED)
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


_REF = """
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
assert jax.device_count() == 4
from repro.configs import get_smoke_config
from repro.launch.mesh import make_test_mesh
from repro.models.model import Batch, Model
arch, cf, B, S, T0, seed, out = sys.argv[1:8]
cf, B, S, T0, seed = float(cf), int(B), int(S), int(T0), int(seed)
cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=cf))
m = Model(cfg)
params = m.init(jax.random.PRNGKey(seed))
tok = np.random.default_rng(seed).integers(
    0, cfg.vocab_size, (B, S)).astype(np.int32)
cap = S + 4
pre = jax.jit(lambda p, t: m.prefill(p, Batch(t, t), cap=cap))
dec = jax.jit(lambda p, t, c, pos: m.decode_step(p, t, c, pos))
loss = jax.jit(lambda p, t: m.loss(p, Batch(t, t)))
res = {}
def run(tag):
    lg, c = pre(params, jnp.asarray(tok[:, :T0]))
    res[tag + "_prefill"] = np.asarray(lg)
    for t in range(T0, S):
        lg, c = dec(params, jnp.asarray(tok[:, t:t + 1]), c, jnp.int32(t))
        res[f"{tag}_step{t}"] = np.asarray(lg)
    res[tag + "_loss"] = np.asarray(loss(params, jnp.asarray(tok)))
run("none")
with jax.set_mesh(make_test_mesh((2, 2))):
    run("mesh")
res["param_sum"] = np.asarray(sum(float(np.abs(np.asarray(x)).sum())
                                  for x in jax.tree.leaves(params)))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each arch's reference outputs, no mesh and under the (2, 2) mesh,
    from one subprocess an arch."""
    out = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    for arch in ARCHS:
        path = tmp_path_factory.mktemp("moe") / f"{arch}.npz"
        run = subprocess.run(
            [sys.executable, "-c", _REF, arch, str(CF), str(B), str(S),
             str(T0), str(SEED), str(path)], env=env, capture_output=True,
            text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-4000:]
        out[arch] = dict(np.load(path))
    return out


def _port(arch):
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, RModel(rcfg).init(
        jax.random.PRNGKey(SEED)))
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=CF))
    psum = sum(float(np.abs(x).sum()) for x in jax.tree.leaves(tree))
    return Model(tcfg), params_from_arrays(tree, tcfg, "cpu"), psum


def _run(tm, tp, mesh):
    tok = torch.from_numpy(_tokens(tm.cfg.vocab_size)).long()
    res = {}
    with set_mesh(mesh), L.attention_backend("auto"), torch.no_grad():
        lg, c = tm.prefill(tp, Batch(tok[:, :T0], tok[:, :T0]), cap=S + 4)
        res["prefill"] = lg.numpy()
        for t in range(T0, S):
            lg, c = tm.decode_step(tp, tok[:, t:t + 1], c, t)
            res[f"step{t}"] = lg.numpy()
        res["loss"] = tm.loss(tp, Batch(tok, tok)).numpy()
    return res


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_groups_match_reference_under_mesh(arch, reference):
    ref = reference[arch]
    tm, tp, psum = _port(arch)
    np.testing.assert_allclose(psum, ref["param_sum"], rtol=1e-12)
    runs = {}
    for tag, mesh in (("none", None), ("mesh", make_test_mesh((2, 2)))):
        got = runs[tag] = _run(tm, tp, mesh)
        np.testing.assert_allclose(got["prefill"], ref[f"{tag}_prefill"],
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"{arch} {tag} prefill")
        for t in range(T0, S):
            np.testing.assert_allclose(got[f"step{t}"], ref[f"{tag}_step{t}"],
                                       rtol=3e-4, atol=3e-4,
                                       err_msg=f"{arch} {tag} step {t}")
        np.testing.assert_allclose(got["loss"], ref[f"{tag}_loss"],
                                   rtol=1e-5, err_msg=f"{arch} {tag} loss")
    port_move = np.abs(runs["mesh"]["prefill"]
                       - runs["none"]["prefill"]).max()
    ref_move = np.abs(ref["mesh_prefill"] - ref["none_prefill"]).max()
    assert port_move > 1e-2 and ref_move > 1e-2, (port_move, ref_move)


def test_route_groups_follow_the_ambient_mesh():
    """`moe_route` splits T tokens into dp_size() groups, each with its
    own capacity and positions; one group when dp_size() does not divide
    T; at decode each group's capacity is its token count."""
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    m = dataclasses.replace(cfg.moe, capacity_factor=1.0)
    router = torch.zeros(cfg.d_model, m.num_experts)
    router[:, 0] = router[:, 1] = 1.0       # every token: experts 0 and 1
    h = torch.ones(12, cfg.d_model)
    one = L.moe_route(router, h, m, s=12)
    with set_mesh(make_test_mesh((2, 2))):
        two = L.moe_route(router, h, m, s=12)
        odd = L.moe_route(router, h[:9], m, s=9)
        dec = L.moe_route(router, h[:4], m, s=1)
    with set_mesh(make_test_mesh((2, 2, 1), ("pod", "data", "model"))):
        four = L.moe_route(router, h, m, s=12)
    k, e = m.top_k, m.num_experts
    assert (one.groups, two.groups, odd.groups, four.groups) == (1, 2, 1, 4)
    assert one.capacity == int(12 * k / e) and two.capacity == int(6 * k / e)
    assert four.capacity == max(1, int(3 * k / e))
    assert one.pos[:, 0].tolist() == list(range(12))
    assert two.pos[:, 0].tolist() == list(range(6)) * 2
    assert dec.groups == 2 and dec.capacity == 2 and bool(dec.keep.all())
    assert two.keep[:, 0].tolist() == ([True] * 3 + [False] * 3) * 2
    assert one.keep[:, 0].tolist() == [True] * 6 + [False] * 6
