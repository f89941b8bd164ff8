"""Sharded training against the reference's sharded step, on the CPU.

The reference trains sharded through GSPMD (`repro/train/step.py`: its
`build_train_step` ignores the mesh; the parameters and AdamW state are
placed with `param_shardings`, the batch with `batch_spec`, under
`jax.set_mesh`), as its `test_sharded_train_step_runs_and_matches_single_
device` does, in a subprocess under 8 forced XLA host devices (as
tests/test_distributed.py runs its meshes). The port runs
`build_train_step(..., mesh=)` on a mesh of `["cpu"] * n`, from the
reference's init (carried with `interop.params_from_arrays`, then
sharded under the port's `param_specs` and `opt_shardings`) and the same
tokens. One step: 2 microbatches, remat, AdamW at lr 1e-3 with its
clipping at norm 1 (the gradient norm is about 2). Compared in f32, at
the model tests' bounds (the reference's own test allows 3e-2): the
loss and the gradient norm within 2e-4; the gradient the step hands
the optimizer (the reference's read through an optimizer that returns
it, the port's gathered from its points) every leaf within 1e-4 of its
largest entry, as tests/test_torch_train_ref.py holds it; every
parameter after the step within 3e-4 but for under 0.01% of the
entries, each of those within 2 lr (AdamW's first step is about lr *
sign(g): an entry whose gradient is at f32 noise may step otherwise;
in qwen's (4, 2) case one embedding entry of 65,536 steps 3.3e-4
otherwise). A case may ask for two steps on the same batch
(`check_step(..., steps=2)`): then the second step's loss and gradient
norm are held too, AdamW's moments after it within 1e-4 (m) and 2e-4
(v) of their leaf's largest entry, and every parameter within 3e-4,
with no entry left out. Cases: qwen1.5-4b's smoke config on the
reference test's (4, 2) mesh; mixtral-8x7b's on (2, 2) (the MoE's
auxiliary loss over the global batch, the experts' backward split two a
point)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import Model as RModel
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_arrays
from repro_torch.launch.dryrun import opt_shardings
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves

from test_torch_spmd_train import Recording

_ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S_LEN, SEED, LR = 8, 32, 3, 1e-3
#: tag -> (arch, mesh shape, fsdp)
CASES = {"qwen1.5-4b@4x2": ("qwen1.5-4b", (4, 2), True),
         "mixtral-8x7b@2x2": ("mixtral-8x7b", (2, 2), True)}

#: argv[1] a JSON list of [tag, arch, mesh shape, fsdp] (and, optionally,
#: a fifth entry {"steps": 2}), argv[2] the .npz, then B, S_LEN, SEED,
#: LR: per case the loss, the gradient norm and the parameters' leaves
#: after one step (or two: then the second's loss and gradient norm and
#: AdamW's moments' leaves too), and the first step's gradient's leaves
#: (`Keep`).
#: Under a stub frontend the batch carries its embeddings drawn from
#: SEED + 1 (`patches`: llava's patches, whisper's frames)
REF = """
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
assert jax.device_count() == 8
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_test_mesh
from repro.models.model import Batch, Model
from repro.parallel import sharding as S
from repro.train import optim as O
from repro.train.step import TrainConfig, build_train_step
cases, out = json.loads(sys.argv[1]), sys.argv[2]
B, S_LEN, SEED = (int(x) for x in sys.argv[3:6])
LR = float(sys.argv[6])
class Keep:    # hands the step's gradient back as a metric
    def init(self, params):
        return ()
    def update(self, grads, state, params):
        return params, state, {"grads": grads}
res = {}
for case in cases:
    tag, arch, shape, fsdp = case[:4]
    steps = case[4].get("steps", 1) if len(case) > 4 else 1
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(SEED))
    opt = O.AdamW(lr=lambda s: jnp.float32(LR))
    state = opt.init(params)
    tok = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S_LEN)).astype(np.int32)
    extra = None
    n = {"vision_stub": cfg.num_patches,
         "audio_stub": cfg.enc_seq_len}.get(cfg.frontend)
    if n is not None:
        extra = jnp.asarray(np.random.default_rng(SEED + 1).standard_normal(
            (B, n, cfg.d_model)).astype(np.float32))
    batch = Batch(jnp.asarray(tok), jnp.roll(jnp.asarray(tok), -1, 1),
                  extra)
    step = build_train_step(model, opt, TrainConfig(microbatches=2))
    mesh = make_test_mesh(tuple(shape), ("data", "model"))
    with jax.set_mesh(mesh):
        psh = S.param_shardings(cfg, mesh, fsdp=fsdp)
        p = jax.device_put(params, psh)
        s = jax.device_put(state, O.AdamWState(NamedSharding(mesh, P()),
                                               psh, psh))
        bsh = NamedSharding(mesh, S.batch_spec(mesh, B))
        b = Batch(jax.device_put(batch.tokens, bsh),
                  jax.device_put(batch.targets, bsh),
                  None if extra is None else jax.device_put(
                      extra, NamedSharding(mesh, S.batch_spec(mesh, B, 2))))
        _, _, g = jax.jit(build_train_step(
            model, Keep(), TrainConfig(microbatches=2)))(p, (), b)
        p, s, m = jax.jit(step)(p, s, b)
    for i, leaf in enumerate(jax.tree.leaves(g["grads"])):
        res[f"{tag}/g{i}"] = np.asarray(leaf)
    res[tag + "/loss"] = np.asarray(m["loss"])
    res[tag + "/grad_norm"] = np.asarray(m["grad_norm"])
    if steps == 2:
        with jax.set_mesh(mesh):
            p, s, m = jax.jit(step)(p, s, b)
        res[tag + "/loss2"] = np.asarray(m["loss"])
        res[tag + "/grad_norm2"] = np.asarray(m["grad_norm"])
        for i, (mu, nu) in enumerate(zip(jax.tree.leaves(s.m),
                                         jax.tree.leaves(s.v))):
            res[f"{tag}/m{i}"] = np.asarray(mu)
            res[f"{tag}/v{i}"] = np.asarray(nu)
    for i, leaf in enumerate(jax.tree.leaves(p)):
        res[f"{tag}/p{i}"] = np.asarray(leaf)
np.savez(out, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_steps(tmp_path_factory, cases: dict) -> dict:
    """REF's readings of `cases` (tag -> (arch, mesh shape, fsdp) or
    (arch, mesh shape, fsdp, steps)), from one subprocess."""
    path = tmp_path_factory.mktemp("spmd_train") / "ref.npz"
    cases = [[tag, c[0], list(c[1]), c[2]] + ([{"steps": c[3]}]
                                                if len(c) > 3 else [])
             for tag, c in cases.items()]
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-c", REF, json.dumps(cases), str(path), str(B),
         str(S_LEN), str(SEED), str(LR)],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_steps(tmp_path_factory, CASES)


def patches(cfg):
    """REF's stub embeddings: the patches under the vision stub, the
    frames under the audio stub, else None."""
    n = {"vision_stub": cfg.num_patches,
         "audio_stub": cfg.enc_seq_len}.get(cfg.frontend)
    if n is None:
        return None
    return torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_step_matches_reference_sharded_step(tag, reference):
    check_step(tag, *CASES[tag], reference)


def check_step(tag, arch, shape, fsdp, reference, steps=1):
    """The port's sharded step (or `steps` 2 steps) of case `tag`
    against REF's, as the module's note says."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jax.numpy.float32)
    tree = jax.tree.map(np.asarray, RModel(rcfg).init(
        jax.random.PRNGKey(SEED)))
    params = params_from_arrays(tree, cfg, "cpu")
    mesh = make_test_mesh(shape, ("data", "model"),
                          devices=["cpu"] * int(np.prod(shape)))
    opt = Recording(O.AdamW(
        lr=lambda s: torch.tensor(LR, dtype=torch.float32)))
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)
    state = opt.init(params)
    p = SP.shard_tree(params, specs, mesh)
    s = SP.shard_tree(state, opt_shardings(state, specs, mesh), mesh)
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S_LEN)).astype(np.int32)).long()
    step = build_train_step(Model(cfg), opt, TrainConfig(microbatches=2),
                            mesh=mesh)
    batch = Batch(tok, torch.roll(tok, -1, 1), patches(cfg))
    p, s, m = step(p, s, batch)
    assert float(m["loss"]) == pytest.approx(
        float(reference[f"{tag}/loss"]), abs=2e-4)
    assert float(m["grad_norm"]) == pytest.approx(
        float(reference[f"{tag}/grad_norm"]), abs=2e-4)
    shapes = [tuple(x.shape) for x in leaves(params)]
    for i, spec in enumerate(S.spec_leaves(specs)):
        g = SP.gather_leaf(SP.Sharded(spec, mesh, tuple(
            opt.grads[pt][i] for pt in range(mesh.size)), shapes[i]))
        want = reference[f"{tag}/g{i}"]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"{tag} gradient leaf {i}")
    if steps == 2:
        check_second_step(tag, step, p, s, batch, reference)
        return
    got = leaves(SP.gather_tree(p))
    assert len(got) == sum(k.startswith(f"{tag}/p") for k in reference)
    for i, leaf in enumerate(got):
        want = reference[f"{tag}/p{i}"]
        d = np.abs(leaf.numpy() - want)
        off = d > 3e-4 + 3e-4 * np.abs(want)
        assert off.mean() < 1e-4 and d.max() <= 2 * LR, (tag, i, d.max())


def check_second_step(tag, step, p, s, batch, reference):
    """A second step on `batch` against REF's: its loss and gradient
    norm, AdamW's moments after it and every parameter entry (the
    module's note)."""
    p, s, m = step(p, s, batch)
    assert float(m["loss"]) == pytest.approx(
        float(reference[f"{tag}/loss2"]), abs=2e-4)
    assert float(m["grad_norm"]) == pytest.approx(
        float(reference[f"{tag}/grad_norm2"]), abs=2e-4)
    state = SP.gather_tree(s)
    for name, tol in (("m", 1e-4), ("v", 2e-4)):
        got = leaves(getattr(state, name))
        assert len(got) == sum(k.startswith(f"{tag}/{name}")
                               for k in reference)
        for i, leaf in enumerate(got):
            want = reference[f"{tag}/{name}{i}"]
            np.testing.assert_allclose(
                leaf.numpy(), want, rtol=0,
                atol=tol * float(np.abs(want).max()),
                err_msg=f"{tag} AdamW {name} leaf {i}")
    got = leaves(SP.gather_tree(p))
    assert len(got) == sum(k.startswith(f"{tag}/p") for k in reference)
    for i, leaf in enumerate(got):
        np.testing.assert_allclose(leaf.numpy(), reference[f"{tag}/p{i}"],
                                   rtol=3e-4, atol=3e-4,
                                   err_msg=f"{tag} parameter leaf {i}")
