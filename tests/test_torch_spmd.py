"""Sharded serving against the reference's sharded run, on the CPU.

The reference runs its model sharded through GSPMD: `jax.device_put` of
`param_shardings(cfg, mesh, fsdp)` and of the tokens under `batch_spec`,
then the jitted prefill and decode steps under `jax.set_mesh(mesh)`, in a
subprocess under 8 forced XLA host devices (as tests/test_distributed.py
runs its meshes). The port runs `Model.prefill` and `Model.decode_step`
inside `parallel.spmd.run` on a mesh of `["cpu"] * n`, its parameters
the reference's init (carried with `interop.params_from_arrays`, then
`spmd.shard_tree` under the port's `param_specs`), its tokens the same.

Compared: the prefill's and every teacher-forced decode step's logits,
in f32, within the model tests' 2e-4 / 3e-4. Here qwen1.5-4b's smoke
config (biased QKV, 4/4 heads) on the meshes: (2, 2) over ("data",
"model") with `fsdp` on and off; (1, 4); and (2, 1, 2) over ("pod",
"data", "model"). The other cases run in files of their own (one
reference subprocess each, so each file stays short): mixtral-8x7b on
the same meshes (tests/test_torch_spmd_moe.py), mixtral at capacity
factor 0.5, where capacity binds (tests/test_torch_spmd_capacity.py),
and minitron-4b, starcoder2-7b and command-r-35b at (2, 2) with the
resharding restore of a checkpoint the reference wrote
(tests/test_torch_spmd_archs.py)."""
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
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP

_ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S_LEN, T0, SEED = 4, 24, 16, 3
MESHES = {"2x2": ((2, 2), ("data", "model"), True),
          "2x2-nofsdp": ((2, 2), ("data", "model"), False),
          "1x4": ((1, 4), ("data", "model"), True),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"), True)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the reference's sharded runs: argv[1] a JSON list of [tag, arch,
#: capacity factor or null, mesh shape, axes, fsdp] (and, optionally, a
#: seventh entry {"B": ..., "T0": ..., "S": ...} overriding the batch,
#: the prefill's length or the tokens' (and so the cap) for that case),
#: argv[2] the .npz,
#: then B, S_LEN, T0, SEED and, optionally, a directory where it saves
#: qwen1.5-4b's f32 smoke parameters (`save_tree`) beside their
#: unsharded prefill logits (under "ckpt/prefill"). Under the vision stub
#: the prefill takes `patches`' embeddings (split as the tokens) first,
#: and the cap and decode positions count them; under the audio stub the
#: prefill encodes `patches`' frames (split as the tokens), which are
#: encoded once more for the decode steps' `enc_out`
REF = """
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
assert jax.device_count() == 8
from jax.sharding import NamedSharding
from repro.configs import get_smoke_config
from repro.launch.mesh import make_test_mesh
from repro.models.model import Batch, Model
from repro.parallel import sharding as S
cases, out = json.loads(sys.argv[1]), sys.argv[2]
B0, S_LEN0, T00, SEED = (int(x) for x in sys.argv[3:7])
res, inits = {}, {}
for case in cases:
    tag, arch, cf, shape, axes, fsdp = case[:6]
    opts = case[6] if len(case) > 6 else {}
    B, T0 = opts.get("B", B0), opts.get("T0", T00)
    S_LEN = opts.get("S", S_LEN0)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    m = Model(cfg)
    if arch not in inits:
        inits[arch] = m.init(jax.random.PRNGKey(SEED))
    params = inits[arch]
    tok = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S_LEN)).astype(np.int32)
    extra, npre = None, 0
    if cfg.frontend == "vision_stub":
        extra = np.random.default_rng(SEED + 1).standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        npre = cfg.num_patches
    elif cfg.frontend == "audio_stub":
        extra = np.random.default_rng(SEED + 1).standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    mesh = make_test_mesh(tuple(shape), tuple(axes))
    with jax.set_mesh(mesh):
        p = jax.device_put(params, S.param_shardings(cfg, mesh, fsdp=fsdp))
        bsh = NamedSharding(mesh, S.batch_spec(mesh, B))
        if extra is not None:
            extra = jax.device_put(jnp.asarray(extra), NamedSharding(
                mesh, S.batch_spec(mesh, B, 2)))
        pre = jax.jit(lambda p, t, e: m.prefill(p, Batch(t, t, e),
                                                cap=npre + S_LEN + 4))
        dec = jax.jit(lambda p, t, c, pos, e: m.decode_step(p, t, c, pos,
                                                             e))
        lg, c = pre(p, jax.device_put(jnp.asarray(tok[:, :T0]), bsh), extra)
        res[tag + "/prefill"] = np.asarray(lg)
        enc = jax.jit(m.encode)(p, extra) if cfg.n_enc_layers else None
        for t in range(T0, S_LEN):
            lg, c = dec(p, jax.device_put(jnp.asarray(tok[:, t:t + 1]),
                                          bsh), c, jnp.int32(npre + t), enc)
            res[f"{tag}/step{t}"] = np.asarray(lg)
if len(sys.argv) > 7:
    B, T0, S_LEN = B0, T00, S_LEN0
    from repro.checkpoint import save_tree
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"),
                              dtype=jnp.float32)
    m = Model(cfg)
    params = m.init(jax.random.PRNGKey(SEED))
    save_tree(params, sys.argv[7])
    tok = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S_LEN)).astype(np.int32)
    pre = jax.jit(lambda p, t: m.prefill(p, Batch(t, t), cap=S_LEN + 4))
    res["ckpt/prefill"] = np.asarray(pre(params, jnp.asarray(tok[:, :T0]))[0])
np.savez(out, **res)
"""


def reference_runs(tmp_path_factory, cases, ckpt=None):
    """{tag/call: logits} of the reference's sharded runs of `cases`
    [(tag, arch, cf, shape, axes, fsdp)], from one subprocess (which
    also writes the checkpoint of REF's note into `ckpt`, if given)."""
    path = tmp_path_factory.mktemp("spmd") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-c", REF, json.dumps(cases), str(path),
         str(B), str(S_LEN), str(T0), str(SEED)]
        + ([str(ckpt)] if ckpt else []),
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(path))


def mesh_cases(tag, arch, cf=None):
    """REF's case rows of `arch` (at capacity factor `cf`) on MESHES."""
    return [[f"{tag}@{m}", arch, cf, *MESHES[m]] for m in MESHES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory,
                          mesh_cases("qwen1.5-4b", "qwen1.5-4b"))


def port_config(arch, cf=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def reference_params(arch, cfg):
    """The reference's init at SEED, as the port's full tensors."""
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jax.numpy.float32)
    tree = jax.tree.map(np.asarray, RModel(rcfg).init(
        jax.random.PRNGKey(SEED)))
    return params_from_arrays(tree, cfg, "cpu")


def cpu_mesh(shape, axes):
    return make_test_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def patches(cfg, batch=B):
    """REF's stub embeddings, drawn from SEED + 1: the patches [batch, P,
    d] under the vision stub, the frames [batch, Se, d] under the audio
    stub, else None."""
    n = {"vision_stub": cfg.num_patches,
         "audio_stub": cfg.enc_seq_len}.get(cfg.frontend)
    if n is None:
        return None
    return torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (batch, n, cfg.d_model)).astype(np.float32))


def port_sharded_run(cfg, params, shape, axes, fsdp, calls_to=None,
                     batch=B, t0=T0, s_len=S_LEN):
    """The port's sharded prefill of `t0` tokens (after `patches`, under
    the vision stub; encoding them, under the audio stub, whose decode
    steps take them encoded once more) and teacher-forced decode (up to
    position `calls_to`, default `s_len`) of `batch` rows of `s_len`
    tokens (cap `s_len` + 4) on `["cpu"] * n` of full `params`, or of
    already sharded ones where `fsdp` is None: {call: full logits as
    numpy}."""
    calls_to = s_len if calls_to is None else calls_to
    mesh = cpu_mesh(shape, axes)
    model = Model(cfg)
    sharded = params if fsdp is None else SP.shard_tree(
        params, S.param_specs(cfg, mesh, fsdp=fsdp), mesh)
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, s_len)).astype(np.int32)).long()
    extra = patches(cfg, batch)
    npre = 0 if cfg.frontend != "vision_stub" else extra.shape[1]
    spec = S.batch_spec(mesh, batch)
    ways = int(np.prod([mesh.shape[a] for a in S.batch_axes(mesh)])) \
        if spec[0] is not None else 1

    def calls(p, t, e):
        out = {}
        lg, c = model.prefill(p, Batch(t[:, :t0], t[:, :t0], e),
                              cap=npre + s_len + 4)
        out["prefill"] = lg
        enc = model.encode(p, e) if cfg.n_enc_layers else None
        for i in range(t0, calls_to):
            lg, c = model.decode_step(p, t[:, i:i + 1], c, npre + i, enc)
            out[f"step{i}"] = lg
        return out
    with torch.no_grad():
        per_point = SP.run(mesh, calls, sharded,
                           SP.shard_leaf(tok, spec, mesh),
                           None if extra is None else SP.shard_leaf(
                               extra, S.batch_spec(mesh, batch, 2), mesh),
                           batch_ways=ways, timeout=120)
    return {k: SP.gather_results(mesh, spec, [r[k] for r in per_point])
            .numpy() for k in per_point[0]}


def check_against(ref, tag, got, t0=T0, s_len=S_LEN):
    np.testing.assert_allclose(got["prefill"], ref[f"{tag}/prefill"],
                               rtol=2e-4, atol=2e-4,
                               err_msg=f"{tag} prefill")
    for t in range(t0, s_len):
        np.testing.assert_allclose(got[f"step{t}"], ref[f"{tag}/step{t}"],
                                   rtol=3e-4, atol=3e-4,
                                   err_msg=f"{tag} step {t}")


def check_case(ref, tag, arch, cf, mesh, batch=B, t0=T0):
    """The port's sharded run of `arch` (`batch` rows, a prefill of `t0`
    tokens) on MESHES[mesh] against REF's."""
    cfg = port_config(arch, cf)
    got = port_sharded_run(cfg, reference_params(arch, cfg), *MESHES[mesh],
                           batch=batch, t0=t0)
    check_against(ref, f"{tag}@{mesh}", got, t0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_serving_matches_reference_sharded_run(mesh, reference):
    check_case(reference, "qwen1.5-4b", "qwen1.5-4b", None, mesh)
