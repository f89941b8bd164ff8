"""Sharded training's checkpoints, resume, compression and backward
threads, on the CPU.

* The port's counterpart of the reference's
  `test_elastic_training_resume_on_new_mesh`: qwen1.5-4b's smoke config
  (f32: bf16 rounds a sharded sum elsewhere than the whole product)
  trains 8 steps unsharded through `FaultTolerantTrainer`, checkpoints,
  and a new trainer resumes the run with `resume_or_init(shardings=)`
  onto a (4, 2) mesh of `["cpu"] * 8` (the parameters under
  `param_shardings`, the AdamW state under `opt_shardings`) and trains 8
  more sharded. Its 16 losses equal an uninterrupted unsharded run's
  within 1e-4, and the reference's own assertion holds (training went on
  from the checkpoint: the first resumed loss is under the first).
  The sharded run's last checkpoint writes the same files as an
  unsharded save of the same state, byte for byte but the manifest's
  time.
* `compressed_psum_int8(g, "data", err)` inside `spmd.run` on (8,)
  against the reference's inside `shard_map` on 8 forced XLA host
  devices (a subprocess, as tests/test_distributed.py runs it): the mean
  bit for bit, the residual within one ulp of the values quantized (XLA
  fuses its last multiply-add).
* Each collective's backward (`all_reduce`, `all_gather`, `copy`) run
  off the thread of the point whose forward recorded it raises, where
  it would otherwise run without a shard context (on CUDA autograd runs
  a backward on its own device thread unless `spmd.run` turns that
  off)."""
import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager, save_tree
from repro_torch.configs import get_smoke_config
from repro_torch.ft import FaultTolerantTrainer
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.parallel.compress import compressed_psum_int8
from repro_torch.parallel.sharding import P
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves

_ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(shape, axes):
    return make_test_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _batches():
    """The reference test's batches: next token = (token + 1) % 17."""
    rng = np.random.default_rng(0)
    while True:
        t0 = rng.integers(0, 17, (8, 1))
        t = torch.from_numpy((t0 + np.arange(32)[None, :]) % 17)
        yield Batch(t, torch.roll(t, -1, 1))


def test_elastic_training_resume_on_new_mesh(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"),
                              dtype=torch.float32)
    model = Model(cfg)
    opt = O.AdamW(lr=lambda s: torch.tensor(1e-3))
    step = build_train_step(model, opt, TrainConfig())

    def fresh():
        return model.init(torch.Generator().manual_seed(0))

    straight = []
    params = fresh()
    FaultTolerantTrainer(step, CheckpointManager(
        str(tmp_path / "straight"), keep=1, async_save=False),
        save_every=100).run(
        {"params": params, "opt": opt.init(params), "step": 0}, _batches(),
        max_steps=16, on_metrics=lambda i, m: straight.append(m["loss"]))

    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, async_save=False)
    trainer = FaultTolerantTrainer(step, mgr, save_every=100)
    params = fresh()
    losses = []
    state = trainer.resume_or_init(params, opt.init(params))
    out = trainer.run(state, _batches(), max_steps=8,
                      on_metrics=lambda i, m: losses.append(m["loss"]))
    assert out["step"] == 8

    # "the cluster grew": a new trainer resumes onto a (4, 2) mesh
    mesh = _cpu_mesh((4, 2), ("data", "model"))
    trainer2 = FaultTolerantTrainer(
        build_train_step(model, opt, TrainConfig(), mesh=mesh), mgr,
        save_every=100)
    target = fresh()
    state2 = trainer2.resume_or_init(target, opt.init(target),
                                     shardings=S.param_shardings(cfg, mesh))
    assert state2["step"] == 8
    assert all(isinstance(x, SP.Sharded)
               for x in leaves({"p": state2["params"], "o": state2["opt"]}))
    batches = _batches()
    for _ in range(8):                  # the batches the first run took
        next(batches)
    losses2 = []
    out2 = trainer2.run(state2, batches, max_steps=16,
                        on_metrics=lambda i, m: losses2.append(m["loss"]))
    assert out2["step"] == 16
    assert losses2[0] < losses[0], (losses[0], losses2[0])
    np.testing.assert_allclose(losses + losses2, straight, rtol=0, atol=1e-4)

    # the sharded state's checkpoint is the unsharded save's, file for file
    save_tree({"params": SP.gather_tree(out2["params"], "cpu"),
               "opt": SP.gather_tree(out2["opt"], "cpu")},
              str(tmp_path / "whole"))
    sharded_dir = mgr._step_dir(16)
    names = sorted(os.listdir(sharded_dir))
    assert names == sorted(os.listdir(tmp_path / "whole"))
    for name in names:
        a, b = os.path.join(sharded_dir, name), str(tmp_path / "whole" / name)
        if name == "manifest.json":
            ma, mb = (json.load(open(x)) for x in (a, b))
            ma.pop("time"), mb.pop("time")
            assert ma == mb
        else:
            assert filecmp.cmp(a, b, shallow=False), name


#: the reference's compressed all-reduce inside shard_map on (8,) over
#: "data": argv[1] the .npz with g and err, argv[2] the output .npz
REF_PSUM = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_test_mesh
from repro.parallel.compress import compressed_psum_int8
mesh = make_test_mesh((8,), ("data",))
data = np.load(sys.argv[1])
sh = NamedSharding(mesh, P("data"))
fn = jax.jit(jax.shard_map(lambda g, e: compressed_psum_int8(g, "data", e),
                           mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"))))
mean, err = fn(jax.device_put(jnp.asarray(data["g"]), sh),
               jax.device_put(jnp.asarray(data["err"]), sh))
np.savez(sys.argv[2], mean=np.asarray(mean), err=np.asarray(err))
"""


def test_compressed_psum_int8_inside_run_matches_shard_map(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.normal(size=(8, 256)).astype(np.float32)
    err = (1e-3 * rng.normal(size=(8, 256))).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, err=err)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-c", REF_PSUM, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    want = np.load(tmp_path / "out.npz")
    mesh = _cpu_mesh((8,), ("data",))
    spec = P("data", None)
    out = SP.run(mesh, lambda a, e: compressed_psum_int8(a, "data", e),
                 SP.shard_leaf(torch.from_numpy(g), spec, mesh),
                 SP.shard_leaf(torch.from_numpy(err), spec, mesh),
                 timeout=60)
    mean = SP.gather_results(mesh, spec, [m for m, _ in out]).numpy()
    new_err = SP.gather_results(mesh, spec, [e for _, e in out]).numpy()
    np.testing.assert_array_equal(mean, want["mean"])
    # XLA fuses gf - q * s into one multiply-add; torch rounds q * s
    # first: at most one ulp of the values quantized
    ulp = float(np.spacing(np.float32(np.abs(g + err).max())))
    np.testing.assert_allclose(new_err, want["err"], rtol=0, atol=ulp)
    assert np.abs(mean[0] - g.mean(axis=0)).max() < 0.05


@pytest.mark.parametrize("kind", ("all_reduce", "all_gather", "copy"))
def test_backward_off_the_points_thread_raises(kind):
    mesh = _cpu_mesh((1, 2), ("data", "model"))

    def forward(x):
        x = x.detach().requires_grad_(True)
        if kind == "all_reduce":
            return SP.all_reduce(x, "model")
        if kind == "all_gather":
            return SP.all_gather(x, "model", 0)
        return SP.copy(x, "model") * 2
    outs = SP.run(mesh, forward, SP.shard_leaf(torch.ones(4, 3),
                                               P("model"), mesh), timeout=60)
    with pytest.raises(RuntimeError, match="off point 0's thread"):
        outs[0].sum().backward()
