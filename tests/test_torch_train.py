"""The port's training substrate (`repro_torch.train`, `parallel.
compress`) on the CPU: the properties `tests/test_train.py` holds the
reference to — the loss falls, microbatch invariance, remat equals no
remat, Adafactor trains with a small state, compressed gradients train,
bf16 accumulation is close to f32 (and the default f32 buffer holds an
f32 sum over 16 microbatches, which a bf16 one does not), clipping and
the schedule — and the
int8 compression against the reference's: `fake_quant_int8` bit for bit,
`compressed_psum_int8` over an 8-shard CPU `DataMesh` against the
reference's `shard_map` version on 8 forced host devices (a subprocess,
as `tests/test_distributed.py` runs it)."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models.model import Batch, Model
from repro_torch.parallel.compress import (compressed_psum_int8,
                                           fake_quant_int8)
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves

_ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once, and a torch thread pool in each
    oversubscribes the cores (the training files took 25x their
    single-process time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch="qwen1.5-4b", opt=None, **tc_kw):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = opt or O.AdamW(lr=O.cosine_schedule(1e-3, 10, 200))
    step = build_train_step(model, opt, TrainConfig(**tc_kw))
    return cfg, model, params, opt, opt.init(params), step


def _batches(n, B=8, S=32, seed=0):
    rng = np.random.default_rng(seed)
    # learnable structure: next token = (token + 1) % 17
    for _ in range(n):
        t0 = rng.integers(0, 17, (B, 1))
        tokens = torch.from_numpy((t0 + np.arange(S)[None, :]) % 17)
        targets = torch.roll(tokens, -1, dims=1)
        targets[:, -1] = -1
        yield Batch(tokens, targets)


def _train(step, params, state, n):
    losses = []
    for batch in _batches(n):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return params, state, losses


def test_loss_decreases():
    _, _, params, _, state, step = _setup(microbatches=2, remat=True)
    _, _, losses = _train(step, params, state, 30)
    assert losses[-1] < 0.5 * losses[0], losses[::10]


def test_microbatch_invariance():
    """Same data, different accumulation granularity => same update
    (bf16 parameters: 2e-2, the reference test's tolerance)."""
    outs = {}
    for m in (1, 4):
        _, _, params, _, state, step = _setup(microbatches=m)
        outs[m], _, _ = step(params, state, next(_batches(1)))
    for a, b in zip(leaves(outs[1]), leaves(outs[4])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_remat_matches_no_remat():
    """Remat recomputes the same forward: the same loss (rel 1e-5) and
    the same parameters after the step."""
    g = {}
    for remat in (False, True):
        _, _, params, _, state, step = _setup(remat=remat)
        p2, _, metrics = step(params, state, next(_batches(1)))
        g[remat] = (float(metrics["loss"]), p2)
    assert g[False][0] == pytest.approx(g[True][0], rel=1e-5)
    for a, b in zip(leaves(g[False][1]), leaves(g[True][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adafactor_trains():
    opt = O.Adafactor(lr=O.cosine_schedule(1e-2, 10, 200))
    _, _, params, _, state, step = _setup(opt=opt)
    params, state, losses = _train(step, params, state, 25)
    assert losses[-1] < 0.7 * losses[0], losses[::8]
    # factored state is small: vr+vc leaves much smaller than params
    n_par = sum(x.numel() for x in leaves(params))
    n_opt = sum(x.numel() for x in leaves(state.vr) + leaves(state.vc))
    assert n_opt < 0.2 * n_par


def test_compressed_grads_still_trains():
    _, _, params, _, state, step = _setup(compress_grads=True)
    _, _, losses = _train(step, params, state, 30)
    assert losses[-1] < 0.6 * losses[0], losses[::10]


def test_bf16_accum_close_to_fp32():
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        _, _, params, _, state, step = _setup(microbatches=2,
                                              accum_dtype=dt)
        _, _, metrics = step(params, state, next(_batches(1)))
        res[dt] = float(metrics["loss"])
    assert res[torch.bfloat16] == pytest.approx(res[torch.float32],
                                                rel=1e-2)


class _Recorder:
    """An optimizer that keeps the gradient the step hands it and leaves
    the parameters as they are."""

    def __init__(self):
        self.grads = None

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in leaves(grads)]
        return params, state, {}


def test_accumulation_buffer_holds_an_f32_sum():
    """At 16 microbatches of qwen's smoke config (bf16 parameters and
    gradients), the default buffer is f32 and the accumulated gradient
    lies within 1e-6 (relative L2) of the f32-exact sum of the 16
    microbatch gradients (each taken alone, summed in f64); a bf16
    buffer falls outside that bound."""
    assert TrainConfig().accum_dtype == torch.float32
    cfg = get_smoke_config("qwen1.5-4b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = next(_batches(1, B=16, S=16, seed=3))
    rec = _Recorder()
    alone = None
    for i in range(16):
        build_train_step(model, rec, TrainConfig(microbatches=1))(
            params, (), Batch(batch.tokens[i:i + 1],
                              batch.targets[i:i + 1]))
        g64 = [g.double() for g in rec.grads]
        alone = g64 if alone is None else [a + g for a, g in zip(alone,
                                                                 g64)]
    want = torch.cat([a.flatten() / 16 for a in alone])
    err = {}
    for dt in (None, torch.bfloat16):
        kw = {} if dt is None else {"accum_dtype": dt}
        build_train_step(model, rec, TrainConfig(microbatches=16, **kw))(
            params, (), batch)
        assert all(g.dtype == (dt or torch.float32) for g in rec.grads)
        got = torch.cat([g.double().flatten() for g in rec.grads])
        err[dt] = float((got - want).norm() / want.norm())
    assert err[None] <= 1e-6, err
    assert err[torch.bfloat16] > 1e-6, err


def test_grad_clip_and_schedule():
    sched = O.cosine_schedule(1.0, 10, 110, floor=0.1)
    assert float(sched(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(sched(10)) == pytest.approx(1.0)
    assert float(sched(110)) == pytest.approx(0.1)
    tree = {"a": torch.ones(100) * 10.0}
    clipped, norm = O.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(100.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_int8_bit_equal_reference(dtype):
    import jax.numpy as jnp
    from repro.parallel.compress import fake_quant_int8 as rfake
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    g[0, 0] = 0.0
    want = np.asarray(rfake(jnp.asarray(g, getattr(jnp, dtype))),
                      np.float32)
    got = fake_quant_int8(torch.from_numpy(g).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_compressed_psum_int8_matches_reference(tmp_path):
    """The mean on 8 CPU shards == the reference's on 8 forced host
    devices bit for bit, the error residuals within an ulp; the mean
    within 0.05 of the exact mean (the reference test's bound)."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(8, 256)).astype(np.float32)
    err = (rng.normal(size=(8, 256)) * 1e-3).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    np.save(tmp_path / "err.npy", err)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.parallel.compress import compressed_psum_int8
        from repro.launch.mesh import make_test_mesh
        mesh = make_test_mesh((8,), ("data",))
        g = np.load(r"{tmp_path}/g.npy"); err = np.load(r"{tmp_path}/err.npy")
        sh = NamedSharding(mesh, P("data"))
        fn = jax.jit(jax.shard_map(
            lambda a, e: compressed_psum_int8(a, "data", e), mesh=mesh,
            in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data"))))
        mean, new_err = fn(jax.device_put(jnp.asarray(g), sh),
                           jax.device_put(jnp.asarray(err), sh))
        np.save(r"{tmp_path}/mean.npy", np.asarray(mean))
        np.save(r"{tmp_path}/new_err.npy", np.asarray(new_err))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mesh = make_data_mesh(8, devices=["cpu"] * 8)
    mean, new_err = compressed_psum_int8(
        [torch.from_numpy(g[s:s + 1]) for s in range(8)], mesh,
        [torch.from_numpy(err[s:s + 1]) for s in range(8)])
    np.testing.assert_array_equal(torch.cat(mean).numpy(),
                                  np.load(tmp_path / "mean.npy"))
    # XLA fuses the residual's gf - q * s into one FMA, rounded once: the
    # residuals agree within an f32 ulp at the gradient's scale (|g| < 4)
    np.testing.assert_allclose(torch.cat(new_err).numpy(),
                               np.load(tmp_path / "new_err.npy"), rtol=0,
                               atol=2.5e-7)
    assert np.abs(mean[0].numpy()[0] - (g + err).mean(axis=0)).max() < 0.05


def test_flash_attention_raises_under_grad():
    """K8 has no backward: with an input that requires grad its wrapper
    raises (on the CPU too, where it runs the plain version), so a loss
    on the "flash" backend cannot silently lose attention's gradient;
    under no_grad it runs."""
    from repro_torch.kernels.flashattn import flash_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16, generator=g), torch.randn(
        1, 8, 2, 16, generator=g)
    pos = torch.arange(8, dtype=torch.int32)[None]
    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, pos, pos, valid)
    with torch.no_grad():
        assert flash_attention(q, k, v, pos, pos, valid).shape == q.shape


def test_attention_backend_override_is_per_thread():
    """The train step's "auto" override holds in its own thread only: a
    thread that runs meanwhile (a server's worker) sees the process-wide
    "flash"."""
    import threading
    from repro_torch.models import layers as L
    seen = []
    with L.attention_backend("auto"):
        t = threading.Thread(
            target=lambda: seen.append(L.current_attention_backend()))
        t.start()
        t.join(timeout=30)
        assert L.current_attention_backend() == "auto"
    assert not t.is_alive() and seen == ["flash"]
    assert L.current_attention_backend() == "flash"


def test_eval_loss_equals_the_train_steps_loss():
    """`build_eval_loss` (no grad) gives the loss the train step reports
    for the same parameters and batch, in f32."""
    import dataclasses
    from repro_torch.train.step import build_eval_loss
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"),
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = next(_batches(1))
    tc = TrainConfig()
    want = float(build_eval_loss(model, tc)(params, batch))
    opt = O.AdamW(lr=O.cosine_schedule(1e-3, 10, 200))
    _, _, m = build_train_step(model, opt, tc)(params, opt.init(params),
                                               batch)
    assert float(m["loss"]) == pytest.approx(want, rel=1e-5)
