"""The port's checkpointing (`repro_torch.checkpoint`) and fault-tolerant
trainer (`repro_torch.ft`) on the CPU: the reference's six tests of
`tests/test_checkpoint_ft.py` in torch, checkpoints crossing between the
two packages bit for bit (bf16 leaves and optimizer NamedTuples
included), and a preempted run that, resumed, gives the uninterrupted
run's losses and parameters exactly."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import restore_tree as rrestore_tree
from repro.checkpoint import save_tree as rsave_tree
from repro.train import optim as RO
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.configs import get_smoke_config
from repro_torch.ft import FaultTolerantTrainer, Preempted, StragglerMonitor
from repro_torch.models.model import Batch, Model
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves, tree_map


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


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(
                np.float32)),
            "b": {"x": torch.from_numpy(rng.normal(size=(8,)).astype(
                      np.float32)).to(torch.bfloat16),
                  "step": torch.zeros((), dtype=torch.int32)}}


def _bits(t):
    """A tensor's bytes (bf16 as its int16 pattern), for exact equality."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_tree(t, str(tmp_path / "ck"))
    out = restore_tree(str(tmp_path / "ck"), tree_map(torch.zeros_like, t))
    _assert_trees_equal(out, t)


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [20, 30]
    step, out = mgr.restore_latest(_tree(0))
    assert step == 30
    np.testing.assert_array_equal(out["w"].numpy(), _tree(30)["w"].numpy())


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = _tree(1)
    mgr.save(1, t)
    t["w"].add_(1.0)         # an in-place update after save() returns
    mgr.wait()
    assert mgr.latest_step() == 1
    np.testing.assert_array_equal(mgr.restore(1, t)["w"].numpy(),
                                  _tree(1)["w"].numpy())


def test_shape_mismatch_rejected(tmp_path):
    save_tree(_tree(), str(tmp_path / "ck"))
    bad = {"w": torch.zeros((4, 4)), "b": {"x": torch.zeros((8,)),
                                           "step": torch.zeros(())}}
    with pytest.raises(AssertionError):
        restore_tree(str(tmp_path / "ck"), bad)


def _qwen_smoke_state():
    cfg = get_smoke_config("qwen1.5-4b")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    opt = O.AdamW(lr=lambda s: torch.tensor(1e-3))
    return cfg, params, opt


def test_reference_checkpoint_restores_in_port_and_back(tmp_path):
    """A tree of bf16 parameters and an AdamW state (a NamedTuple with a
    0-d int32 step) written by the reference restores in the port bit for
    bit, and the port's save of it restores in the reference bit for
    bit."""
    cfg, params, opt = _qwen_smoke_state()
    tree = {"params": params, "opt": opt.init(params)}
    rng = np.random.default_rng(3)
    tree = tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        t.shape).astype(np.float32)).to(t.dtype), tree)
    ref_tree = jax.tree.map(
        lambda t: jnp.asarray(_bits(t)).view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()),
        {"params": tree["params"],
         "opt": RO.AdamWState(*tree["opt"])})
    rsave_tree(ref_tree, str(tmp_path / "ref"))
    target = tree_map(torch.zeros_like, tree)
    got = restore_tree(str(tmp_path / "ref"), target)
    assert isinstance(got["opt"], O.AdamWState)
    _assert_trees_equal(got, tree)
    save_tree(got, str(tmp_path / "port"))
    back = rrestore_tree(str(tmp_path / "port"),
                         jax.tree.map(jnp.zeros_like, ref_tree))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree)):
        assert x.dtype == y.dtype
        assert x.shape == y.shape
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def _training(tmp_path, save_every=5):
    cfg, params, opt = _qwen_smoke_state()
    step = build_train_step(Model(cfg), opt, TrainConfig())
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    trainer = FaultTolerantTrainer(step, mgr, save_every=save_every)
    state = {"params": params, "opt": opt.init(params), "step": 0}

    def batches():
        rng = np.random.default_rng(0)
        while True:
            t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
            yield Batch(t, torch.roll(t, -1, 1))

    return trainer, state, batches


def test_preempt_checkpoint_resume(tmp_path):
    trainer, state, batches = _training(tmp_path)
    gen = batches()

    def interrupting():
        for i, b in enumerate(gen):
            if i == 7:
                trainer.preempt()
            yield b

    with pytest.raises(Preempted):
        trainer.run(state, interrupting(), max_steps=100)
    assert trainer.ckpt.latest_step() == 7

    # "restart": a fresh trainer resumes from the checkpoint
    trainer2, state2, batches2 = _training(tmp_path)
    resumed = trainer2.resume_or_init(state2["params"], state2["opt"])
    assert resumed["step"] == 7
    out = trainer2.run(resumed, batches2(), max_steps=12)
    assert out["step"] == 12


def test_resumed_run_equals_uninterrupted(tmp_path):
    """4 steps straight against 4 steps preempted at step 2 and resumed
    by a fresh trainer: the same per-step losses and the same final
    parameters and optimizer state, exactly."""
    def losses_of(trainer, state, gen, max_steps, out):
        return trainer.run(state, gen, max_steps=max_steps,
                           on_metrics=lambda i, m: out.append(m["loss"]))

    trainer, state, batches = _training(tmp_path / "a", save_every=100)
    want_losses = []
    want = losses_of(trainer, state, batches(), 4, want_losses)

    trainer, state, batches = _training(tmp_path / "b", save_every=100)
    gen = batches()
    got_losses = []

    def interrupting():
        for i, b in enumerate(gen):
            if i == 2:
                trainer.preempt()
            yield b

    with pytest.raises(Preempted):
        losses_of(trainer, state, interrupting(), 4, got_losses)
    trainer2, state2, _ = _training(tmp_path / "b", save_every=100)
    resumed = trainer2.resume_or_init(state2["params"], state2["opt"])
    assert resumed["step"] == 2
    # the data resumes at the checkpoint's step, as a loader would
    got = losses_of(trainer2, resumed,
                    itertools.islice(batches(), 2, None), 4, got_losses)
    assert got_losses == want_losses
    _assert_trees_equal({"p": got["params"], "o": got["opt"]},
                        {"p": want["params"], "o": want["opt"]})


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=16, threshold=2.0)
    for _ in range(10):
        assert not mon.record(0.1)
    assert mon.record(0.5)       # 5x median
    assert mon.flagged == 1
    assert not mon.record(0.11)
