"""The port's training path against the reference's on the CPU, in f32
smoke configs (bf16 rounds at other places in the two frameworks, so the
algorithm is compared in f32, as tests/test_torch_models.py does):

* `Model.loss` and its gradient for every parameter against
  `jax.value_and_grad` of the reference's `Model.loss`, for qwen1.5-4b,
  deepseek-v2-lite-16b (MLA, the routed MoE and its auxiliary loss, a
  leading dense layer), mixtral-8x7b (sliding-window attention, the
  MoE), mamba2-370m (Mamba-2's chunked SSD, tied embeddings),
  jamba-1.5-large-398b (attention and Mamba in one stack), whisper-base
  (the encoder over the batch's frame embeddings, cross-attention; each
  cross layer's unread `ln` gets a zero gradient in both) and
  llava-next-mistral-7b (the batch's patch embeddings prepended, their
  targets -1): loss within rel 1e-5, each gradient within 1e-4 of its
  largest entry;
* three steps of `build_train_step` (2 microbatches, remat) with AdamW
  and with Adafactor against the reference's jit'd step: losses within
  rel 1e-5; parameters within 1e-5 (the learning rate is 1e-3, so that
  is 1% of a step) but for under 0.1% of the entries, and every entry
  within 3e-4 (AdamW's update is ~lr * sign(g): an entry whose gradient
  is at f32 noise may step otherwise); optimizer moments within rel
  1e-4.

The weights are the reference's init carried across with
`interop.params_from_arrays`; the tokens come from numpy, seeded."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import Batch as RBatch
from repro.models.model import Model as RModel
from repro.train import optim as RO
from repro.train.step import TrainConfig as RTrainConfig
from repro.train.step import build_train_step as rbuild_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_arrays
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves, unflatten

ARCHS = ["qwen1.5-4b", "deepseek-v2-lite-16b", "mixtral-8x7b", "mamba2-370m",
         "jamba-1.5-large-398b", "whisper-base", "llava-next-mistral-7b"]


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


def _pair(arch, seed=1):
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    rm = RModel(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed)))
    return (rm, jax.tree.map(jnp.asarray, tree), Model(tcfg),
            params_from_arrays(tree, tcfg, "cpu"))


def _tokens(vocab, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tgt = np.roll(toks, -1, 1)
    tgt[:, -1] = -1
    return toks, tgt


def _extra(cfg, B=4, seed=0):
    """The stub frontend's f32 embeddings (None without one)."""
    n = {"vision_stub": cfg.num_patches,
         "audio_stub": cfg.enc_seq_len}.get(cfg.frontend)
    if n is None:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rm, rparams, tm, tparams = _pair(arch)
    toks, tgt = _tokens(rm.cfg.vocab_size)
    extra = _extra(rm.cfg)
    rloss, rgrads = jax.value_and_grad(lambda p: rm.loss(
        p, RBatch(jnp.asarray(toks), jnp.asarray(tgt),
                  None if extra is None else jnp.asarray(extra)),
        loss_chunk=32))(rparams)
    ps = [p.requires_grad_(True) for p in leaves(tparams)]
    with L.attention_backend("auto"):
        loss = tm.loss(unflatten(tparams, ps),
                       Batch(torch.from_numpy(toks), torch.from_numpy(tgt),
                             None if extra is None
                             else torch.from_numpy(extra)),
                       loss_chunk=32)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        ps, torch.autograd.grad(loss, ps, allow_unused=True))]
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    want = jax.tree.leaves(rgrads)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_three_train_steps_match_reference(name):
    rm, rparams, tm, tparams = _pair("qwen1.5-4b")
    ropt = RO.make_optimizer(name, RO.cosine_schedule(1e-3, 2, 10))
    opt = O.make_optimizer(name, O.cosine_schedule(1e-3, 2, 10))
    rstep = jax.jit(rbuild_train_step(
        rm, ropt, RTrainConfig(microbatches=2, remat=True, loss_chunk=64)))
    step = build_train_step(tm, opt, TrainConfig(microbatches=2, remat=True,
                                                 loss_chunk=64))
    rstate, state = ropt.init(rparams), opt.init(tparams)
    for i in range(3):
        toks, tgt = _tokens(rm.cfg.vocab_size, seed=i)
        rparams, rstate, rm_ = rstep(rparams, rstate, RBatch(
            jnp.asarray(toks), jnp.asarray(tgt)))
        tparams, state, m = step(tparams, state, Batch(
            torch.from_numpy(toks), torch.from_numpy(tgt)))
        assert float(m["loss"]) == pytest.approx(float(rm_["loss"]),
                                                 rel=1e-5), i
    for w, g in zip(jax.tree.leaves(rparams), leaves(tparams)):
        d = np.abs(g.numpy() - np.asarray(w))
        # AdamW's step is ~lr * sign(g) where |g| is tiny, so an entry
        # whose gradient is at the f32 noise floor may step otherwise
        assert d.max() <= 3e-4 and (d > 1e-5).mean() < 1e-3, d.max()
    for w, g in zip(jax.tree.leaves(rstate), leaves(state)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-7)
