"""The port's training path and plain-torch query backends on an NVIDIA
GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flashattn import flash_attention
from repro_torch.models.model import Batch, Model
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def test_two_train_steps_on_cuda_match_cpu(cuda):
    """Two AdamW steps of the f32 smoke config (2 microbatches, remat):
    losses within rel 1e-5 of the same steps on the CPU (TF32 off: plain
    f32 products on both); parameters within 1e-5 but for under 0.1% of
    the entries, and all within 2e-3, the two steps' largest movement
    (AdamW steps ~lr * sign(g): an entry whose gradient is at f32 noise
    may step otherwise on the two devices)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"),
                              dtype=torch.float32)
    model = Model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda):
        # copies: the step updates its parameters in place
        params = tree_map(lambda t: t.to(dev, copy=True), cpu_params)
        opt = O.AdamW(lr=O.cosine_schedule(1e-3, 2, 10))
        step = build_train_step(model, opt, TrainConfig(microbatches=2))
        state = opt.init(params)
        rng = np.random.default_rng(0)
        losses = []
        for _ in range(2):
            t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
            t = t.to(dev)
            params, state, m = step(params, state,
                                    Batch(t, torch.roll(t, -1, 1)))
            losses.append(float(m["loss"]))
        out[str(dev)] = (losses, params)
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-5)
    for a, b in zip(leaves(pc), leaves(pg)):
        assert b.device.type == "cuda"
        d = (b.cpu() - a).abs()
        assert float(d.max()) <= 2e-3, float(d.max())
        assert float((d > 1e-5).float().mean()) < 1e-3


def test_flash_attention_raises_under_grad(cuda):
    """K8 has no backward: with an input that requires grad it raises
    instead of returning an output detached from the graph; under
    no_grad it runs."""
    b, s, h, d = 1, 64, 2, 128
    q = torch.randn(b, s, h, d, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(b, s, h, d, device=cuda, dtype=torch.bfloat16)
    v = torch.randn(b, s, h, d, device=cuda, dtype=torch.bfloat16)
    pos = torch.arange(s, device=cuda, dtype=torch.int32)[None]
    valid = torch.ones(b, s, dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, pos, pos, valid)
    with torch.no_grad():
        out = flash_attention(q, k, v, pos, pos, valid)
    assert out.shape == (b, s, h, d) and not out.requires_grad


@pytest.mark.parametrize("plane", [True, False], ids=["on", "off"])
def test_degrade_never_moves_a_torch_rung_on_cuda_to_the_host(cuda,
                                                              monkeypatch,
                                                              plane):
    """A torch rung on the card whose device op fails makes the query
    raise with the ladder armed; no numpy-rung result comes back."""
    from repro_torch.core import bloom
    from repro_torch.core.transfer import make_strategy
    from repro_torch.relational import ExecConfig, Executor
    from repro_torch.tpch import build_query, generate

    def broken(*a, **kw):
        raise RuntimeError("device op failed")

    monkeypatch.setattr(bloom, "probe_hashed_dev", broken)
    cat = generate(sf=0.002, seed=3)
    cfg = ExecConfig(strategy=make_strategy(
        "pred-trans", backend="torch", device_resident=plane),
        join_backend="torch", device="on" if plane else "off",
        degrade=True)
    ex = Executor(cat, cfg)
    assert ex._on_device()
    with pytest.raises(RuntimeError, match="device op failed"):
        ex.execute(build_query(5, sf=0.002))
