"""The launch and sharding layer's device paths on an NVIDIA GPU: the
multi-pod filter transfer through K2 and K3 on a (2, 4) ("pod", "data")
mesh of eight shards of one card, the MoE's per-shard token groups on
CUDA, and the dry run's argument bytes against the bytes a served model
really allocates.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_launch_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false. The transfer's words and masks
must equal the plain versions and the 1-D mesh bit for bit; the MoE's
logits on CUDA (f32, TF32 off, attention on "auto") must equal the
port's on the CPU within the model tests' 2e-4 / 3e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.core import bloom, distributed
from repro_torch.kernels.bloom import ops as kb
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from repro_torch.launch.mesh import make_data_mesh, make_test_mesh, set_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("tree_or", [False, True])
def test_pod_transfer_on_one_card(cuda, tree_or):
    """(2, 4) pod mesh of cuda:0 x 8: every shard's words == `build_ref`
    over all the build keys == the 1-D mesh's words over the same 8
    shards; the mask == `probe_ref` of the whole column; 8 K2 and 8 K3
    launches a call."""
    rng = np.random.default_rng(5)
    bkeys = rng.integers(0, 10**7, 50_003).astype(np.int64)
    pkeys = np.concatenate([bkeys[:20_000], rng.integers(
        2 * 10**7, 3 * 10**7, 180_001).astype(np.int64)])
    nblocks = bloom.blocks_for(len(bkeys))
    mesh = make_test_mesh((2, 4), ("pod", "data"), devices=[cuda] * 8)
    flat = make_data_mesh(8, devices=[cuda] * 8)
    b = distributed.shard_table_arrays(bkeys, mesh, bucket=True)
    p = distributed.shard_table_arrays(pkeys, mesh, bucket=True)
    kb.reset_launches()
    words = distributed.distributed_bloom_build(*b, nblocks, mesh,
                                                tree_or=tree_or)
    mask = distributed.make_distributed_transfer(mesh, nblocks,
                                                 tree_or=tree_or)(*b, *p)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["bloom_build"] == 16 and kb.LAUNCHES["probe"] == 8
    blo, bhi = bloom.keys_to_device(bkeys, cuda)
    plo, phi = bloom.keys_to_device(pkeys, cuda)
    whole = kb.build_ref(blo, bhi, nblocks)
    hit = kb.probe_ref(whole, plo, phi)
    one_d = distributed.distributed_bloom_build(*b, nblocks, flat,
                                                tree_or=tree_or)
    for w, w1 in zip(words, one_d):
        assert torch.equal(w, whole) and torch.equal(w1, whole)
    got = torch.cat(mask)
    assert torch.equal(got[:len(pkeys)], hit)
    assert not bool(got[len(pkeys):].any())


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_groups_on_cuda_equal_cpu(cuda, arch):
    """The smoke config in f32 with capacity factor 0.5 (the smoke's own
    4.0 never binds) under a (2, 2) ambient mesh: prefill and
    teacher-forced decode logits on CUDA == the port on the CPU, and the
    mesh moves the prefill logits by more than 1e-2."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 24))).long()
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        pd, td = _to(params, dev), tok.to(dev)
        for tag, mesh in (("none", None), ("mesh", make_test_mesh((2, 2)))):
            with set_mesh(mesh), L.attention_backend("auto"), \
                    torch.no_grad():
                lg, c = model.prefill(pd, Batch(td[:, :16], td[:, :16]),
                                      cap=28)
                steps = [lg]
                for t in range(16, 24):
                    lg, c = model.decode_step(pd, td[:, t:t + 1], c, t)
                    steps.append(lg)
            out[name, tag] = [s.float().cpu() for s in steps]
    for tag in ("none", "mesh"):
        for i, (g, w) in enumerate(zip(out["cuda", tag], out["cpu", tag])):
            tol = 2e-4 if i == 0 else 3e-4
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    moved = (out["cuda", "mesh"][0] - out["cuda", "none"][0]).abs().max()
    assert float(moved) > 1e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_argument_bytes_equal_allocated_bytes(cuda):
    """qwen1.5-4b's smoke config on a one-device mesh: the dry run's
    reckoned prefill bytes == the parameters' and the batch's storage
    on the card; decode's == parameters + tokens + the ring caches."""
    cfg = get_smoke_config("qwen1.5-4b")
    mesh = make_test_mesh((1, 1))
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    p_bytes = sum(t.untyped_storage().nbytes() for t in _leaves(params))
    kind, args, _ = input_specs("qwen1.5-4b",
                                ShapeSpec("p", 64, 4, "prefill"), mesh, cfg)
    batch = [torch.zeros(x.shape, dtype=x.dtype, device=cuda)
             for x in args[0] if x is not None]
    want = dryrun.argument_bytes("qwen1.5-4b",
                                 ShapeSpec("p", 64, 4, "prefill"), mesh,
                                 cfg)
    assert want["argument_bytes"] == p_bytes + sum(
        t.untyped_storage().nbytes() for t in batch)
    caches = model.init_cache(4, 72, cuda)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    got = p_bytes + tok.untyped_storage().nbytes() + sum(
        t.untyped_storage().nbytes() for c in caches["prefix"]
        + caches["slots"] for t in (c.k, c.v))
    assert dryrun.argument_bytes("qwen1.5-4b",
                                 ShapeSpec("d", 72, 4, "decode"), mesh,
                                 cfg)["argument_bytes"] == got


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
