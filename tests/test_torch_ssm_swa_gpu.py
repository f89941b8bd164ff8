"""Sliding-window attention and Mamba-2 of the port on an NVIDIA GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_swa_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false. The CPU side of each comparison is
held against the reference package by tests/test_torch_ssm_swa.py."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flashattn import ops as fa
from repro_torch.kernels.flashattn.ref import sdpa_ref
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture()
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _run(m, params, tokens, t0):
    """Prefill logits of tokens[:, :t0], then each teacher-forced decode
    step's, and the caches after the last step."""
    out = []
    lg, caches = m.prefill(params, Batch(tokens[:, :t0], None),
                           cap=tokens.shape[1] + 4)
    out.append(lg[:, 0])
    for t in range(t0, tokens.shape[1]):
        lg, caches = m.decode_step(params, tokens[:, t:t + 1], caches, t)
        out.append(lg[:, 0])
    return torch.stack(out), caches


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_smoke_config_on_cuda_matches_cpu(cuda, no_tf32, arch):
    """The f32 smoke config on the card ("auto" attention: jamba's head
    size 32 is not one K8 is built for) == the same weights and tokens on
    the CPU: prefill at 2e-4, each decode step at 3e-4 (the CPU tests'
    tolerances against the reference), the Mamba conv windows and SSM
    states at 1e-4; no hand kernel launches."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab_size, (2, 46),
                           generator=torch.Generator().manual_seed(2))
    with L.attention_backend("auto"):
        want, wc = _run(m, params, tokens, 37)
        fa.reset_launches()
        got, gc = _run(m, _to(params, cuda), tokens.to(cuda), 37)
        torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == 0
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got[1:].cpu(), want[1:], rtol=3e-4,
                               atol=3e-4)
    for (kind, _), g, w in zip(m.slots, gc["slots"], wc["slots"]):
        if kind == "mamba":
            torch.testing.assert_close(g.conv.cpu(), w.conv, rtol=1e-4,
                                       atol=1e-4)
            torch.testing.assert_close(g.ssm.cpu(), w.ssm, rtol=1e-4,
                                       atol=1e-4)
        else:
            assert g.index == w.index == 46


def _ring(index, cap, b, dev):
    return L._ring_positions(index, cap, b, dev)


def _rows(b, n, start, dev):
    return torch.arange(start, start + n, dtype=torch.int32,
                        device=dev)[None].expand(b, n).contiguous()


#: mixtral-8x7b's heads (32 query heads, 8 kv heads of 128): name, b, sq,
#: window, (q positions, (kv positions, kv validity)) as functions of dev
MIXTRAL_CASES = {
    # the full forward / loss: the window masks, whole tiles skipped
    "prefill, window 256 over 1024": (1, 1024, 256, lambda d: (
        _rows(1, 1024, 0, d), (_rows(1, 1024, 0, d),
                               torch.ones(1, 1024, dtype=torch.bool,
                                          device=d)))),
    # a 600-token prompt into a 256-slot ring: its last 256 tokens kept,
    # rows before position 344 see no key
    "prefill longer than the ring": (2, 600, 256, lambda d: (
        _rows(2, 600, 0, d), _ring(600, 256, 2, d))),
    # decode on a wrapped ring of the window's size
    "decode, ring wrapped": (2, 1, 256, lambda d: (
        _rows(2, 1, 300, d), _ring(301, 256, 2, d))),
    # the serve path's ring: 4096 slots, position 4100
    "decode, 4096-slot ring wrapped": (2, 1, 4096, lambda d: (
        _rows(2, 1, 4100, d), _ring(4101, 4096, 2, d))),
}


@pytest.mark.parametrize("case", list(MIXTRAL_CASES))
def test_flash_kernel_at_mixtral_heads(cuda, no_tf32, case):
    """K8 at mixtral's head shape (32/8, d 128) with a sliding window, on
    the ring shapes the model gives it, == `flash_plain` and `sdpa_ref`
    within 2e-2 (bf16); a decode also within two bf16 ulps of the
    largest output. The wrapper counts its one launch."""
    b, sq, window, pos = MIXTRAL_CASES[case]
    qp, (kp, kval) = pos(cuda)
    skv = kp.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)
    q, k, v = randn(b, sq, 32, 128), randn(b, skv, 8, 128), \
        randn(b, skv, 8, 128)
    kw = {"causal": True, "window": window}
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, qp, kp, kval, **kw)
    torch.cuda.synchronize()
    variant = "flash_decode" if sq == 1 else "flash_prefill"
    assert fa.LAUNCHES == {**{k: 0 for k in fa.LAUNCHES}, variant: 1}
    plain = fa.flash_plain(q, k, v, qp, kp, kval, **kw)
    dense = sdpa_ref(q, k.repeat_interleave(4, 2), v.repeat_interleave(4, 2),
                     qp, kp, kval, **kw)
    for want in (plain, dense):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        if sq == 1:
            top = float(want.float().abs().max())
            limit = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
            assert float((got.float() - want.float()).abs().max()) <= limit
