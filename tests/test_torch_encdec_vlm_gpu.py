"""Whisper's encoder and cross-attention, and llava's patch prefix, of the
port on an NVIDIA GPU.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_encdec_vlm_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false. The CPU side of each comparison is
held against the reference package by tests/test_torch_encdec_vlm.py.
The smoke configs' head sizes (16, 32) are not ones K8 is built for, so
the served models here are narrow configs at the published head sizes:
whisper's 64 and llava's 128."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flashattn import ops as fa
from repro_torch.kernels.flashattn.ref import sdpa_ref
from repro_torch.launch import serve
from repro_torch.models import layers as L

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


def _decode_limit(ref):
    """Two bf16 ulps of the largest |ref| (tests/test_torch_kernels_gpu.py
    says why)."""
    top = float(ref.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


#: whisper-base's heads (8 query, 8 kv heads of 64) at serve-whisper's
#: shapes: name -> (b, sq, skv, q positions, kv positions), each a function
#: of the device; every key valid, non-causal
WHISPER_CASES = {
    # the encoder: 1500 frames, positions 0..1499, the last key tile 92
    "encoder": (16, 1500, 1500, lambda n, d: torch.arange(
        n, dtype=torch.int32, device=d)),
    # cross-attention: every q and kv position 0
    "cross prefill": (16, 32, 1500, lambda n, d: torch.zeros(
        n, dtype=torch.int32, device=d)),
    "cross decode": (16, 1, 1500, lambda n, d: torch.zeros(
        n, dtype=torch.int32, device=d)),
}


@pytest.mark.parametrize("case", list(WHISPER_CASES))
def test_flash_kernel_at_whisper_shapes(cuda, no_tf32, case):
    """K8 at whisper-base's heads (8/8, d 64, non-causal) on serve-whisper's
    shapes == `flash_plain`, `sdpa_ref` and SDPA within 2e-2 (bf16); a
    decode also within two bf16 ulps of the largest output of the first
    two; the wrapper counts its one launch. A cross decode step over 1500
    frames at B 16 takes 6 splits of 4 tiles (the source note's rule)."""
    b, sq, skv, pos = WHISPER_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)
    q, k, v = randn(b, sq, 8, 64), randn(b, skv, 8, 64), randn(b, skv, 8, 64)
    qp = pos(sq, cuda)[None].expand(b, sq).contiguous()
    kp = pos(skv, cuda)[None].expand(b, skv).contiguous()
    kval = torch.ones(b, skv, dtype=torch.bool, device=cuda)
    kw = {"causal": False, "window": None}
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, qp, kp, kval, **kw)
    torch.cuda.synchronize()
    variant = "flash_decode" if sq == 1 else "flash_prefill"
    assert fa.LAUNCHES == {**{k: 0 for k in fa.LAUNCHES}, variant: 1}
    assert got.shape == (b, sq, 8, 64) and bool(torch.isfinite(got).all())
    for want in (fa.flash_plain(q, k, v, qp, kp, kval, **kw),
                 sdpa_ref(q, k, v, qp, kp, kval, **kw)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        if sq == 1:
            err = float((got.float() - want.float()).abs().max())
            assert err <= _decode_limit(want), (err, _decode_limit(want))
    library = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    torch.testing.assert_close(got.float(), library.transpose(1, 2).float(),
                               atol=2e-2, rtol=2e-2)
    if sq == 1:
        assert fa.flash_decode_splits(b, 8, skv) == 6


@pytest.mark.parametrize("sq", [32, 1], ids=["prefill", "decode"])
def test_cross_attention_layer_launches_k8(cuda, no_tf32, sq):
    """One cross-attention layer at whisper-base's widths (d_model 512, 8
    heads of 64, bf16) over a 1500-frame encoder output: K and V come from
    `enc_out @ wk` reshaped (the strides K8's TMA and cp.async loads
    check), and the layer on "flash" launches K8 once and equals itself
    on "auto" within 2e-2."""
    gen = torch.Generator(device=cuda).manual_seed(sq)
    d, hd = 512, 8 * 64

    def w(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(torch.bfloat16)
    p = {name: w(d, hd, scale=d ** -0.5) for name in ("wq", "wk", "wv")}
    p["wo"] = w(hd, d, scale=hd ** -0.5)
    p["ln_x"] = torch.ones(d, device=cuda)
    x, enc = w(16, sq, d), w(16, 1500, d)
    a = get_smoke_config("whisper-base").attn
    a = dataclasses.replace(a, num_heads=8, num_kv_heads=8, head_dim=64)
    fa.reset_launches()
    got = L.cross_attention(p, x, enc, a, norm_kind="layernorm")
    torch.cuda.synchronize()
    variant = "flash_decode" if sq == 1 else "flash_prefill"
    assert fa.LAUNCHES == {**{k: 0 for k in fa.LAUNCHES}, variant: 1}
    with L.attention_backend("auto"):
        want = L.cross_attention(p, x, enc, a, norm_kind="layernorm")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


#: narrow bf16 configs at the published head sizes: whisper's 64 (4/4
#: heads, 2 encoder layers over 300 frames, whose last key tile is 44 of
#: 128), llava's 128 (8/2 heads, group 4, 100 patches)
NARROW = {
    "whisper-base": dict(d_model=256, n_layers=2, n_enc_layers=2,
                         enc_seq_len=300, d_ff=512, vocab_size=1024,
                         attn=(4, 4, 64)),
    "llava-next-mistral-7b": dict(d_model=512, n_layers=2, num_patches=100,
                                  d_ff=1024, vocab_size=1024,
                                  attn=(8, 2, 128)),
}
#: flash against "auto", teacher-forced, on the same weights and tokens:
#: both compute in bf16 and differ where attention rounds. At these
#: widths the logits have std 0.32 (whisper) and 0.46 (llava); on the CPU
#: (`flash_plain` for K8, the same configs, batch, prompt and tokens) the
#: gaps read max 0.0098 / mean 0.0021 (whisper) and 0.0234 / 0.0046
#: (llava); the bounds leave about 2.5 times the larger, far under the
#: logits' own scale, by which a wrong mask, position or cache slot moves
#: them
NARROW_MAX_ABS, NARROW_MEAN_ABS = 0.06, 0.012


def narrow_config(arch):
    spec = dict(NARROW[arch])
    h, kvh, hd = spec.pop("attn")
    base = get_smoke_config(arch)
    return dataclasses.replace(
        base, name=f"{arch}-narrow", dtype=torch.bfloat16,
        attn=dataclasses.replace(base.attn, num_heads=h, num_kv_heads=kvh,
                                 head_dim=hd), **spec)


@pytest.mark.parametrize("arch", list(NARROW))
def test_narrow_model_served_on_cuda_matches_auto(cuda, no_tf32, arch):
    """A narrow bf16 whisper (encoder, cross-attention) and llava (patch
    prefix) at published head sizes through `serve.serve_config` on the
    card: K8 launches one a self-attention layer, one a cross-attention
    layer and, at the prefill, two an encoder layer (the prefill's encode
    and `generate`'s), per pass; K1-K7 none. The greedy tokens fed again
    with "auto" attention give the prefill's and every step's logits
    within `NARROW_MAX_ABS` (max) and `NARROW_MEAN_ABS` (mean); the cache
    holds the patches too, and decode starts past them."""
    cfg = narrow_config(arch)
    b, s, g = 2, 40, 6
    fa.reset_launches()
    res = serve.serve_config(cfg, b, s, g, cuda)
    torch.cuda.synchronize()
    cross = cfg.n_layers if cfg.n_enc_layers else 0
    runs = len(res["passes"])
    assert dict(fa.LAUNCHES) == {
        "flash_prefill": (cfg.n_layers + cross + 2 * cfg.n_enc_layers) * runs,
        "flash_decode": (cfg.n_layers + cross) * g * runs}
    prefix = cfg.num_patches if cfg.frontend == "vision_stub" else 0
    assert res["cap"] == prefix + s + g + 8
    with L.attention_backend("auto"):
        fa.reset_launches()
        tf = serve.generate(res["model"], res["params"], res["prompt"], g,
                            res["cap"], forced=res["tokens"],
                            extra=res["extra"])
        torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == 0
    assert len(tf["logits"]) == g + 1
    for i, (got, want) in enumerate(zip(res["logits"], tf["logits"])):
        diff = (got - want).abs()
        assert bool(torch.isfinite(got).all())
        assert float(diff.max()) <= NARROW_MAX_ABS, (i, float(diff.max()))
        assert float(diff.mean()) <= NARROW_MEAN_ABS, (i, float(diff.mean()))
