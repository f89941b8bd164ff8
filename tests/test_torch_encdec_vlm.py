"""Whisper's encoder and cross-attention, and llava's patch prefix, in the
port (`repro_torch.models`, `repro_torch.launch.serve`) against the
reference (`repro.models`) on the CPU.

The same weights (the reference's init, carried across with
`repro_torch.interop.params_from_arrays`) and the same inputs (numpy,
from a seed: tokens, whisper's frame embeddings, llava's patch
embeddings) go through both packages, in the f32 smoke configs of
whisper-base (audio stub, 2 encoder and 2 decoder layers, layernorm,
gelu) and llava-next-mistral-7b (vision stub, 8 patches), on both
attention backends ("flash": the reference's Pallas kernel in interpret
mode, the port's `flash_plain`), at the reference's tolerances: 2e-4 for
the encoder and the prefill, 3e-4 for each decode step.

The launcher's cache counts the patch positions the prefill writes;
`examples/serve_lm.py` leaves them out, so where a config has more
patches than `gen_tokens + 8` its ring drops the first of them (ROADMAP
Queue 3, deliberate differences)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as RL
from repro.models.model import Batch as RBatch
from repro.models.model import Model as RModel
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_arrays
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model

WHISPER, LLAVA = "whisper-base", "llava-next-mistral-7b"
ARCHS = [WHISPER, LLAVA]
BACKENDS = ["auto", "flash"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once, and a torch thread pool in each
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def backend():
    """Set both packages' attention backend; restore their defaults."""
    def set_both(name):
        RL.set_attention_backend(name)
        L.set_attention_backend(name)
    yield set_both
    RL.set_attention_backend("auto")
    L.set_attention_backend("flash")


def _f32_pair(arch, seed=1, **changes):
    """(reference model, its params, port model, port params) of the f32
    smoke config, with `changes` applied to both configs."""
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32, **changes)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                               **changes)
    rm = RModel(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed)))
    return (rm, jax.tree.map(jnp.asarray, tree), Model(tcfg),
            params_from_arrays(tree, tcfg, "cpu"))


def _extra(cfg, b, seed=3):
    """The stub frontend's f32 embeddings: [b, enc_seq_len, d] frames for
    whisper, [b, num_patches, d] patches for llava."""
    n = cfg.enc_seq_len if cfg.n_enc_layers else cfg.num_patches
    return np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _numpy_tree(tree):
    """The port's parameter tree as the reference's: dicts and lists of
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return jnp.asarray(tree.detach().numpy())


@pytest.mark.parametrize("name", BACKENDS)
def test_encode_matches_reference(name, backend):
    """Whisper's encoder: `frame_proj`, the stacked layers (non-causal
    attention with RoPE at the frame positions, the gelu MLP, layernorm),
    `enc_ln_f` — the port's `encode` == the reference's within 2e-4."""
    backend(name)
    rm, params, tm, tp = _f32_pair(WHISPER)
    frames = _extra(rm.cfg, 2)
    want = rm.encode(params, jnp.asarray(frames))
    got = tm.encode(tp, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, rm.cfg.enc_seq_len, rm.cfg.d_model)
    assert got.dtype == torch.float32
    _close(got, want, 2e-4, f"encode on {name}")


@pytest.mark.parametrize("name", BACKENDS)
@pytest.mark.parametrize("sq", [1, 5], ids=["decode", "prefill"])
def test_cross_attention_matches_reference(name, sq, backend):
    """One decoder layer's cross-attention (queries from norm(x, ln_x), K
    and V from the encoder output, every position 0, non-causal) at a
    decode step's Sq of 1 and a prompt's, == the reference's within 2e-4;
    `ln` (the self-attention norm the layer also carries) is not read."""
    backend(name)
    rm, params, tm, tp = _f32_pair(WHISPER)
    a = rm.cfg.attn
    rng = np.random.default_rng(sq)
    x = rng.standard_normal((2, sq, rm.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, rm.cfg.enc_seq_len,
                               rm.cfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda t: t[1], params["cross"])
    want = RL.cross_attention(rp, jnp.asarray(x), jnp.asarray(enc), a,
                              norm_kind=rm.cfg.norm)
    p = {k: v[1] for k, v in tp["cross"].items()}
    p["ln"] = torch.full_like(p["ln"], float("nan"))
    got = L.cross_attention(p, torch.from_numpy(x), torch.from_numpy(enc),
                            tm.cfg.attn, norm_kind=tm.cfg.norm)
    _close(got, want, 2e-4, f"cross-attention on {name}")


def _prompt(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, name, backend):
    """Prefill logits, then teacher-forced decode logits step by step: the
    port == the reference on the same attention backend. Whisper's
    prefill encodes the frames; its decode steps take `enc_out` from
    `encode`. Llava's prefill writes the 8 patches and the prompt; its
    decode positions start past the patches. After the last step every
    KV cache equals the reference's."""
    backend(name)
    rm, params, tm, tp = _f32_pair(arch)
    cfg = rm.cfg
    B, S, T0 = 2, 30, 21
    tokens = _prompt(cfg, B, S)
    extra = _extra(cfg, B)
    off = 0 if cfg.n_enc_layers else cfg.num_patches
    cap = off + S + 4
    rl, rc = jax.jit(lambda p, t, e: rm.prefill(p, RBatch(t, t, e), cap=cap))(
        params, jnp.asarray(tokens[:, :T0]), jnp.asarray(extra))
    tt, te = torch.from_numpy(tokens).long(), torch.from_numpy(extra)
    tl, tc = tm.prefill(tp, Batch(tt[:, :T0], tt[:, :T0], te), cap=cap)
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, rl, 2e-4, f"{arch} {name} prefill")
    r_enc = t_enc = None
    if cfg.n_enc_layers:
        r_enc = rm.encode(params, jnp.asarray(extra))
        t_enc = tm.encode(tp, te)
    decode = jax.jit(lambda p, t, c, pos, e: rm.decode_step(p, t, c, pos, e))
    for t in range(T0, S):
        rl, rc = decode(params, jnp.asarray(tokens[:, t:t + 1]), rc,
                        jnp.int32(off + t), r_enc)
        tl, tc = tm.decode_step(tp, tt[:, t:t + 1], tc, off + t, t_enc)
        _close(tl, rl, 3e-4, f"{arch} {name} step {t}")
    (got,), (want,) = tc["slots"], rc["slots"]
    assert got.index == off + S
    assert np.all(np.asarray(want.index) == off + S)
    _close(got.k, want.k, 1e-4, f"{arch} k cache")
    _close(got.v, want.v, 1e-4, f"{arch} v cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_reference_shapes_and_scales(arch):
    """The port's init == the reference's in layout, shapes and dtypes —
    whisper's `frame_proj`, `encoder` (stacked on [n_enc_layers]),
    `enc_ln_f` and `cross` (stacked on [n_layers], with `ln_x`), llava's
    `patch_proj` included; ones exactly; every random tensor at the
    reference's scale: std within 5% and mean within 5% of the std, or
    within four standard errors where a tensor is too small for that."""
    ref = jax.tree.map(np.asarray, RModel(ref_smoke(arch)).init(
        jax.random.PRNGKey(0)))
    port = Model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    rleaves = jax.tree_util.tree_leaves_with_path(ref)
    pleaves = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in rleaves] == [p for p, _ in pleaves]
    new = {"frame_proj", "encoder", "enc_ln_f", "cross"} \
        if arch == WHISPER else {"patch_proj"}
    assert new <= set(port)
    for (path, r), (_, t) in zip(rleaves, pleaves):
        what = jax.tree_util.keystr(path)
        assert tuple(t.shape) == r.shape, what
        assert str(t.dtype).split(".")[1] == r.dtype.name, what
        rf, tf = r.astype(np.float32), t.float().numpy()
        if np.all(rf == rf.flat[0]):                # ones and zeros
            assert np.all(tf == rf.flat[0]), what
            continue
        n = tf.size
        assert abs(tf.std() / rf.std() - 1) < max(0.05, 4 / np.sqrt(2 * n)), \
            what
        assert abs(tf.mean()) < max(0.05, 4 / np.sqrt(n)) * rf.std(), what


def test_serve_cap_keeps_every_patch_position(backend):
    """The launcher's cache holds the patches, the prompt, gen_tokens and
    8 slots. llava's smoke config with 24 patches (more than gen_tokens +
    8 = 12) and a 20-token prompt: `serve_config`'s prefill logits equal
    the reference `Model.prefill`'s at the launcher's cap (48) within
    2e-4, so no patch drops; at `serve_lm.py`'s cap (prompt + gen + 8 =
    32) the reference's ring keeps only the last 32 of the 44 positions
    written, and its logits lie far from them. Decode starts at position
    44, past the patches."""
    backend("auto")
    cfg = dataclasses.replace(get_smoke_config(LLAVA), dtype=torch.float32,
                              num_patches=24)
    rcfg = dataclasses.replace(ref_smoke(LLAVA), dtype=jnp.float32,
                               num_patches=24)
    b, s, g = 2, 20, 4
    res = serve.serve_config(cfg, b, s, g, torch.device("cpu"))
    assert res["cap"] == 24 + s + g + 8
    assert tuple(res["extra"].shape) == (b, 24, cfg.d_model)
    caches = res["model"].prefill(res["params"], Batch(
        res["prompt"], res["prompt"], res["extra"]), cap=res["cap"])[1]
    assert caches["slots"][0].index == 24 + s
    rm, params = RModel(rcfg), _numpy_tree(res["params"])
    batch = RBatch(jnp.asarray(res["prompt"].numpy()),
                   jnp.asarray(res["prompt"].numpy()),
                   jnp.asarray(res["extra"].numpy()))
    got = res["logits"][0].numpy()
    short, _ = rm.prefill(params, batch, cap=s + g + 8)
    assert float(np.abs(got - np.asarray(short)[:, -1]).max()) > 1e-2
    rl, rc = rm.prefill(params, batch, cap=res["cap"])
    _close(got, np.asarray(rl)[:, -1], 2e-4, "prefill at the full cap")
    # the greedy run's decode against the reference's, past the patches
    toks = res["tokens"].numpy().astype(np.int32)
    for i in range(g):
        rl, rc = rm.decode_step(params, jnp.asarray(toks[:, i:i + 1]), rc,
                                jnp.int32(24 + s + i))
        _close(res["logits"][i + 1], np.asarray(rl)[:, -1], 3e-4,
               f"decode step {i}")
