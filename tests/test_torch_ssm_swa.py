"""Sliding-window attention and Mamba-2 in the port (`repro_torch.models`)
against the reference (`repro.models`) on the CPU.

The same weights (the reference's init, carried across with
`repro_torch.interop.params_from_arrays`) and the same tokens (numpy,
from a seed) go through both packages, in the f32 smoke configs of
mixtral-8x7b (sliding-window attention, the routed MoE), mamba2-370m
(attention-free, Mamba-2 only) and jamba-1.5-large-398b (1 attention : 7
Mamba, MoE every second layer), at the reference's tolerances: 2e-4 for
the prefill, 3e-4 for each decode step. Prompts are not a multiple of
the smoke `chunk` (32), so the SSD's zero padding is exercised.

The reference's prefill of a prompt longer than a sliding window keeps
only the last `window` tokens in the ring cache and attends against it,
so its last-token logits are those of a forward over the last `window`
tokens, not of the full forward: the port reproduces that (ROADMAP
Queue 3, deliberate differences inside the reference)."""
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
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model

MIXTRAL, MAMBA, JAMBA = "mixtral-8x7b", "mamba2-370m", "jamba-1.5-large-398b"
ARCHS = [MIXTRAL, MAMBA, JAMBA]


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


def _window(cfg, window):
    if window is None:
        return cfg
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, sliding_window=window))


def _f32_pair(arch, seed=1, window=None):
    """(reference model, its params, port model, port params) of the f32
    smoke config, its window replaced by `window` if given."""
    rcfg = _window(dataclasses.replace(ref_smoke(arch), dtype=jnp.float32),
                   window)
    tcfg = _window(dataclasses.replace(get_smoke_config(arch),
                                       dtype=torch.float32), window)
    rm = RModel(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed)))
    return (rm, jax.tree.map(jnp.asarray, tree), Model(tcfg),
            params_from_arrays(tree, tcfg, "cpu"))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _full_logits(m, params, tokens):
    """The port's full forward (no cache): logits at every position."""
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    h, _, _ = m.backbone(params, m.embed_inputs(params, Batch(tokens, None)),
                         pos)
    return m.hidden_to_logits(params, L.norm(h, params["ln_f"], m.cfg.norm))


@pytest.mark.parametrize("arch,name,window",
                         [(a, "auto", None) for a in ARCHS]
                         + [(MIXTRAL, "flash", None), (MIXTRAL, "flash", 16)])
def test_prefill_and_decode_match_reference(arch, name, window, backend):
    """Prefill logits, then teacher-forced decode logits step by step: the
    port == the reference on the same attention backend ("flash": the
    reference's Pallas kernel in interpret mode, the port's
    `flash_plain`). At window 16 the 37-token prompt overflows the ring
    (its last 16 tokens kept) and decode wraps it. After the last step
    every cache equals the reference's: the KV cursors, K and V, and the
    Mamba layers' conv windows and SSM states."""
    backend(name)
    rm, params, tm, tp = _f32_pair(arch, window=window)
    B, S, T0 = 2, 46, 37               # 37 = one chunk of 32 and 5 padded
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, rm.cfg.vocab_size, (B, S)).astype(np.int32)
    cap = S + 4
    prefill = jax.jit(lambda p, t: rm.prefill(p, RBatch(t, t), cap=cap))
    decode = jax.jit(lambda p, t, c, pos: rm.decode_step(p, t, c, pos))
    rl, rc = prefill(params, jnp.asarray(tokens[:, :T0]))
    tt = torch.from_numpy(tokens).long()
    tl, tc = tm.prefill(tp, Batch(tt[:, :T0], tt[:, :T0]), cap=cap)
    assert tl.shape == (B, 1, rm.cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, rl, 2e-4, f"{arch} {name} prefill")
    for t in range(T0, S):
        rl, rc = decode(params, jnp.asarray(tokens[:, t:t + 1]), rc,
                        jnp.int32(t))
        tl, tc = tm.decode_step(tp, tt[:, t:t + 1], tc, t)
        _close(tl, rl, 3e-4, f"{arch} {name} step {t}")
    assert len(tc["slots"]) == len(rc["slots"]) == len(tm.slots)
    for (kind, _), got, want in zip(tm.slots, tc["slots"], rc["slots"]):
        if kind == "mamba":
            assert isinstance(got, L.MambaCache)
            assert got.conv.dtype == torch.float32 == got.ssm.dtype
            _close(got.conv, want.conv, 1e-4, f"{arch} conv window")
            _close(got.ssm, want.ssm, 1e-4, f"{arch} ssm state")
        else:
            assert np.all(np.asarray(want.index) == S) and got.index == S
            _close(got.k, want.k, 1e-4, f"{arch} k cache")
            _close(got.v, want.v, 1e-4, f"{arch} v cache")


@pytest.mark.parametrize("s", [64, 50], ids=["whole chunks", "padded"])
def test_segsum_and_ssd_chunked_match_reference(s):
    """`_segsum` on random input, and `_ssd_chunked` on random x, dt, B, C
    and a_log (f32, chunk 16), over whole chunks and over a sequence
    zero-padded to them as `mamba2` pads it: y and the final state
    within 1e-5 of the reference's."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(RL._segsum(jnp.asarray(x)))
    got = L._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)

    b, h, p, n, chunk = 2, 4, 8, 6, 16
    pad = (-s) % chunk
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)

    def zpad(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    args = [zpad(a) for a in (xh, dt)] + [a_log] + [zpad(a) for a in (B, C)]
    wy, wstate = RL._ssd_chunked(*map(jnp.asarray, args), chunk)
    gy, gstate = L._ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert gy.dtype == torch.float32 and gstate.shape == (b, h, p, n)
    np.testing.assert_allclose(gy[:, :s].numpy(), np.asarray(wy)[:, :s],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gstate.numpy(), np.asarray(wstate),
                               rtol=1e-5, atol=1e-5)


def test_sliding_window_bounds_cache():
    """The twin of the reference's test: mixtral's smoke config (window
    64) at cap 4096 builds 64-slot rings; jamba's attention slot (no
    window) keeps the cap, its Mamba slots a state that does not grow."""
    caches = Model(get_smoke_config(MIXTRAL)).init_cache(2, 4096, "cpu")
    k = caches["slots"][0].k
    assert tuple(k.shape) == (4, 2, 64, 2, 32)   # [reps, B, window, KVH, D]
    jcfg = get_smoke_config(JAMBA)
    caches = Model(jcfg).init_cache(2, 100, "cpu")
    assert caches["slots"][0].k.shape[2] == 100
    mb = jcfg.mamba
    d_inner = mb.expand * jcfg.d_model
    for sc in caches["slots"][1:]:
        assert tuple(sc.conv.shape) == (1, 2, mb.d_conv - 1,
                                        d_inner + 2 * mb.d_state)
        assert sc.conv.dtype == jcfg.dtype
        assert tuple(sc.ssm.shape) == (1, 2, d_inner // mb.head_dim,
                                       mb.head_dim, mb.d_state)
        assert sc.ssm.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_full_forward(arch):
    """The port's own serving-consistency property (f32, flash backend):
    prefill then token-by-token decode reproduces the full forward's
    logits at every position. mixtral runs at window 16 and decodes 48
    tokens past an 8-token prompt: its ring wraps three times, and each
    step's cache holds exactly the tokens the full forward's window mask
    lets in."""
    window = 16 if arch == MIXTRAL else None
    tcfg = _window(dataclasses.replace(get_smoke_config(arch),
                                       dtype=torch.float32), window)
    m = Model(tcfg)
    params = m.init(torch.Generator().manual_seed(1))
    B, S, T0 = 2, 56, 8
    tokens = torch.randint(0, tcfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(2))
    full = _full_logits(m, params, tokens)
    logits, caches = m.prefill(params, Batch(tokens[:, :T0], None),
                               cap=S + 4)
    torch.testing.assert_close(logits[:, 0], full[:, T0 - 1], rtol=2e-4,
                               atol=2e-4)
    for t in range(T0, S):
        lg, caches = m.decode_step(params, tokens[:, t:t + 1], caches, t)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=3e-4,
                                   atol=3e-4, msg=f"{arch} step {t}")
    if window:
        assert caches["slots"][0].k.shape[2] == window
        assert caches["slots"][0].index == S


def test_prompt_longer_than_window_matches_reference():
    """A 40-token prompt through mixtral's smoke config at window 16: the
    ring keeps the last 16 tokens and the prefill attends against them,
    in the reference and in the port alike. The port's logits equal the
    reference's; both differ from the full forward's at the last
    position and equal a forward over the last 16 tokens."""
    rm, params, tm, tp = _f32_pair(MIXTRAL, window=16)
    S, W = 40, 16
    tokens = np.random.default_rng(5).integers(
        0, rm.cfg.vocab_size, (2, S)).astype(np.int32)
    rl, _ = rm.prefill(params, RBatch(jnp.asarray(tokens),
                                      jnp.asarray(tokens)), cap=S + 4)
    tt = torch.from_numpy(tokens).long()
    tl, tc = tm.prefill(tp, Batch(tt, tt), cap=S + 4)
    assert tc["slots"][0].k.shape[2] == W and tc["slots"][0].index == S
    _close(tl, rl, 2e-4, "prefill past the window")
    full = _full_logits(tm, tp, tt)[:, -1]
    last = _full_logits(tm, tp, tt[:, -W:])[:, -1]
    for got in (tl[:, 0], torch.from_numpy(np.array(rl)[:, 0])):
        assert float((got - full).abs().max()) > 1e-2
        torch.testing.assert_close(got, last, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_reference_shapes_and_scales(arch):
    """The port's init == the reference's in layout, shapes and dtypes,
    Mamba layers included (`in_proj`, `conv_w`, `a_log`, `dt_bias`,
    `d_skip`, `out_proj`, `ln`); ones and zeros exactly; every random
    tensor at the reference's scale: std within 5% and mean within 5% of
    the std, or within four standard errors where a tensor is too small
    for that (jamba's smoke router has 512 entries: its mean's standard
    error is 4.4% of the std)."""
    ref = jax.tree.map(np.asarray, RModel(ref_smoke(arch)).init(
        jax.random.PRNGKey(0)))
    port = Model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    rleaves = jax.tree_util.tree_leaves_with_path(ref)
    pleaves = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in rleaves] == [p for p, _ in pleaves]
    kinds = {type(port["layers"][i]["mixer"].get("conv_w"))
             for i in range(len(port["layers"]))}
    assert (torch.Tensor in kinds) == (arch != MIXTRAL)
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


def test_params_from_arrays_carries_hybrid_tree():
    """jamba's smoke tree crosses whole: no prefix layers, eight pattern
    slots (attention in slot 0, Mamba in 1-7, the MoE on odd slots),
    every leaf bit for bit (bf16 as its bit pattern); a wrong conv
    width raises."""
    cfg = ref_smoke(JAMBA)
    tree = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(5)))
    tcfg = get_smoke_config(JAMBA)
    port = params_from_arrays(tree, tcfg, "cpu")
    assert port["prefix_layers"] == [] and len(port["layers"]) == 8
    assert "wq" in port["layers"][0]["mixer"]
    for si in range(1, 8):
        assert set(port["layers"][si]["mixer"]) == {
            "in_proj", "conv_w", "a_log", "dt_bias", "d_skip", "out_proj",
            "ln"}
        assert ("router" in port["layers"][si]["ffn"]) == (si % 2 == 1)
    rleaves = jax.tree_util.tree_leaves_with_path(tree)
    pleaves = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in rleaves] == [p for p, _ in pleaves]
    for (path, r), (_, t) in zip(rleaves, pleaves):
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert bits.numpy().tobytes() == r.tobytes(), \
            jax.tree_util.keystr(path)
    mixer = tree["layers"][3]["mixer"]
    mixer["conv_w"] = mixer["conv_w"][:, :, :-1]
    with pytest.raises(ValueError, match="conv_w"):
        params_from_arrays(tree, tcfg, "cpu")
