"""The LM serving path of the port (`repro_torch.models`) against the
reference (`repro.models`) on the CPU.

The same weights (the reference's init, carried across with
`repro_torch.interop.params_from_arrays`) and the same tokens (numpy,
from a seed) go through both packages. Logits are compared in f32 smoke
configs — bf16 rounds at other places in the two frameworks, so the
algorithm is compared in f32 (as tests/test_models.py does) — at the
reference's tolerances: 2e-4 for the prefill, 3e-4 for each decode step.
The reference initialises the QKV biases to zero, so the tests set them,
on both sides, to random values that exercise the bias path.
deepseek-v2-lite's smoke config brings MLA attention (q/k head size 48
against v's 32 in the smoke), the routed MoE with a shared expert, and a
leading dense layer (`prefix_layers`)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as RL
from repro.models.model import Batch as RBatch
from repro.models.model import Model as RModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_arrays
from repro_torch.models import layers as L
from repro_torch.models.model import Batch, Model

DENSE = ["qwen1.5-4b", "minitron-4b", "starcoder2-7b", "command-r-35b"]
MLA_MOE = "deepseek-v2-lite-16b"


@pytest.fixture()
def backend():
    """Set both packages' attention backend; restore their defaults."""
    def set_both(name):
        RL.set_attention_backend(name)
        L.set_attention_backend(name)
    yield set_both
    RL.set_attention_backend("auto")
    L.set_attention_backend("flash")


def _f32_pair(arch, seed=1):
    """(reference model, its params, port model, port params) of the f32
    smoke config, with random QKV biases where the config has them."""
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    rm = RModel(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(seed)))
    if rcfg.attn.qkv_bias:
        rng = np.random.default_rng(seed)
        mixer = tree["layers"][0]["mixer"]
        for name in ("bq", "bk", "bv"):
            mixer[name] = (0.5 * rng.standard_normal(mixer[name].shape)
                           ).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    tm = Model(tcfg)
    return rm, params, tm, params_from_arrays(tree, tcfg, "cpu")


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("arch,name", [(a, "auto") for a in DENSE]
                         + [("qwen1.5-4b", "flash"),
                            ("minitron-4b", "flash"),
                            (MLA_MOE, "auto"), (MLA_MOE, "flash")])
def test_prefill_and_decode_match_reference(arch, name, backend):
    """Prefill logits, then teacher-forced decode logits step by step: the
    port == the reference, both on the same attention backend ("auto":
    the dense path; "flash": the reference's Pallas kernel in interpret
    mode, the port's `flash_plain`); the prefix and slot caches' cursors
    equal the reference's."""
    backend(name)
    rm, params, tm, tp = _f32_pair(arch)
    B, S, T0 = 2, 28, 16
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
    assert len(tc["prefix"]) == len(rc["prefix"])
    for got, want in zip(tc["prefix"] + tc["slots"],
                         rc["prefix"] + rc["slots"]):
        assert np.all(np.asarray(want.index) == S) and got.index == S


def test_bf16_prefill_and_decode_match_reference(backend):
    """qwen1.5-4b's smoke config in its own dtype, bf16: the reference's
    params (through `params_from_arrays`) and tokens go through both
    packages on the "flash" backend (the reference's Pallas kernel in
    interpret mode; the port's `flash_plain` for the prefill and each
    teacher-forced decode step).

    Tolerance, fixed before the first run: the two frameworks round to
    bf16 at other places (XLA fuses elementwise chains and keeps their
    f32 intermediates, torch rounds each op's output), so the two bf16
    runs can agree only up to bf16's own rounding noise. That noise is
    measured on the reference itself: its bf16 logits against its f32
    logits over the same weights (bf16 values, widened exactly) and
    tokens. Each bf16 run lies about that far from the f32 one, so the
    two lie at most twice as far apart, and the port, which rounds at
    more places, gets a further 1.5x: max |d| and mean |d| over the
    prefill and all steps within 3x the reference's own. A wrong mask,
    head mapping, position or cache slot moves logits by their own
    scale, far above that."""
    backend("flash")
    _bf16_check("qwen1.5-4b")


def test_bf16_mla_moe_prefill_and_decode_match_reference(backend):
    """deepseek-v2-lite's smoke config in bf16, as the qwen test above:
    MLA (q/k 48, v 32 in the smoke), the MoE and the dense first layer on
    the "flash" backend, held to the same rule, fixed before the first
    run: max |d| and mean |d| within 3x the reference's own bf16-vs-f32
    gap. A routing choice that flips between the frameworks' roundings
    moves a token's output more than rounding does; the reference's own
    bf16 run flips choices against its f32 run in the same way, so the
    gap it measures carries that too."""
    backend("flash")
    _bf16_check(MLA_MOE)


def _bf16_check(arch):
    rcfg = ref_smoke(arch)
    assert rcfg.dtype == jnp.bfloat16
    rm = RModel(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    mixer = tree["layers"][0]["mixer"]
    if rcfg.attn.qkv_bias:               # zero at init: exercise the path
        for name in ("bq", "bk", "bv"):
            mixer[name] = (0.5 * rng.standard_normal(mixer[name].shape)
                           ).astype(mixer[name].dtype)
    params = jax.tree.map(jnp.asarray, tree)
    r32 = RModel(dataclasses.replace(rcfg, dtype=jnp.float32))
    params32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    tcfg = get_smoke_config(arch)
    assert tcfg.dtype == torch.bfloat16
    tm, tp = Model(tcfg), params_from_arrays(tree, tcfg, "cpu")

    B, S, T0 = 2, 28, 16
    tokens = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    cap = S + 4

    def reference(model, p):
        prefill = jax.jit(lambda p, t: model.prefill(p, RBatch(t, t),
                                                     cap=cap))
        decode = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c,
                                                                pos))
        lg, c = prefill(p, jnp.asarray(tokens[:, :T0]))
        out = [np.asarray(lg, np.float32)]
        for t in range(T0, S):
            lg, c = decode(p, jnp.asarray(tokens[:, t:t + 1]), c,
                           jnp.int32(t))
            out.append(np.asarray(lg, np.float32))
        return np.stack(out)

    want, exact = reference(rm, params), reference(r32, params32)
    tt = torch.from_numpy(tokens).long()
    lg, c = tm.prefill(tp, Batch(tt[:, :T0], tt[:, :T0]), cap=cap)
    got = [lg.float().numpy()]
    for t in range(T0, S):
        lg, c = tm.decode_step(tp, tt[:, t:t + 1], c, t)
        got.append(lg.float().numpy())
    got = np.stack(got)
    noise = np.abs(want - exact)
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and noise.max() > 0
    assert diff.max() <= 3 * noise.max(), (diff.max(), noise.max())
    assert diff.mean() <= 3 * noise.mean(), (diff.mean(), noise.mean())


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minitron-4b", MLA_MOE])
def test_port_decode_matches_full_forward(arch):
    """The port's own serving-consistency property (f32, flash backend):
    prefill then token-by-token decode reproduces the full forward's
    logits at every position."""
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    m = Model(tcfg)
    params = m.init(torch.Generator().manual_seed(1))
    B, S, T0 = 2, 40, 20
    tokens = torch.randint(0, tcfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(2))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    h, _, _ = m.backbone(params, m.embed_inputs(params,
                                                Batch(tokens, tokens)), pos)
    full = m.hidden_to_logits(params, L.norm(h, params["ln_f"], tcfg.norm))
    logits, caches = m.prefill(params, Batch(tokens[:, :T0], None), cap=S + 4)
    torch.testing.assert_close(logits[:, 0], full[:, T0 - 1], rtol=2e-4,
                               atol=2e-4)
    for t in range(T0, S):
        lg, caches = m.decode_step(params, tokens[:, t:t + 1], caches, t)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=3e-4,
                                   atol=3e-4, msg=f"{arch} step {t}")


@pytest.mark.parametrize("index,s", [(0, 5), (3, 1), (6, 4), (2, 11)],
                         ids=["prefill", "decode", "wrap", "roll"])
def test_ring_cache_write_and_positions_match_reference(index, s):
    """`_cache_update` (in place) and `_ring_positions` == the
    reference's, byte for byte, on each branch: a run of slots, one
    slot, a run that wraps round the ring, and s >= cap (roll)."""
    cap, b = 8, 2
    rng = np.random.default_rng(index * 16 + s)
    old = rng.standard_normal((b, cap, 2, 4)).astype(np.float32)
    kn = rng.standard_normal((b, s, 2, 4)).astype(np.float32)
    vn = rng.standard_normal((b, s, 2, 4)).astype(np.float32)
    want = RL._cache_update(RL.KVCache(jnp.asarray(old), jnp.asarray(-old),
                                       jnp.int32(index)),
                            jnp.asarray(kn), jnp.asarray(vn))
    cache = L.KVCache(torch.from_numpy(old.copy()),
                      torch.from_numpy(-old), index)
    got = L._cache_update(cache, torch.from_numpy(kn), torch.from_numpy(vn))
    assert got.k is cache.k and got.index == int(want.index) == index + s
    assert np.asarray(want.k).tobytes() == got.k.numpy().tobytes()
    assert np.asarray(want.v).tobytes() == got.v.numpy().tobytes()
    rp, rv = RL._ring_positions(want.index, cap, b)
    tp, tv = L._ring_positions(got.index, cap, b, "cpu")
    assert tp.dtype == torch.int32 and tp.is_contiguous()
    assert tv.dtype == torch.bool and tv.is_contiguous()
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("arch", DENSE + [MLA_MOE])
def test_init_has_reference_shapes_and_scales(arch):
    """The port's init (torch.Generator) == the reference's (jax.random)
    in layout, shapes and dtypes; ones and zeros exactly; every random
    tensor at the reference's scale (std within 5%, mean near 0)."""
    ref = jax.tree.map(np.asarray, RModel(ref_smoke(arch)).init(
        jax.random.PRNGKey(0)))
    port = Model(get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0))
    rleaves = jax.tree_util.tree_leaves_with_path(ref)
    pleaves = jax.tree_util.tree_leaves_with_path(port)
    assert [p for p, _ in rleaves] == [p for p, _ in pleaves]
    for (path, r), (_, t) in zip(rleaves, pleaves):
        what = jax.tree_util.keystr(path)
        assert tuple(t.shape) == r.shape, what
        assert str(t.dtype).split(".")[1] == r.dtype.name, what
        rf, tf = r.astype(np.float32), t.float().numpy()
        if np.all(rf == rf.flat[0]):                # ones and zeros
            assert np.all(tf == rf.flat[0]), what
            continue
        assert abs(tf.std() / rf.std() - 1) < 0.05, what
        assert abs(tf.mean()) < 0.05 * rf.std(), what


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """Counted from shapes alone, for every architecture of the zoo."""
    assert get_smoke_config(arch).param_count() == \
        ref_smoke(arch).param_count()
    assert get_config(arch).param_count() == ref_config(arch).param_count()


def test_params_from_arrays_carries_bf16_bit_for_bit():
    """bf16 weights cross as their bit pattern (ml_dtypes' bfloat16 or
    np.uint16), f32 ones as they are; a shape that does not fit the
    config raises."""
    cfg = ref_smoke("qwen1.5-4b")
    tree = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(3)))
    port = params_from_arrays(tree, get_smoke_config("qwen1.5-4b"), "cpu")
    wq = tree["layers"][0]["mixer"]["wq"]
    got = port["layers"][0]["mixer"]["wq"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == wq.tobytes()
    assert port["ln_f"].dtype == torch.float32
    bits = params_from_arrays(
        jax.tree.map(lambda a: a.view(np.uint16)
                     if a.dtype.name == "bfloat16" else a, tree),
        get_smoke_config("qwen1.5-4b"), "cpu")
    assert torch.equal(bits["embed"], port["embed"])
    tree["layers"][0]["mixer"]["wq"] = wq[:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_arrays(tree, get_smoke_config("qwen1.5-4b"), "cpu")


def test_attention_backend_defaults_to_flash_and_checks_names():
    assert L._SDPA_BACKEND == "flash"
    with pytest.raises(ValueError):
        L.set_attention_backend("pallas")


def _reference_route(p, h, m):
    """The reference `moe`'s routing with one token group, step for step
    (repro/models/layers.py, `moe`): f32 logits, softmax, top-k
    renormalised, the capacity rule, the exclusive cumsum over the
    flattened (token, slot) order, the keep mask."""
    t = h.shape[0]
    probs = jax.nn.softmax(h.astype(jnp.float32) @ p["router"], axis=-1)
    top_w, top_e = jax.lax.top_k(probs, m.top_k)
    top_w = top_w / jnp.clip(top_w.sum(-1, keepdims=True), 1e-9)
    cap = int(max(1, m.capacity_factor * t * m.top_k / m.num_experts))
    onehot = jax.nn.one_hot(top_e, m.num_experts, dtype=jnp.int32)
    flat = onehot.reshape(t * m.top_k, m.num_experts)
    pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1)
    pos = pos.reshape(t, m.top_k)
    return np.asarray(top_w), np.asarray(top_e), np.asarray(pos), \
        np.asarray(pos < cap), cap


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 4.0])
def test_moe_routing_and_drops_match_reference(capacity_factor):
    """`moe()` alone in f32 (deepseek's smoke MoE layer, the reference's
    init): at a capacity factor that drops tokens (0.5 and 1.0 here) and
    at one that drops none, the port's `moe_route` gives the reference's
    top-k experts, weights, queue positions and keep mask exactly, and
    `moe()` the reference's output within 1e-5."""
    from repro.models.common import init_moe_layer as ref_init_moe
    rcfg = dataclasses.replace(ref_smoke(MLA_MOE), dtype=jnp.float32)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(get_smoke_config(MLA_MOE),
                               dtype=torch.float32)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    tree = jax.tree.map(np.asarray,
                        ref_init_moe(jax.random.PRNGKey(7), rcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 24, rcfg.d_model)).astype(np.float32)
    want = np.asarray(RL.moe(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(x), rcfg))
    h = np.asarray(RL.rmsnorm(jnp.asarray(x), jnp.asarray(tree["ln"])))
    ref = _reference_route(tree, h.reshape(-1, rcfg.d_model), rcfg.moe)
    hx = L.rmsnorm(torch.from_numpy(x), tp["ln"]).reshape(-1, tcfg.d_model)
    got = L.moe_route(tp["router"], hx, tcfg.moe, s=24)
    np.testing.assert_allclose(got.top_w.numpy(), ref[0], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got.top_e.numpy(), ref[1])
    np.testing.assert_array_equal(got.pos.numpy(), ref[2])
    np.testing.assert_array_equal(got.keep.numpy(), ref[3])
    assert got.capacity == ref[4]
    assert (not ref[3].all()) == (capacity_factor < 4.0)
    out = L.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moe_decode_is_dropless():
    """At s == 1 the capacity is the token count, so no (token, slot) is
    dropped even when every token picks the same experts."""
    tcfg = get_smoke_config(MLA_MOE)
    m = tcfg.moe
    router = torch.zeros(tcfg.d_model, m.num_experts)
    router[:, 0] = router[:, 1] = 1.0       # every token: experts 0 and 1
    h = torch.ones(5, tcfg.d_model)
    r = L.moe_route(router, h, m, s=1)
    assert r.capacity == 5 and bool(r.keep.all())
    assert sorted(r.top_e[0].tolist()) == [0, 1]
    assert r.pos[:, 0].tolist() == [0, 1, 2, 3, 4]


def test_params_from_arrays_carries_moe_and_prefix_layers():
    """deepseek's layout crosses whole: the unstacked prefix layer (MLA
    and its dense MLP), the f32 router bit for bit, the stacked experts'
    bf16 bit for bit, the shared experts; a wrong expert count raises."""
    cfg = ref_smoke(MLA_MOE)
    tree = jax.tree.map(np.asarray, RModel(cfg).init(jax.random.PRNGKey(5)))
    tcfg = get_smoke_config(MLA_MOE)
    port = params_from_arrays(tree, tcfg, "cpu")
    assert len(port["prefix_layers"]) == 1
    assert set(port["prefix_layers"][0]["mixer"]) == {
        "wq", "w_dkv", "w_uk", "w_uv", "w_kr", "w_qr", "wo", "ln"}
    ffn, rffn = port["layers"][0]["ffn"], tree["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["router"].numpy().tobytes() == rffn["router"].tobytes()
    for name in ("w1", "w2", "w3"):
        assert ffn[name].dtype == torch.bfloat16
        assert ffn[name].view(torch.int16).numpy().tobytes() == \
            rffn[name].tobytes()
    assert tuple(ffn["w1"].shape) == rffn["w1"].shape == (
        2, tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.d_ff_expert)
    assert torch.equal(port["prefix_layers"][0]["ffn"]["w1"].view(
        torch.int16), torch.from_numpy(np.array(
            tree["prefix_layers"][0]["ffn"]["w1"].view(np.int16))))
    assert set(ffn["shared"]) == {"w1", "w2", "w3", "ln"}
    rffn["w2"] = rffn["w2"][:, :-1]
    with pytest.raises(ValueError, match="w2"):
        params_from_arrays(tree, tcfg, "cpu")
