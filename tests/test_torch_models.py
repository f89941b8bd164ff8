"""The LM serving path of the port (`repro_torch.models`) against the
reference (`repro.models`) on the CPU.

The same weights (the reference's init, carried across with
`repro_torch.interop.params_from_arrays`) and the same tokens (numpy,
from a seed) go through both packages. Logits are compared in f32 smoke
configs — bf16 rounds at other places in the two frameworks, so the
algorithm is compared in f32 (as tests/test_models.py does) — at the
reference's tolerances: 2e-4 for the prefill, 3e-4 for each decode step.
The reference initialises the QKV biases to zero, so the tests set them,
on both sides, to random values that exercise the bias path."""
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
                            ("minitron-4b", "flash")])
def test_prefill_and_decode_match_reference(arch, name, backend):
    """Prefill logits, then teacher-forced decode logits step by step: the
    port == the reference, both on the same attention backend ("auto":
    the dense path; "flash": the reference's Pallas kernel in interpret
    mode, the port's `flash_plain`)."""
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
    assert tc["slots"][0].index == S


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
    arch = "qwen1.5-4b"
    backend("flash")
    rcfg = ref_smoke(arch)
    assert rcfg.dtype == jnp.bfloat16
    rm = RModel(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    mixer = tree["layers"][0]["mixer"]
    for name in ("bq", "bk", "bv"):      # zero at init: exercise the path
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


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minitron-4b"])
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
    h, _ = m.backbone(params, m.embed_inputs(params, Batch(tokens, tokens)),
                      pos)
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


@pytest.mark.parametrize("arch", DENSE)
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
