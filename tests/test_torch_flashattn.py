"""K8 (flash attention) on the CPU: the port's `flash_attention` — its plain
torch version `flash_plain` on CPU tensors — against the reference's
`flash_attention` (the Pallas kernel in interpret mode) and its dense
oracle `sdpa_ref`, over the sweeps of tests/test_kernels_flash.py and
the decode kernel's tile and split cases.

Inputs are drawn with numpy from a seed and rounded to bf16 the same way
(round to nearest even) on both sides. Tolerances are the reference's
own: 2e-5 in f32, 2e-2 in bf16 (where the two frameworks round the
products and p at other places)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flashattn import flash_attention as ref_flash
from repro.kernels.flashattn.ref import sdpa_ref as ref_sdpa
from repro_torch.kernels.flashattn import ops as fa
from repro_torch.kernels.flashattn.ref import NEG, sdpa_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _dims(d):
    """(q and k's head size, v's) of a case's `d`: an int, or a pair where
    v's is smaller (MLA's (192, 128))."""
    return d if isinstance(d, tuple) else (d, d)


def _inputs(b, sq, skv, h, kvh, d, seed=0, dead_rows=0):
    """f32 numpy q/k/v, decode-style positions and ragged validity (the
    last 3 keys invalid), as the reference's tests; `dead_rows` first
    query rows placed before every key (they see no valid key); `d` as
    `_dims` reads it."""
    d, dv = _dims(d)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, dv)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(skv - sq, skv)[None], (b, sq)).copy()
    kv_pos = np.broadcast_to(np.arange(skv)[None], (b, skv)).copy()
    q_pos[:, :dead_rows] = -1
    return (q, k, v, q_pos.astype(np.int32), kv_pos.astype(np.int32),
            kv_pos < (skv - 3))


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of the same values in `dtype`."""
    q, k, v, qp, kp, kval = arrays
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx = tuple(jnp.asarray(x, jdt) for x in (q, k, v)) + tuple(
        jnp.asarray(x) for x in (qp, kp, kval))
    tx = tuple(torch.from_numpy(x).to(tdt) for x in (q, k, v)) + tuple(
        torch.from_numpy(x) for x in (qp, kp, kval))
    return jx, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _expanded(x, rep):
    return x.repeat_interleave(rep, 2) if isinstance(x, torch.Tensor) \
        else jnp.repeat(x, rep, axis=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d", [
    (2, 128, 256, 4, 2, 64),
    (1, 200, 300, 2, 1, 128),    # non-block-aligned
    (2, 1, 384, 4, 4, 64),       # decode shape
])
def test_flash_vs_reference(dtype, b, sq, skv, h, kvh, d):
    """The port == the reference's Pallas kernel and its dense oracle."""
    jx, tx = _both(_inputs(b, sq, skv, h, kvh, d), dtype)
    got = fa.flash_attention(*tx, causal=True)
    assert got.dtype == tx[0].dtype and got.shape == (b, sq, h, d)
    rep = h // kvh
    want_pallas = ref_flash(*jx, causal=True)
    want_dense = ref_sdpa(jx[0], _expanded(jx[1], rep),
                          _expanded(jx[2], rep), *jx[3:], causal=True,
                          window=None)
    tol = TOL[dtype]
    for want in (want_pallas, want_dense):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 17, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_masks(window, causal):
    jx, tx = _both(_inputs(1, 128, 256, 2, 2, 64, seed=3), "float32")
    got = fa.flash_attention(*tx, causal=causal, window=window)
    for want in (ref_flash(*jx, causal=causal, window=window),
                 ref_sdpa(*jx, causal=causal, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 70])
def test_rows_without_a_valid_key_follow_sdpa_ref(dtype, sq):
    """A query row that sees no key averages v over the Skv real keys, as
    `sdpa_ref` gives; the reference's padded Pallas path averages over
    the padded length instead, so these rows are held to `sdpa_ref`
    only (a difference inside the reference, ROADMAP Queue 3)."""
    jx, tx = _both(_inputs(2, sq, 200, 4, 2, 64, seed=5, dead_rows=1), dtype)
    got = fa.flash_attention(*tx, causal=True)
    want = ref_sdpa(jx[0], _expanded(jx[1], 2), _expanded(jx[2], 2),
                    *jx[3:], causal=True, window=None)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    mean_v = np.repeat(_np(tx[2]).mean(axis=1), 2, axis=1)
    np.testing.assert_allclose(_np(got)[:, 0], mean_v, atol=tol, rtol=tol)
    # the Pallas path pads 200 keys to 256: its row is ΣV/256, not ΣV/200
    pallas = _np(ref_flash(*jx, causal=True))[:, 0]
    np.testing.assert_allclose(pallas, mean_v * 200 / 256, atol=tol,
                               rtol=tol)
    assert np.abs(pallas - mean_v).max() > tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40)])
def test_flash_plain_vs_port_sdpa_ref(dtype, causal, window):
    """`flash_plain` == the port's own dense oracle, with GQA and ragged
    Q and KV blocks (300 and 333 rows over 128-row blocks)."""
    _, tx = _both(_inputs(2, 300, 333, 6, 2, 32, seed=9), dtype)
    got = fa.flash_plain(*tx, causal=causal, window=window)
    want = sdpa_ref(tx[0], _expanded(tx[1], 3), _expanded(tx[2], 3),
                    *tx[3:], causal=causal, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 100])
def test_masked_kv_blocks_leave_the_online_softmax_unchanged(dtype, window):
    """The rule the prefill kernel's tile skipping rests on, pinned on the
    reference's numerics (`flash_plain`, 128-key blocks). With causal
    positions, q-block i of 128 rows sees no key of kv-blocks past i, and
    with a window of 100 none of kv-blocks before i - 1; its output over
    only the blocks it may see is bit-identical to its output over all
    keys (a masked block adds p = exp(NEG - m) = 0 after a row's first
    allowed key and is wiped by alpha = exp(NEG - m_new) = 0 before it).
    A row with no allowed key is the exception: over all keys it
    averages V over every key, so cutting the keys changes it."""
    i, n = 2, 128
    q, k, v, _, kv_pos, kv_valid = _both(
        _inputs(2, 4 * n, 4 * n, 4, 2, 32, seed=13), dtype)[1]
    kv_valid = torch.ones_like(kv_valid)
    q_pos = kv_pos.clone()                     # query j at position j
    q_pos[:, i * n] = -1                       # this row sees no key
    rows = slice(i * n, (i + 1) * n)
    lo = 0 if window is None else (i - 1) * n
    keys = slice(lo, (i + 1) * n)

    def run(ks):
        return fa.flash_plain(q[:, rows], k[:, ks], v[:, ks], q_pos[:, rows],
                              kv_pos[:, ks], kv_valid[:, ks], causal=True,
                              window=window)
    full, cut = run(slice(None)), run(keys)
    assert torch.equal(full[:, 1:], cut[:, 1:])
    assert not torch.equal(full[:, 0], cut[:, 0])
    mean_v = v.float().mean(dim=1).repeat_interleave(2, 1)
    tol = TOL[dtype]
    torch.testing.assert_close(full[:, 0].float(), mean_v.to(dtype=getattr(
        torch, dtype)).float(), atol=tol, rtol=tol)


def _decode_inputs(b, skv, h, kvh, d, pos, seed):
    """Decode inputs (Sq 1): `tail` the decode-style positions of
    `_inputs` (the last 3 slots invalid), `ring` the model's ring cache
    of `skv` slots after `skv + 188` tokens (kv_pos wraps), `dead` as
    `tail` with batch row 0's query before every key."""
    arrays = _inputs(b, 1, skv, h, kvh, d, seed=seed,
                     dead_rows=int(pos == "dead"))
    if pos != "ring":
        return arrays
    from repro_torch.models.layers import _ring_positions
    index = skv + 188
    kp, kval = _ring_positions(index, skv, b, "cpu")
    qp = np.full((b, 1), index - 1, np.int32)
    return arrays[:3] + (qp, kp.numpy(), kval.numpy())


DECODE_CASES = [  # b, skv, h, kvh, d, window, pos
    (2, 300, 4, 4, 64, None, "tail"),   # Skv not a tile multiple, group 1
    (2, 50, 6, 2, 32, None, "tail"),    # less than one tile, group 3
    (1, 400, 18, 2, 32, None, "tail"),  # group 9
    (1, 260, 16, 1, 32, None, "tail"),  # group 16
    (2, 700, 4, 2, 32, 64, "tail"),     # window: tiles 0-8 see no key
    (2, 300, 4, 2, 32, None, "ring"),   # wrapped ring
    (2, 300, 6, 2, 32, 100, "dead"),    # row 0 sees no key in any tile
    (1, 300, 4, 4, (192, 128), None, "ring"),   # MLA's Dv < D, wrapped
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,h,kvh,d,window,pos", DECODE_CASES)
def test_flash_decode_vs_reference(dtype, b, skv, h, kvh, d, window, pos):
    """At Sq == 1 the port == the reference's Pallas kernel and its dense
    oracle. A row that sees no key is held to `sdpa_ref` and to the mean
    of v over the Skv keys only (the padded Pallas path averages over
    128-padded lengths, ROADMAP Queue 3). Where Dv < D the Pallas kernel
    takes v padded with zeros to D and its output is sliced back, as the
    reference's MLA calls it."""
    jx, tx = _both(_decode_inputs(b, skv, h, kvh, d, pos, seed=skv), dtype)
    got = fa.flash_attention(*tx, causal=True, window=window)
    d, dv = _dims(d)
    assert got.dtype == tx[0].dtype and got.shape == (b, 1, h, dv)
    rep = h // kvh
    wants = [ref_sdpa(jx[0], _expanded(jx[1], rep), _expanded(jx[2], rep),
                      *jx[3:], causal=True, window=window)]
    if pos != "dead":
        v_pad = jnp.pad(jx[2], ((0, 0),) * 3 + ((0, d - dv),))
        wants.append(ref_flash(jx[0], jx[1], v_pad, *jx[3:], causal=True,
                               window=window)[..., :dv])
    tol = TOL[dtype]
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    if pos == "dead":
        mean_v = np.repeat(_np(tx[2]).mean(axis=1), rep, axis=1)
        np.testing.assert_allclose(_np(got)[0, 0], mean_v[0], atol=tol,
                                   rtol=tol)


def _split_merge_decode(q, k, v, allowed, n):
    """The decode kernel's split and merge on one query row a batch row:
    each split of `n` consecutive slots with an allowed key reports its
    max m, l = sum exp(s - m) and o = p.V (p rounded to v's dtype), a
    split with none is left out; the merge weighs each by exp(m - M), M
    the largest m; with no split left the row averages v over the Skv
    slots."""
    b, _, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[-1]
    s = torch.einsum("bgrd,bkgd->bgrk", q[:, 0].view(b, kvh, h // kvh, d),
                     k) / math.sqrt(d)
    s = torch.where(allowed[:, None, None], s, NEG)
    ms, ls, os_ = [], [], []
    for j in range(0, k.shape[1], n):
        live = allowed[:, j:j + n].any(dim=1)[:, None, None]      # [B,1,1]
        m = s[..., j:j + n].amax(dim=-1)
        p = torch.exp(s[..., j:j + n] - m[..., None])
        ms.append(torch.where(live, m, -math.inf))
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype),
                                v[:, j:j + n]))
    m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os_)
    w = torch.exp(m - m.amax(dim=0).clamp(min=NEG))    # 0 for a dead split
    out = (w[..., None] * o).sum(dim=0) / torch.clamp(
        (w * l).sum(dim=0), min=1e-30)[..., None]
    mean_v = v.mean(dim=1)[:, :, None]                 # [B,KVH,1,Dv]
    out = torch.where(allowed.any(dim=1)[:, None, None, None], out, mean_v)
    return out.reshape(b, 1, h, dv)


@pytest.mark.parametrize("split", [64, 128, 832])
@pytest.mark.parametrize("b,skv,h,kvh,d,window,pos", DECODE_CASES)
def test_split_kv_merge_matches_flash_plain(b, skv, h, kvh, d, window, pos,
                                            split):
    """The rule the decode kernel's split over the cache rests on, pinned
    on the reference's numerics: in f32, merging per-split partial states
    equals `flash_plain`'s sequential online softmax within 2e-5 (only
    the order of the sums differs), with splits of one 64-key tile, of
    two, and of 13 (B 1 over 32,768 slots on an H100); leaving out the
    splits that see no key changes nothing but for a row that sees none,
    which averages v."""
    from repro_torch.kernels.flashattn.ref import attend_mask
    _, tx = _both(_decode_inputs(b, skv, h, kvh, d, pos, seed=skv + 1),
                  "float32")
    allowed = attend_mask(*tx[3:], causal=True, window=window)[:, 0]
    got = _split_merge_decode(*tx[:3], allowed, split)
    want = fa.flash_plain(*tx, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _ref_lse(jx, causal, window):
    """The rows' log-sum-exp [B, H] of a decode call, from the reference's
    numerics in numpy: the f32 scores q.k / sqrt(D) over the keys the
    reference's mask allows, -inf for a row allowed none."""
    q, k, _, qp, kp, kval = (np.asarray(x, np.float32) if i < 3
                             else np.asarray(x) for i, x in enumerate(jx))
    rep = q.shape[2] // k.shape[2]
    s = np.einsum("bhd,bkhd->bhk", q[:, 0], np.repeat(k, rep, axis=2)) \
        / math.sqrt(q.shape[-1])
    ok = kval[:, None, :] & (~causal | (kp <= qp)[:, None, :])
    if window is not None:
        ok = ok & ((qp - kp) < window)[:, None, :]
    top = np.where(ok, s, -np.inf).max(-1)
    with np.errstate(divide="ignore"):      # log(0) where none is allowed
        out = top + np.log(np.where(ok, np.exp(s - np.where(
            np.isfinite(top), top, 0)[..., None]), 0).sum(-1))
    return np.where(ok.any(-1), out, -np.inf)


@pytest.mark.parametrize("b,skv,h,kvh,d,window,pos", DECODE_CASES)
def test_decode_lse_matches_reference_logsumexp(b, skv, h, kvh, d, window,
                                                pos):
    """K8 decode's `return_lse` on the CPU (`flash_plain`): each row's
    log-sum-exp equals the reference's masked scores' within 2e-5 in f32,
    -inf exactly where a row may see no key (row 0 of "dead"); the
    output is the call's without it."""
    jx, tx = _both(_decode_inputs(b, skv, h, kvh, d, pos, seed=skv + 2),
                   "float32")
    o, lse = fa.flash_attention(*tx, causal=True, window=window,
                                return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    want = _ref_lse(jx, True, window)
    got = lse.numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=2e-5)
    assert torch.equal(o, fa.flash_attention(*tx, causal=True,
                                             window=window))
    with pytest.raises(ValueError, match="decode call"):
        fa.flash_attention(tx[0].repeat(1, 2, 1, 1), *tx[1:3],
                           tx[3].repeat(1, 2), *tx[4:], return_lse=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ranges", [2, 4])
@pytest.mark.parametrize("b,skv,h,kvh,d,window,pos", [
    (2, 300, 4, 4, 64, None, "tail"), (2, 400, 6, 2, 32, None, "ring"),
    (2, 320, 4, 2, 32, 64, "tail")])
def test_merged_slot_ranges_equal_the_whole_call(dtype, ranges, b, skv, h,
                                                 kvh, d, window, pos):
    """Context parallelism's decode merge (`merge_partials`): the cache
    cut into `ranges` slot ranges, K8 on each with its log-sum-exp, merged
    by the weights exp(lse - max), equals the whole-cache call: within
    2e-5 in f32, within 2 bf16 ulps of the largest output in bf16 (the
    ranges' outputs are rounded once more before the f32 merge; the
    card's phase holds K8 to `chip_smoke.DECODE_ULPS`, 2). The cursor is
    put before the last range, so that range holds no valid key: its lse
    is -inf and it weighs 0 (leaving it out changes nothing)."""
    from repro_torch.models.layers import _ring_positions
    _, tx = _both(_inputs(b, 1, skv, h, kvh, d, seed=ranges), dtype)
    q, k, v = tx[:3]
    n = skv // ranges
    index = skv + 57 if pos == "ring" else (ranges - 1) * n
    kp, kval = _ring_positions(index, skv, b, "cpu")
    if pos == "ring":               # the last range's slots: not yet valid
        kval[:, (ranges - 1) * n:] = False
    qp = torch.full((b, 1), index - 1, dtype=torch.int32)
    whole = fa.flash_attention(q, k, v, qp, kp, kval, window=window)
    outs, lses = [], []
    for r in range(ranges):
        sl = slice(r * n, skv if r == ranges - 1 else (r + 1) * n)
        o, lse = fa.flash_attention(q, k[:, sl], v[:, sl], qp, kp[:, sl],
                                    kval[:, sl], window=window,
                                    return_lse=True)
        outs.append(o[:, 0])
        lses.append(lse)
    assert bool(torch.isneginf(lses[-1]).all())
    got = fa.merge_partials(torch.stack(outs), torch.stack(lses))
    assert torch.equal(got, fa.merge_partials(torch.stack(outs[:-1]),
                                          torch.stack(lses[:-1])))
    ref = whole[:, 0].float()
    if dtype == "float32":
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    else:
        ulp = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)
        assert float((got.to(torch.bfloat16).float() - ref).abs().max()) \
            <= 2 * ulp


def test_merge_of_rows_with_no_valid_key_anywhere_is_zero():
    """A row whose every range reports -inf takes no NaN from the merge
    (it comes out 0); a finite range among -inf ones is taken as it is."""
    o = torch.randn(3, 2, 4, 8)
    lse = torch.full((3, 2, 4), -math.inf)
    lse[1, 1] = 0.5
    got = fa.merge_partials(o, lse)
    assert torch.equal(got[0], torch.zeros(4, 8))
    torch.testing.assert_close(got[1], o[1, 1])


def test_port_sdpa_ref_matches_reference_sdpa_ref():
    jx, tx = _both(_inputs(2, 64, 96, 4, 4, 32, seed=2), "float32")
    for causal, window in ((True, None), (False, 9)):
        np.testing.assert_allclose(
            _np(sdpa_ref(*tx, causal=causal, window=window)),
            _np(ref_sdpa(*jx, causal=causal, window=window)),
            atol=2e-6, rtol=2e-6)


def test_wrapper_counts_no_launch_on_the_cpu_and_rejects_other_devices():
    """On the CPU the plain version runs and no kernel launch is counted;
    a tensor on any other device than CPU or CUDA raises; bad shapes
    raise ValueError."""
    _, tx = _both(_inputs(1, 8, 8, 2, 2, 16), "float32")
    fa.reset_launches()
    fa.flash_attention(*tx)
    assert fa.LAUNCHES == {"flash_prefill": 0, "flash_decode": 0}
    meta = [t.to("meta") for t in tx]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_attention(*meta)
    with pytest.raises(ValueError, match="KVH must divide H"):
        fa.flash_attention(tx[0], tx[1][:, :, :1].repeat(1, 1, 3, 1),
                           tx[2][:, :, :1].repeat(1, 1, 3, 1), *tx[3:])
    with pytest.raises(ValueError, match="kv_pos"):
        fa.flash_attention(*tx[:4], tx[4][:, :5], tx[5])


def test_failed_build_raises(monkeypatch):
    """Without a working nvcc the kernel library cannot be built: the
    wrapper's loader raises instead of falling back to the plain
    version."""
    from repro_torch.kernels import build as kbuild

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kbuild, "nvcc_path", no_nvcc)
    monkeypatch.setattr(kbuild, "_target",
                        lambda name: kbuild.BUILD_DIR / "missing.so")
    monkeypatch.delitem(kbuild._LIBS, "flashattn", raising=False)
    monkeypatch.setattr(fa, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._lib()


def test_decode_group_limit_matches_kernel_source():
    """The wrapper's `MAX_GROUP` is the decode kernel's `kMaxGroup`, so the
    wrapper refuses exactly the groups the kernel cannot serve."""
    import re
    from repro_torch.kernels import build as kbuild
    src = kbuild.SOURCES["flashattn"].read_text()
    assert int(re.search(r"kMaxGroup = (\d+);", src).group(1)) \
        == fa.MAX_GROUP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,dv,pos", [
    (2, 128, 256, 4, 4, 48, 32, "tail"),    # deepseek's smoke MLA sizes
    (1, 200, 300, 2, 2, 192, 128, "tail"),  # deepseek-v2-lite's, ragged
    (2, 1, 300, 4, 4, 192, 128, "ring"),    # decode on a wrapped ring
    (2, 1, 200, 4, 2, 96, 64, "dead"),      # GQA; row 0 sees no key
])
def test_flash_with_narrower_v_matches_padded_reference(dtype, b, sq, skv,
                                                        h, kvh, d, dv, pos):
    """MLA's call: v's head dim Dv below q/k's D. The port with v
    [.., Dv] == the reference's kernel (Pallas, interpret mode) and dense
    oracle on v zero-padded to D, sliced back to Dv, as the reference's
    MLA does (the scale stays 1/sqrt(D)); a row that sees no key, as in
    `test_flash_decode_vs_reference`, against the dense oracle only."""
    arrays = _decode_inputs(b, skv, h, kvh, d, pos, seed=d + dv) \
        if sq == 1 else _inputs(b, sq, skv, h, kvh, d, seed=d + dv)
    arrays = (arrays[0], arrays[1], arrays[2][..., :dv]) + arrays[3:]
    padded = arrays[:2] + (np.concatenate(
        [arrays[2], np.zeros(arrays[2].shape[:3] + (d - dv,), np.float32)],
        axis=-1),) + arrays[3:]
    jx, _ = _both(padded, dtype)
    _, tx = _both(arrays, dtype)
    got = fa.flash_attention(*tx, causal=True)
    assert got.shape == (b, sq, h, dv) and got.dtype == tx[0].dtype
    rep = h // kvh
    wants = [ref_sdpa(jx[0], _expanded(jx[1], rep), _expanded(jx[2], rep),
                      *jx[3:], causal=True, window=None)]
    if pos != "dead":
        wants.append(ref_flash(*jx, causal=True))
    tol = TOL[dtype]
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want)[..., :dv], atol=tol,
                                   rtol=tol)
    dense = sdpa_ref(tx[0], _expanded(tx[1], rep), _expanded(tx[2], rep),
                     *tx[3:], causal=True, window=None)
    assert dense.shape == got.shape
    torch.testing.assert_close(got.float(), dense.float(), atol=tol,
                               rtol=tol)


def test_v_wider_than_k_is_rejected():
    _, tx = _both(_inputs(1, 8, 8, 2, 2, 16), "float32")
    wide = torch.cat([tx[2], tx[2]], dim=-1)
    with pytest.raises(ValueError, match="Dv <= D"):
        fa.flash_attention(tx[0], tx[1], wide, *tx[3:])
    with pytest.raises(ValueError, match="Dv <= D"):
        fa.flash_plain(tx[0], tx[1], wide[:, :4], *tx[3:])


def test_head_dim_pairs_match_kernel_source():
    """The wrapper's `HEAD_DIMS` are the (D, Dv) pairs `flashattn.cu`
    instantiates for both variants, so a CUDA call at any other pair is
    refused before it reaches the library."""
    import re
    from repro_torch.kernels import build as kbuild
    src = kbuild.SOURCES["flashattn"].read_text()
    for fn in ("flash_prefill", "flash_decode"):
        body = src[src.index(f"int {fn}("):]
        body = body[:body.index("\n}\n")]
        pairs = re.findall(r"D == (\d+) && Dv == (\d+)", body)
        assert tuple((int(a), int(b)) for a, b in pairs) == fa.HEAD_DIMS, fn
