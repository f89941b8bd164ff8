"""Sharded execution (`repro_torch.parallel.spmd`) on the CPU: exact
checks that need no reference run.

Meshes of `["cpu"] * n` (a device may repeat), one thread a point. The
shards of a tree must gather back to it bit for bit, a point's
parameter bytes must be `launch.dryrun.local_bytes` of `param_specs` and
its cache bytes `cache_spec`'s share, the collectives must count what
the formula in `spmd.py` says, a point that raises must make `run`
raise within its timeout, and the resharding
restore must place a checkpoint's leaves as their shards (the
counterpart of the reference's `test_elastic_reshard_restore`). The
parity of sharded prefill and decode with the reference's sharded run
is in tests/test_torch_spmd.py, tests/test_torch_spmd_archs.py,
tests/test_torch_spmd_mla.py, tests/test_torch_spmd_vlm.py,
tests/test_torch_spmd_ssm.py, tests/test_torch_spmd_hybrid.py,
tests/test_torch_spmd_encdec.py and, at batch 1,
tests/test_torch_spmd_b1.py, tests/test_torch_spmd_b1_mla.py and
tests/test_torch_spmd_b1_ssm.py."""
import dataclasses
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.dryrun import local_bytes
from repro_torch.launch.mesh import make_test_mesh, set_mesh
from repro_torch.models.common import abstract_params
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.parallel.sharding import P, NamedSharding

MESHES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 1, 2), ("pod", "data", "model")),
          ((4, 2), ("data", "model")))
B, T0, STEPS = 4, 12, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, axes):
    n = 1
    for k in shape:
        n *= k
    return make_test_mesh(shape, axes, devices=["cpu"] * n)


def _f32(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)


def _ways(mesh, batch):
    spec = S.batch_spec(mesh, batch)
    if spec[0] is None:
        return 1
    n = 1
    for a in S.batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _serve_calls(model, params, tok, cap, frames=None):
    """A prefill of T0 tokens, then STEPS decode steps: (the logits of
    each call, the caches). Whisper's prefill encodes `frames`, which
    are encoded once more for the decode steps, as `serve.generate`
    does."""
    lg, c = model.prefill(params, Batch(tok[:, :T0], tok[:, :T0], frames),
                          cap=cap)
    enc = model.encode(params, frames) if frames is not None else None
    out = [lg[:, -1]]
    for i in range(T0, T0 + STEPS):
        lg, c = model.decode_step(params, tok[:, i:i + 1], c, i, enc)
        out.append(lg[:, -1])
    return out, c


def _frames(cfg):
    """Whisper's stub frames [B, Se, d] (seeded), else None."""
    if cfg.frontend != "audio_stub":
        return None
    return torch.randn((B, cfg.enc_seq_len, cfg.d_model),
                       generator=torch.Generator().manual_seed(2))


@pytest.mark.parametrize("fsdp", (True, False))
@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", ("qwen1.5-4b", "mixtral-8x7b"))
def test_shard_gather_roundtrip_and_param_bytes(arch, shape, axes, fsdp):
    """gather_tree(shard_tree(x)) == x bit for bit (bf16), and every
    point holds `dryrun.local_bytes` of `param_specs`."""
    cfg = get_smoke_config(arch)
    mesh = _mesh(shape, axes)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)
    sharded = SP.shard_tree(params, specs, mesh)
    back = SP.gather_tree(sharded)
    flat_a, flat_b = [], []
    SP._map(lambda a, b: flat_a.append(a) or flat_b.append(b), params, back)
    assert len(flat_a) > 10
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = local_bytes(abstract_params(cfg), specs, mesh)
    for point in range(mesh.size):
        assert SP.tree_local_bytes(sharded, point) == want
    if mesh.shape["model"] > 1:     # something is really split
        assert want < sum(t.numel() * t.element_size() for t in flat_a)


def test_init_sharded_equals_init_then_shard():
    """Drawing each leaf straight into its shards gives the shards of
    the whole draw, bit for bit."""
    cfg = get_smoke_config("mixtral-8x7b")
    mesh = _mesh((2, 2), ("data", "model"))
    specs = S.param_specs(cfg, mesh, fsdp=True)
    model = Model(cfg)
    a = SP.init_sharded(lambda: model.init(torch.Generator().manual_seed(5)),
                        specs, mesh)
    b = SP.shard_tree(model.init(torch.Generator().manual_seed(5)), specs,
                      mesh)
    pairs = []
    SP._map(lambda x, y: pairs.append((x, y)), a, b)
    assert len(pairs) > 10
    for x, y in pairs:
        assert x.spec == y.spec and x.shape == y.shape
        for u, v in zip(x.shards, y.shards):
            assert torch.equal(u, v)


@pytest.mark.parametrize("arch,shape,batch", (
    ("qwen1.5-4b", (2, 2), B), ("qwen1.5-4b", (1, 4), B),
    ("mixtral-8x7b", (2, 2), B), ("command-r-35b", (1, 2), B),
    ("deepseek-v2-lite-16b", (2, 2), B), ("deepseek-v2-lite-16b", (1, 4), B),
    ("mamba2-370m", (2, 2), B), ("mamba2-370m", (1, 4), B),
    ("jamba-1.5-large-398b", (2, 2), B), ("whisper-base", (2, 2), B),
    ("whisper-base", (1, 4), B), ("mixtral-8x7b", (1, 4), B),
    ("minitron-4b", (1, 4), B), ("qwen1.5-4b", (2, 2), 1),
    ("qwen1.5-4b", (4, 1), 1), ("deepseek-v2-lite-16b", (2, 2), 1),
    ("deepseek-v2-lite-16b", (4, 1), 1), ("mamba2-370m", (2, 2), 1),
    ("mamba2-370m", (4, 1), 1), ("jamba-1.5-large-398b", (2, 2), 1)))
def test_cache_bytes_are_cache_spec_share(arch, shape, batch):
    """A point's caches after a prefill and decode steps of `batch` rows
    hold `cache_spec`'s local share: the port splits the kv heads where
    `cache_spec` splits head_dim and tp divides the heads, and the slots
    where it does not (mixtral's 2 and minitron's 2 kv heads on (1, 4):
    the sequence split), and at a batch the data axes do not divide the
    slots over "data" where `cache_spec` splits the KV length (batch 1 on
    (2, 2) and (4, 1)): the same bytes. MLA's latent and rope caches are
    split by their columns, a Mamba layer's conv window by its channels
    and its SSM state by its heads, as `cache_spec` splits them; at
    batch 1 MLA's by their slots over "data", every column whole, and
    the SSM state by its heads over "data" (on (4, 1) a point holding
    the whole latent or every head would hold four times the share). The
    cap, 20, divides over each mesh's axes."""
    cfg = _f32(arch)
    mesh = _mesh(shape, ("data", "model"))
    model = Model(cfg)
    params = SP.shard_tree(model.init(torch.Generator().manual_seed(0)),
                           S.param_specs(cfg, mesh, fsdp=False), mesh)
    tok = torch.randint(0, cfg.vocab_size, (batch, T0 + STEPS),
                        generator=torch.Generator().manual_seed(1))
    cap = T0 + STEPS + 5
    toks = SP.shard_leaf(tok, S.batch_spec(mesh, batch), mesh)
    frames = _frames(cfg)
    if frames is not None:
        frames = SP.shard_leaf(frames[:batch],
                               S.batch_spec(mesh, batch, 2), mesh)
    with torch.no_grad():
        out = SP.run(mesh, lambda p, t, f: serve.cache_bytes(
            _serve_calls(model, p, t, cap, f)[1]), params, toks, frames,
            batch_ways=_ways(mesh, batch), timeout=60)
    whole = model.init_cache(batch, cap, "meta")
    want = local_bytes(whole, S.cache_spec(cfg, mesh, batch), mesh)
    assert want < serve.cache_bytes(whole)
    assert out == [want] * mesh.size


def test_mla_sequence_split_cache_is_cache_spec_share():
    """deepseek's smoke config on (1, 8), which divides none of its 4
    heads, r 64 and dr 16 (MLA split by sequence), cap 24: after a
    prefill and decode steps each point's latent and rope caches hold its
    3 slots [3p, 3p + 3) over "model" at every column, cap/8 (r + dr)
    elements a row, which is `cache_spec`'s share (r and dr split 8
    ways): 1/8 of the whole cache."""
    cfg = _f32("deepseek-v2-lite-16b")
    mesh = _mesh((1, 8), ("data", "model"))
    model = Model(cfg)
    params = SP.shard_tree(model.init(torch.Generator().manual_seed(0)),
                           S.param_specs(cfg, mesh, fsdp=False), mesh)
    tok = torch.randint(0, cfg.vocab_size, (B, T0 + STEPS),
                        generator=torch.Generator().manual_seed(1))
    cap, a = 24, cfg.attn

    def point(p, t):
        c = _serve_calls(model, p, t, cap)[1]
        kv = [c["prefix"][0], c["slots"][0]]
        return serve.cache_bytes(c), [(x.axes, x.start, tuple(x.k.shape),
                                       tuple(x.v.shape)) for x in kv]
    with torch.no_grad():
        out = SP.run(mesh, point, params,
                     SP.shard_leaf(tok, S.batch_spec(mesh, B), mesh),
                     timeout=60)
    whole = model.init_cache(B, cap, "meta")
    want = local_bytes(whole, S.cache_spec(cfg, mesh, B), mesh)
    assert want * 8 == serve.cache_bytes(whole)
    reps = cfg.n_layers - 1
    for p, (nbytes, kv) in enumerate(out):
        assert nbytes == want
        assert kv == [(("model",), 3 * p, (B, 3, a.kv_lora_rank),
                       (B, 3, a.rope_head_dim)),
                      (("model",), 3 * p, (reps, B, 3, a.kv_lora_rank),
                       (reps, B, 3, a.rope_head_dim))]


def test_moe_combine_is_a_reduction_not_a_scatter(monkeypatch):
    """The MoE sums a token's k weighted expert outputs by a reduction. It
    scattered them with `index_add_`, which on CUDA adds in the order its
    atomics land, so on a model axis that splits neither the experts nor
    their d_ff (deepseek-v2-lite's 64 experts of 1,408 on (1, 3)) each
    point's replica of the MoE held other bits and the points routed the
    next layer differently (the H100's `serve-sharded-seq-mla`). Here a
    scatter-add whose terms land in the reverse order must leave the
    layer's output bit for bit as it was (deepseek's smoke config at top-4
    of its 4 experts: reversed, four f32 terms round otherwise)."""
    from repro_torch.models import layers as L
    cfg = _f32("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           top_k=4))
    stacked = Model(cfg).init(torch.Generator().manual_seed(0))
    ffn = {k: v[0] for k, v in stacked["layers"][0]["ffn"].items()
           if k != "shared"}
    ffn["shared"] = {k: v[0] for k, v in
                     stacked["layers"][0]["ffn"]["shared"].items()}
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want = L.moe(ffn, x, cfg)
    add = torch.Tensor.index_add_

    def reversed_order(self, dim, index, source, *a, **k):
        return add(self, dim, index.flip(0), source.flip(0), *a, **k)
    monkeypatch.setattr(torch.Tensor, "index_add_", reversed_order)
    assert torch.equal(L.moe(ffn, x, cfg), want)


def test_mla_sequence_split_step_matches_unsharded_step():
    """MLA's sequence split under autograd (deepseek's smoke config on
    (1, 8): 2 query rows a point of a microbatch's 16, against every
    row's gathered c_kv and k_rope; h, the gathered leaves and the
    gathered c_kv and k_rope entering the row split through `spmd.copy`),
    every point's gradient of every leaf within 1e-5 of its slice of the
    unsharded step's (tests/test_torch_spmd_train.py's check): leaving
    out any of those copies fails it."""
    from test_torch_spmd_train import check_case
    check_case("1x8", arch="deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch,shape,batch,prompt", (
    ("minitron-4b", (1, 4), B, 16), ("minitron-4b", (1, 4), B, 14),
    ("qwen1.5-4b", (2, 2), 1, 16), ("minitron-4b", (2, 4), 1, 16),
    ("deepseek-v2-lite-16b", (1, 8), B, 16),
    ("deepseek-v2-lite-16b", (1, 8), B, 12),
    ("deepseek-v2-lite-16b", (1, 3), B, 12)))
def test_context_parallel_collectives_and_k8_shapes(arch, shape, batch,
                                                    prompt):
    """A served pass (`serve.generate_sharded`: a prefill of `prompt`
    tokens, STEPS decode steps, cap 24) under the sequence split
    (minitron's 6/2 heads on (1, 4): its weights gathered, its rows' k, v
    and y gathered where 4 divides the prompt, 16 but not 14; MLA's (deepseek's 4
    heads, r 64 and dr 16 on (1, 8)), its rows' c_kv, k_rope and y
    gathered where 8 divides the prompt, 16 but not 12; on (1, 3), where
    3 splits none of its leaves, no leaf gathered), the
    length split (qwen at batch 1 on (2, 2): the decode merge over
    "data", wo summed over "model") and both (minitron at batch 1 on (2,
    4): the slots over ("data", "model")): `spmd.COMM` equals
    `spmd.serve_comm` (the formulas of spmd.py's note), K8
    runs at Sq = S/tp (every row where tp does not divide S) against the
    call's S keys, and a decode step over the point's cap/n slots; the
    logits are the unsharded pass's."""
    import chip_smoke
    from repro_torch.models import layers as L
    cfg = _f32(arch)
    mesh = _mesh(shape, ("data", "model"))
    model = Model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    params = SP.shard_tree(full, S.param_specs(cfg, mesh, fsdp=False), mesh)
    tok = torch.randint(0, cfg.vocab_size, (batch, prompt),
                        generator=torch.Generator().manual_seed(1))
    cap = 24
    SP.reset_counts()
    seen, restore = chip_smoke.record_k8_shapes(L)
    try:
        with torch.no_grad():
            got = serve.generate_sharded(model, params, tok, STEPS, cap,
                                         mesh)
    finally:
        restore()
    assert dict(SP.COMM) == SP.serve_comm(
        cfg, mesh, batch, prompt, STEPS, cap)
    tp, a = shape[1], cfg.attn
    seq = tp > 1 and (a.num_heads % tp or a.num_kv_heads % tp or (
        a.kv_lora_rank and (a.kv_lora_rank % tp or a.rope_head_dim % tp)))
    rows = prompt // tp if seq and prompt % tp == 0 else prompt
    n = 1
    for w in ([shape[0]] if batch % shape[0] else []) + ([tp] if seq
                                                          else []):
        n *= w if cap % (n * w) == 0 else 1
    calls = cfg.n_layers * mesh.size
    assert {(sq, skv): c for (sq, skv, _, _), c in seen.items()} == {
        (rows, prompt): calls, (1, cap // n): calls * STEPS}
    with set_mesh(make_test_mesh(shape)), torch.no_grad():
        want = serve.generate(model, full, tok, STEPS, cap,
                              forced=got["tokens"])
    for a, b in zip(got["logits"], want["logits"]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch,shape,batch", (
    ("deepseek-v2-lite-16b", (2, 2), 1), ("deepseek-v2-lite-16b", (4, 1), 1),
    ("mamba2-370m", (2, 2), 1), ("jamba-1.5-large-398b", (2, 2), 1),
    ("deepseek-v2-lite-16b", (2, 2), B), ("mamba2-370m", (1, 4), B)))
def test_mla_and_ssm_serve_collectives_and_k8_shapes(arch, shape, batch):
    """A served pass (`serve.generate_sharded`: a prefill of 16 tokens,
    STEPS decode steps, cap 24) of MLA, Mamba-2 and jamba's hybrid stack
    (at batch 4 too, where the data axes divide the batch):
    `spmd.COMM` equals `spmd.serve_comm` (the formulas of spmd.py's
    note: at batch 1 MLA's latent gathered a call instead of its caches
    and a decode step's partials merged over "data", the Mamba-2 mixer's
    gated output gathered over "data"; deepseek's shared experts gathered
    along their layers once a call), K8 runs at batch 1 at (16, 16) a
    prefill and over the point's cap/dp slots a decode step (at batch 4
    against the whole cache), and the logits are the unsharded pass's
    (its MoE groups the sharded run's)."""
    import chip_smoke
    from repro_torch.models import layers as L
    cfg = _f32(arch)
    mesh = _mesh(shape, ("data", "model"))
    model = Model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    params = SP.shard_tree(full, S.param_specs(cfg, mesh, fsdp=False), mesh)
    prompt, cap = 16, 24
    tok = torch.randint(0, cfg.vocab_size, (batch, prompt),
                        generator=torch.Generator().manual_seed(1))
    SP.reset_counts()
    seen, restore = chip_smoke.record_k8_shapes(L)
    try:
        with torch.no_grad():
            got = serve.generate_sharded(model, params, tok, STEPS, cap,
                                         mesh)
    finally:
        restore()
    assert dict(SP.COMM) == SP.serve_comm(
        cfg, mesh, batch, prompt, STEPS, cap)
    split = batch == 1 and cap % shape[0] == 0      # the slots, over data
    calls = mesh.size * sum(cfg.layer_kind(i) == "attn"
                            for i in range(cfg.n_layers))
    want = {(prompt, prompt if split else cap): calls,
            (1, cap // shape[0] if split else cap): calls * STEPS} \
        if calls else {}
    assert {(sq, skv): c for (sq, skv, _, _), c in seen.items()} == want
    with set_mesh(make_test_mesh(shape)), torch.no_grad():
        ref = serve.generate(model, full, tok, STEPS, cap,
                             forced=got["tokens"])
    for a, b in zip(got["logits"], ref["logits"]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def _formula(cfg, mesh, fsdp, calls):
    """spmd.py's counts for a dense-MLP model whose heads, d_ff, vocab
    and d_model all divide the axes: (all_reduce calls, all_reduce bytes,
    all_gather calls, all_gather bytes) summed over the points, for
    `calls` [(local batch rows, sequence length), ...]."""
    a, d, L = cfg.attn, cfg.d_model, cfg.n_layers
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    e = 4                                           # f32
    hq, hk, f, v = (a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim,
                    cfg.d_ff, cfg.vocab_size)
    per_layer = (2 * d * hq + 2 * d * hk + 3 * d * f) // (dp * tp)
    ar = ar_b = ag = ag_b = 0
    for b, s in calls:
        ar += 1 + 2 * L
        ar_b += (tp - 1) * e * b * s * d * (1 + 2 * L)
        ag += 1
        ag_b += (tp - 1) * e * b * (v // tp)
        if fsdp:
            ag += 7 * L + 1
            ag_b += (dp - 1) * e * (L * per_layer + d * v // (dp * tp))
    n = mesh.size
    return ar * n, ar_b * n, ag * n, ag_b * n


@pytest.mark.parametrize("fsdp", (True, False))
def test_collective_counts_match_formula(fsdp):
    cfg = _f32("qwen1.5-4b")
    mesh = _mesh((2, 2), ("data", "model"))
    model = Model(cfg)
    params = SP.shard_tree(model.init(torch.Generator().manual_seed(0)),
                           S.param_specs(cfg, mesh, fsdp=fsdp), mesh)
    tok = torch.randint(0, cfg.vocab_size, (B, T0 + STEPS),
                        generator=torch.Generator().manual_seed(1))
    toks = SP.shard_leaf(tok, S.batch_spec(mesh, B), mesh)
    SP.reset_counts()
    with torch.no_grad():
        SP.run(mesh, lambda p, t: _serve_calls(model, p, t, 32)[0], params,
               toks, batch_ways=2, timeout=60)
    got = (SP.COMM["all_reduce"], SP.COMM["all_reduce_bytes"],
           SP.COMM["all_gather"], SP.COMM["all_gather_bytes"])
    assert got == _formula(cfg, mesh, fsdp,
                           [(B // 2, T0)] + [(B // 2, 1)] * STEPS)


def _mla_formula(cfg, mesh, fsdp, calls, cap, b1=False):
    """spmd.py's counts for MLA layers that split over "model": (all_reduce
    calls, all_reduce bytes, all_gather calls, all_gather bytes) summed
    over the points, for `calls` [(local batch rows, sequence length),
    ...] against a cache of `cap` slots (None: without a cache; f32),
    made one after the other into an empty cache. With `b1` (a batch the
    data axis does not divide) the cache holds cap/dp slots at every
    column, the call's latent is gathered over "model", a decode step's
    partials are merged over "data" and any multi-token call but the
    first gathers the written slots."""
    a, d = cfg.attn, cfg.d_model
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    e, r, dr = 4, a.kv_lora_rank, a.rope_head_dim
    hq = a.num_heads * a.head_dim
    w = 2 * d * hq + a.num_heads * dr * d + d * r + d * dr + 2 * r * hq
    ar = ar_b = ag = ag_b = 0
    for i, (b, s) in enumerate(calls):
        if cap is None:
            ag += 2
            ag_b += (tp - 1) * e * (b * s * r + d * dr) // tp
        elif b1:
            ag += 2 if tp > 1 else 0
            ag_b += (tp - 1) * e * (b * s * r + d * dr) // tp
            if s == 1:          # the decode merge over "data"
                ag += 1
                ag_b += (dp - 1) * 4 * b * a.num_heads // tp \
                    * (a.head_dim + 1)
            elif i:             # the written slots over "data"
                ag += 2
                ag_b += (dp - 1) * e * b * cap * (r + dr) // dp
        else:
            ag += 3
            ag_b += (tp - 1) * e * (b * cap * (r + dr) + d * dr) // tp
        ar += 1
        ar_b += (tp - 1) * e * b * s * d
        if fsdp and dp > 1:
            ag += 7
            ag_b += (dp - 1) * e * w // (dp * tp)
    n = mesh.size
    return ar * n, ar_b * n, ag * n, ag_b * n


@pytest.mark.parametrize("shape,fsdp,cached,batch", (
    ((2, 2), True, True, B), ((2, 2), False, True, B),
    ((1, 4), False, True, B), ((2, 2), True, False, B),
    ((2, 2), False, True, 1), ((2, 2), True, "chunks", 1)))
def test_mla_layer_collectives_match_formula(shape, fsdp, cached, batch):
    """One MLA layer of deepseek's smoke config, a prefill of T0 tokens
    into its cache and STEPS decode steps on every point (or, without a
    cache, one call over all T0 + STEPS tokens, as the loss runs it):
    `spmd.COMM` against the formula of spmd.py's note (the latent and
    rope caches gathered, w_kr whole, wo's sum; FSDP's gathers), and the
    layer's output against the unsharded layer's. At batch 1 the cache
    holds each point's slots at every column: the call's latent gathered
    instead of the cache, a decode step's partials merged over "data";
    with "chunks" the prefill comes in two calls, the second of which
    gathers the written slots."""
    from repro_torch.models import layers as L
    cfg = _f32("deepseek-v2-lite-16b")
    mesh = _mesh(shape, ("data", "model"))
    model = Model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    mixer = full["prefix_layers"][0]["mixer"]
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)["prefix_layers"][0]["mixer"]
    cap = T0 + STEPS + 5
    x = torch.randn((batch, T0 + STEPS, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(T0 + STEPS)[None].expand(batch, -1).to(torch.int32)
    lens = ([T0 // 2] * 2 if cached == "chunks" else [T0]) + [1] * STEPS

    def layer(p, x, pos):
        if not cached:
            return L.attention(p, x, cfg.attn, pos, None)[0]
        c = model._empty_cache_slot("attn", x.shape[0], cap, "cpu")
        out, at = [], 0
        for n in lens:
            y, c = L.attention(p, x[:, at:at + n], cfg.attn,
                               pos[:, at:at + n], c)
            out.append(y)
            at += n
        return torch.cat(out, dim=1)
    spec = S.batch_spec(mesh, batch, 2)
    ways = _ways(mesh, batch)
    SP.reset_counts()
    with torch.no_grad():
        parts = SP.run(mesh, layer, SP.shard_tree(mixer, specs, mesh),
                       SP.shard_leaf(x, spec, mesh),
                       SP.shard_leaf(pos, S.batch_spec(mesh, batch), mesh),
                       batch_ways=ways, timeout=60)
        want = layer(mixer, x, pos)
    got = (SP.COMM["all_reduce"], SP.COMM["all_reduce_bytes"],
           SP.COMM["all_gather"], SP.COMM["all_gather_bytes"])
    b = batch // ways
    calls = [(b, n) for n in lens] if cached else [(b, T0 + STEPS)]
    assert got == _mla_formula(cfg, mesh, fsdp, calls,
                               cap if cached else None,
                               b1=bool(cached) and batch == 1)
    torch.testing.assert_close(SP.gather_results(mesh, spec, parts), want,
                               rtol=2e-5, atol=2e-5)


def _layer(tree, specs, r=0):
    """Repetition `r` of a stacked slot's leaves, and their specs with
    the stacked dim dropped."""
    return ({k: v[r] for k, v in tree.items()},
            {k: P(*tuple(v)[1:]) for k, v in specs.items()})


def _mamba_formula(cfg, mesh, fsdp, calls, b1=False):
    """spmd.py's counts for Mamba-2 layers that split over "model":
    (all_reduce calls, all_reduce bytes, all_gather calls, all_gather
    bytes) summed over the points, for `calls` [(local batch rows,
    sequence length), ...] (f32); with `b1` (a cache at batch 1, which
    the data axis does not divide) the SSM heads split over "data" and
    the gated output is gathered over it."""
    mb, d = cfg.mamba, cfg.d_model
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    e, d_inner = 4, mb.expand * d
    c = d_inner + 2 * mb.d_state
    w = d_inner + c + d_inner // mb.head_dim
    ar = ar_b = ag = ag_b = 0
    for b, s in calls:
        if tp > 1:
            ag += 2
            ag_b += (tp - 1) * e * b * s * (w + c) // tp
            ar += 1
            ar_b += (tp - 1) * e * b * s * d
        if b1:
            ag += 1
            ag_b += (dp - 1) * e * b * s * d_inner // dp
        if fsdp and dp > 1:
            ag += 2
            ag_b += (dp - 1) * e * d * (w + d_inner) // (dp * tp)
    n = mesh.size
    return ar * n, ar_b * n, ag * n, ag_b * n


@pytest.mark.parametrize("shape,fsdp,cached,batch", (
    ((2, 2), True, True, B), ((2, 2), False, True, B),
    ((1, 4), False, True, B), ((2, 2), True, False, B),
    ((2, 2), False, True, 1), ((4, 1), True, True, 1)))
def test_mamba_layer_collectives_match_formula(shape, fsdp, cached, batch):
    """One Mamba-2 layer of mamba2-370m's smoke config, a prefill of T0
    tokens into its cache and STEPS decode steps on every point (or,
    without a cache, one call over all T0 + STEPS tokens, as the loss
    runs it): `spmd.COMM` against the formula of spmd.py's note (in_proj's
    output and the conv's gathered, out_proj's sum; FSDP's gathers; at
    batch 1 the gated output gathered over "data"), each point's conv
    and SSM caches `cache_spec`'s share, and the layer's output against
    the unsharded layer's."""
    from repro_torch.launch.dryrun import local_bytes as lb
    from repro_torch.models import layers as L
    cfg = _f32("mamba2-370m")
    mesh = _mesh(shape, ("data", "model"))
    model = Model(cfg)
    mixer, specs = _layer(
        model.init(torch.Generator().manual_seed(0))["layers"][0]["mixer"],
        S.param_specs(cfg, mesh, fsdp=fsdp)["layers"][0]["mixer"])
    x = torch.randn((batch, T0 + STEPS, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def layer(p, x):
        if not cached:
            return L.mamba2(p, x, cfg.mamba)[0], 0
        c = model._empty_cache_slot("mamba", x.shape[0], 1, "cpu")
        y, c = L.mamba2(p, x[:, :T0], cfg.mamba, c)
        out = [y]
        for i in range(T0, T0 + STEPS):
            y, c = L.mamba2(p, x[:, i:i + 1], cfg.mamba, c)
            out.append(y)
        return torch.cat(out, dim=1), serve.cache_bytes(
            {"prefix": [c], "slots": []})
    spec = S.batch_spec(mesh, batch, 2)
    ways = _ways(mesh, batch)
    SP.reset_counts()
    with torch.no_grad():
        parts = SP.run(mesh, layer, SP.shard_tree(mixer, specs, mesh),
                       SP.shard_leaf(x, spec, mesh), batch_ways=ways,
                       timeout=60)
        want = layer(mixer, x)[0]
    got = (SP.COMM["all_reduce"], SP.COMM["all_reduce_bytes"],
           SP.COMM["all_gather"], SP.COMM["all_gather_bytes"])
    b = batch // ways
    calls = [(b, T0)] + [(b, 1)] * STEPS if cached else [(b, T0 + STEPS)]
    assert got == _mamba_formula(cfg, mesh, fsdp, calls,
                                 b1=bool(cached) and batch == 1)
    torch.testing.assert_close(SP.gather_results(
        mesh, spec, [y for y, _ in parts]), want, rtol=2e-5, atol=2e-5)
    if cached:
        whole = model.init_cache(batch, 1, "meta")  # stacked [n_reps]
        share = lb(whole, S.cache_spec(cfg, mesh, batch), mesh) \
            // model.n_reps
        assert share < serve.cache_bytes(whole) // model.n_reps
        assert [n for _, n in parts] == [share] * mesh.size


def _whisper_formula(cfg, mesh, fsdp, calls, frames):
    """spmd.py's counts for whisper whose heads and d_ff split over
    "model" and whose vocabulary does not (whole on every point: no
    embedding sum, no logits gather): (all_reduce calls, all_reduce
    bytes, all_gather calls, all_gather bytes) summed over the points,
    for decoder `calls` [(local batch rows, sequence length), ...] and
    encoder calls `frames` [(local batch rows, frames), ...] (f32)."""
    a, d, v = cfg.attn, cfg.d_model, cfg.vocab_size
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    e, f = 4, cfg.d_ff
    hq, hk = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    attn = 2 * d * hq + 2 * d * hk
    ar = ar_b = ag = ag_b = 0
    gather = fsdp and dp > 1
    for b, se in frames:
        ag += 1
        ag_b += (tp - 1) * e * b * se * d // tp
        ar += 2 * cfg.n_enc_layers
        ar_b += 2 * cfg.n_enc_layers * (tp - 1) * e * b * se * d
        if gather:
            ag += 1 + 6 * cfg.n_enc_layers
            ag_b += (dp - 1) * e * (d * d + cfg.n_enc_layers
                                    * (attn + 2 * d * f)) // (dp * tp)
    for b, s in calls:
        ar += 3 * cfg.n_layers
        ar_b += 3 * cfg.n_layers * (tp - 1) * e * b * s * d
        if gather:
            ag += 10 * cfg.n_layers + 1
            ag_b += (dp - 1) * e * (cfg.n_layers * (2 * attn + 2 * d * f)
                                    // (dp * tp) + d * v // dp)
    n = mesh.size
    return ar * n, ar_b * n, ag * n, ag_b * n


@pytest.mark.parametrize("fsdp", (True, False))
def test_whisper_collectives_match_formula(fsdp):
    """whisper's smoke config with a vocabulary of 515 rows, which 2 does
    not divide (as whisper-base's 51,865 divides neither 2 nor 4), on
    (2, 2): the embedding and the LM head stay whole (a plain lookup, no
    logits gather), `spmd.COMM` of a prefill (which encodes), an encode
    and STEPS decode steps against the formula of spmd.py's note, and
    the logits against the unsharded run's."""
    cfg = dataclasses.replace(_f32("whisper-base"), vocab_size=515)
    mesh = _mesh((2, 2), ("data", "model"))
    model = Model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)
    assert specs["embed"] == P(None, None)
    assert specs["unembed"] == (P("data", None) if fsdp else P(None, None))
    tok = torch.randint(0, cfg.vocab_size, (B, T0 + STEPS),
                        generator=torch.Generator().manual_seed(1))
    frames = _frames(cfg)
    SP.reset_counts()
    with torch.no_grad():
        parts = SP.run(mesh, lambda p, t, f: _serve_calls(model, p, t, 32,
                                                          f)[0],
                       SP.shard_tree(full, specs, mesh),
                       SP.shard_leaf(tok, S.batch_spec(mesh, B), mesh),
                       SP.shard_leaf(frames, S.batch_spec(mesh, B, 2), mesh),
                       batch_ways=2, timeout=60)
        want = _serve_calls(model, full, tok, 32, frames)[0]
    got = (SP.COMM["all_reduce"], SP.COMM["all_reduce_bytes"],
           SP.COMM["all_gather"], SP.COMM["all_gather_bytes"])
    b = B // 2
    assert got == _whisper_formula(
        cfg, mesh, fsdp, [(b, T0)] + [(b, 1)] * STEPS,
        [(b, cfg.enc_seq_len)] * 2)
    spec = S.batch_spec(mesh, B)
    for i, w in enumerate(want):
        torch.testing.assert_close(SP.gather_results(
            mesh, spec, [p[i] for p in parts]), w, rtol=2e-4, atol=2e-4)


def _respec(specs, names, tail):
    """`specs` with each leaf named in `names` split by `tail` over its
    last dims (its stacked leading dims whole)."""
    if isinstance(specs, dict):
        return {k: P(*(None,) * (len(v) - len(tail)), *tail)
                if k in names and isinstance(v, P)
                else _respec(v, names, tail) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_respec(v, names, tail) for v in specs]
    return specs


# (arch, [(leaves, their new split over the last dims)]): an FSDP entry
# on the embedding, the MLP replicated, and the MoE's d_ff split inside
# each expert where the policy splits the experts
RESPECS = (("qwen1.5-4b", [(("embed",), ("model", "data"))]),
           ("qwen1.5-4b", [(("w1", "w2", "w3"), (None, None))]),
           ("mixtral-8x7b", [(("w1", "w3"), (None, None, "model")),
                             (("w2",), (None, "model", None))]))


@pytest.mark.parametrize("case", range(len(RESPECS)))
def test_layers_follow_the_leaf_spec(case):
    """The layer library reads each leaf's split from its spec: a spec
    tree other than `param_specs`'s gives the unsharded logits, and a
    spec that leaves attention's heads whole where they split raises."""
    arch, moves = RESPECS[case]
    cfg = _f32(arch)
    mesh = _mesh((2, 2), ("data", "model"))
    model = Model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    specs = S.param_specs(cfg, mesh, fsdp=True)
    for names, tail in moves:
        specs = _respec(specs, names, tail)
    tok = torch.randint(0, cfg.vocab_size, (B, T0 + STEPS),
                        generator=torch.Generator().manual_seed(1))
    spec = S.batch_spec(mesh, B)
    with torch.no_grad():
        with set_mesh(make_test_mesh((2, 2))):     # the same MoE groups
            want = _serve_calls(model, full, tok, 32)[0]
        parts = SP.run(mesh, lambda p, t: _serve_calls(model, p, t, 32)[0],
                       SP.shard_tree(full, specs, mesh),
                       SP.shard_leaf(tok, spec, mesh), batch_ways=2,
                       timeout=60)
    for i, w in enumerate(want):
        got = SP.gather_results(mesh, spec, [p[i] for p in parts])
        torch.testing.assert_close(got, w, rtol=2e-4, atol=3e-4)
    bad = SP.shard_tree(full, _respec(specs, ("wq",), (None, None)), mesh)
    with pytest.raises(ValueError, match="wq's spec"):
        with torch.no_grad():
            SP.run(mesh, lambda p, t: _serve_calls(model, p, t, 32)[0],
                   bad, SP.shard_leaf(tok, spec, mesh), batch_ways=2,
                   timeout=60)


def test_collectives_sum_in_shard_order_into_new_tensors():
    """all_reduce: every point of a group gets the same bits, a tensor
    of its own (also in a group of one); all_gather: shard order."""
    mesh = _mesh((2, 3), ("data", "model"))

    def fn():
        ctx = SP.context()
        x = torch.full((5,), float(ctx.point) + 0.1, dtype=torch.float32)
        one = SP.all_reduce(x, "pod")           # no such axis: size 1
        return (x, one, SP.all_reduce(x, "model"),
                SP.all_gather(x[:1], ("data", "model"), 0),
                SP.all_gather(x[:1], "data", 0))
    out = SP.run(mesh, fn, timeout=30)
    for point, (x, one, red, everyone, col) in enumerate(out):
        assert one.data_ptr() != x.data_ptr() and torch.equal(one, x)
        row = point // 3
        want = torch.zeros(5)
        for q in range(3 * row, 3 * row + 3):
            want += torch.full((5,), float(q) + 0.1)
        assert torch.equal(red, want)
        assert torch.equal(everyone, torch.arange(6) + 0.1)
        assert torch.equal(col, torch.tensor([point % 3, point % 3 + 3])
                           + 0.1)


def test_collective_stress_with_many_points():
    """16 points (more than this host's cores) on one rendezvous, the
    interpreter switching threads every microsecond: every sum is exact
    and the counts are what the calls make."""
    mesh = _mesh((4, 4), ("data", "model"))
    rounds = 40
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    SP.reset_counts()
    try:
        def fn():
            p = SP.context().point
            total = []
            for r in range(rounds):
                total.append(SP.all_reduce(torch.tensor([p + r]),
                                           ("data", "model")).item())
            return total
        out = SP.run(mesh, fn, timeout=60)
    finally:
        sys.setswitchinterval(prev)
    want = [sum(range(16)) + 16 * r for r in range(rounds)]
    assert out == [want] * 16
    assert SP.COMM["all_reduce"] == 16 * rounds
    assert SP.COMM["all_reduce_bytes"] == 16 * rounds * 15 * 8


def test_a_split_stacked_dim_is_gathered_once_a_call():
    """A stacked leaf whose layer dim is split over "model" (as the rules
    split deepseek's shared experts): `spmd.index` refuses it, the
    backbone's `_stacked` all-gathers it once (counted), and every layer
    taken from that is the whole leaf's; under autograd a point's
    gradient is its slice of the layers' gradient, summed over the data
    shards by `data_parallel_sum`."""
    from repro_torch.models.model import _stacked
    mesh = _mesh((2, 2), ("data", "model"))
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    leaf = SP.shard_leaf(full, P("model", None), mesh)

    def fn(t):
        t = SP.like(t.detach().requires_grad_(), t)
        with pytest.raises(ValueError, match="stacked dim is split"):
            SP.index(t, 0)
        st = _stacked({"w": t})["w"]
        layers = [SP.index(st, r) for r in range(4)]
        loss = sum((r + 1) * layers[r].sum() for r in range(4))
        g, = torch.autograd.grad(loss, t)
        return [x.detach() for x in layers], SP.data_parallel_sum(g, t)
    SP.reset_counts()
    out = SP.run(mesh, fn, leaf, batch_ways=2, timeout=30)
    assert SP.COMM["all_gather"] == 4
    assert SP.COMM["all_gather_bytes"] == 4 * 2 * 6 * 4  # the other half
    for point, (layers, g) in enumerate(out):
        for r in range(4):
            assert torch.equal(layers[r], full[r])
        m = point % 2                   # the point's two layers, 2m, 2m + 1
        want = torch.stack([torch.full((6,), 2.0 * (2 * m + 1)),
                            torch.full((6,), 2.0 * (2 * m + 2))])
        assert torch.equal(g, want)


def test_run_raises_the_first_error_within_its_timeout():
    mesh = _mesh((2, 2), ("data", "model"))

    def fn():
        if SP.context().point == 2:
            raise ValueError("point 2 fails")
        return SP.all_reduce(torch.ones(3), "model")
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="point 2 fails"):
        SP.run(mesh, fn, timeout=5.0)
    assert time.monotonic() - t0 < 5.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-point")]


def test_run_fails_a_rendezvous_that_waits_past_its_timeout():
    """A point that leaves out a collective: the others' rendezvous
    times out and `run` raises instead of hanging."""
    mesh = _mesh((1, 3), ("data", "model"))

    def fn():
        if SP.context().point == 0:
            return None
        return SP.all_gather(torch.ones(1), "model", 0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed or timed out"):
        SP.run(mesh, fn, timeout=0.5)
    assert time.monotonic() - t0 < 3.0


def test_collective_outside_run_raises():
    with pytest.raises(RuntimeError, match="only inside spmd.run"):
        SP.all_reduce(torch.ones(2), "model")


@pytest.mark.parametrize("arch", ("qwen1.5-4b", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b",
                                  "llava-next-mistral-7b", "mamba2-370m",
                                  "jamba-1.5-large-398b", "whisper-base"))
def test_serve_config_on_a_mesh_matches_unsharded(arch):
    """The launcher on a (2, 2) mesh (parameters drawn straight into
    shards) against the unsharded launcher under the same ambient
    abstract mesh (the MoE's groups): the same greedy tokens, logits
    within the model tests' 2e-4 in f32; per device the parameter and
    cache bytes of its four points."""
    cfg = _f32(arch)
    mesh = _mesh((2, 2), ("data", "model"))
    got = serve.serve_config(cfg, B, T0, STEPS, "cpu", mesh=mesh)
    with set_mesh(make_test_mesh((2, 2))):
        ref = serve.serve_config(cfg, B, T0, STEPS, "cpu")
    assert torch.equal(got["tokens"], ref["tokens"])
    for a, b in zip(got["logits"], ref["logits"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    assert got["fsdp"] is False
    row = got["device_bytes"]["cpu"]
    specs = S.param_specs(cfg, mesh, fsdp=False)
    assert row["points"] == 4 and row["peak"] is None
    assert row["params"] == 4 * local_bytes(abstract_params(cfg), specs,
                                            mesh)
    whole = Model(cfg).init_cache(B, got["cap"], "meta")
    assert row["caches"] == 4 * local_bytes(
        whole, S.cache_spec(cfg, mesh, B), mesh)


@pytest.mark.parametrize("arch", ("mamba2-370m", "jamba-1.5-large-398b",
                                  "whisper-base"))
def test_serve_config_on_1x4_matches_unsharded(arch):
    """The launcher on (1, 4): the Mamba-2 mixers split four ways (jamba's
    2 kv heads leave its attention gathered), whisper one head a point;
    the same greedy tokens as unsharded, logits within 2e-4 in f32."""
    cfg = _f32(arch)
    got = serve.serve_config(cfg, B, T0, STEPS, "cpu",
                             mesh=_mesh((1, 4), ("data", "model")))
    with set_mesh(make_test_mesh((1, 4))):
        ref = serve.serve_config(cfg, B, T0, STEPS, "cpu")
    assert torch.equal(got["tokens"], ref["tokens"])
    for a, b in zip(got["logits"], ref["logits"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_parse_mesh():
    m = serve.parse_mesh("2x1x2", "cpu")
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 1, "model": 2}
    assert [str(d) for d in m.devices] == ["cpu"] * 4
    assert serve.parse_mesh("1x4", "cpu").axis_names == ("data", "model")
    with pytest.raises(ValueError):
        serve.parse_mesh("4", "cpu")


def test_elastic_reshard_restore(tmp_path):
    """The reference's test of the same name: a tree saved whole,
    restored onto a (4, 2) mesh with `w` over ("data", "model")."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "s": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(5, tree)
    mesh = _mesh((4, 2), ("data", "model"))
    sh = {"w": NamedSharding(mesh, P("data", "model")),
          "s": NamedSharding(mesh, P())}
    step, out = mgr.restore_latest(tree, sh)
    assert step == 5
    assert out["w"].spec == P("data", "model")
    assert torch.equal(SP.gather_leaf(out["w"]), tree["w"])
    for point in range(8):
        d, m = divmod(point, 2)
        assert torch.equal(out["w"].shards[point],
                           tree["w"][2 * d:2 * d + 2, 4 * m:4 * m + 4])
        assert torch.equal(out["s"].shards[point], tree["s"])
    # without shardings the restore keeps today's behaviour
    plain = mgr.restore(5, tree)
    assert torch.equal(plain["w"], tree["w"])


@pytest.mark.parametrize("shape,axes", MESHES[:3])
def test_smoke_sharded_check_replays_each_points_routes(shape, axes):
    """`chip_smoke.sharded_gap` (path `serve-sharded`'s check) at
    mixtral's smoke config in f32 with binding capacity: each point
    replays its own rows of the unsharded run's routes (rows of other
    tokens would route them elsewhere), so the two agree within 1e-4;
    routing on its own, each point's routing is the unsharded run's
    (`sharded_route_check`)."""
    import chip_smoke
    from repro_torch.models import layers as L
    cfg = _f32("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    mesh = _mesh(shape, axes)
    routes, restore = chip_smoke.record_routes(L)
    try:
        with set_mesh(make_test_mesh(shape, axes)):
            ref = serve.serve_config(cfg, B, T0, STEPS, "cpu")
    finally:
        restore()
    res = serve.serve_config(cfg, B, T0, STEPS, "cpu", mesh=mesh)
    inner = L.moe_route
    gap = chip_smoke.sharded_gap(torch, L, SP, serve, ref, res["model"],
                                 res["params"], mesh, routes, replay=True)
    assert L.moe_route is inner
    assert gap["routes_replayed"] and len(gap["steps"]) == STEPS + 1
    assert gap["max_abs"] < 1e-4 and gap["argmax_agreement"] == 1.0
    free = chip_smoke.sharded_gap(torch, L, SP, serve, ref, res["model"],
                                  res["params"], mesh, routes)
    assert L.moe_route is inner and not free["routes_replayed"]
    assert free["routes_consistent"], free["route_faults"]
    assert free["route_choices"] == B * (T0 + STEPS) * cfg.n_layers
    assert free["route_differing_share"] == 0.0
    assert free["route_groups_compared"] > 0


def test_smoke_sharded_check_feeds_the_patches():
    """`chip_smoke.sharded_gap` (path `serve-sharded-llava`'s check) at
    llava's smoke config in f32 on (2, 2): the sharded model fed the
    unsharded run's patches and tokens agrees within 1e-4; fed other
    patches, it does not."""
    import chip_smoke
    from repro_torch.models import layers as L
    cfg = _f32("llava-next-mistral-7b")
    mesh = _mesh((2, 2), ("data", "model"))
    with set_mesh(make_test_mesh((2, 2))):
        ref = serve.serve_config(cfg, B, T0, STEPS, "cpu")
    res = serve.serve_config(cfg, B, T0, STEPS, "cpu", mesh=mesh)
    gap = chip_smoke.sharded_gap(torch, L, SP, serve, ref, res["model"],
                                 res["params"], mesh)
    assert gap["max_abs"] < 1e-4 and gap["argmax_agreement"] == 1.0
    other = dict(ref, extra=torch.flip(ref["extra"], (1,)))
    assert chip_smoke.sharded_gap(torch, L, SP, serve, other, res["model"],
                                  res["params"], mesh)["max_abs"] > 1e-2


def test_points_take_turns_between_rendezvous():
    """Only the point holding the turn runs its Python between two
    rendezvous (16 points, a thread switch every microsecond): the count
    of points inside a segment never exceeds one."""
    mesh = _mesh((4, 4), ("data", "model"))
    inside, most, lock = [0], [0], threading.Lock()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def segment():
        with lock:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.001)               # lets the interpreter lock go
        with lock:
            inside[0] -= 1

    def fn():
        for _ in range(10):
            segment()
            SP.all_reduce(torch.ones(1), "model")
        segment()
    try:
        SP.run(mesh, fn, timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert most[0] == 1
