"""Sharded serving (`repro_torch.parallel.spmd`) on NVIDIA GPUs.

Imports torch, numpy and `repro_torch` only (no jax, no reference
package), so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spmd_gpu.py

Every test carries the `gpu` marker and skips, with a reason, where
`torch.cuda.is_available()` is false; a mesh across cards skips with
fewer cards than points (run it on a host with four). The sharded
model is held against the same model unsharded on the same weights and
tokens, fed the unsharded run's greedy tokens (teacher forcing), under
the mesh's abstract twin (the MoE's groups). Small configs at K8's head
size 128: bf16 with K8 on every point's heads, within bounds measured
on the CPU with K8's plain version (`BF16_MAX_ABS`); a MoE in f32 with
dense attention ("auto"), within the model tests' 2e-4 / 3e-4. Then four
zoo configs at their published widths (`ZOO`): deepseek-v2-lite-16b's
MLA (K8 at (192, 128) on each point's heads, the latent and rope caches
gathered) and llava-next-mistral-7b's patch prefix, cut in depth, and
mamba2-370m's Mamba-2 mixers and whisper-base's encoder and
cross-attention, uncut, in bf16 with the routing replayed for deepseek
(`chip_smoke.sharded_gap`), within bounds measured the same way
(`ZOO_BOUNDS`). Last, context parallelism: K8 decode's log-sum-exp
against `flash_plain`'s on the card, slot ranges merged against the
whole-cache call, and qwen1.5-4b at published widths cut to 2 layers on
(1, 8) of one card (its 20 heads split by sequence) against the same
model unsharded (`CP_BOUNDS`); deepseek-v2-lite-16b at batch 1 on (2, 2),
its latent split by slots over "data" (`B1_MLA_BOUNDS`), and cut to 1
layer on (1, 3), its MLA split by sequence (`SEQ_MLA_BOUNDS`). A served
pass's collectives (`spmd.COMM`) on (2, 2) of one card equal one point's
pass counted on the meta device (`launch.collectives.count_serve`)
times the points."""
import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels.flashattn import ops as fa
from repro_torch.launch import serve
from repro_torch.launch.dryrun import local_bytes
from repro_torch.launch.mesh import make_test_mesh, set_mesh
from repro_torch.models import layers as L
from repro_torch.models.common import (
    AttnConfig, ModelConfig, MoEConfig, abstract_params,
)
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: 4 layers, d_model 1024, 8/4 heads of 128, d_ff 2048, vocab 8192
DENSE = ModelConfig(
    name="dense-gpu", d_model=1024, n_layers=4, vocab_size=8192, d_ff=2048,
    attn=AttnConfig(num_heads=8, num_kv_heads=4, head_dim=128),
    act="swiglu", norm="rmsnorm")
#: the same with 4 experts top-2 of 1024 (capacity 1.25: it binds) and a
#: window of 64
MOE = dataclasses.replace(
    DENSE, name="moe-gpu",
    attn=dataclasses.replace(DENSE.attn, sliding_window=64),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=1024,
                  capacity_factor=1.25))
B, S_LEN, G = 4, 96, 6
#: bf16 gap of the sharded run from the unsharded one, fed the same
#: tokens: measured on the CPU (K8's plain version, `_forced_gap` on
#: ["cpu"] * n, DENSE) at max |d| 0.0391 and mean 0.0067 on (2, 2),
#: 0.0432 and 0.0067 on (1, 2). The bounds leave about three times
#: that (cuBLAS rounds elsewhere than the CPU); a wrong head, shard or
#: sum moves the logits (std 0.64) by their own scale
BF16_MAX_ABS, BF16_MEAN_ABS = 0.12, 0.02
#: arch -> the layers its published config is cut to: deepseek's dense
#: first layer and two MoE layers (so the shared experts' two stacked
#: layers split one a point over "model"), llava's first four;
#: mamba2-370m and whisper-base uncut
ZOO = {"deepseek-v2-lite-16b": 3, "llava-next-mistral-7b": 4,
       "mamba2-370m": 48, "whisper-base": 6}
#: arch -> (max |d|, mean |d|) bounds of its bf16 gap from the unsharded
#: run (`_zoo_gap`), measured on the CPU (K8's plain version, `_zoo_gap`
#: on ["cpu"] * 4 at B, S_LEN and G) at max |d| 0.0625 and mean 0.0088
#: (deepseek, routing replayed), 0.109 and 0.0163 (llava, its 576
#: patches first), 0.184 and 0.0302 (mamba2, its mixers' two gathers
#: and out_proj's sum) and 0.0195 and 0.0029 (whisper, its 1500 stub
#: frames); the bounds leave about three times that, as `BF16_MAX_ABS`
#: does
ZOO_BOUNDS = {"deepseek-v2-lite-16b": (0.19, 0.027),
              "llava-next-mistral-7b": (0.33, 0.05),
              "mamba2-370m": (0.55, 0.09), "whisper-base": (0.06, 0.009)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _forced_gap(cfg, mesh, device, backend="flash"):
    """(the sharded run's logits fed the unsharded greedy run's tokens,
    the unsharded run's logits, the sharded serve result)."""
    with L.attention_backend(backend):
        with set_mesh(make_test_mesh(mesh.axis_sizes, mesh.axis_names)):
            ref = serve.serve_config(cfg, B, S_LEN, G, device)
        res = serve.serve_config(cfg, B, S_LEN, G, device, mesh=mesh)
        tf = serve.generate_sharded(res["model"], res["params"],
                                    ref["prompt"], G, ref["cap"], mesh,
                                    forced=ref["tokens"])
    return tf["logits"], ref["logits"], res


def test_dense_bf16_on_one_card_matches_unsharded(cuda):
    """(2, 2) over cuda:0 x 4: K8 launches once a layer a point a call,
    each point holds `dryrun.local_bytes`, and the forced logits lie
    within the bf16 bounds."""
    mesh = make_test_mesh((2, 2), devices=[cuda] * 4)
    fa.reset_launches()
    got, want, res = _forced_gap(DENSE, mesh, cuda)
    # the unsharded run's two passes, the sharded run's two, the forced
    n = DENSE.n_layers
    assert fa.LAUNCHES["flash_prefill"] == 2 * n + 3 * 4 * n
    assert fa.LAUNCHES["flash_decode"] == (2 * n + 3 * 4 * n) * G
    specs = S.param_specs(DENSE, mesh, fsdp=res["fsdp"])
    per_point = local_bytes(abstract_params(DENSE), specs, mesh)
    for point in range(4):
        assert SP.tree_local_bytes(res["params"], point) == per_point
        leaf = res["params"]["layers"][0]["mixer"]["wq"]
        assert leaf.shards[point].device == cuda
    assert res["device_bytes"][str(cuda)]["params"] == 4 * per_point
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        assert bool(torch.isfinite(a).all())
        assert float(d.max()) <= BF16_MAX_ABS and \
            float(d.mean()) <= BF16_MEAN_ABS, (float(d.max()),
                                               float(d.mean()))


@pytest.mark.parametrize("cfg,batch", ((DENSE, B), (MOE, B), (DENSE, 1)),
                         ids=("dense", "moe", "dense-b1"))
def test_collectives_on_one_card_are_the_count(cfg, batch, cuda):
    """A served pass (`serve.generate_sharded`, K8 on every point's heads)
    on (2, 2) of cuda:0 x 4: its `spmd.COMM` is one point's pass counted
    on the meta device (`collectives.count_serve`) times the points; at
    batch 1 too, where the cache's slots split over "data"."""
    from repro_torch.launch import collectives
    mesh = make_test_mesh((2, 2), devices=[cuda] * 4)
    model = Model(cfg)
    params = SP.init_sharded(
        lambda: model.init(torch.Generator(device=cuda).manual_seed(0)),
        S.param_specs(cfg, mesh, fsdp=False), mesh)
    prompt = torch.randint(0, cfg.vocab_size, (batch, S_LEN), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    cap = S_LEN + G + 4
    SP.reset_counts()
    with torch.no_grad():
        serve.generate_sharded(model, params, prompt, G, cap, mesh)
    one = collectives.count_serve(cfg, mesh, batch, S_LEN, G, cap, False)
    assert dict(SP.COMM) == {k: one[k] * mesh.size for k in SP.COMM}


def test_moe_f32_on_one_card_matches_unsharded(cuda):
    """Expert-parallel MoE with binding capacity and a window, f32 and
    dense attention (K8 takes bf16 only), on (2, 2) of cuda:0 x 4."""
    mesh = make_test_mesh((2, 2), devices=[cuda] * 4)
    cfg = dataclasses.replace(MOE, dtype=torch.float32)
    got, want, _ = _forced_gap(cfg, mesh, cuda, backend="auto")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-4)


def test_mesh_over_two_cards_matches_unsharded(cuda):
    """(1, 2) over cuda:0 and cuda:1: the shards live on their cards, the
    collectives are peer copies."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_test_mesh((1, 2), devices=["cuda:0", "cuda:1"])
    got, want, res = _forced_gap(DENSE, mesh, cuda)
    wq = res["params"]["layers"][0]["mixer"]["wq"]
    assert [str(t.device) for t in wq.shards] == ["cuda:0", "cuda:1"]
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        assert float(d.max()) <= BF16_MAX_ABS and \
            float(d.mean()) <= BF16_MEAN_ABS


def test_mixtral_uncut_on_four_cards(cuda):
    """mixtral-8x7b uncut (32 layers, 93.4 GB of bf16) on (1, 4) over
    cuda:0..3 through `tools/serve_sharded.py` at a short prompt: finite
    logits, K8 once a layer a point a call, each card's parameter bytes
    `dryrun.local_bytes` of `param_specs`."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    spec = importlib.util.spec_from_file_location(
        "serve_sharded", ROOT / "tools" / "serve_sharded.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.run("mixtral-8x7b", "1x4", batch=2, prompt_len=512,
                   gen_tokens=4)
    assert out["finite"] and out["launches_ok"]
    for row in out["devices"].values():
        assert row["params"] == row["params_reckoned"]


def _zoo_gap(cfg, mesh, device, batch=B):
    """(`chip_smoke.sharded_gap` of `cfg` sharded over `mesh` against its
    unsharded greedy run of `batch` rows, the routing replayed for a MoE;
    the sharded serve result)."""
    import chip_smoke
    moe = cfg.moe is not None
    routes, restore = chip_smoke.record_routes(L) if moe else (None, None)
    try:
        with set_mesh(make_test_mesh(mesh.axis_sizes, mesh.axis_names)):
            ref = serve.serve_config(cfg, batch, S_LEN, G, device)
    finally:
        if restore:
            restore()
    res = serve.serve_config(cfg, batch, S_LEN, G, device, mesh=mesh)
    gap = chip_smoke.sharded_gap(torch, L, SP, serve, ref, res["model"],
                                 res["params"], mesh, routes, replay=moe)
    return gap, res


@pytest.mark.parametrize("arch", list(ZOO))
def test_zoo_config_on_one_card_matches_unsharded(arch, cuda):
    """(2, 2) over cuda:0 x 4 at published widths, cut in depth: K8 once
    an attention layer a point a call (at (192, 128) for MLA; whisper's
    cross-attention and encoder too, `chip_smoke.expected_launches`;
    none for mamba2), every point's parameter bytes `dryrun.local_bytes`
    of the specs and its cache bytes `cache_spec`'s share (MLA's latent
    split by its columns, Mamba's conv by its channels and its SSM state
    by its heads), the forced logits within `ZOO_BOUNDS`."""
    import chip_smoke
    cfg = dataclasses.replace(get_config(arch), n_layers=ZOO[arch])
    mesh = make_test_mesh((2, 2), devices=[cuda] * 4)
    fa.reset_launches()
    gap, res = _zoo_gap(cfg, mesh, cuda)
    # the unsharded run's two passes, the sharded run's two, the forced
    one, each = (chip_smoke.expected_launches(cfg, G, runs)
                 for runs in (2, 3))
    for name in ("flash_prefill", "flash_decode"):
        assert fa.LAUNCHES[name] == one[name] + 4 * each[name]
    specs = S.param_specs(cfg, mesh, fsdp=res["fsdp"])
    per_point = local_bytes(abstract_params(cfg), specs, mesh)
    assert [SP.tree_local_bytes(res["params"], p) for p in range(4)] \
        == [per_point] * 4
    whole = res["model"].init_cache(B, res["cap"], "meta")
    assert res["device_bytes"][str(cuda)]["caches"] == 4 * local_bytes(
        whole, S.cache_spec(cfg, mesh, B), mesh)
    most, mean = ZOO_BOUNDS[arch]
    for step in gap["steps"]:
        assert step["max_abs"] <= most and step["mean_abs"] <= mean, step


@pytest.mark.parametrize("d,dv,h,kvh", ((128, 128, 20, 20),
                                         (64, 64, 16, 4),
                                         (192, 128, 8, 8)))
def test_decode_lse_on_the_card_matches_flash_plain(d, dv, h, kvh, cuda):
    """K8 decode's `return_lse` (the CUDA kernel): the output and the
    log-sum-exp against `flash_plain`'s on the same inputs (the lse within
    `chip_smoke.LSE_TOL`, -inf where plain's is), then the cache cut into
    2 and 4 slot ranges, the last with no valid key (its lse -inf), merged
    by `ops.merge_partials` within `chip_smoke.DECODE_ULPS` of the
    whole-cache K8 call; at MLA's (192, 128) too, on a (2, 2) point's 8
    heads."""
    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, skv = 2, 1040
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((b, 1, h, d), (b, skv, kvh, d),
                                      (b, skv, kvh, dv)))
    for ranges in (2, 4):
        n = skv // ranges
        kp, kval = L._ring_positions((ranges - 1) * n, skv, b, cuda)
        qp = torch.full((b, 1), (ranges - 1) * n - 1, dtype=torch.int32,
                        device=cuda)
        fa.reset_launches()
        o, lse = fa.flash_attention(q, k, v, qp, kp, kval, return_lse=True)
        assert fa.LAUNCHES["flash_decode"] == 1
        po, plse = fa.flash_plain(q, k, v, qp, kp, kval, return_lse=True)
        assert float((o.float() - po.float()).abs().max()) \
            <= chip_smoke.decode_limit(po)
        assert torch.equal(torch.isinf(lse), torch.isinf(plse))
        assert float((lse - plse).abs().max()) <= chip_smoke.LSE_TOL
        outs, lses = [], []
        for r in range(ranges):
            sl = slice(r * n, (r + 1) * n)
            o_r, l_r = fa.flash_attention(
                q, k[:, sl].contiguous(), v[:, sl].contiguous(), qp,
                kp[:, sl].contiguous(), kval[:, sl].contiguous(),
                return_lse=True)
            outs.append(o_r[:, 0])
            lses.append(l_r)
        assert bool(torch.isneginf(lses[-1]).all())
        merged = fa.merge_partials(torch.stack(outs),
                                   torch.stack(lses)).to(torch.bfloat16)
        assert float((merged.float() - o[:, 0].float()).abs().max()) \
            <= chip_smoke.decode_limit(o)


#: (max |d|, mean |d|) bounds of deepseek-v2-lite-16b's bf16 gap at batch
#: 1 from the unsharded run (`_zoo_gap` at batch 1, its published widths
#: cut to 2 layers, routing replayed), measured on the CPU (K8's plain
#: version on ["cpu"] * 4) at max |d| 0.0508 and mean 0.0091; about three
#: times that, as `ZOO_BOUNDS`
B1_MLA_BOUNDS = (0.15, 0.027)


def test_mla_batch_one_on_one_card_matches_unsharded(cuda):
    """deepseek-v2-lite-16b at published widths cut to 2 layers (its dense
    first layer and one MoE layer) at batch 1 on (2, 2) of cuda:0 x 4:
    each point holds 55 of the 110 slots of MLA's latent and rope caches
    at every column (`cache_spec`'s share), K8 (192, 128) runs on its 8
    heads at (S_LEN, S_LEN) a prefill and over its 55 slots a decode step
    with the log-sum-exp (two passes and the forced run, 2 layers, 4
    points), the unsharded run's at (S_LEN, 110) and (1, 110); the forced
    logits, routing replayed, within `B1_MLA_BOUNDS`."""
    import chip_smoke
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=2)
    mesh = make_test_mesh((2, 2), devices=[cuda] * 4)
    seen, restore = chip_smoke.record_k8_shapes(L)
    try:
        gap, res = _zoo_gap(cfg, mesh, cuda, batch=1)
    finally:
        restore()
    cap = res["cap"]
    assert cap == S_LEN + G + 8
    assert dict(seen) == {(S_LEN, cap, 16, 16): 2 * 2,
                          (1, cap, 16, 16): 2 * 2 * G,
                          (S_LEN, S_LEN, 8, 8): 3 * 2 * 4,
                          (1, cap // 2, 8, 8): 3 * 2 * 4 * G}
    whole = res["model"].init_cache(1, cap, "meta")
    assert res["device_bytes"][str(cuda)]["caches"] == 4 * local_bytes(
        whole, S.cache_spec(cfg, mesh, 1), mesh)
    most, mean = B1_MLA_BOUNDS
    for step in gap["steps"]:
        assert step["max_abs"] <= most and step["mean_abs"] <= mean, step


#: qwen1.5-4b at its published widths cut to 2 layers, served on (1, 8):
#: B, a prompt of 104 tokens (13 query rows a point) and 8 tokens, so
#: the 120 cache slots split 15 a point
CP_PROMPT, CP_GEN = 104, 8
#: (max |d|, mean |d|) bounds of its bf16 gap from the unsharded run
#: (`_cp_gap`), measured on the CPU (K8's plain version, `_cp_gap` on
#: ["cpu"] * 8) at max |d| 0.0586 and mean 0.0087; about three times
#: that, as `BF16_MAX_ABS`
CP_BOUNDS = (0.18, 0.027)


def _cp_gap(mesh, device, arch="qwen1.5-4b", layers=2, prompt=CP_PROMPT,
            gen=CP_GEN):
    """(`chip_smoke.sharded_gap` of `arch` cut to `layers` on `mesh`
    against its unsharded greedy run at B, `prompt` and `gen` tokens, the
    K8 calls by (Sq, Skv) of the sharded pass, the sharded serve
    result)."""
    import chip_smoke
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    with set_mesh(make_test_mesh(mesh.axis_sizes, mesh.axis_names)):
        ref = serve.serve_config(cfg, B, prompt, gen, device)
    seen, restore = chip_smoke.record_k8_shapes(L)
    try:
        res = serve.serve_config(cfg, B, prompt, gen, device, mesh=mesh)
    finally:
        restore()
    gap = chip_smoke.sharded_gap(torch, L, SP, serve, ref, res["model"],
                                 res["params"], mesh)
    shapes = {}
    for (sq, skv, _, _), c in seen.items():
        shapes[(sq, skv)] = shapes.get((sq, skv), 0) + c
    return gap, shapes, res


def test_sequence_split_on_one_card_matches_unsharded(cuda):
    """qwen1.5-4b's 20 heads on (1, 8) of cuda:0 x 8, context parallel:
    K8 prefill on each point's 13 query rows against the 104 gathered
    keys and decode on its 15 slots with the log-sum-exp (two passes, 2
    layers, 8 points), each point's cache bytes `cache_spec`'s share,
    the forced logits within `CP_BOUNDS`."""
    mesh = make_test_mesh((1, 8), devices=[cuda] * 8)
    gap, shapes, res = _cp_gap(mesh, cuda)
    calls = 2 * 2 * 8
    assert shapes == {(CP_PROMPT // 8, CP_PROMPT): calls,
                      (1, 15): calls * CP_GEN}
    cfg = res["cfg"]
    whole = res["model"].init_cache(B, res["cap"], "meta")
    assert res["device_bytes"][str(cuda)]["caches"] == 8 * local_bytes(
        whole, S.cache_spec(cfg, mesh, B), mesh)
    most, mean = CP_BOUNDS
    for step in gap["steps"]:
        assert step["max_abs"] <= most and step["mean_abs"] <= mean, step


#: deepseek-v2-lite-16b at its published widths cut to 1 layer (its dense
#: first layer: MLA, the FFN's 10,944 hidden units split three ways)
#: served on (1, 3), where 3 divides none of its 16 heads, r 512 and dr
#: 64: B, a prompt of 96 tokens (32 query rows a point) and 7 tokens, so
#: the 111 cache slots split 37 a point
SEQ_MLA_PROMPT, SEQ_MLA_GEN = 96, 7
#: (max |d|, mean |d|) bounds of its bf16 gap from the unsharded run
#: (`_cp_gap`), measured on the CPU (K8's plain version, `_cp_gap` on
#: ["cpu"] * 3) at max |d| 0.0391 and mean 0.0062; about three times
#: that, as `BF16_MAX_ABS`
SEQ_MLA_BOUNDS = (0.12, 0.019)


def test_mla_sequence_split_on_one_card_matches_unsharded(cuda):
    """deepseek-v2-lite-16b's MLA on (1, 3) of cuda:0 x 3, split by
    sequence: K8 (192, 128) prefill on each point's 32 query rows against
    the 96 gathered keys and decode over its 37 slots with the
    log-sum-exp (two passes, 1 layer, 3 points), each point's cache a
    third of the whole (`cache_spec` keeps the latent whole on 3), the
    forced logits within `SEQ_MLA_BOUNDS`."""
    mesh = make_test_mesh((1, 3), devices=[cuda] * 3)
    gap, shapes, res = _cp_gap(mesh, cuda, "deepseek-v2-lite-16b", 1,
                               SEQ_MLA_PROMPT, SEQ_MLA_GEN)
    calls = 2 * 1 * 3
    assert res["cap"] == 111
    assert shapes == {(SEQ_MLA_PROMPT // 3, SEQ_MLA_PROMPT): calls,
                      (1, 37): calls * SEQ_MLA_GEN}
    whole = res["model"].init_cache(B, res["cap"], "meta")
    assert res["device_bytes"][str(cuda)]["caches"] == \
        serve.cache_bytes(whole)
    most, mean = SEQ_MLA_BOUNDS
    for step in gap["steps"]:
        assert step["max_abs"] <= most and step["mean_abs"] <= mean, step
