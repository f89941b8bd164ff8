"""Sharded training (`build_train_step(..., mesh=)`) against the port's
own unsharded step, on the CPU.

deepseek-v2-lite-16b's and llava-next-mistral-7b's smoke configs (MLA;
the patch prefix, its patches in the batch) on (2, 2) and (1, 4) with
FSDP, mamba2-370m's and whisper-base's (its frames in the batch) on
(2, 2) with FSDP, and minitron-4b's and mixtral-8x7b's on (1, 4), whose
attention splits by sequence, are held the same way as qwen's below.

qwen1.5-4b's smoke config in f32 on meshes of `["cpu"] * n`: (2, 2)
over ("data", "model") with `fsdp` on and off, (1, 4), (1, 8) (its 4
heads split by sequence, 2 query rows a point), (2, 1, 2) over
("pod", "data", "model"), and (4, 1) with loss chunks that cut across
the points' rows (the points then run as many chunks each, some empty);
remat on and off; `compress_grads` on; Adafactor on (2, 2). The
unsharded step runs under the mesh's abstract twin (`set_mesh`), as the
sharded step's model sees it. Checked: every point's gradient of every
leaf (what the step hands the optimizer, after the data-parallel sum)
against its slice of the unsharded gradient, within 1e-5 relative L2
(compressed: on the whole leaf's int8 grid, one step off at under 0.1%
of the entries, where f32 rounding crossed a rounding boundary);
the loss and gradient norm on every point within 1e-5; the parameters
after one step (AdamW with clipping active, its norm about 1.9 against
a limit of 1) within 1e-5 relative L2 over the tree, every entry within
3e-4 and all but 0.1% within 1e-5 (AdamW's first step is about lr *
sign(g), so an entry whose gradient is at f32 noise, such as the k
bias's, may step otherwise; compressed, within 1e-3, an entry one int8
step off stepping otherwise); the optimizer state within 1e-5 relative
L2 (compressed, not compared: the moments are functions of the
gradients and norm checked above, one-step differences included).
Also: the collective counts of a step against `spmd.train_comm` (the
formula of spmd.py's note), in f32 and bf16, FSDP on and off; the
optimizer state `spmd.init_state` makes on the points against the whole
state sharded (AdamW and Adafactor); and `chip_smoke.py`'s f32 gate of
path `train-sharded` on the smoke config: the sharded step passes it,
its control (a data-parallel sum left out) does not."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import opt_shardings
from repro_torch.launch.mesh import make_test_mesh, set_mesh
from repro_torch.models.model import Batch, Model
from repro_torch.parallel import sharding as S
from repro_torch.parallel import spmd as SP
from repro_torch.parallel.sharding import spec_leaves
from repro_torch.train import optim as O
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.tree import leaves, tree_map


B, S_LEN, SEED = 8, 32, 0
#: name -> (mesh shape, axes, fsdp, optimizer, TrainConfig overrides)
CASES = {
    "2x2": ((2, 2), ("data", "model"), True, "adamw", {}),
    "2x2-nofsdp": ((2, 2), ("data", "model"), False, "adamw", {}),
    "1x4": ((1, 4), ("data", "model"), True, "adamw", {}),
    "1x8": ((1, 8), ("data", "model"), False, "adamw", {}),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model"), True, "adamw", {}),
    "4x1-chunks": ((4, 1), ("data", "model"), True, "adamw",
                   {"loss_chunk": 40}),
    "2x2-noremat": ((2, 2), ("data", "model"), True, "adamw",
                    {"remat": False}),
    "2x2-compress": ((2, 2), ("data", "model"), True, "adamw",
                     {"compress_grads": True}),
    "2x2-adafactor": ((2, 2), ("data", "model"), True, "adafactor", {}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recording:
    """An optimizer that records, per mesh point (-1 unsharded), the
    gradient leaves and metrics the step hands it, then updates with
    `inner`."""

    def __init__(self, inner):
        self.inner, self.grads, self.metrics = inner, {}, {}

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        ctx = SP.context()
        point = -1 if ctx is None else ctx.point
        self.grads[point] = [g.clone() for g in leaves(grads)]
        out = self.inner.update(grads, state, params)
        self.metrics[point] = out[2]
        return out


def rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def check_quantized(g, mine, full):
    """An int8-compressed gradient: on the grid of the whole leaf's scale
    (its largest magnitude over 127; a point's own largest would make
    another grid), and the unsharded one's but where an entry's f32
    rounding put it across a rounding boundary (one step, at under 0.1%
    of the entries)."""
    scale = float(full.abs().max()) / 127
    steps = g / scale
    assert float((steps - steps.round()).abs().max()) < 1e-3
    off = (g - mine).abs() / scale
    assert float(off.max()) < 1 + 1e-3
    assert float((off > 1e-3).float().mean()) < 1e-3


def batch_of(cfg, device="cpu"):
    """B x S_LEN seeded tokens, their targets shifted by one, and seeded
    stub embeddings: patches under the vision stub, frames under the
    audio stub."""
    rng = np.random.default_rng(SEED)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S_LEN)))
    tgt = torch.roll(tok, -1, 1)
    tgt[:, -1] = -1
    extra = None
    n = {"vision_stub": cfg.num_patches,
         "audio_stub": cfg.enc_seq_len}.get(cfg.frontend)
    if n is not None:
        extra = torch.from_numpy(rng.standard_normal(
            (B, n, cfg.d_model)).astype(np.float32)).to(device)
    return Batch(tok.to(device), tgt.to(device), extra)


def run_pair(shape, axes, fsdp, opt_name, tc_kw, device="cpu",
             arch="qwen1.5-4b"):
    """One f32 step of `arch`'s smoke config unsharded (on `device`, or
    the first of a list of a device a point) and one sharded (on a mesh
    of `device` repeated, or of that list) from the same weights and
    batch: (unsharded (params, state, optimizer), sharded (params, state,
    optimizer), the mesh, the specs)."""
    devices = device if isinstance(device, list) \
        else [device] * int(np.prod(shape))
    device = devices[0]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    model = Model(cfg)
    params = tree_map(lambda t: t.to(device),
                      model.init(torch.Generator().manual_seed(SEED)))
    mesh = make_test_mesh(shape, axes, devices=devices)
    tc = TrainConfig(microbatches=2, **{"loss_chunk": 64, **tc_kw})
    batch = batch_of(cfg, device)

    def optimizer():
        return Recording(O.make_optimizer(opt_name,
                                          O.cosine_schedule(1e-3, 2, 10)))
    one = optimizer()
    p1 = tree_map(lambda t: t.clone(), params)
    with set_mesh(make_test_mesh(shape, axes)):
        p1, s1, _ = build_train_step(model, one, tc)(p1, one.init(p1),
                                                     batch)
    many = optimizer()
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)
    state = many.init(params)
    p2 = SP.shard_tree(params, specs, mesh)
    s2 = SP.shard_tree(state, opt_shardings(state, specs, mesh), mesh)
    p2, s2, _ = build_train_step(model, many, tc, mesh=mesh)(p2, s2, batch)
    return (p1, s1, one), (p2, s2, many), mesh, specs


def check_case(case, device="cpu", tol=1e-5, arch="qwen1.5-4b"):
    """CASES[case] of `arch` on `device`: the sharded step against the
    unsharded one, as the module's note says, `tol` for the relative
    bounds."""
    shape, axes, fsdp, opt_name, tc_kw = CASES[case]
    (p1, s1, one), (p2, s2, many), mesh, specs = run_pair(
        shape, axes, fsdp, opt_name, tc_kw, device, arch)
    assert sorted(many.grads) == list(range(mesh.size))
    want = one.metrics[-1]
    for point in range(mesh.size):
        got = many.metrics[point]
        for key in ("loss", "grad_norm"):
            if key in want:
                assert float(got[key]) == pytest.approx(float(want[key]),
                                                        rel=tol), key
                assert torch.equal(got[key].cpu(),
                                   many.metrics[0][key].cpu())
        for g, full, spec in zip(many.grads[point], one.grads[-1],
                                 spec_leaves(specs)):
            mine = full[SP.local_slices(full.shape, spec, mesh, point)] \
                .to(g.device)
            assert g.shape == mine.shape
            if tc_kw.get("compress_grads"):
                check_quantized(g, mine, full)
            else:
                assert rel(g, mine) <= tol, (case, point, spec)
    got, exp = leaves(SP.gather_tree(p2)), leaves(p1)
    num = sum(float((a - b).pow(2).sum()) for a, b in zip(got, exp))
    den = sum(float(b.pow(2).sum()) for b in exp)
    assert (num / den) ** 0.5 <= tol
    # a compressed entry one int8 step off may step by up to 2 lr (5e-4
    # at step 1) otherwise: from 0 to lr * sign, or across 0
    most = 1e-3 if tc_kw.get("compress_grads") else 3e-4
    for a, b in zip(got, exp):
        d = (a - b).abs()
        assert float(d.max()) <= most and float((d > tol).float().mean()) \
            < 1e-3
    if tc_kw.get("compress_grads"):
        return      # the moments hold the gradients' one-step differences
    for a, b in zip(leaves(SP.gather_tree(s2)), leaves(s1)):
        assert rel(a.float(), b.float()) <= tol


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_unsharded_step(case):
    check_case(case)


@pytest.mark.parametrize("case", ("2x2", "1x4"))
@pytest.mark.parametrize("arch", ("deepseek-v2-lite-16b",
                                  "llava-next-mistral-7b"))
def test_mla_and_patch_prefix_step_matches_unsharded_step(arch, case):
    """MLA (deepseek: on (2, 2) the shared expert's stacked layers split
    one a point; on (1, 4) the rope dims four ways) and the patch prefix
    (llava: on (1, 4) its attention gathered) under the same check."""
    check_case(case, arch=arch)


@pytest.mark.parametrize("arch", ("mamba2-370m", "whisper-base"))
def test_mamba_and_encoder_decoder_step_matches_unsharded_step(arch):
    """The Mamba-2 mixer (mamba2-370m: in_proj's and the conv's outputs
    gathered, their gradients summed over "model" before a point keeps
    its columns; the per-head scalars' gradients summed) and whisper
    (`frame_proj`'s columns, the encoder's and cross-attention's heads,
    the encoder output's gradient summed over "model") on (2, 2) with
    FSDP, under the same check."""
    check_case("2x2", arch=arch)


@pytest.mark.parametrize("arch", ("minitron-4b", "mixtral-8x7b"))
def test_sequence_split_step_matches_unsharded_step(arch):
    """Context parallelism under autograd (minitron's 6/2 and mixtral's
    4/2 heads on (1, 4): each point's 8 query rows of a microbatch
    against the gathered k and v, y gathered; h, the gathered weights and
    the gathered k and v entering the row split through `spmd.copy`),
    every leaf's gradient within 1e-5 of the unsharded step's."""
    check_case("1x4", arch=arch)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("fsdp", (True, False))
def test_step_collectives_match_formula(fsdp, dtype):
    """A (2, 2) step's `spmd.COMM` (calls and bytes of every kind)
    against `spmd.train_comm`, the formula of spmd.py's note that path
    `train-sharded` holds the card's step to."""
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"), dtype=dtype)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED))
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    opt = O.AdamW(lr=O.cosine_schedule(1e-3, 2, 10))
    specs = S.param_specs(cfg, mesh, fsdp=fsdp)
    state = opt.init(params)
    p = SP.shard_tree(params, specs, mesh)
    s = SP.shard_tree(state, opt_shardings(state, specs, mesh), mesh)
    tc = TrainConfig(microbatches=2, loss_chunk=64)
    SP.reset_counts()
    build_train_step(model, opt, tc, mesh=mesh)(p, s, batch_of(cfg))
    assert dict(SP.COMM) == SP.train_comm(cfg, mesh, B, S_LEN, tc, fsdp)


@pytest.mark.parametrize("opt_name", ("adamw", "adafactor"))
def test_init_state_makes_the_sharded_state_on_the_points(opt_name):
    """`spmd.init_state(opt.init, params, opt_shardings)` against the
    whole state sharded by `opt_shardings`: the same specs, shapes and
    shards, each on its point's device."""
    cfg = get_smoke_config("qwen1.5-4b")
    params = Model(cfg).init(torch.Generator().manual_seed(SEED))
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    specs = S.param_specs(cfg, mesh)
    opt = O.make_optimizer(opt_name, O.cosine_schedule(1e-3, 2, 10))
    whole = opt.init(params)
    want = SP.shard_tree(whole, opt_shardings(whole, specs, mesh), mesh)
    got = SP.init_state(opt.init, SP.shard_tree(params, specs, mesh),
                        opt_shardings)
    assert type(got) is type(want)
    pairs = list(zip(leaves(got), leaves(want)))
    assert len(pairs) == len(leaves(whole))
    for g, w in pairs:
        assert (g.spec, g.shape) == (w.spec, w.shape)
        for a, b in zip(g.shards, w.shards):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_smoke_gate_passes_the_step_and_rejects_its_control():
    """`chip_smoke.sharded_train_gate` (path `train-sharded`'s f32 gate,
    every limit `SHARDED_TRAIN_*`) on the smoke config on (2, 2) of the
    CPU: the sharded step passes it, every leaf's gradient within f32
    rounding; the control, one data shard's gradient, fails it in every
    gradient reading."""
    import chip_smoke
    cfg = get_smoke_config("qwen1.5-4b")
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    out = chip_smoke.sharded_train_gate(
        torch, cfg, mesh, batch_of(cfg), TrainConfig(microbatches=2,
                                                     loss_chunk=64), True)
    sound, control = out["sharded"], out["control"]
    assert sound["passes_gate"] and not control["passes_gate"]
    assert sound["grad_leaf_rel"] < 1e-5 and sound["update_rel"] < 1e-3
    assert control["grad_leaf_rel"] > chip_smoke.SHARDED_TRAIN_GRAD_REL
    assert control["update_rel"] > chip_smoke.SHARDED_TRAIN_UPDATE_REL


def test_smoke_gate_passes_the_mla_step_and_rejects_its_control():
    """The same gate on deepseek-v2-lite-16b's smoke config (MLA, the
    experts split two a point, the shared expert's stacked layers one a
    point): the sharded step passes it, its control fails it (CPU
    readings: worst leaf 1.5e-6, control 1.10 and updates 0.99)."""
    import chip_smoke
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    out = chip_smoke.sharded_train_gate(
        torch, cfg, mesh, batch_of(cfg), TrainConfig(microbatches=2,
                                                     loss_chunk=64), True)
    assert out["sharded"]["passes_gate"] and not out["control"]["passes_gate"]
    assert out["sharded"]["grad_leaf_rel"] < 1e-5
