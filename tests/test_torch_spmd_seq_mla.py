"""MLA's sequence split against the reference's sharded run, on the CPU
(tests/test_torch_spmd.py's note says how both sides run): deepseek-v2-
lite-16b's smoke config (4 heads, latent rank 64, 16 rope dims) on a
model axis of 8, which divides none of them, so MLA splits by sequence
(`layers.seq_split`, the reference's "seq" layout): its leaves are
gathered over "model", each point projects its S/8 query rows against
every row's latent and rope keys (all-gathered along the sequence), and
its rows of y are all-gathered. Its latent and rope caches hold cap/8 of
the ring's slots at every column, and a decode step merges the points'
outputs by their log-sum-exp.

  * (1, 8), a prefill of 16 tokens: 2 query rows a point;
  * (1, 8), a prefill of 20 tokens, which 8 does not divide: every point
    takes every row (the reference's "none" layout);
both with 28 tokens (cap 32: 4 slots a point), the prefill's and every
teacher-forced decode step's logits within 2e-4 / 3e-4 in f32, each
point's slot range asserted; and two AdamW steps of 2 microbatches with
remat on (1, 8) (tests/test_torch_spmd_train_ref.py's bounds for two
steps: moments and every parameter entry)."""
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.model import Model
from repro_torch.parallel import spmd as SP

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    B, check_against, cpu_mesh, one_torch_thread, port_config,
    port_sharded_run, reference_params, reference_runs,
)
from test_torch_spmd_train_ref import check_step, reference_steps

ARCH = "deepseek-v2-lite-16b"
AXES = ("data", "model")
S_LEN = 28
#: tag -> (mesh shape, prefill tokens)
CASES = {f"{ARCH}@1x8": ((1, 8), 16),
         f"{ARCH}@1x8-t20": ((1, 8), 20)}
TRAIN = {f"{ARCH}@1x8": (ARCH, (1, 8), True, 2)}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """REF's serving runs and train steps, from their two subprocesses
    run at once."""
    with ThreadPoolExecutor(2) as pool:
        runs = pool.submit(reference_runs, tmp_path_factory, [
            [tag, ARCH, None, shape, AXES, False, {"T0": t0, "S": S_LEN}]
            for tag, (shape, t0) in CASES.items()])
        steps = pool.submit(reference_steps, tmp_path_factory, TRAIN)
        return runs.result(), steps.result()


def point_slots(cfg, shape, batch, cap):
    """Each point's (axes, first slot, slots, columns of the latent, of
    the rope keys) of the first MLA cache `init_cache` gives it inside
    `spmd.run`."""
    def one():
        c = Model(cfg).init_cache(batch, cap, "meta")["slots"][0]
        return c.axes, c.start, c.k.shape[2], c.k.shape[3], c.v.shape[3]
    return SP.run(cpu_mesh(shape, AXES), one, timeout=60)


@pytest.mark.parametrize("tag", list(CASES))
def test_mla_sequence_split_matches_reference_sharded_run(tag, references):
    reference = references[0]
    shape, t0 = CASES[tag]
    cfg = port_config(ARCH)
    got = port_sharded_run(cfg, reference_params(ARCH, cfg), shape, AXES,
                           False, t0=t0, s_len=S_LEN)
    check_against(reference, tag, got, t0, S_LEN)
    cap, tp, a = S_LEN + 4, shape[1], cfg.attn
    assert point_slots(cfg, shape, B, cap) == [
        (("model",), p * cap // tp, cap // tp, a.kv_lora_rank,
         a.rope_head_dim) for p in range(tp)]


@pytest.mark.parametrize("tag", list(TRAIN))
def test_mla_sequence_split_steps_match_reference_sharded_steps(
        tag, references):
    check_step(tag, *TRAIN[tag][:3], references[1], steps=2)
