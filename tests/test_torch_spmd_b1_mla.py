"""MLA at batch 1 against the reference's sharded run, on the CPU
(tests/test_torch_spmd.py's note says how both sides run, here with its
batch passed as 1). A batch the data axes do not divide is whole on
every point, and `cache_spec` lays MLA's latent [B, cap, r] and rope
[B, cap, dr] caches out as `P(None, "data", None)`: the slots split over
"data", every column whole over "model". So each point holds its range
of the slots at all r and dr columns, gathers a call's latent over
"model" (not the cache), and merges a decode step's partial outputs over
"data" by their log-sum-exp, as attention does at batch 1.

deepseek-v2-lite-16b's smoke config (4 heads of 32, r 64, dr 16):
  * on (2, 2), with `fsdp` on and off: 14 of the 28 slots a point, its 2
    heads expanded from them;
  * on (4, 1): 7 slots a point, point 3 holding slots 21-27, which hold no
    key until step 21 (its lse -inf, weight 0, until then);
  * on (8, 1), whose 8 data points do not divide the 28 slots: the slots
    stay whole on every point, as `fit_spec` leaves such a dim, and so do
    the columns.
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.model import Model
from repro_torch.parallel import spmd as SP

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    S_LEN, check_against, cpu_mesh, one_torch_thread, port_config,
    port_sharded_run, reference_params, reference_runs,
)

ARCH = "deepseek-v2-lite-16b"
AXES = ("data", "model")
CAP = S_LEN + 4
R, DR = 64, 16
#: tag -> (mesh shape, fsdp, each point's (axes, first slot, slots, latent
#: columns, rope columns) of every MLA cache)
CASES = {
    "2x2-b1": ((2, 2), True, [(("data",), 14 * (p // 2), 14, R, DR)
                              for p in range(4)]),
    "2x2-nofsdp-b1": ((2, 2), False, [(("data",), 14 * (p // 2), 14, R, DR)
                                      for p in range(4)]),
    "4x1-b1": ((4, 1), True, [(("data",), 7 * p, 7, R, DR)
                              for p in range(4)]),
    "8x1-b1": ((8, 1), True, [((), 0, CAP, R, DR)] * 8),
}


def point_latents(cfg, shape):
    """Each point's [(axes, first slot, slots, latent columns, rope
    columns)] of every MLA cache `init_cache` gives it for one row inside
    `spmd.run`, or the first that differs from the first cache's."""
    def one():
        caches = Model(cfg).init_cache(1, CAP, "meta")
        got = {(c.axes, c.start, c.k.shape[-2], c.k.shape[-1],
                c.v.shape[-1]) for c in caches["prefix"] + caches["slots"]}
        assert len(got) == 1, got
        return got.pop()
    return SP.run(cpu_mesh(shape, AXES), one, batch_ways=1, timeout=60)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        [f"{ARCH}@{tag}", ARCH, None, shape, AXES, fsdp, {"B": 1}]
        for tag, (shape, fsdp, _) in CASES.items()])


@pytest.mark.parametrize("tag", list(CASES))
def test_mla_batch_one_matches_reference_sharded_run(tag, reference):
    shape, fsdp, want = CASES[tag]
    cfg = port_config(ARCH)
    assert point_latents(cfg, shape) == want
    got = port_sharded_run(cfg, reference_params(ARCH, cfg), shape, AXES,
                           fsdp, batch=1)
    check_against(reference, f"{ARCH}@{tag}", got)
