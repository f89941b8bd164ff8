"""Batch-1 sharded serving against the reference's sharded run, on the
CPU (tests/test_torch_spmd.py's note says how both sides run, here with
its batch passed as 1). A batch the data axes do not divide is whole on
every point, and each data point holds a range of the cache's slots, as
`cache_spec` splits the KV length over "data" at batch 1; a decode step
runs K8 on the point's slots with their log-sum-exp and merges the data
points' outputs.

  * qwen1.5-4b's smoke config (4/4 heads) on (2, 2): 14 of the 28 slots
    and 2 of the 4 kv heads a point;
  * the same on (4, 1): 7 slots a point, point 3 holding slots 21-27,
    which hold no key until step 21 (its lse -inf, weight 0, until then);
  * mixtral-8x7b's (its window ring of 28 slots) on (2, 2);
  * qwen on (8, 1), whose 8 data points do not divide the 28 slots: the
    slots stay whole on every point, as `fit_spec` leaves such a dim.
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    S_LEN, T0, check_against, one_torch_thread, port_config,
    port_sharded_run, reference_params, reference_runs,
)
from test_torch_spmd_cp import AXES, point_slots

#: tag -> (arch, mesh shape, each point's (axes, first slot, slots))
CAP = S_LEN + 4
CASES = {
    "qwen1.5-4b@2x2-b1": ("qwen1.5-4b", (2, 2),
                          [(("data",), 14 * (p // 2), 14)
                           for p in range(4)]),
    "qwen1.5-4b@4x1-b1": ("qwen1.5-4b", (4, 1),
                          [(("data",), 7 * p, 7) for p in range(4)]),
    "mixtral-8x7b@2x2-b1": ("mixtral-8x7b", (2, 2),
                            [(("data",), 14 * (p // 2), 14)
                             for p in range(4)]),
    "qwen1.5-4b@8x1-b1": ("qwen1.5-4b", (8, 1), [((), 0, CAP)] * 8),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        [tag, arch, None, shape, AXES, True, {"B": 1}]
        for tag, (arch, shape, _) in CASES.items()])


@pytest.mark.parametrize("tag", list(CASES))
def test_batch_one_matches_reference_sharded_run(tag, reference):
    arch, shape, slots = CASES[tag]
    cfg = port_config(arch)
    assert point_slots(cfg, shape, 1, 1, CAP) == slots
    got = port_sharded_run(cfg, reference_params(arch, cfg), shape, AXES,
                           True, batch=1)
    check_against(reference, tag, got, T0)
