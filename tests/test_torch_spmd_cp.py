"""Context parallelism against the reference's sharded run, on the CPU
(tests/test_torch_spmd.py's note says how both sides run): attention
whose heads do not split whole over the model axis runs by sequence
(`layers.seq_split`): each point takes its S/tp query rows against the
gathered k and v, holds cap/tp of the cache's slots, and merges its
decode output with the other points' by their log-sum-exp.

  * minitron-4b's smoke config (6/2 heads) on (1, 4): the reference's
    "seq" layout (`hints.attn_layout`), a prefill of 16 tokens, 4 rows a
    point, 7 of the 28 slots a point;
  * mixtral-8x7b's (4/2 heads, a window of 64: its ring of 28 slots) on
    (1, 4), where the reference lays attention out by heads but the port
    cannot split 2 kv heads four ways;
  * minitron on (1, 4) with a prefill of 18 tokens, which 4 does not
    divide: every point takes every row (the reference's "none");
  * minitron on (2, 4) with the batch split over "data" and the sequence
    over "model".
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32;
each point's cache holds its range of the slots."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.model import Model
from repro_torch.parallel import spmd as SP

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    B, S_LEN, check_against, cpu_mesh, one_torch_thread, port_config,
    port_sharded_run, reference_params, reference_runs,
)

AXES = ("data", "model")
#: tag -> (arch, mesh shape, prefill tokens)
CASES = {"minitron-4b@1x4": ("minitron-4b", (1, 4), 16),
         "mixtral-8x7b@1x4": ("mixtral-8x7b", (1, 4), 16),
         "minitron-4b@1x4-t18": ("minitron-4b", (1, 4), 18),
         "minitron-4b@2x4": ("minitron-4b", (2, 4), 16)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        [tag, arch, None, shape, AXES, True, {"T0": t0}]
        for tag, (arch, shape, t0) in CASES.items()])


def point_slots(cfg, shape, batch, batch_ways, cap):
    """Each point's (axes, first slot, slots) of the first attention
    cache `init_cache` gives it inside `spmd.run`."""
    mesh = cpu_mesh(shape, AXES)

    def one():
        c = Model(cfg).init_cache(batch, cap, "meta")["slots"][0]
        return c.axes, c.start, c.k.shape[2]
    return SP.run(mesh, one, batch_ways=batch_ways, timeout=60)


@pytest.mark.parametrize("tag", list(CASES))
def test_sequence_split_matches_reference_sharded_run(tag, reference):
    arch, shape, t0 = CASES[tag]
    cfg = port_config(arch)
    got = port_sharded_run(cfg, reference_params(arch, cfg), shape, AXES,
                           True, t0=t0)
    check_against(reference, tag, got, t0)
    cap, tp = S_LEN + 4, shape[1]
    ways = shape[0]
    slots = point_slots(cfg, shape, B // ways, ways, cap)
    assert slots == [(("model",), (p % tp) * cap // tp, cap // tp)
                     for p in range(shape[0] * tp)]


def test_sequence_split_on_the_auto_backend_matches_reference(reference):
    """The same split on the "auto" attention backend (plain torch dense
    attention, which serves f32 models on the card, where K8 takes bf16
    only): its decode partials carry the dense path's log-sum-exp."""
    from repro_torch.models import layers as L
    arch, shape, t0 = CASES["minitron-4b@1x4"]
    cfg = port_config(arch)
    with L.attention_backend("auto"):
        got = port_sharded_run(cfg, reference_params(arch, cfg), shape,
                               AXES, True, t0=t0)
    check_against(reference, "minitron-4b@1x4", got, t0)
