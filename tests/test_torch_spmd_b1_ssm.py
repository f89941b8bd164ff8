"""The Mamba-2 mixer at batch 1 against the reference's sharded run, on
the CPU (tests/test_torch_spmd.py's note says how both sides run, here
with its batch passed as 1). A batch the data axes do not divide is
whole on every point, and `cache_spec` lays a Mamba layer's SSM state
[B, H, P, N] out as `P(None, "data", None, None)` (the heads over
"data", whole over "model") and its conv window [B, k, ch] as `P(None,
None, "model")`. So each point runs the SSD and the recurrent step on
its data coordinate's heads, all-gathers their gated output over
"data" and multiplies its rows' heads of it by its rows of out_proj,
which are generally other heads: on (2, 2) point 1 holds SSM heads 0-3
and out_proj's rows for heads 4-7.

  * mamba2-370m's smoke config (8 heads of 32, 288 conv channels) on
    (2, 2): 4 SSM heads by the point's "data" coordinate, 144 conv
    channels by its "model" coordinate;
  * the same on (4, 1): 2 heads a point, the conv whole;
  * the same on (8, 1): one head a point;
  * jamba-1.5-large-398b's (a period of one attention layer and seven
    Mamba-2 layers of 8 heads) on (2, 2): the Mamba layers as mamba2's,
    the attention cache's slots over "data".
Prefill and teacher-forced decode logits within 2e-4 / 3e-4, in f32."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.parallel import spmd as SP

from test_torch_spmd import (  # noqa: F401  (one_torch_thread: a fixture)
    S_LEN, check_against, cpu_mesh, one_torch_thread, port_config,
    port_sharded_run, reference_params, reference_runs,
)

AXES = ("data", "model")
#: tag -> (arch, mesh shape, each point's (SSM heads' axes, first head,
#: heads, conv channels) of every Mamba cache)
CASES = {
    "mamba2-370m@2x2-b1": ("mamba2-370m", (2, 2),
                           [(("data",), 4 * (p // 2), 4, 144)
                            for p in range(4)]),
    "mamba2-370m@4x1-b1": ("mamba2-370m", (4, 1),
                           [(("data",), 2 * p, 2, 288) for p in range(4)]),
    "mamba2-370m@8x1-b1": ("mamba2-370m", (8, 1),
                           [(("data",), p, 1, 288) for p in range(8)]),
    "jamba-1.5-large-398b@2x2-b1": ("jamba-1.5-large-398b", (2, 2),
                                    [(("data",), 4 * (p // 2), 4, 144)
                                     for p in range(4)]),
}


def point_heads(cfg, shape):
    """Each point's (axes, first head, heads) of the SSM state
    (`layers.ssm_split`) and the heads and conv channels of every Mamba
    cache `init_cache` gives it for one row inside `spmd.run`."""
    def one():
        caches = Model(cfg).init_cache(1, S_LEN + 4, "meta")
        got = {(c.ssm.shape[-3], c.conv.shape[-1])
               for c in caches["prefix"] + caches["slots"]
               if isinstance(c, L.MambaCache)}
        assert len(got) == 1, got
        axes, first, n = L.ssm_split(cfg.mamba, cfg.d_model,
                                     L.whole_batch(1))
        heads, channels = got.pop()
        assert heads == n
        return axes, first, n, channels
    return SP.run(cpu_mesh(shape, AXES), one, batch_ways=1, timeout=60)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(tmp_path_factory, [
        [tag, arch, None, shape, AXES, True, {"B": 1}]
        for tag, (arch, shape, _) in CASES.items()])


@pytest.mark.parametrize("tag", list(CASES))
def test_ssm_batch_one_matches_reference_sharded_run(tag, reference):
    arch, shape, want = CASES[tag]
    cfg = port_config(arch)
    assert point_heads(cfg, shape) == want
    got = port_sharded_run(cfg, reference_params(arch, cfg), shape, AXES,
                           True, batch=1)
    check_against(reference, tag, got)
