"""The count of tests/test_torch_spmd_count.py (its note says what is
held) for MLA: deepseek-v2-lite-16b's smoke config (MLA split over "model", its
latent cache by columns, or by slots over "data" at batch 1; the
expert-parallel MoE with its shared experts gathered along their
layers)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_count import (  # noqa: F401  (a fixture)
    cases, check_call, check_serve, one_torch_thread,
)

ARCH = "deepseek-v2-lite-16b"


@pytest.mark.parametrize("arch,layout,call", cases((ARCH,)))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)


@pytest.mark.parametrize("layout", ("2x2", "2x2-b1", "1x4"))
def test_count_serve_is_the_real_pass_comm(layout):
    check_serve(ARCH, layout)
