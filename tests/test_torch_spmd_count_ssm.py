"""The count of tests/test_torch_spmd_count.py (its note says what is
held) for the Mamba-2 mixer: mamba2-370m's smoke config (in_proj's and the
conv's outputs gathered over "model"; at batch 1 the SSM heads split
over "data" and the gated output gathered over it)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_count import (  # noqa: F401  (a fixture)
    cases, check_call, check_serve, one_torch_thread,
)

ARCH = "mamba2-370m"


@pytest.mark.parametrize("arch,layout,call", cases((ARCH,)))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)


@pytest.mark.parametrize("layout", ("2x2", "2x2-b1", "1x4"))
def test_count_serve_is_the_real_pass_comm(layout):
    check_serve(ARCH, layout)
