"""The count of tests/test_torch_spmd_count.py (its note says what is
held) for jamba-1.5-large-398b's hybrid stack: its smoke config (attention,
Mamba-2 and the MoE in one period), served; its train step is in
tests/test_torch_spmd_count_hybrid_train.py."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_count import (  # noqa: F401  (a fixture)
    cases, check_call, check_serve, one_torch_thread,
)

ARCH = "jamba-1.5-large-398b"


@pytest.mark.parametrize("arch,layout,call",
                         cases((ARCH,), ("prefill", "decode")))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)


@pytest.mark.parametrize("layout", ("2x2", "2x2-b1", "1x4"))
def test_count_serve_is_the_real_pass_comm(layout):
    check_serve(ARCH, layout)
