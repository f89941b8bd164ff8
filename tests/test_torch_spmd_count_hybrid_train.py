"""The count of tests/test_torch_spmd_count.py (its note says what is
held) for jamba-1.5-large-398b's hybrid stack trained: its smoke config
(attention, Mamba-2 and the MoE in one period) through one train step
with Adafactor, its optimizer in the dry run."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_count import (  # noqa: F401  (a fixture)
    cases, check_call, one_torch_thread,
)


@pytest.mark.parametrize("arch,layout,call",
                         cases(("jamba-1.5-large-398b",), ("train",)))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)
