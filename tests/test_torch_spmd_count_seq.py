"""The count of tests/test_torch_spmd_count.py (its note says what is
held) for the sequence split: minitron-4b's smoke config (6 query and 2 kv heads:
on a model axis of 4 its weights gathered, each point's query rows
against the gathered k and v, its cache's slots split over "model"; on
2 its heads split whole)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_spmd_count import (  # noqa: F401  (a fixture)
    cases, check_call, check_serve, one_torch_thread,
)

ARCH = "minitron-4b"


@pytest.mark.parametrize("arch,layout,call", cases((ARCH,)))
def test_count_is_the_real_runs_comm(arch, layout, call, monkeypatch):
    check_call(arch, layout, call, monkeypatch)


@pytest.mark.parametrize("layout", ("2x2", "2x2-b1", "1x4"))
def test_count_serve_is_the_real_pass_comm(layout):
    check_serve(ARCH, layout)
