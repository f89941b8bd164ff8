import numpy as np
import pytest


@pytest.fixture(scope="session")
def tpch_small():
    """Shared tiny TPC-H catalog (sf=0.01)."""
    from repro.tpch import generate
    return generate(sf=0.01, seed=7)


@pytest.fixture(scope="session")
def tpch_tiny():
    """Minimal catalog for interpret-mode kernel paths (sf=0.002)."""
    from repro.tpch import generate
    return generate(sf=0.002, seed=11)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with CUDA (the port's hand "
        "kernels); skipped where torch.cuda.is_available() is false")
