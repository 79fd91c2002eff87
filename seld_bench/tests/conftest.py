"""The benchmark's tests: run them with `python -m pytest seld_bench/tests`.

Tests marked `card` need a CUDA card; each decides inside the test (the
`card` fixture) and skips on a machine without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
