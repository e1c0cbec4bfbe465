import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with CUDA; skips on a host without one",
    )


@pytest.fixture
def card():
    """The CUDA card, decided when the test runs; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
