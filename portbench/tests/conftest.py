"""Fixtures of the benchmark's own tests."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True, scope="session")
def one_torch_thread():
    """The CPU runs drive small shapes through many small ops, which
    torch's thread pool only slows on a shared host."""
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
