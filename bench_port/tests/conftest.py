"""The benchmark's own tests (``python -m pytest bench_port/tests``): on
the CPU at small sizes, with one torch thread. A test that needs the card
is marked ``cuda`` and skips without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True, scope="session")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
