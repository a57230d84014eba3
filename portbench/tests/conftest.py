"""The benchmark's own tests (`python -m pytest portbench/tests -q` from the
repository's root; the repository's tier-1 run collects tests/ only).
They run on the CPU at small sizes; those marked `gpu` need a CUDA card
and skip without one, deciding inside the `card` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
