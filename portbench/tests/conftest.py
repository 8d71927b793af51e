"""The benchmark's own tests: the CPU at tiny widths, the card where a test
is marked `cuda`. Run them with `python -m pytest portbench/tests -q`."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
