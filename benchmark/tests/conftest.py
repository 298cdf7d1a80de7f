import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    from benchmark.tests.tiny import make_tiny_copy
    torch.set_num_threads(4)
    return make_tiny_copy(tmp_path_factory.mktemp("tiny"))
