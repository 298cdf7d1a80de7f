"""On the card, at each cell's own size: the program passes the comparison
and the control (the plain reference in the program's place with TF32 on,
one precision step below the configuration's) fails it, on three seeds.
Run on a machine with a card:

    python -m pytest benchmark/tests/test_bench_controls_cuda.py -m cuda
"""
import pytest
import torch

from benchmark.harness.main import cell_spec, run_cell

CELLS = ("second_iou_f32.train", "second_iou.see_gt")
CONTROL = {"program": "benchmark.reference.seeref", "control": True}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    spec = cell_spec(cell)
    for seed in (2**31 + 1001, 2**31 + 2003, 2**31 + 3001):
        assert run_cell(spec, seed, 3.0, False)["correct"]
        assert not run_cell(spec, seed, 3.0, False, overrides=CONTROL)["correct"]
