"""On the card, at each cell's own size: on three seeds, the program's
numbers keep to the cell's limits and the control's (the reference in the
precision below the configuration's) do not. Skips without a CUDA card;
run on the card with ``python -m pytest perfbench/tests/test_perfbench_chip.py``
(about three minutes on an H100 for the two cells)."""
import pytest
import torch

from perfbench import harness
from perfbench.calibrate import readings

CONTROL = {"search.opt-1.3b": "tf32", "search.qwen3-4b": "fp8"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    harness.cache_env()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_fails_at_the_cells_size(card, cell):
    c = harness.load_cell(cell)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        r = readings(c, seed, 10.0, CONTROL[cell], card)
        assert r["program_correct"], r
        assert not r["control_correct"], r
