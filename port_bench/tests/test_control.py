"""The control comes out not correct: the reference computed in the
precision below the configuration's (fp8 operands for a bf16
configuration) put in the program's place reads above each cell's limit,
while the program reads below it.  On the CPU at tiny sizes; with the
``gpu`` marker at each cell's own size on the card (three seeds, through
``calibrate.readings``, which prints the same lines as ``calibrate.py``)."""
import json

import pytest

from port_bench import calibrate
from port_bench.harness import spec as S
from port_bench.tests.tiny import tiny_cell

CELLS = ["qwen2-1.5b.longprompt", "olmoe-1b-7b.decode", "qwen2-1.5b.admm-train"]


def _fails(cell, readings):
    """The numbers of the cell whose fp8 reading passes its limit."""
    return [k for k, v in readings.items()
            if k.endswith(".fp8") and k[:-len(".fp8")] in cell.limits
            and v > cell.limits[k[:-len(".fp8")]]]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program_at_a_tiny_size(name):
    """At a tiny size the limits (set at the cell's size) do not apply;
    the control still reads at least twice the program on one of the
    cell's compared numbers."""
    cell = tiny_cell(name)
    [(m, line)] = calibrate.readings(cell, [2 ** 31 + 5], 0.3, device="cpu")
    r = line["readings"]
    compared = [c["name"] for c in m.checks if c["name"] in r]
    assert any(r[f"{k}.fp8"] >= 2 * r[k] and r[f"{k}.fp8"] > 0 for k in compared), r


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = S.load_cell(name)
    for m, line in calibrate.readings(cell, [9001, 9002, 9003], 5.0):
        print(json.dumps(line), flush=True)
        assert m.correct, line
        assert _fails(cell, line["readings"]), line
