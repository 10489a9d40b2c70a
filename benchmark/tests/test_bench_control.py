"""On the card: the control (the reference in the nearest lower precision,
TF32 matmuls and einsums, in the program's place) comes out not correct
against the cell's limits, and the program comes out correct, at sizes a
test run holds, the traffic's overrides read from the kind's ``CONTROL``:
the VO cell at the camera's full size with a shorter stream, the BA cell
at 512 windows a call.

    python -m pytest benchmark/tests/test_bench_control.py -q
"""

import copy

import pytest
import torch

from benchmark.harness import cell as cell_mod, compare, spec as spec_mod
from benchmark.tests._tiny import all_cells, kind_module


@pytest.mark.cuda
@pytest.mark.parametrize("name", all_cells())
def test_control_fails_and_program_holds(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec_mod.cell(name)
    tr = dict(copy.deepcopy(c.traffic), **kind_module(c.traffic["kind"]).CONTROL)
    cell = spec_mod.Cell(name=name, chips=1, config=c.config, traffic=tr,
                         end_to_end=c.end_to_end, per_layer=c.per_layer, limits=c.limits)
    drv = cell_mod.driver(cell, 2**32 + 3, torch.device("cuda", 0))
    drv.setup()
    drv.window(2.0)
    drv.release()
    program = compare.held(drv.check(), c.limits)
    control = compare.held(drv.control(), c.limits)
    assert all(k.ok for k in program), program
    assert not all(k.ok for k in control), control
