"""On the card: the control, the plain reference with TF32 products in
the program's place, fails a number of each cell at the cell's own size,
while the program passes. Skips where torch finds no CUDA card; about a
minute a cell on an H100."""

import pytest
import torch

from gsbench import harness
from gsbench.tests.tiny import FIT, REPO, SERVE


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [FIT, SERVE])
def test_control_fails(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.find_cell(REPO, cell)
    kind = harness.traffic_kind(REPO, c["traffic"]["kind"])
    run = kind.Run(c, 2**31 + 77, torch.device("cuda", 0), tmp_path, print)
    if c["traffic"]["kind"] == "serve":
        run.window(2.0)
    run.release()
    ref = run.reference_outputs()
    assert all(v <= lim for _, v, lim in run.compare(run.outputs(), ref))
    ctrl = run.reference_outputs(tf32=True)
    assert any(v > lim for _, v, lim in run.compare(ctrl, ref))
