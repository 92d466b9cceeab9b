"""On the card: the tiny cell through the harness with a traced slice.
The device trace finds the port's pair, k-space and rebin kernels, the
slice's busy time is inside its window, and the run is correct at f32.
Skips without a CUDA card (decided inside the test)."""
import time

import pytest
import torch

from mdbench.harness import cell

from . import tiny


@pytest.mark.gpu
def test_traced_tiny_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, tr, lim = tiny.cell(tmp_path)
    run = cell.run(cfg, tr, 2 ** 31 + 5, 1.0, True, "cuda",
                   time.perf_counter(), lim)
    t = run.trace
    assert {"pair", "kspace", "rebin"} <= set(t["by_layer"])
    assert 0 < t["busy_s"] <= t["window_s"]
    assert t["steps"] == tr["thermo"] * tr["trace_intervals"]
    for k in ("start_x", "start_v", "follow_x", "temp"):
        assert run.checks[k]["value"] <= run.checks[k]["limit"], k
