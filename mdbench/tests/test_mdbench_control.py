"""The control (the reference in bfloat16 in the program's place) comes
out not correct on the tiny cell, as it does on the chip at the cell's
size (``python3 mdbench/control.py``); the same control in f32 reads
under the limits of the numbers that f32 rounding alone sets."""
import pytest
import torch

from mdbench import control
from mdbench.harness import checks

from . import tiny


@pytest.mark.parametrize("dump", [False, True], ids=["thermo", "dump"])
def test_bfloat16_control_fails(tmp_path, dump):
    cfg, tr, lim = tiny.cell(tmp_path, dump)
    r = control.readings(cfg, tr, 5, 10, "cpu", torch.bfloat16)
    judged = checks.judge(r, lim)
    failed = [k for k, c in judged.items() if c["value"] > c["limit"]]
    assert failed
    # every position, velocity and force number fails by itself
    for k in ("start_x", "follow_x", "force_max", "force_rms"):
        assert k in failed
    if dump:
        assert "pe_atom" in failed and "stress_atom" in failed


def test_f32_control_reads_under_the_rounding_limits(tmp_path):
    cfg, tr, lim = tiny.cell(tmp_path)
    r = control.readings(cfg, tr, 5, 10, "cpu", torch.float32)
    for k in ("start_x", "start_v", "temp", "follow_x", "follow_v"):
        assert r[k] <= lim["limits"][k], k
