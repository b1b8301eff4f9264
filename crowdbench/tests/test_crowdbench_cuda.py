"""On the card: one short run of every cell through the benchmark's own
command, correct, with the keys the result line must have, and the
control judged not correct at each configuration's own size. Skipped
without a card (the check is made in a fixture, never at import).

    python3 -m pytest crowdbench/tests/test_crowdbench_cuda.py -q
"""

import json
import subprocess
import sys

import pytest

from crowdbench import spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "crowdbench.run", "--workload", cell,
         "--seed", str(2**31 + 17), "--seconds", "3", "--trace",
         str(trace)], cwd=str(spec.ROOT), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    c = spec.resolve(cell)
    want = c.per_layer if trace else c.end_to_end
    assert {m["name"] for m in want} == set(result["metrics"])
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(  # each configuration's first cell
    {w["config"]: w["name"]
     for w in reversed(spec.load_spec()["workloads"])}.values()))
def test_control_is_not_correct_at_the_cells_size(card, cell):
    """The bfloat16 reference in the program's place, on the cell's own
    scans, comes out not correct, and the program correct."""
    proc = subprocess.run(
        [sys.executable, "-m", "crowdbench.control", "--workload", cell,
         "--seeds", "1", "--first-seed", str(2**31 + 23), "--seconds", "1"],
        cwd=str(spec.ROOT), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "control correct on 0 of 1 seeds" in proc.stdout
