"""On the card only: one short run of the cell through the command of
BENCHMARK.json comes out correct and prints the end-to-end metrics. Skips
without a CUDA device (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CELL, ROOT


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs on the card only")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", CELL,
         "--seed", "12345", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert {"reads_per_s.basic", "peak_mem_gib", "setup_s"} <= set(line["metrics"])


def test_without_a_card_the_run_fails_and_prints_nothing():
    """The command exits non-zero with no result where torch sees no card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
