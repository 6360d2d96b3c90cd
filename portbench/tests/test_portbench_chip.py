"""The committed cells on the card: one short run each through run.py,
which must print a correct result. Skips where no CUDA device is present;
run on the card with ``python -m pytest portbench/tests -m gpu``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import portbench_tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["whitney-tex2048.series", "whitney-tex4096.frames"])
def test_cell_runs_correct_on_the_card(card, name):
    cmd = [sys.executable, os.path.join(portbench_tiny.BENCH, "run.py"), "--workload", name,
           "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=1200,
                         cwd=portbench_tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
