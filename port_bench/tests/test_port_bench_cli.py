"""The measuring command: it refuses to run without a CUDA card (no
fallback to the CPU) and prints no result line then."""

import os
import subprocess
import sys

import pytest

from conftest import ROOT


def test_command_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "kitti75-train",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_command_refuses_an_unknown_cell():
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
