"""``python3 -m evalbench.run`` prints no result and exits non-zero where
it cannot measure: without a card, and in a directory that holds only
BENCHMARK.json and the benchmark's own files."""

import shutil
import subprocess
import sys

import pytest

from evalbench.tests.conftest import ROOT

ARGS = ["-m", "evalbench.run", "--workload", "robust04.rerank-sweep",
        "--seed", "3", "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")


def test_exits_non_zero_without_a_card(no_card):
    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_exits_non_zero_with_only_its_own_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "evalbench", tmp_path / "evalbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
