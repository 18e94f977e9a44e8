"""`run.py` needs a card: without one it exits non-zero and prints no
result line; so it does in a directory that holds only BENCHMARK.json and
benchmark/ (where, on a card, the program's import fails)."""

import shutil
import subprocess
import sys

import torch

from harness import spec


def run_in(root):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "seg2cat-batch32",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)


def assert_no_result(proc):
    assert proc.returncode != 0
    assert "correct" not in proc.stdout and "metrics" not in proc.stdout


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        return      # on a card the run measures; the stripped copy below still fails
    proc = run_in(spec.ROOT)
    assert_no_result(proc)
    assert "CUDA device" in proc.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert_no_result(run_in(tmp_path))
