"""``run.py`` fails, and prints no result, where it cannot measure: without
a card (it never falls back to the CPU) and in a directory that holds only
the benchmark's own files."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(cwd: pathlib.Path, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tick-16k-refit",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(out) -> bool:
    for line in out.stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            pass
    return True


@pytest.fixture
def no_card_env():
    torch = pytest.importorskip("torch")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    return env


def test_without_a_card_it_fails(no_card_env):
    out = _run(ROOT, no_card_env)
    assert out.returncode == 3, out.stderr[-2000:]
    assert _no_result(out) and "card" in out.stderr


def test_with_only_the_benchmark_files_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, {k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert _no_result(out)
