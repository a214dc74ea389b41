"""The port's examples (``examples/torch_*.py``) at smoke size on the CPU:
each runs as its own process with ``--device cpu`` and prints its ``OK``
line, as its counterpart in ``examples/`` does. ``torch_train_100m.py``
runs its ``--smoke`` widths for 40 steps (the failure injected at step 20,
before the first checkpoint at 25: the trainer restarts from step 0), into
a fresh checkpoint directory.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart.py": ([], "quickstart OK"),
    "torch_serve_migration.py": (
        [], "serving migration OK (replica exact, decode resumed)"),
    "torch_train_100m.py": (["--smoke", "--steps", "40"], "train_100m OK"),
    "torch_elastic_rescale.py": ([], "elastic rescale OK"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example at once, each in its own process."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for name, (args, _) in EXAMPLES.items():
        if name == "torch_train_100m.py":
            args = args + ["--ckpt", str(ckpt / "run")]
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
             *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=str(ckpt))
    out = {}
    try:
        for name, p in procs.items():
            out[name] = (p.communicate(timeout=300)[0], p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_cpu(runs, name):
    text, code = runs[name]
    assert code == 0, text[-3000:]
    assert EXAMPLES[name][1] in [ln.strip() for ln in text.splitlines()]


def test_train_100m_restarts_after_the_failure(runs):
    text, _ = runs["torch_train_100m.py"]
    assert "simulated node failure at step 20" in text
    assert "restarts: 1" in text
    assert "improved=True" in text


def test_examples_import_no_jax():
    for name in EXAMPLES:
        src = (ROOT / "examples" / name).read_text()
        assert "import jax" not in src and "from repro." not in src \
            and "from repro " not in src, name
