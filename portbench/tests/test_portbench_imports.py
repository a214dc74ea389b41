"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is not ``repro``); the references,
generators and counts import nothing of the program either."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _top_levels(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_import(path):
    assert not set(_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("kind", ["refs", "gen", "counts", "layer_metrics"])
def test_yardstick_imports_nothing_of_the_program(kind):
    for path in (BENCH / kind).glob("*.py"):
        assert "repro_torch" not in set(_top_levels(path)), path


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.core", "jaxtyping", "flaxen"], []),
    (["repro.core.cycles", "repro_torch"], ["repro"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"])])
def test_top_level_names_are_compared_whole(names, found):
    from portbench.lib import harness as H
    assert H.forbidden_modules(names) == found


def test_what_a_run_loads_holds_no_jax():
    """Every module a run can load (the harness, each driver, reference and
    per-layer metric, and the program modules they import) in a fresh
    interpreter, then the loaded top-level names."""
    pytest.importorskip("torch")
    code = """
import sys, json
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from portbench import run
from portbench.lib import harness as H, trace, serve, lm
for kind in ("drivers", "refs", "layer_metrics"):
    for p in sorted((H.BENCH / kind).glob("*.py")):
        H.load_module(kind, p.stem)
import repro_torch.core.surveillance, repro_torch.core.precopy
import repro_torch.launch.serve, repro_torch.train
print(json.dumps(H.forbidden_modules()))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
