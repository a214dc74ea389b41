"""The port's own rules: it never imports JAX or the JAX package, its
entry points default to the card and raise without one, and a CPU run
never launches a kernel."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fleetsim import FleetSim, SimJob, table3_traces  # noqa: E402
from repro_torch.core.orchestrator import LMCM, MigrationRequest  # noqa: E402
from repro_torch.core.surveillance import SurveillanceEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import build_replica  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix()
                              for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_cpu_fleetsim_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.core.fleetsim import FleetSim, SimJob, "
        "table3_traces\n"
        "from repro_torch.core.orchestrator import MigrationRequest\n"
        "jobs = [SimJob(j, t, 1e9) for j, t in table3_traces().items()]\n"
        "sim = FleetSim(jobs, policy='alma-paper', warmup_s=900.0, "
        "device='cpu')\n"
        "res = sim.run_with_plan([MigrationRequest(jobs[0].job_id, sim.now, "
        "1e9)], horizon_s=300.0)\n"
        "assert len(res.migrations) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_cpu_precopy_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import torch\n"
        "from repro_torch.core import precopy\n"
        "from repro_torch.launch.serve import build_replica\n"
        "r = build_replica('h2o_danube3_4b', 2, 16, 8, device='cpu')\n"
        "logits, cache = r.prefill(r.params, r.batch)\n"
        "box = {'c': cache, 't': logits.argmax(-1)[:, None].to(torch.int32)}\n"
        "def step():\n"
        "    box['t'], _, box['c'] = r.decode(r.params, box['t'], box['c'])\n"
        "dest, rep = precopy.migrate(\n"
        "    lambda: {'params': r.params, 'cache': box['c']}, step,\n"
        "    precopy.PrecopyConfig(block_elems=1 << 12, max_rounds=3,\n"
        "                          stop_dirty_blocks=0))\n"
        "assert rep.outcome.rounds == 3, rep\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [SimJob(j, t, 1e9) for j, t in table3_traces().items()]
    cfg = get_config("h2o_danube3_4b").smoke()
    for make in (lambda: FleetSim(jobs, policy="alma-paper"),
                 lambda: LMCM(policy="alma-paper"),
                 lambda: SurveillanceEngine(),
                 lambda: SurveillanceEngine(device="cuda"),
                 lambda: build_replica("h2o_danube3_4b", 2, 16, 8),
                 lambda: lm.init_params(cfg),
                 lambda: lm.init_cache(cfg, 2, 16),
                 lambda: make_batch(cfg, 2, 16),
                 lambda: params_from_numpy(cfg, {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_cpu_run_launches_no_kernel():
    ops.reset_launch_counts()
    jobs = [SimJob(j, t, 1e9) for j, t in table3_traces().items()]
    sim = FleetSim(jobs, policy="alma-paper", warmup_s=900.0, device="cpu")
    sim.run_with_plan([MigrationRequest(jobs[1].job_id, sim.now, 1e9)],
                      horizon_s=300.0)
    assert sim.lmcm.engine.jobs[jobs[1].job_id].model.period > 1
    assert ops.launch_counts() == {"power_spectrum": 0, "autocorr_score": 0,
                                   "dirty_blocks": 0, "ssm_scan": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0}
