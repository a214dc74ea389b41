"""Quickstart on the PyTorch port: the whole ALMA pipeline in one file,
smoke scale (the counterpart of ``examples/quickstart.py``).

1. Train a reduced qwen3-style model for a handful of steps while collecting
   ALMA load-index telemetry.
2. Characterize the workload (Naive Bayes -> LM/NLM) and extract its cycle
   (FFT, Algorithm 1: kernels B1 and B2 on the card).
3. Submit a migration request through the LMCM and watch it be postponed to
   a suitable moment (Algorithm 2).
4. Execute the migration with the pre-copy engine (dirty scans: kernel B3
   on the card) while the job keeps training, and verify the destination
   state is exact.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the default device is the card).
"""
import argparse

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import precopy
from repro_torch.core.fleetsim import FleetSim, SimJob, WorkloadTrace
from repro_torch.core.orchestrator import MigrationRequest
from repro_torch.data import make_batch
from repro_torch.kernels.backend import resolve_device
from repro_torch.train import init_train_state, make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

print("=== 1. train a reduced model, collect telemetry ===")
cfg = get_config("qwen3_8b").smoke()
state = init_train_state(cfg, 0, device=dev)
step = make_train_step(cfg, telemetry=True)
for i in range(8):
    batch = make_batch(cfg, 2, 64, step=i, device=dev)
    state, metrics = step(state, batch)
    print(f"  step {i}: loss={float(metrics['loss']):.4f} "
          f"dirty={float(metrics['dirty_fraction']):.2f}")

print("\n=== 2. characterize + recognize cycles (paper §4) ===")
trace = WorkloadTrace([("MEM", 30), ("CPU", 60), ("IDLE", 30)], 3600)
sim = FleetSim([SimJob("job0", trace, v_bytes=1e9)], policy="alma-paper",
               warmup_s=600.0, device=dev)
model = sim.lmcm.refresh_job("job0")
print(f"  detected cycle: period={model.period} samples "
      f"(truth 120), confidence={model.confidence:.3f}")
print(f"  ArrayLM[:8]={model.array_lm[:8].tolist()} "
      f"ArrayNLM[:8]={model.array_nlm[:8].tolist()}")

print("\n=== 3. LMCM postpones a migration out of the MEM phase (Alg. 2) ===")
res = sim.run_with_plan([MigrationRequest("job0", sim.now, 1e9)],
                        horizon_s=600.0)
req = res.migrations[0]
print(f"  requested at t={req.created_at:.0f}s "
      f"(phase={trace.phase_at(req.created_at)})")
print(f"  fired at     t={req.scheduled_at:.0f}s "
      f"(phase={trace.phase_at(req.scheduled_at)})")
print(f"  migration: {req.outcome.total_time:.1f}s, "
      f"{req.outcome.bytes_sent/1e6:.0f} MB, rounds={req.outcome.rounds}")

print("\n=== 4. live pre-copy migration of the real training state ===")
box = {"s": state}


def train_once():
    b = make_batch(cfg, 2, 64, step=int(box["s"]["step"]), device=dev)
    box["s"], _ = step(box["s"], b)


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


dest, report = precopy.migrate(
    lambda: box["s"], train_once,
    precopy.PrecopyConfig(block_elems=1 << 12, max_rounds=4,
                          stop_dirty_blocks=0))
exact = all(same_bits(a, b) for a, b in
            zip(tree.leaves(dest), tree.leaves(box["s"])))
print(f"  rounds={report.outcome.rounds} "
      f"bytes={report.outcome.bytes_sent/1e6:.1f}MB "
      f"downtime(model)={report.outcome.downtime*1e3:.2f}ms exact={exact}")
assert exact
print("\nquickstart OK")
