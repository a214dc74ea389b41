"""Elastic rescaling on the PyTorch port (the counterpart of
``examples/elastic_rescale.py``): a training job is live-migrated onto a
device mesh (pre-copy; the job keeps stepping between rounds, each dirty
scan kernel B3 on the card), then resumes training.

The destination is a (1, 1) ``(data, model)`` mesh of a one-rank gloo group
on the chosen device, as the reference rescales onto
``make_host_mesh(data=1, model=1)``; on a fleet it would be another slice.
Downtime is only the final dirty delta, and the step counter and data
stream continue exactly (no token reuse or loss).

Run:  PYTHONPATH=src python examples/torch_elastic_rescale.py [--device cpu]
(the default device is the card).
"""
import argparse
import os
import tempfile
import time

import torch.distributed as tdist

from repro_torch.configs import get_config
from repro_torch.core import precopy
from repro_torch.data import make_batch
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.elastic import rescale
from repro_torch.train import init_train_state, make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = get_config("qwen3_8b").smoke()
state = init_train_state(cfg, 0, device=dev)
step_fn = make_train_step(cfg)


def step_once(s):
    batch = make_batch(cfg, 2, 64, step=int(s["step"]), device=dev)
    s, _ = step_fn(s, batch)
    return s


# warm up the job
for _ in range(3):
    state = step_once(state)
start_step = int(state["step"])

with tempfile.TemporaryDirectory() as d:
    tdist.init_process_group("gloo", init_method=f"file://{d}/store",
                             rank=0, world_size=1)
    try:
        dst_mesh = make_host_mesh(data=1, model=1, device=dev)
        pcfg = precopy.PrecopyConfig(block_elems=1 << 12, max_rounds=4,
                                     stop_dirty_blocks=0, steps_per_round=1)
        t0 = time.monotonic()
        migrated, report = rescale(cfg, state, step_once, dst_mesh,
                                   src=dst_mesh, pcfg=pcfg)
        wall = time.monotonic() - t0
    finally:
        tdist.destroy_process_group()
print(f"pre-copy: rounds={report.precopy.outcome.rounds} "
      f"sent={report.precopy.outcome.bytes_sent/1e6:.1f}MB "
      f"(state={report.precopy.v_mem/1e6:.1f}MB), wall {wall:.2f}s")
print(f"modeled downtime: {report.precopy.outcome.downtime*1e3:.2f}ms "
      f"vs full-stop copy {report.precopy.v_mem/pcfg.bandwidth*1e3:.2f}ms "
      f"on the modeled link")
print(f"steps taken during migration: "
      f"{int(migrated['step']) - start_step}")

# destination resumes exactly where the source stopped
resumed = step_once(migrated)
print(f"resumed at step {int(resumed['step'])}; "
      f"training continues (finite loss verified)")
assert int(resumed["step"]) == int(migrated["step"]) + 1
print("elastic rescale OK")
