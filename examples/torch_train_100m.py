"""End-to-end driver on the PyTorch port (the counterpart of
``examples/train_100m.py``): train a ~100M-param decoder LM with the full
production loop -- fault-tolerant Trainer (async checkpoints, restart),
telemetry (kernel B3 on the card), and a mid-run simulated node failure
that the loop absorbs by restoring from the last checkpoint.

``--smoke`` trains the same family at smoke widths on a small batch (the
CPU test runs it so).

Run:  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]
      [--ckpt DIR] [--device cpu] [--smoke]   (the default device is the card)
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                               "repro_torch_100m_ckpt"))
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
ap.add_argument("--smoke", action="store_true",
                help="smoke widths, batch 2 x 64")
args = ap.parse_args()

# ~100M params: internlm2 family, reduced depth/width
cfg = get_config("internlm2_1p8b").replace(
    num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, d_head=64,
    d_ff=2048, vocab_size=32000, remat="none", accum_steps=1,
    learning_rate=1e-3)
batch, seq = 8, 256
if args.smoke:
    cfg = cfg.smoke().replace(learning_rate=1e-3)
    batch, seq = 2, 64
print(f"params: {cfg.param_count():,}")

fail_at = args.steps // 2
state = {"failed": False}


def failure_hook(step):
    if step == fail_at and not state["failed"]:
        state["failed"] = True
        print(f"*** simulated node failure at step {step}; "
              f"restoring from checkpoint ***")
        return True
    return False


trainer = Trainer(cfg, TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=25,
                                     telemetry=True),
                  batch=batch, seq=seq, failure_hook=failure_hook,
                  device=args.device)
out = trainer.run(args.steps)

hist = out["history"]
print(f"\nsteps: {out['final_step']}  restarts: {out['restarts']}")
for i in range(0, len(hist), max(1, len(hist) // 12)):
    h = hist[i]
    print(f"  loss={h['loss']:.4f}  {h['step_time']*1e3:6.1f} ms/step")
first = np.mean([h["loss"] for h in hist[:10]])
last = np.mean([h["loss"] for h in hist[-10:]])
print(f"loss {first:.3f} -> {last:.3f}  (improved={last < first})")
assert last < first, "training failed to make progress"
print("train_100m OK")
