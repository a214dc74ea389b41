"""Training launcher (``repro``'s ``launch/train.py`` on torch).

Real optimization steps on a config (its ``.smoke()`` reduction by
default) through the fault-tolerant ``Trainer``: checkpoints and restart,
per-step ALMA telemetry. ``--device`` defaults to the card and raises
without one.

The launcher sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
(unless the caller sets its own) before torch is imported: a full-size
state pre-copied on its own card (``runtime/elastic.rescale``) fits only
in segments that grow in place.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1p8b \\
      --steps 20 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1p8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tcfg, batch=args.batch, seq=args.seq,
                      device=args.device)
    out = trainer.run(args.steps)
    for i, h in enumerate(out["history"]):
        if i % args.log_every == 0:
            print(f"step={i + 1} loss={h['loss']:.4f} "
                  f"dirty={h.get('dirty_fraction', 0.0):.3f} "
                  f"t={h['step_time'] * 1e3:.1f}ms")
    print(json.dumps({k: v for k, v in out.items() if k != "history"},
                     default=float))


if __name__ == "__main__":
    main()
