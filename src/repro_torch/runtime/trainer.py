"""Fault-tolerant training driver (``repro``'s ``runtime/trainer.py``).

Deterministic step-indexed data, asynchronous checkpoints, NaN and
injected-failure detection with restore-and-replay, and ALMA telemetry
per step (the load indexes of ``core/telemetry.TelemetryBuffer``).
Failures are injectable (tests, ``chip_smoke.py``) through
``failure_hook``. The step time is a host clock around the step and a
device synchronize.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.telemetry import TelemetryBuffer
from repro_torch.data import SyntheticCorpus
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.train import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    telemetry: bool = True
    max_nan_restarts: int = 3
    seed: int = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, *,
                 batch: int = 8, seq: int = 128,
                 failure_hook: Optional[Callable[[int], bool]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg, self.tcfg = cfg, tcfg
        self.batch, self.seq = batch, seq
        self.corpus = SyntheticCorpus(cfg, batch, seq, seed=tcfg.seed)
        self.telemetry = TelemetryBuffer()
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir)
        self.failure_hook = failure_hook
        self.step_fn = make_train_step(cfg, telemetry=tcfg.telemetry)
        self.state = None
        self.history: List[Dict[str, float]] = []
        self.restarts = 0

    # -- lifecycle -----------------------------------------------------------
    def init_or_restore(self) -> int:
        last = latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            like = init_train_state(self.cfg, self.tcfg.seed, device="meta")
            self.state = restore_checkpoint(self.tcfg.ckpt_dir, last, like,
                                            device=self.device)
            return int(self.state["step"])
        self.state = init_train_state(self.cfg, self.tcfg.seed,
                                      device=self.device)
        return 0

    def _record(self, step: int, metrics, dt: float) -> None:
        m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        m["step_time"] = dt
        self.telemetry.record(
            step, step_time=dt,
            dirty_bytes=m.get("dirty_bytes", 0.0),
            dirty_fraction=m.get("dirty_fraction", 0.0),
            compute_util=min(1.0, 0.05 / max(dt, 1e-6)),
        )
        self.history.append(m)

    # -- the loop --------------------------------------------------------------
    def run(self, num_steps: int) -> Dict[str, Any]:
        step = self.init_or_restore()
        target = step + num_steps
        while step < target:
            if self.failure_hook is not None and self.failure_hook(step):
                # simulated node failure: drop state, restore from checkpoint
                self.ckpt.wait()
                self.state = None
                step = self.init_or_restore()
                self.restarts += 1
                continue
            batch = {k: torch.from_numpy(v.copy()).to(self.device)
                     for k, v in self.corpus.batch_at(step).items()}
            _sync(self.device)
            t0 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch)
            _sync(self.device)
            dt = time.monotonic() - t0
            if not math.isfinite(float(metrics["loss"])):
                if self.restarts >= self.tcfg.max_nan_restarts:
                    raise FloatingPointError(f"NaN loss at step {step}")
                # the pending write lands first: the restore reads finished
                # steps only (the reference races it here)
                self.ckpt.wait()
                self.state = None
                step = self.init_or_restore()
                self.restarts += 1
                continue
            step += 1
            self._record(step, metrics, dt)
            if step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return {"final_step": step, "restarts": self.restarts,
                "loss": self.history[-1]["loss"] if self.history else None,
                "history": self.history}
