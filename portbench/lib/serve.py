"""What the serving cells share: the port's replica on the benchmark's
weights, greedy tokens copied to the host as they come, and the check of
served tokens against the configuration's plain reference.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from portbench.lib import harness as H
from portbench.lib import lm as lmlib


def config(ctx: H.Ctx) -> dict:
    """The configuration as run: the file, with a test's ``sizes`` over
    it (tests run a small model of the same wiring on the CPU)."""
    cfg = dict(ctx.config)
    cfg.update(ctx.sizes.get("config", {}))
    return cfg


class Replica:
    """The port's serving replica: the benchmark's weights, the prefill and
    decode steps of ``launch/serve``, one batch of requests in flight."""

    def __init__(self, ctx: H.Ctx, cfg: dict, cache_len: int):
        from repro_torch.train import make_decode_step, make_prefill_step
        self.ctx, self.cfg = ctx, cfg
        if ctx.device == "cuda":
            from repro_torch.kernels import build
            build.build_all()
        self.arch = lmlib.arch_config(cfg)
        self.params = lmlib.make_params(cfg, ctx.seed, ctx.device)
        self.cache_len = cache_len
        self.prefill_fn = make_prefill_step(self.arch, cache_len=cache_len)
        self.decode_fn = make_decode_step(self.arch)
        self.cache = None
        self.tok = None
        self.pos = 0
        self.served: List[np.ndarray] = []        # (B,) ids, one per step
        self.arrivals: List[float] = []           # host time of each

    def prefill(self, tokens) -> None:
        """Prefill a batch; its first token goes to the host."""
        logits, self.cache = self.prefill_fn(self.params, {"tokens": tokens})
        self.pos = tokens.shape[1]
        self.tok = logits.argmax(-1)[:, None].to(tokens.dtype)
        self.served = []
        self.arrivals = []
        self._emit()

    def decode(self) -> None:
        """One greedy decode step; its tokens go to the host."""
        self.tok, _, self.cache = self.decode_fn(self.params, self.tok,
                                                 self.cache)
        self.pos += 1
        self._emit()

    def _emit(self) -> None:
        self.served.append(self.tok[:, 0].cpu().numpy())
        self.arrivals.append(time.perf_counter())

    def state(self) -> dict:
        return {"params": self.params, "cache": self.cache}


def judge(ctx: H.Ctx, cfg: dict, requests: List[Tuple[np.ndarray,
                                                      np.ndarray]],
          block: int) -> dict:
    """Served tokens against the reference. ``requests``: (prompt ids (P,),
    served ids (T,)) each; the reference runs once over prompt + served
    tokens and reads, at each served position, how far the served token's
    logit lies below its best. Returns the widest such gap, and with
    ``ctx.control`` the control's: at the same positions, the gap of the
    token the reference in float8 puts first."""
    import torch
    ref = H.load_module("refs", ctx.workload["config"])
    params = lmlib.make_params(cfg, ctx.seed, ctx.device)
    worst, ctrl = 0.0, 0.0
    n_tok = 0
    by_len: Dict[Tuple[int, int], list] = {}
    for p, s in requests:
        by_len.setdefault((len(p), len(s)), []).append((p, s))
    for (P, T), group in sorted(by_len.items()):
        for i in range(0, len(group), block):
            part = group[i:i + block]
            seq = np.stack([np.concatenate([p, s[:-1]]) for p, s in part])
            toks = torch.as_tensor(seq, device=ctx.device)
            at = torch.arange(P - 1, P + T - 1, device=ctx.device)
            served = torch.as_tensor(np.stack([s for _, s in part]),
                                     device=ctx.device)
            want = ref.logits(params, cfg, toks, at)
            worst = max(worst, float(ref.gaps(want, served).max()))
            n_tok += served.numel()
            if ctx.control:
                low = ref.logits(params, cfg, toks, at, quant=ref.fp8)
                ctrl = max(ctrl, float(ref.gaps(want, low.argmax(-1)).max()))
            del want
    out = {"served_logit_gap": worst, "tokens": n_tok}
    if ctx.control:
        out["control"] = ctrl
    return out
