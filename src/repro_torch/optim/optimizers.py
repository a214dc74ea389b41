"""Optimizers on torch (``repro``'s ``optim/optimizers.py``): AdamW (f32
master and moments) and Adafactor (factored second moment, no momentum).

States are plain nested dicts that mirror the params, as the reference's
pytrees do, on the params' device. The arithmetic follows the reference's
order and types: the schedule and AdamW's bias corrections in f32 tensors
(``1 - b1 ** c`` with ``c`` an f32 count, never a Python double), the
global norm with f32 accumulation inside each leaf's reduce, Adafactor's
elementwise math in the gradient's dtype with its reductions in f32.

Unlike the reference, which is functional, AdamW updates ``m``, ``v`` and
``master`` in place: at full width they are 12 bytes a parameter, and a
second copy of them would not fit beside a live migration's shadow. The
new params are always fresh tensors (``master`` cast to the param dtype,
copied even where that dtype is f32), so the old params stay intact for
the step's dirty-block telemetry. Adafactor's factored moments are small
and are replaced each step. A caller that keeps a state must not read it
again after handing it to ``apply_updates``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig

OptState = Dict[str, Any]
F32 = torch.float32


def make_schedule(cfg: ArchConfig, warmup: int = 200,
                  total: int = 10_000) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """step (int tensor) -> learning rate (f32 tensor): linear warm-up,
    then a cosine down to a tenth of ``cfg.learning_rate``."""
    peak = cfg.learning_rate

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32) + 1.0
        warm = peak * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.1 * peak + 0.9 * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return schedule


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each leaf's square summed
    with f32 accumulation (no f32 copy of a bf16 leaf)."""
    sums = [torch.sum(torch.square(g), dtype=F32) for g in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _adamw_init(params) -> OptState:
    return {
        "m": tree.map(lambda p: torch.zeros_like(p, dtype=F32), params),
        "v": tree.map(lambda p: torch.zeros_like(p, dtype=F32), params),
        "master": tree.map(lambda p: p.to(F32, copy=True), params),
    }


def _adamw_update(cfg: ArchConfig, params, grads, state: OptState, lr,
                  scale, b1=0.9, b2=0.95, eps=1e-8) -> Tuple[Any, OptState]:
    count = state["count"] + 1
    c = count.to(F32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    for g, m, v, master in zip(tree.leaves(grads), tree.leaves(state["m"]),
                               tree.leaves(state["v"]),
                               tree.leaves(state["master"])):
        g = g.to(F32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        master.sub_(lr * (step + cfg.weight_decay * master))
    new_params = _zip_map(lambda mp, p: mp.to(p.dtype, copy=True),
                          state["master"], params)
    return new_params, {"m": state["m"], "v": state["v"],
                        "master": state["master"], "count": count}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; rank-1 for matrices, dense for vectors)
# ---------------------------------------------------------------------------
def _adafactor_init(params) -> OptState:
    def factored(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                      device=p.device),
                    "vc": torch.zeros((*p.shape[:-2], p.shape[-1]),
                                      dtype=F32, device=p.device)}
        return {"v": torch.zeros_like(p, dtype=F32)}

    return {"v": tree.map(factored, params)}


def _adafactor_leaf(cfg: ArchConfig, g, v, p, lr, scale, decay=0.99,
                    eps=1e-30, clip_thresh=1.0):
    """One leaf's update; elementwise math in ``g``'s dtype, reductions in
    f32, the result promoted as the reference's jnp arithmetic promotes."""
    dt = g.dtype
    if g.dim() >= 2:
        sq = torch.square(g)
        g2m_r = torch.mean(sq, dim=-1, dtype=F32)
        g2m_c = torch.mean(sq, dim=-2, dtype=F32)
        del sq
        s2 = scale ** 2
        vr = decay * v["vr"] + (1 - decay) * (g2m_r * s2 + eps)
        vc = decay * v["vc"] + (1 - decay) * (g2m_c * s2 + eps)
        r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
        denom = (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                 + 1e-8)
        step = (g * scale.to(dt)) / denom.to(dt)
        new_v = {"vr": vr, "vc": vc}
    else:
        gf = g.to(F32) * scale
        nv = decay * v["v"] + (1 - decay) * (gf * gf + eps)
        step = (gf / (torch.sqrt(nv) + 1e-8)).to(dt)
        new_v = {"v": nv}
    rms = torch.sqrt(torch.mean(torch.square(step), dtype=F32) + 1e-30)
    limit = torch.clamp(rms / clip_thresh, min=1.0).to(dt)
    ct = torch.promote_types(dt, p.dtype)
    wd = torch.tensor(cfg.weight_decay, dtype=dt, device=p.device).to(ct)
    upd = (step / limit).to(ct) + wd * p.to(ct)
    new_p = (p.to(ct) - lr.to(dt).to(ct) * upd).to(p.dtype)
    return new_p, new_v


def _adafactor_update(cfg: ArchConfig, params, grads, state: OptState, lr,
                      scale) -> Tuple[Any, OptState]:
    count = state["count"] + 1
    pairs = _zip_map(lambda g, v, p: _adafactor_leaf(cfg, g, v, p, lr,
                                                     scale),
                     grads, state["v"], params)
    new_params = _zip_map(lambda t: t[0], pairs, stop=_is_pair)
    new_v = _zip_map(lambda t: t[1], pairs, stop=_is_pair)
    return new_params, {"v": new_v, "count": count}


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(
        x[0], torch.Tensor) and isinstance(x[1], dict)


def _zip_map(fn, first, *rest, stop=lambda x: False):
    """``fn`` over matching nodes of several trees shaped like ``first``
    (a node of ``first`` is a leaf when it is a tensor or ``stop`` says
    so); the structure of ``first`` is kept."""
    if isinstance(first, torch.Tensor) or stop(first):
        return fn(first, *rest)
    if isinstance(first, dict):
        return {k: _zip_map(fn, first[k], *(r[k] for r in rest), stop=stop)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, f, *(r[i] for r in rest), stop=stop)
                           for i, f in enumerate(first))
    raise TypeError(f"not a tree of tensors: {type(first).__name__}")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def init_opt_state(cfg: ArchConfig, params) -> OptState:
    """Zero moments (and AdamW's f32 master copy) on the params' device,
    with an int32 step ``count``."""
    state = (_adafactor_init(params) if cfg.optimizer == "adafactor"
             else _adamw_init(params))
    leaf = tree.leaves(params)[0]
    state["count"] = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return state


def apply_updates(cfg: ArchConfig, params, grads, state: OptState,
                  lr) -> Tuple[Any, OptState, torch.Tensor]:
    """Clip-by-global-norm then the optimizer's update. Returns (new params,
    new state, grad norm). AdamW's moments and master in ``state`` are
    updated in place and handed back in the new state."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-6),
                        max=1.0)
    if cfg.optimizer == "adafactor":
        params, state = _adafactor_update(cfg, params, grads, state, lr,
                                          scale)
    else:
        params, state = _adamw_update(cfg, params, grads, state, lr, scale)
    return params, state, gnorm
