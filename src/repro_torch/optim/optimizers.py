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

On a mesh (``apply_updates(..., mesh=, specs=)``: the params, grads and
state are a rank's slices, ``specs`` their leaves' specs) AdamW is
element-wise and runs on the slices as they are; the global norm sums
every rank's squares, a replicated slice's share divided by its replica
count so that each element counts once; Adafactor's row and column means,
the mean of ``vr`` and the update's rms span the ranks a dimension is cut
over (sums all-reduced there, divided by the whole dimension).
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


def _sum_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over the ranks of each of ``axes`` (no gradient)."""
    import torch.distributed as tdist
    for a in axes:
        if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
            t = t.clone()
            tdist.all_reduce(t, group=mesh.get_group(a))
    return t


def global_norm(grads, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each leaf's square summed
    with f32 accumulation (no f32 copy of a bf16 leaf). With ``mesh`` the
    leaves are slices with ``specs``: each slice's squares over its replica
    count, summed over every rank."""
    sums = [torch.sum(torch.square(g), dtype=F32) for g in tree.leaves(grads)]
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    from repro_torch.launch.sharding import replicas
    share = torch.tensor([1.0 / replicas(mesh, s) for s in specs],
                         dtype=F32, device=sums[0].device)
    total = _sum_over(torch.sum(torch.stack(sums) * share), mesh,
                      mesh.mesh_dim_names)
    return torch.sqrt(total)


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


def _mean(t: torch.Tensor, dim, cut, keepdim: bool = False) -> torch.Tensor:
    """``torch.mean(t, dim, dtype=f32)`` where ``cut`` is None; else ``cut``
    = (mesh, axes) the ranks ``dim`` is split over: the sums all-reduced
    there, over the whole dimension's count."""
    if cut is None or not cut[1]:
        return torch.mean(t, dim=dim, keepdim=keepdim, dtype=F32)
    mesh, axes = cut
    n = t.numel() if dim is None else t.shape[dim]
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    s = (torch.sum(t, dtype=F32) if dim is None
         else torch.sum(t, dim=dim, keepdim=keepdim, dtype=F32))
    return _sum_over(s, mesh, axes) / n


def _adafactor_leaf(cfg: ArchConfig, g, v, p, lr, scale, decay=0.99,
                    eps=1e-30, clip_thresh=1.0, *, mesh=None, spec=None):
    """One leaf's update; elementwise math in ``g``'s dtype, reductions in
    f32, the result promoted as the reference's jnp arithmetic promotes.
    With ``mesh`` the leaf is a slice cut by ``spec``."""
    from repro_torch.launch.sharding import spec_axes
    dt = g.dtype

    def cut(*dims):                    # the mesh axes of the given dims
        if mesh is None:
            return None
        full = tuple(spec) + (None,) * (g.dim() - len(spec))
        sel = full if not dims else tuple(full[d] for d in dims)
        return mesh, spec_axes(sel)

    if g.dim() >= 2:
        sq = torch.square(g)
        g2m_r = _mean(sq, -1, cut(-1))
        g2m_c = _mean(sq, -2, cut(-2))
        del sq
        s2 = scale ** 2
        vr = decay * v["vr"] + (1 - decay) * (g2m_r * s2 + eps)
        vc = decay * v["vc"] + (1 - decay) * (g2m_c * s2 + eps)
        r = vr / torch.clamp(_mean(vr, -1, cut(-2), keepdim=True), min=eps)
        denom = (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                 + 1e-8)
        step = (g * scale.to(dt)) / denom.to(dt)
        new_v = {"vr": vr, "vc": vc}
    else:
        gf = g.to(F32) * scale
        nv = decay * v["v"] + (1 - decay) * (gf * gf + eps)
        step = (gf / (torch.sqrt(nv) + 1e-8)).to(dt)
        new_v = {"v": nv}
    rms = torch.sqrt(_mean(torch.square(step), None, cut()) + 1e-30)
    limit = torch.clamp(rms / clip_thresh, min=1.0).to(dt)
    ct = torch.promote_types(dt, p.dtype)
    wd = torch.tensor(cfg.weight_decay, dtype=dt, device=p.device).to(ct)
    upd = (step / limit).to(ct) + wd * p.to(ct)
    new_p = (p.to(ct) - lr.to(dt).to(ct) * upd).to(p.dtype)
    return new_p, new_v


def _adafactor_update(cfg: ArchConfig, params, grads, state: OptState, lr,
                      scale, mesh=None, specs=None) -> Tuple[Any, OptState]:
    count = state["count"] + 1
    by_leaf = ({} if specs is None
               else dict(zip(map(id, tree.leaves(params)), specs)))
    pairs = _zip_map(lambda g, v, p: _adafactor_leaf(
                         cfg, g, v, p, lr, scale, mesh=mesh,
                         spec=by_leaf.get(id(p))),
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
                  lr, *, mesh=None, specs=None
                  ) -> Tuple[Any, OptState, torch.Tensor]:
    """Clip-by-global-norm then the optimizer's update. Returns (new params,
    new state, grad norm). AdamW's moments and master in ``state`` are
    updated in place and handed back in the new state. ``mesh`` and
    ``specs`` (the param leaves' specs, ``tree.leaves`` order): the trees
    are a rank's slices."""
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-6),
                        max=1.0)
    if cfg.optimizer == "adafactor":
        params, state = _adafactor_update(cfg, params, grads, state, lr,
                                          scale, mesh, specs)
    else:
        params, state = _adamw_update(cfg, params, grads, state, lr, scale)
    return params, state, gnorm
