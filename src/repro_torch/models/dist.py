"""Distribution context for model code, and the collectives it runs.

Counterpart of ``repro/models/dist.py``. Model functions are mesh-agnostic
except where a layer needs an explicit collective schedule: the
expert-parallel MoE dispatch (``blocks._moe_ffn_sharded``). The caller
installs a ``DistContext`` under ``with use(ctx):``; blocks query
``current()`` and take their local path when none is set.

The reference runs the layer under ``shard_map`` over a global array; the
port runs one process a rank (``torch.distributed``), so under a context a
layer takes this rank's block of the tokens and of the weights
(``launch/sharding.param_shardings``) and calls the collectives below on
the mesh's groups. They are autograd-aware (``all_to_all`` and
``all_reduce`` the forms of ``torch.distributed.nn.functional``,
``all_gather`` the port's own, ``_AllGather``), so gradients pass through
them as through the reference's ``lax`` collectives:

  ``lax.all_gather(tiled=True)`` -> ``all_gather``
  ``lax.all_to_all(tiled=True)`` -> ``all_to_all``
  ``lax.psum``                   -> ``all_reduce``

A rank's block (``local_tokens``): the batch split over the batch axes
when it divides them (else every batch rank holds all of it), the
sequence split over the model axis when ``seq_shard`` is set. The
reference decides the sequence split inside the layer from the global
length (it falls back when S does not divide, as in decode); a rank's
block cannot say whether it was split, so the port reads ``seq_shard`` as
the caller's statement, and ``local_tokens`` refuses a split that does not
divide: decode under a context without it.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.launch import mesh as meshlib


@dataclass(frozen=True)
class DistContext:
    mesh: Any                          # DeviceMesh
    batch_axes: Tuple[str, ...]        # ('pod', 'data') / ('data',)
    tp_axis: str = "model"
    seq_shard: bool = False
    # the reference's perf knob (refuted there): shard the expert FFN inner
    # dim over 'data' instead of ZeRO-3; ``blocks._moe_ffn_sharded``
    # refuses True
    expert_inner_shard: bool = False


_state = threading.local()


def current() -> Optional[DistContext]:
    return getattr(_state, "ctx", None)


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """The identity on this rank's tensor. The reference's
    ``constrain_heads`` is a GSPMD layout hint (shard a head-major tensor
    over the batch and model axes); a rank running eager code holds its
    local tensor already, and there is no compiler to hint."""
    return x


@contextlib.contextmanager
def use(ctx: Optional[DistContext]):
    prev = current()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def batch_size(ctx: DistContext) -> int:
    """Ranks along the batch axes together."""
    n = 1
    for a in ctx.batch_axes:
        n *= meshlib.axis_size(ctx.mesh, a)
    return n


def batch_index(ctx: DistContext) -> int:
    """This rank's index along the batch axes together (row-major)."""
    i = 0
    for a in ctx.batch_axes:
        i = i * meshlib.axis_size(ctx.mesh, a) + meshlib.axis_rank(ctx.mesh, a)
    return i


def local_tokens(ctx: DistContext, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global (B, S, ...) tensor."""
    nb, tp_n = batch_size(ctx), meshlib.axis_size(ctx.mesh, ctx.tp_axis)
    B, S = x.shape[:2]
    if B % nb == 0:
        b = B // nb
        x = x[batch_index(ctx) * b:(batch_index(ctx) + 1) * b]
    if ctx.seq_shard:
        if S % tp_n:
            raise ValueError(f"seq_shard: S = {S} does not divide the "
                             f"{ctx.tp_axis} axis ({tp_n}); use a context "
                             "without seq_shard")
        s, r = S // tp_n, meshlib.axis_rank(ctx.mesh, ctx.tp_axis)
        x = x[:, r * s:(r + 1) * s]
    return x


# ---------------------------------------------------------------------------
# autograd-aware collectives over one mesh axis
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _functional():
    """``torch.distributed.nn.functional`` warns that it is deprecated in
    favour of the private functional collectives; it is the public
    autograd-aware form, so the port keeps it and silences the warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        import torch.distributed.nn.functional as F
        yield F


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; backward sums each rank's share of the
    gradient back to it (an all-to-all of the gradient's chunks, summed in
    rank order). ``torch.distributed.nn.functional.all_gather`` is not
    used: its backward on gloo passes group ranks to ``scatter`` as global
    ranks and fails on any group but the world."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((tdist.get_world_size(grp) * xt.shape[0],
                            *xt.shape[1:]))
        tdist.all_gather_into_tensor(out, xt, group=grp)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0).contiguous()
        parts = torch.empty_like(gt)
        tdist.all_to_all_single(parts, gt, group=ctx.grp)
        n = tdist.get_world_size(ctx.grp)
        gx = parts.reshape(n, -1, *gt.shape[1:]).sum(0)
        return gx.movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, end to end along ``dim`` in rank
    order (``lax.all_gather(x, axis, axis=dim, tiled=True)``), contiguous
    (the products that read it see the layout of the local path's
    weights)."""
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Dim 0 of ``x`` cut into one equal chunk per rank of ``axis``, chunk
    j sent to rank j; the chunks received are stacked along dim 0 in rank
    order."""
    x = x.contiguous()
    with _functional() as F:
        return F.all_to_all_single(torch.empty_like(x), x, None, None,
                                   group=mesh.get_group(axis))


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (``lax.psum``)."""
    with _functional() as F:
        return F.all_reduce(x, op=tdist.ReduceOp.SUM,
                            group=mesh.get_group(axis))
