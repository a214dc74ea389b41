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

Each returns its input unchanged when the axis has one rank (a (1, 1)
mesh runs no copy and no backend call), and so does its gradient.

The model on a ``(data, model)`` mesh (``models/blocks``, ``models/lm``)
runs the collectives GSPMD inserts for the reference, in Megatron's form:
every rank of a ``model`` group computes the same loss, so a
tensor-parallel region is entered by ``copy_to_tp`` (identity forward,
all-reduce backward) and left by ``reduce_from_tp`` (all-reduce forward,
identity backward); with ``seq_shard`` the residual stream is split along
the sequence, entered by ``all_gather`` along it (reduce-scatter
backward) and left by ``reduce_scatter`` (all-gather backward):
``tp_enter`` and ``tp_exit`` pick the pair. ``gather_split`` (all-gather
forward, this rank's chunk backward) and ``split`` (the chunk forward,
all-gather backward) move a tensor between a split layout and a
replicated one; ``scale_grad`` scales a gradient only. A leaf whole on
every ``model`` rank but used rank by rank (a norm's scale, the Mamba2
and RWKV6 per-head leaves) enters through ``tp_param`` (``copy_to_tp``),
or ``tp_block`` for the rank's part of it; ``tp_sum`` adds per-rank
partial statistics (the Mamba2 gated norm's sum of squares) that every
rank then uses alike (all-reduce both ways). The
expert-parallel MoE layer keeps the exact adjoints above (every
collective's backward its transpose, as ``lax``'s); ``lm._moe``
adapts it to the replicated loss.

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
    # decode: the whole window W of the KV rings, which tells a ring block
    # that is a whole ring (``model`` divides neither its KV heads nor W)
    # from 1/tp of a ring cut along its window (``blocks.ring_split``)
    kv_window: Optional[int] = None


_state = threading.local()


def current() -> Optional[DistContext]:
    return getattr(_state, "ctx", None)


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """The identity on this rank's tensor. The reference's
    ``constrain_heads`` is a GSPMD layout hint (shard a head-major tensor
    over the batch and model axes); a rank running eager code already
    holds its batch block, and a tensor-parallel layer computes only its
    own block of heads, or every head where ``model`` does not cut them
    (``blocks.head_split``), so the layout it asks for is local by
    construction and there is no compiler to hint."""
    return x


def model_context(mesh, seq_shard: bool = False,
                  kv_window: Optional[int] = None) -> "DistContext":
    """The context of the model on ``mesh``: its batch axes, ``model`` the
    tensor-parallel axis, the sequence split when ``seq_shard``, and for
    decode the KV rings' whole window (``DistContext.kv_window``)."""
    return DistContext(mesh, meshlib.batch_axes(mesh), seq_shard=seq_shard,
                       kv_window=kv_window)


def tp_size(ctx: Optional[DistContext]) -> int:
    return 1 if ctx is None else meshlib.axis_size(ctx.mesh, ctx.tp_axis)


def tp_rank(ctx: Optional[DistContext]) -> int:
    return 0 if ctx is None else meshlib.axis_rank(ctx.mesh, ctx.tp_axis)


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


def _one(mesh, axis: str) -> bool:
    return meshlib.axis_size(mesh, axis) == 1


def _chunks_summed(g: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim``: chunk j of every rank's ``g`` summed
    on rank j, in rank order (an all-to-all, since gloo has no
    reduce-scatter)."""
    gt = g.movedim(dim, 0).contiguous()
    parts = torch.empty_like(gt)
    tdist.all_to_all_single(parts, gt, group=grp)
    n = tdist.get_world_size(grp)
    return parts.reshape(n, -1, *gt.shape[1:]).sum(0).movedim(0, dim)


def _gathered(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((tdist.get_world_size(grp) * xt.shape[0],
                        *xt.shape[1:]))
    tdist.all_gather_into_tensor(out, xt, group=grp)
    return out.movedim(0, dim).contiguous()


def _own_chunk(g: torch.Tensor, grp, dim: int) -> torch.Tensor:
    n, r = tdist.get_world_size(grp), tdist.get_rank(grp)
    step = g.shape[dim] // n
    return g.narrow(dim, r * step, step).contiguous()


def _summed(x: torch.Tensor, grp) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, group=grp)
    return out


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; backward sums each rank's share of the
    gradient back to it (``_chunks_summed``).
    ``torch.distributed.nn.functional.all_gather`` is not used: its
    backward on gloo passes group ranks to ``scatter`` as global ranks and
    fails on any group but the world."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _gathered(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunks_summed(g, ctx.grp, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the ranks, this rank's chunk along ``dim`` kept; backward
    all-gathers the chunks' gradients (the transpose)."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _chunks_summed(x, grp, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.grp, ctx.dim), None, None


class _GatherSplit(torch.autograd.Function):
    """All-gather along ``dim`` into a tensor every rank then uses alike;
    backward keeps this rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _gathered(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.grp, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a replicated tensor; backward
    all-gathers the chunks' gradients into the replicated one."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _own_chunk(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.grp, ctx.dim), None, None


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward (the
    gradients of a replicated input's per-rank uses summed)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.grp), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward (every
    rank's partial sum gets the replicated gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, grp):
        return _summed(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, end to end along ``dim`` in rank
    order (``lax.all_gather(x, axis, axis=dim, tiled=True)``), contiguous
    (the products that read it see the layout of the local path's
    weights). Backward: the transpose, a reduce-scatter."""
    if _one(mesh, axis):
        return x
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Dim 0 of ``x`` cut into one equal chunk per rank of ``axis``, chunk
    j sent to rank j; the chunks received are stacked along dim 0 in rank
    order."""
    if _one(mesh, axis):
        return x
    x = x.contiguous()
    with _functional() as F:
        return F.all_to_all_single(torch.empty_like(x), x, None, None,
                                   group=mesh.get_group(axis))


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (``lax.psum``);
    backward the same sum of the gradients."""
    if _one(mesh, axis):
        return x
    with _functional() as F:
        return F.all_reduce(x, op=tdist.ReduceOp.SUM,
                            group=mesh.get_group(axis))


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, this rank's chunk along ``dim``
    kept (``lax.psum_scatter(tiled=True)``); backward all-gathers."""
    if _one(mesh, axis):
        return x
    return _ReduceScatter.apply(x, mesh.get_group(axis), dim)


def gather_split(x: torch.Tensor, mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """All-gather along ``dim`` into a tensor every rank of ``axis`` uses
    alike (its gradient replicated); backward keeps this rank's chunk."""
    if _one(mesh, axis):
        return x
    return _GatherSplit.apply(x, mesh.get_group(axis), dim)


def split(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a tensor replicated over
    ``axis``; backward all-gathers the gradient."""
    if _one(mesh, axis):
        return x
    return _Split.apply(x, mesh.get_group(axis), dim)


def copy_to_tp(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity forward, all-reduce over ``axis`` backward."""
    if _one(mesh, axis) or not torch.is_grad_enabled():
        return x
    return _CopyToTP.apply(x, mesh.get_group(axis))


def reduce_from_tp(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce over ``axis`` forward, identity backward."""
    if _one(mesh, axis):
        return x
    return _ReduceFromTP.apply(x, mesh.get_group(axis))


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The element-wise max over ``axis``, without a gradient."""
    if _one(mesh, axis):
        return x.detach()
    out = x.detach().clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=mesh.get_group(axis))
    return out


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity forward; backward multiplies the gradient by ``s``."""
    if s == 1.0 or not torch.is_grad_enabled():
        return x
    return _ScaleGrad.apply(x, s)


# ---------------------------------------------------------------------------
# tensor-parallel regions of the model
# ---------------------------------------------------------------------------
def tp_enter(x: torch.Tensor, ctx: DistContext, *, exact: bool = False
             ) -> torch.Tensor:
    """The residual stream ``x`` entering a tensor-parallel region: with
    ``seq_shard`` all-gathered along the sequence (dim 1; reduce-scatter
    backward), else ``copy_to_tp`` (replicated; the identity with
    ``exact``, the transpose convention of the MoE layer)."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    if ctx.seq_shard:
        return all_gather(x, mesh, tp, dim=1)
    return x if exact else copy_to_tp(x, mesh, tp)


def tp_exit(x: torch.Tensor, ctx: DistContext, *, exact: bool = False
            ) -> torch.Tensor:
    """A region's partial sums leaving it: with ``seq_shard``
    reduce-scattered along the sequence (all-gather backward), else
    ``reduce_from_tp`` (``all_reduce`` with ``exact``)."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    if ctx.seq_shard:
        return reduce_scatter(x, mesh, tp, dim=1)
    return all_reduce(x, mesh, tp) if exact else reduce_from_tp(x, mesh, tp)


def tp_param(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """A leaf replicated over ``model`` whose use on a rank sees only part
    of the work (its heads, or with ``seq_shard`` its tokens): its
    gradient summed over ``model`` (``copy_to_tp``)."""
    return copy_to_tp(t, ctx.mesh, ctx.tp_axis)


def tp_block(t: torch.Tensor, ctx: DistContext, dim: int,
             ranges=None) -> torch.Tensor:
    """This rank's part along ``dim`` of a leaf that is whole on every
    ``model`` rank, taken through ``tp_param`` (its gradient lands in the
    part's place in the whole leaf and is summed over ``model``).
    ``ranges``: [(start, stop), ...] along ``dim``, end to end in that
    order; by default the rank's equal block (the rank's heads of a
    head-major dim). ``t`` itself where the part is the whole leaf (a
    one-rank axis)."""
    tp, r = tp_size(ctx), tp_rank(ctx)
    if ranges is None:
        n = t.shape[dim] // tp
        ranges = [(r * n, (r + 1) * n)]
    merged: list = []
    for a, b in ranges:                 # adjacent ranges as one
        if merged and merged[-1][1] == a:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    if merged == [(0, t.shape[dim])]:
        return t
    t = tp_param(t, ctx)
    parts = [t.narrow(dim, a, b - a) for a, b in merged]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class _SumStat(torch.autograd.Function):
    """The sum over ``model`` of per-rank partial statistics that every
    rank then uses alike: all-reduce forward, and all-reduce backward (each
    rank's gradient reaches only its own share of the work)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _summed(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.grp), None


def tp_sum(x: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """A per-rank partial sum (a norm's sum of squares over the rank's
    channels) summed over ``model``; the gradient of the result, which
    every rank uses for its own channels, summed back over ``model``."""
    if _one(ctx.mesh, ctx.tp_axis):
        return x
    return _SumStat.apply(x, ctx.mesh.get_group(ctx.tp_axis))


def fsdp(t: torch.Tensor, ctx: DistContext, full: int, dim: int
         ) -> torch.Tensor:
    """A weight's ZeRO-3 shard all-gathered over ``data`` along ``dim``
    when it was cut there (``t.shape[dim] != full``); its gradient then
    reduce-scattered, each ``data`` rank's share summed."""
    if t.shape[dim] == full:
        return t
    return all_gather(t, ctx.mesh, "data", dim=dim)
