"""Host meshes over the ranks of ``torch.distributed``, and the collectives
the port's sharded paths run on them.

Counterpart of ``repro/launch/mesh.py``'s host half. The reference builds
a ``jax.sharding.Mesh`` over the devices one process sees and runs its
sharded stages under ``shard_map``; the port runs one process a rank
(SPMD) and names the same axes on a ``DeviceMesh`` over the ranks of the
process group the caller has already initialised:

  ``("shard",)``        the decide plane's row split (``core/shard.py``);
  ``("data", "model")`` the model (``models/dist.py``): ``data`` the
                        batch and ZeRO-3 axis, ``model`` the tensor,
                        expert (and sequence) axis;
  ``("pod", "data", "model")`` the same with an outer data-parallel axis
                        (``make_production_mesh(multi_pod=True)``).

Axis semantics as in the reference: ``pod`` and ``data`` are the batch
axes (``batch_axes``), ``model`` is tensor/expert parallel.

Backends. NCCL runs one rank a card. Several ranks that share one card
(NCCL refuses them) or the CPU use a ``gloo`` group, which the caller
names at ``init_process_group``. gloo takes CUDA tensors for every
collective the port runs (``all_gather_into_tensor``,
``all_to_all_single``, ``all_reduce``; checked on the H100 with torch
2.11) and stages them through host memory itself, so the port hands it
the tensors as they are and never switches a backend.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import DeviceLike, resolve_device


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group before building a mesh")
    return dist.get_world_size()


def device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], *,
                device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over ranks 0 .. prod(shape) - 1 of the
    initialised group, axes ``names``, on ``device``'s type (``None`` is
    the card, which raises without one). Every rank of the group must call
    it (the mesh's groups are made collectively)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if n > world:
        raise ValueError(f"a mesh of {shape} needs {n} ranks, the group "
                         f"has {world}")
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The production mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``, over the first
    256 or 512 ranks of the initialised group (a smaller group raises).
    The dry run builds it under a fake process group of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, names, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None):
    """A ``("data", "model")`` mesh over the initialised group, clamped to
    its ranks as the reference clamps to its devices (``data`` first,
    then ``model`` to what is left)."""
    n = _world()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return device_mesh((data, model), ("data", "model"), device=device)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 off the mesh's axes)."""
    names = mesh.mesh_dim_names
    return mesh.get_local_rank(name) if name in names else 0


class Gathered:
    """An all-gather in flight: ``wait()`` finishes it and returns the
    gathered tensor (its first ``rows`` rows, when given)."""

    __slots__ = ("_out", "_work", "_rows")

    def __init__(self, out: torch.Tensor, work=None,
                 rows: Optional[int] = None):
        self._out, self._work = out, work
        self._rows = out.shape[0] if rows is None else rows

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out[:self._rows]


def all_gather_rows(x: torch.Tensor, grp, *, async_op: bool = False,
                    rows: Optional[int] = None) -> Gathered:
    """Every rank's ``x`` (the same shape on each) end to end along dim 0,
    in rank order (``lax.all_gather(x, axis, tiled=True)``), cut to its
    first ``rows`` rows when given. With ``async_op`` the gather is issued
    and ``wait()`` finishes it."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(grp) * x.shape[0], *x.shape[1:]))
    work = dist.all_gather_into_tensor(out, x, group=grp, async_op=async_op)
    return Gathered(out, work if async_op else None, rows)


def _pad_rows(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """Pad dim 0 to a multiple of ``n`` with zeros; returns (padded,
    original rows). Row stages never mix rows, so padding cannot perturb
    real rows."""
    B = x.shape[0]
    B_p = -(-B // n) * n
    if B_p != B:
        x = torch.cat([x, x.new_zeros((B_p - B, *x.shape[1:]))])
    return x, B


def row_sharded(fn, mesh, *rows: torch.Tensor, async_op: bool = False
                ) -> Union[torch.Tensor, Gathered]:
    """``fn(*rows)`` with the rows split over the 1-D ``mesh``: pad to a
    multiple of the mesh with zeros, this rank's block through ``fn``,
    all-gather, padding cut. A rank outside the mesh computes every row
    itself. With ``async_op`` returns the gather in flight. The rule of the
    sharded decide plane (``core/shard.py``) and of the kernels' ``mesh=``
    (``kernels/ops.py``)."""
    coord = mesh.get_coordinate()
    if coord is None:
        out = fn(*rows)
        return Gathered(out) if async_op else out
    n, index = mesh.size(), coord[0]
    padded = [_pad_rows(r, n)[0] for r in rows]
    step = padded[0].shape[0] // n
    g = all_gather_rows(fn(*(r[index * step:(index + 1) * step]
                             for r in padded)),
                        mesh.get_group(mesh.mesh_dim_names[0]),
                        async_op=async_op, rows=rows[0].shape[0])
    return g if async_op else g.wait()
