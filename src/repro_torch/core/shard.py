"""Sharded decide plane: the surveillance rows split over ranks.

Counterpart of ``repro/core/shard.py``. Every stage of the surveillance
pipeline (NB classify, the spectrum, the lag scores, Algorithm 2) works
row by row: no stage reduces across jobs. The reference splits the job
rows over a 1-D ``('shard',)`` device mesh with ``shard_map``; the port
runs one process a rank (``torch.distributed``) and does what
``shard_map`` over a replicated host array does: every rank holds the
whole fleet's inputs, computes its block of rows and all-gathers the
result, so every rank ends with the whole answer. Rows are padded to a
multiple of the mesh and the padding is cut after
(``launch/mesh.row_sharded``).

The sharded results are bit-identical to the unsharded ones: each row's
arithmetic does not depend on how many rows share its launch (NB and
Algorithm 2 are element-wise and integer ops; B1's order is a function
of N, B2's of N and the lag grid, ``kernels/autocorr.py``).

  * ``decide_mesh(shards)`` -- the ``('shard',)`` mesh over the first
    ``shards`` ranks of the initialised group (``None``/``<= 1``: no
    mesh, the unsharded path). A rank outside the mesh computes every
    row itself.
  * ``classify_lm(nb, W, mesh)`` -- NB tables on every rank, rows split;
    the block runs the port's ``characterize._nb_predict_lm``.
  * ``postpone_rows(profiles, periods, m_now, mesh)`` -- Algorithm 2 with
    the three row-aligned operands split. It does not read the result on
    the host; with ``async_op`` the all-gather is issued and the caller
    waits on it when it reads the result (``surveillance.TickResult``).

The kernel stages take the mesh through ``kernels.ops``
(``cycles.fit_cycle_batch(..., mesh=...)``), padded by the same rule.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.core import characterize
from repro_torch.core import postpone as pp
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.launch import mesh as meshlib


def device_count() -> int:
    """Ranks of the initialised process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def decide_mesh(shards: Optional[int] = None, *, device: DeviceLike = None):
    """1-D ``('shard',)`` mesh over the first ``shards`` ranks.

    ``None`` or ``<= 1`` returns ``None``: callers then take the unsharded
    path unchanged. Asking for more shards than ranks is an error. The
    mesh lives on ``device``'s type (``None`` is the card, which raises
    without one); every rank of the group must call this."""
    if shards is None or shards <= 1:
        return None
    resolve_device(device)
    n = device_count()
    if shards > n:
        raise ValueError(
            f"requested {shards} shards but the process group has {n} "
            "ranks; start that many ranks (torch.distributed) first")
    return meshlib.device_mesh((shards,), ("shard",), device=device)


def classify_lm(nb: characterize.NaiveBayes, windows,
                mesh=None) -> torch.Tensor:
    """(J, T, F) windows -> (J, T) int8 LM series on the model's device,
    optionally row-sharded. Bit-identical either way: NB decides each
    sample on its own."""
    if mesh is None:
        return characterize.classify_lm_batch(nb, windows)
    x = characterize._as_f32(nb, windows)
    return meshlib.row_sharded(
        lambda w: characterize._nb_predict_lm(nb, w), mesh, x)


def postpone_rows(profiles: torch.Tensor, periods: torch.Tensor,
                  m_now: torch.Tensor, mesh=None, *, async_op: bool = False
                  ) -> Union[torch.Tensor, meshlib.Gathered]:
    """Algorithm 2 over the packed fleet, optionally row-sharded: (J,)
    int32 RemainTime on the operands' device, never read on the host here.
    Padding rows carry period 0, which Algorithm 2 maps to RemainTime 0
    whatever ``m_now``. With ``async_op`` returns a ``Gathered`` whose
    ``wait()`` gives the result (the all-gather runs meanwhile)."""
    if mesh is None:
        out = pp.postpone_batch(profiles, periods, m_now)
        return meshlib.Gathered(out) if async_op else out
    return meshlib.row_sharded(pp.postpone_batch, mesh, profiles, periods,
                               m_now, async_op=async_op)
