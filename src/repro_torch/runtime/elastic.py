"""Elastic rescaling: live-migrate a training job onto another placement
(``repro``'s ``runtime/elastic.py``).

The sequence:

  1. keep training on the source while the pre-copy engine copies the
     state in rounds to the destination (dirty-block transfers, each round
     scanned by kernel B3 on the card);
  2. at the stop-and-copy point, pause (the downtime) and send the final
     delta;
  3. resume on the destination at the same step index; the data pipeline
     is step-indexed, so not a token is lost.

The destination is a device (``"cpu"``, or ``cuda:N``) or, as the
reference takes it, a ``DeviceMesh``. Onto a mesh, every rank of the
source mesh runs the pre-copy of its own slices of the state (the same
ranks make up the destination), the rounds' dirty counts summed over the
ranks (``precopy.migrate``'s ``reduce``) so that every rank takes the same
rounds and stop. At the stop-and-copy the copy is re-laid onto the
destination: each leaf all-gathered over the source mesh and cut by
``launch/sharding.state_shardings(dst)``, the reference's placement. That
re-layout is part of the pause; its seconds are reported. ALMA's role:
the LMCM picks the stop-and-copy moment, so the final delta, the only
blocking transfer, is small.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import precopy


@dataclass
class RescaleReport:
    precopy: precopy.PrecopyReport
    src_devices: int
    dst_devices: int
    #: host seconds of the re-layout onto a destination mesh (0 for a
    #: device)
    relayout_seconds: float = 0.0


def _state_specs(cfg: ArchConfig, mesh, state) -> Any:
    """The spec tree of a training state on ``mesh``, from the config's
    full shapes."""
    from repro_torch.launch import sharding
    from repro_torch.train.steps import init_train_state
    full = init_train_state(cfg, device="meta")
    if set(full) != set(state):
        raise ValueError("rescale onto a mesh takes a training state "
                         "(params, opt, step)")
    return sharding.state_specs(mesh, full)


def _to_mesh(cfg: ArchConfig, state, step_once, src, dst, pcfg
             ) -> Tuple[Any, RescaleReport]:
    from repro_torch.launch import sharding
    from repro_torch.models import dist

    def reduce(counts: List[int]) -> List[int]:
        t = torch.tensor(counts, dtype=torch.int64,
                         device=tree.leaves(state)[0].device)
        for a in src.mesh_dim_names:
            t = dist.all_reduce(t, src, a)
        return t.tolist()

    box = {"state": state}

    def do_step():
        box["state"] = step_once(box["state"])

    copy, report = precopy.migrate(lambda: box["state"], do_step, pcfg,
                                   reduce=reduce)
    t0 = time.perf_counter()
    src_specs = _state_specs(cfg, src, copy)
    dst_specs = _state_specs(cfg, dst, copy)

    def relay(path, leaf, s_spec, d_spec):
        full = sharding.gather_leaf(src, s_spec, leaf)
        return sharding.local_slice(dst, d_spec, full)

    out = sharding.walk(relay, copy, (), src_specs, dst_specs)
    del copy
    precopy._synchronize(out)
    return out, RescaleReport(report, src.size(), dst.size(),
                              time.perf_counter() - t0)


def rescale(cfg: ArchConfig, state, step_once: Callable[[Any], Any],
            dst, *, src=None, pcfg: Optional[precopy.PrecopyConfig] = None
            ) -> Tuple[Any, RescaleReport]:
    """Move ``state`` onto the device or ``DeviceMesh`` ``dst`` with
    pre-copy semantics.

    Onto a mesh, ``state`` is this rank's slices on the mesh ``src`` (by
    default the current ``models/dist`` context's), every rank of it calls
    ``rescale``, and the result is this rank's slices on ``dst``
    (``launch/sharding.state_shardings``), equal to the slices cut from the
    gathered source at the stop-and-copy; ``dst_devices`` is the mesh's
    size.

    ``step_once(state) -> state`` advances training on the source (keeps
    the job live during the copy rounds). Returns (the destination's state,
    bit-equal to the source's at the stop-and-copy, and the report).

    Memory: ``dst`` holds a second copy of the state beside the source and
    a step's transients. With ``dst`` the source's own card, internlm2-1.8b
    at full size (26.5 GB of state, a 16 GB step) fits an 80 GB card only
    when the caching allocator's segments grow in place: the caller sets
    ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` before torch
    starts CUDA, as ``launch/train.py`` and ``chip_smoke.py`` do. Without
    it the free room strands in split blocks and the round runs out."""
    pcfg = pcfg or precopy.PrecopyConfig()
    if hasattr(dst, "mesh_dim_names"):
        if src is None:
            from repro_torch.models import dist
            ctx = dist.current()
            if ctx is None:
                raise ValueError("rescale onto a mesh: name the source mesh "
                                 "(src=) or run under its dist context")
            src = ctx.mesh
        return _to_mesh(cfg, state, step_once, src, dst, pcfg)
    dst = torch.device(dst)
    box = {"state": state}

    def do_step():
        box["state"] = step_once(box["state"])

    def placement(t):              # a no-op for leaves already on dst
        return tree.map(lambda x: x.to(dst), t)

    src = {t.device for t in tree.leaves(state)}
    migrated, report = precopy.migrate(lambda: box["state"], do_step, pcfg,
                                       placement=placement)
    return migrated, RescaleReport(report, len(src), 1)
