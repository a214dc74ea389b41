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

On one card the destination is a device (``"cpu"``, or ``cuda:N``), not a
mesh: the row-sharded placement of the reference (``launch/sharding``) is
not ported. ALMA's role: the LMCM picks the stop-and-copy moment, so the
final delta, the only blocking transfer, is small.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import precopy


@dataclass
class RescaleReport:
    precopy: precopy.PrecopyReport
    src_devices: int
    dst_devices: int


def rescale(cfg: ArchConfig, state, step_once: Callable[[Any], Any],
            dst, *, pcfg: Optional[precopy.PrecopyConfig] = None
            ) -> Tuple[Any, RescaleReport]:
    """Move ``state`` onto the device ``dst`` with pre-copy semantics.

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
