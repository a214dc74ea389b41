"""Block-level pre-copy live migration of a live tree of tensors.

The paper's migration algorithm (§3.2) on real job state (``repro``'s
``core/precopy.py`` on torch): while the job keeps stepping, the blocks of
its state that changed since the last round ("dirty pages") are re-copied
to the destination; Xen's three stop conditions end the iterative phase
and a final stop-and-copy (the only pause the job sees) sends the last
dirty set. The destination then equals the source bit for bit at the
moment of the final copy.

The block scan goes through ``kernels.ops.dirty_blocks``: on the card the
hand-written ``dirty_delta.cu`` kernel for float leaves, an exact ``!=``
for integer ones. Leaves are walked in ``jax.tree.leaves`` order (dict keys
sorted), so per-leaf masks line up with the reference's.

Two choices differ from the reference, which is functional. Round 0 clones
the state into a contiguous shadow, so that no destination tensor aliases
a live one (a decode step may write its KV cache in place). Each later
round copies its dirty blocks into that shadow in place, so a migration
holds two copies of the state and never a third. Where a ``placement``
puts a shadow leaf on another device or in another dtype, the source keeps
its round-0 clone of that leaf as the record it scans against: a scan then
never moves a whole leaf, and only the dirty blocks cross to the
destination.

Time accounting is dual, as in the reference: wall-clock (real copies) and
a bandwidth model (bytes / link bandwidth).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.strunk import (MigrationOutcome, XEN_MAX_ROUNDS,
                                     XEN_STOP_DIRTY_PAGES,
                                     XEN_STOP_TOTAL_FACTOR)
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class PrecopyConfig:
    block_elems: int = 1 << 14                 # "page" size, in elements
    max_rounds: int = XEN_MAX_ROUNDS
    stop_dirty_blocks: int = XEN_STOP_DIRTY_PAGES
    stop_total_factor: float = XEN_STOP_TOTAL_FACTOR
    bandwidth: float = 50e9                    # modeled link, bytes/s
    steps_per_round: int = 1                   # job steps overlapped per round


# ---------------------------------------------------------------------------
# block view of a tree
# ---------------------------------------------------------------------------
def _leaf_dirty(new: torch.Tensor, old: torch.Tensor,
                block: int) -> torch.Tensor:
    """Leaf pair -> (ceil(n / block),) bool dirty mask, read flat."""
    return kops.dirty_blocks(new.reshape(-1), old.reshape(-1), block=block)


def _leaf_merge(new: torch.Tensor, old: torch.Tensor, dirty: torch.Tensor,
                block: int) -> None:
    """Copy the dirty blocks of ``new`` over ``old`` in place (the 'network
    transfer'); only those blocks move, to ``old``'s device and dtype."""
    src, dst = new.reshape(-1), old.view(-1)
    full = src.numel() // block
    idx = dirty[:full].nonzero().squeeze(1)
    if idx.numel():
        rows = src[: full * block].view(full, block).index_select(0, idx)
        dst[: full * block].view(full, block).index_copy_(
            0, idx.to(dst.device), rows.to(dst.device, dst.dtype))
    if src.numel() > full * block and bool(dirty[full]):
        dst[full * block:] = src[full * block:].to(dst.device, dst.dtype)


def dirty_scan(live, shadow, block: int
               ) -> Tuple[List[torch.Tensor], int, int]:
    """Per-leaf dirty masks + (dirty_blocks, dirty_bytes) totals. A dirty
    block counts ``block * itemsize`` bytes, the ragged last one too. Each
    shadow leaf must lie on its live leaf's device: the scan compares in
    place and moves no leaf across."""
    pairs = list(zip(tree.leaves(live), tree.leaves(shadow)))
    for n, o in pairs:
        if o.device != n.device:
            raise ValueError(f"dirty_scan compares on one device: live leaf "
                             f"on {n.device}, shadow leaf on {o.device}")
    masks = [_leaf_dirty(n, o.to(n.dtype), block) for n, o in pairs]
    if not masks:
        return masks, 0, 0
    counts = torch.stack([m.sum().to(masks[0].device)
                          for m in masks]).tolist()       # one sync
    n_bytes = sum(d * block * n.element_size()
                  for d, (n, _) in zip(counts, pairs))
    return masks, int(sum(counts)), int(n_bytes)


def merge_dirty(live, shadow, masks: List[torch.Tensor], block: int):
    """Copy every dirty block of ``live`` into ``shadow`` in place; returns
    ``shadow``."""
    for n, o, m in zip(tree.leaves(live), tree.leaves(shadow), masks):
        _leaf_merge(n, o, m, block)
    return shadow


def _send(live, record: List[torch.Tensor], dest, masks: List[torch.Tensor],
          block: int) -> None:
    """Merge the dirty blocks into the scan's record and, where the
    destination leaf is another tensor, into it too."""
    for n, r, d, m in zip(tree.leaves(live), record, tree.leaves(dest), masks):
        _leaf_merge(n, r, m, block)
        if d is not r:
            _leaf_merge(n, d, m, block)


def total_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(state))


def _synchronize(state) -> None:
    for dev in {t.device for t in tree.leaves(state) if t.is_cuda}:
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclass
class PrecopyReport:
    outcome: MigrationOutcome
    wall_time: float
    per_round_dirty_bytes: List[int]
    v_mem: int
    #: host seconds of each dirty scan, from a synced device to the scan's
    #: own sync; the stop-and-copy's last
    scan_seconds: List[float] = field(default_factory=list)


def migrate(get_state: Callable[[], Any],
            step_fn: Optional[Callable[[], None]],
            cfg: PrecopyConfig = PrecopyConfig(),
            *, placement: Optional[Callable[[Any], Any]] = None
            ) -> Tuple[Any, PrecopyReport]:
    """Pre-copy migrate the state returned by ``get_state`` while ``step_fn``
    keeps mutating it between rounds (the 'live' in live migration).

    ``placement`` optionally maps the round-0 copy onto its destination
    (e.g. ``lambda t: repro_torch.tree.map(lambda x: x.to("cuda:1"), t)``);
    later rounds scan against the source's copy and move only the dirty
    blocks there. Returns (destination_state, report).
    """
    t0 = time.monotonic()
    place = placement or (lambda t: t)
    live = get_state()
    v_mem = total_bytes(live)
    scan_seconds: List[float] = []

    def scan(live):
        _synchronize(live)                 # time the scan, not the step
        t = time.perf_counter()
        out = dirty_scan(live, record, cfg.block_elems)
        scan_seconds.append(time.perf_counter() - t)
        return out

    # round 0: full copy (iterative-copy stage, first iteration)
    local = tree.map(
        lambda t: t.clone(memory_format=torch.contiguous_format), live)
    shadow = place(local)
    record = [d if (d.device, d.dtype) == (o.device, o.dtype) else o
              for o, d in zip(tree.leaves(local), tree.leaves(shadow))]
    del local
    sent = v_mem
    sim_t = v_mem / cfg.bandwidth
    per_round = [v_mem]
    rounds = 1
    reason = "max_rounds"

    while True:
        if step_fn is not None:            # job keeps running during the copy
            for _ in range(cfg.steps_per_round):
                step_fn()
        live = get_state()
        masks, n_dirty, n_bytes = scan(live)
        if n_dirty <= cfg.stop_dirty_blocks:
            reason = "dirty_low"
            break
        if rounds >= cfg.max_rounds:
            reason = "max_rounds"
            break
        if sent + n_bytes > cfg.stop_total_factor * v_mem:
            reason = "total_cap"
            break
        _send(live, record, shadow, masks, cfg.block_elems)
        sent += n_bytes
        sim_t += n_bytes / cfg.bandwidth
        per_round.append(n_bytes)
        rounds += 1

    # stop-and-copy: job paused; transfer the final dirty set
    live = get_state()
    masks, n_dirty, n_bytes = scan(live)
    _send(live, record, shadow, masks, cfg.block_elems)
    _synchronize(shadow)
    downtime = n_bytes / cfg.bandwidth
    sent += n_bytes
    sim_t += downtime
    per_round.append(n_bytes)

    outcome = MigrationOutcome(total_time=sim_t, downtime=downtime,
                               bytes_sent=float(sent), rounds=rounds,
                               stop_reason=reason)
    report = PrecopyReport(outcome=outcome, wall_time=time.monotonic() - t0,
                           per_round_dirty_bytes=per_round, v_mem=v_mem,
                           scan_seconds=scan_seconds)
    return shadow, report
