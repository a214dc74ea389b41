"""Block-level pre-copy live migration of a live tree of tensors.

The paper's migration algorithm (§3.2) on real job state (``repro``'s
``core/precopy.py`` on torch): while the job keeps stepping, the blocks of
its state that changed since the last round ("dirty pages") are re-copied
to the destination; Xen's three stop conditions end the iterative phase
and a final stop-and-copy (the only pause the job sees) sends the last
dirty set. The destination then equals the source bit for bit at the
moment of the final copy.

The block scan goes through ``kernels.ops.dirty_blocks_many``: on the card
one launch of the hand-written ``dirty_delta.cu`` kernel for all float
leaves, an exact ``!=`` for integer ones. Leaves are walked in
``jax.tree.leaves`` order (dict keys sorted), so per-leaf masks line up
with the reference's.

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
a bandwidth model (bytes / link bandwidth). The recorder's spans
(``runtime/spans.py``) split the wall clock: the round-0 clone, each
round's step, scan and send, and the stop-and-copy pause.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.strunk import (MigrationOutcome, XEN_MAX_ROUNDS,
                                     XEN_STOP_DIRTY_PAGES,
                                     XEN_STOP_TOTAL_FACTOR)
from repro_torch.kernels import ops as kops
from repro_torch.runtime import spans


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
    news, olds = tree.leaves(live), tree.leaves(shadow)
    for n, o in zip(news, olds):
        if o.device != n.device:
            raise ValueError(f"dirty_scan compares on one device: live leaf "
                             f"on {n.device}, shadow leaf on {o.device}")
    olds = [o if o.dtype == n.dtype else o.to(n.dtype)
            for n, o in zip(news, olds)]
    masks, counts = kops.dirty_blocks_many(news, olds, block=block)
    if spans.enabled():
        size = [n.numel() * n.element_size() for n in news]
        spans.count("precopy.scan_bytes",
                    (sum(size), sum(b for b, c in zip(size, counts) if c)))
    n_bytes = sum(c * block * n.element_size() for c, n in zip(counts, news))
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


def migrate(get_state: Callable[[], Any],
            step_fn: Optional[Callable[[], None]],
            cfg: PrecopyConfig = PrecopyConfig(),
            *, placement: Optional[Callable[[Any], Any]] = None,
            reduce: Optional[Callable[[List[int]], List[int]]] = None
            ) -> Tuple[Any, PrecopyReport]:
    """Pre-copy migrate the state returned by ``get_state`` while ``step_fn``
    keeps mutating it between rounds (the 'live' in live migration).

    ``placement`` optionally maps the round-0 copy onto its destination
    (e.g. ``lambda t: repro_torch.tree.map(lambda x: x.to("cuda:1"), t)``);
    later rounds scan against the source's copy and move only the dirty
    blocks there. ``reduce`` maps this process's counts (the state's bytes,
    then each scan's dirty blocks and bytes) to the totals over every
    process migrating its part of one state (a sum over ranks), so that
    each takes the same stop decisions and reports the whole. Returns
    (destination_state, report).
    """
    with spans.span("precopy.migrate"):
        total = reduce or (lambda counts: counts)
        t0 = time.monotonic()
        place = placement or (lambda t: t)
        live = get_state()
        v_mem, = total([total_bytes(live)])

        def scan(live):
            with spans.span("precopy.scan"):
                masks, n_dirty, n_bytes = dirty_scan(live, record,
                                                     cfg.block_elems)
                return (masks, *total([n_dirty, n_bytes]))

        # round 0: full copy (iterative-copy stage, first iteration)
        with spans.span("precopy.clone"):
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
            with spans.span("precopy.round", rounds):
                if step_fn is not None:    # job keeps running during the copy
                    with spans.span("precopy.step"):
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
                with spans.span("precopy.send"):
                    _send(live, record, shadow, masks, cfg.block_elems)
            sent += n_bytes
            sim_t += n_bytes / cfg.bandwidth
            per_round.append(n_bytes)
            rounds += 1

        # stop-and-copy: job paused; transfer the final dirty set
        with spans.span("precopy.stop_and_copy"):
            live = get_state()
            masks, n_dirty, n_bytes = scan(live)
            with spans.span("precopy.send"):
                _send(live, record, shadow, masks, cfg.block_elems)
            _synchronize(shadow)
        downtime = n_bytes / cfg.bandwidth
        sent += n_bytes
        sim_t += downtime
        per_round.append(n_bytes)

        outcome = MigrationOutcome(total_time=sim_t, downtime=downtime,
                                   bytes_sent=float(sent), rounds=rounds,
                                   stop_reason=reason)
        report = PrecopyReport(outcome=outcome,
                               wall_time=time.monotonic() - t0,
                               per_round_dirty_bytes=per_round, v_mem=v_mem)
        return shadow, report
