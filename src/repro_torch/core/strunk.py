"""Pre-copy live-migration cost model (paper §3.2, Strunk's bounds).

Implements Inequalities 1–2 and an iterative pre-copy simulator with the Xen
stop conditions the paper lists: (i) fewer than ``stop_dirty_pages`` dirty
pages since the last round, (ii) at most ``max_rounds`` rounds, (iii) total
transfer capped at ``stop_total_factor`` x V_mem. Dirty rate may be a
constant or a callable of absolute time, which is how the fleet simulator
injects the *workload-phase-dependent* dirty rate — the whole point of the
paper: the same migration started in an NLM phase costs multiples of one
started in an LM phase.

Two executions of the same model:

  * ``simulate_precopy_reference`` — the original scalar Python loop, kept
    as the executable specification (and as the honest per-request baseline
    for the concurrency-sweep benchmark).
  * ``simulate_precopy_batch`` — one vectorized simulation over (M,)
    in-flight migrations: per-round dirty-rate sampling across all lanes,
    the three Xen stop conditions evaluated as masked lanes, per-lane
    start times and bandwidths. Bit-equal to the reference lane-for-lane
    (same float64 operation order), which ``tests/test_precopy.py``
    asserts across all three stop reasons and callable rates.

``simulate_precopy`` is the M=1 view of the batch path — the same
structural-parity pattern as ``cycles.fit_cycle`` vs ``fit_cycle_batch``.
The contention-aware execution plane (``core/plane.py``) re-implements the
identical round recurrence with bandwidth recomputed at round boundaries
from the shared-link network model; its uncontended single-lane output is
bit-equal to this module's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

DirtyRate = Union[float, Callable[[float], float]]
# batch rates: one spec per lane, or a single spec broadcast to every lane,
# or a vectorized callable (marked ``.vectorized = True``) mapping an (M,)
# time array to an (M,) rate array in one call.
BatchDirtyRate = Union[DirtyRate, Sequence[DirtyRate]]

PAGE = 4096
XEN_MAX_ROUNDS = 29
XEN_STOP_DIRTY_PAGES = 50
XEN_STOP_TOTAL_FACTOR = 3.0

# stop-reason lane codes (batch) <-> names (scalar outcomes)
REASON_DIRTY_LOW, REASON_MAX_ROUNDS, REASON_TOTAL_CAP = 0, 1, 2
STOP_REASONS = ("dirty_low", "max_rounds", "total_cap")
# a lane settled early by fault injection (MigrationPlane.abort /
# fail_host) — deliberately NOT in STOP_REASONS: the pre-copy recurrence
# never produces it, only the abort path does, so completion and abort
# outcomes stay distinguishable by stop_reason alone
STOP_ABORTED = "aborted"
# a lane settled early by the prediction guard (core/guard.py): realized
# progress diverged past the abort ratio of its admission-time priced
# expectation. Like STOP_ABORTED it is NOT in STOP_REASONS (only the
# watchdog produces it), and it is distinct from fault aborts so the
# simulator can route misprediction feedback (forced refit, trust decay)
# without confusing it with infrastructure failure
STOP_GUARD = "guard_abort"


def strunk_bounds(v_mem: float, bandwidth: float,
                  max_rounds: int = XEN_MAX_ROUNDS) -> Tuple[float, float]:
    """(T_mig lower, upper) per Inequality 1: V/B <= T <= (M+1)V/B."""
    return v_mem / bandwidth, (max_rounds + 1) * v_mem / bandwidth


@dataclass
class MigrationOutcome:
    total_time: float          # paper's 'live migration total time'
    downtime: float            # stop-and-copy duration
    bytes_sent: float          # 'network data transfer'
    rounds: int
    stop_reason: str


@dataclass
class BatchMigrationOutcome:
    """(M,) pre-copy outcomes — SoA arrays plus a scalar accessor."""
    total_time: np.ndarray
    downtime: np.ndarray
    bytes_sent: np.ndarray
    rounds: np.ndarray
    stop_reason: np.ndarray    # int codes, see STOP_REASONS

    def __len__(self) -> int:
        return len(self.total_time)

    def item(self, i: int) -> MigrationOutcome:
        return MigrationOutcome(
            total_time=float(self.total_time[i]),
            downtime=float(self.downtime[i]),
            bytes_sent=float(self.bytes_sent[i]),
            rounds=int(self.rounds[i]),
            stop_reason=STOP_REASONS[int(self.stop_reason[i])])


@dataclass
class ResumeState:
    """Mid-round initial state for (M,) lanes — the execution plane's
    ``lane_state()`` snapshot in array form, or fresh rows (``fresh``)
    for lanes not yet launched.

    ``rem``      bytes left in the lane's current transfer: the in-flight
                 round's remainder, or the stop-and-copy remnant when
                 ``stopped``;
    ``acc``      dirty bytes already accrued during the current round;
    ``sent``     bytes already charged to the lane's links (completed
                 rounds plus the progressed part of the current one) —
                 feeds the 3xV total-transfer cap but NOT the returned
                 bill;
    ``rounds``   pre-copy rounds already completed;
    ``stopped``  True once the lane has entered stop-and-copy;
    ``reason``   stop-reason code carried through for already-stopped
                 lanes (ignored for running ones).

    Resumed outcomes are MARGINAL: ``bytes_sent`` / ``total_time`` cover
    only the remaining work from ``start_time`` on, so a what-if sweep
    bills the dilution a candidate batch inflicts on already-running
    lanes as the resumed bill under the hypothetical shares.
    """
    rem: np.ndarray
    acc: np.ndarray
    sent: np.ndarray
    rounds: np.ndarray
    stopped: np.ndarray
    reason: Optional[np.ndarray] = None

    @staticmethod
    def fresh(v_mem) -> "ResumeState":
        """Launch-time state: round 0 copies all of V_mem, nothing accrued."""
        v = np.atleast_1d(np.asarray(v_mem, np.float64))
        m = v.shape[0]
        return ResumeState(rem=v.copy(), acc=np.zeros(m), sent=np.zeros(m),
                           rounds=np.zeros(m, np.int64),
                           stopped=np.zeros(m, bool),
                           reason=np.full(m, REASON_MAX_ROUNDS, np.int64))

    def take(self, idx) -> "ResumeState":
        """Gather rows ``idx`` (with repeats) — the flattened-sweep layout."""
        idx = np.asarray(idx, np.intp)
        return ResumeState(
            rem=self.rem[idx], acc=self.acc[idx], sent=self.sent[idx],
            rounds=self.rounds[idx], stopped=self.stopped[idx],
            reason=None if self.reason is None else self.reason[idx])


def _resume_precopy_batch(v, bw, rate, nonneg, t0, init: ResumeState,
                          thresh, cap, max_rounds) -> BatchMigrationOutcome:
    """Generalized pre-copy recurrence from arbitrary mid-round state.

    Same math as the fresh-start hot loop, but per-lane round counters
    (lanes resume at different depths) and a first-iteration dirty carry:
    the first resumed round dirties ``acc + rate*dt`` because ``acc``
    bytes accrued before the snapshot. For ``ResumeState.fresh`` inputs
    this is value-identical to ``simulate_precopy_batch``'s own loop
    (``0.0 + x == x`` and the op order matches), which
    ``tests/test_horizon.py`` asserts bit-for-bit.
    """
    m = v.shape[0]
    t = t0.astype(np.float64).copy()
    sent = np.zeros(m)                       # marginal: future bytes only
    charged = np.asarray(init.sent, np.float64) + np.zeros(m)
    rounds = np.asarray(init.rounds, np.int64).copy()
    if init.reason is not None:
        reason = np.asarray(init.reason, np.int64).astype(np.int8).copy()
    else:
        reason = np.full(m, REASON_MAX_ROUNDS, np.int8)
    stopped0 = np.asarray(init.stopped, bool)
    rem0 = np.asarray(init.rem, np.float64) + np.zeros(m)
    final = np.where(stopped0, rem0, 0.0)    # stop-and-copy payload
    active = ~stopped0
    work = np.where(active, rem0, 0.0)
    carry = np.where(active, np.asarray(init.acc, np.float64), 0.0)
    while active.any():
        dt = work / bw
        mid = t + 0.5 * dt
        r = rate(mid, active)
        grown = (np.asarray(r, np.float64) if nonneg
                 else np.maximum(r, 0.0)) * dt
        dirtied = np.minimum(carry + grown, v)
        sent = sent + work
        t = t + dt
        rounds = rounds + active
        # stop conditions, priority-ordered as the reference loop (the
        # last copyto wins): dirty_low, then max_rounds, then total_cap
        c_dirty = dirtied <= thresh
        c_rounds = rounds >= max_rounds
        c_total = (charged + sent) + dirtied > cap
        stop = (c_dirty | c_rounds | c_total) & active
        if stop.any():
            np.copyto(reason, REASON_TOTAL_CAP, where=stop)
            np.copyto(reason, REASON_MAX_ROUNDS, where=stop & c_rounds)
            np.copyto(reason, REASON_DIRTY_LOW, where=stop & c_dirty)
            np.copyto(final, dirtied, where=stop)
            active = active & ~stop
        work = dirtied * active              # zero stopped lanes exactly
        carry = np.zeros(m)                  # the carry is spent in round 1
    downtime = final / bw                    # stop-and-copy
    sent = sent + final
    t = t + downtime
    return BatchMigrationOutcome(total_time=t - t0, downtime=downtime,
                                 bytes_sent=sent, rounds=rounds,
                                 stop_reason=reason.astype(np.int64))


def batch_rate_fn(dirty_rate: BatchDirtyRate, m: int
                  ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Normalize a batch dirty-rate spec to ``f(t, active) -> rates``.

    ``t`` is the (M,) absolute sample time per lane; only lanes with
    ``active`` True need a valid rate. Scalars broadcast; a callable with
    ``.vectorized`` set is called once on the whole time array; plain
    callables are sampled per active lane (the compatibility path for the
    fleet's per-job ``trace.dirty_rate`` functions).
    """
    if callable(dirty_rate) and getattr(dirty_rate, "vectorized", False):
        return lambda t, active: np.asarray(dirty_rate(t), np.float64)
    if callable(dirty_rate):
        def one_fn(t: np.ndarray, active: np.ndarray) -> np.ndarray:
            out = np.zeros(m)
            for i in np.flatnonzero(active):
                out[i] = float(dirty_rate(float(t[i])))
            return out
        return one_fn
    if np.isscalar(dirty_rate):
        const = np.full(m, float(dirty_rate))
        return lambda t, active: const
    specs = list(dirty_rate)
    if len(specs) != m:
        raise ValueError(f"{len(specs)} rate specs for {m} lanes")
    call_idx = [i for i, s in enumerate(specs) if callable(s)]
    base = np.asarray([0.0 if callable(s) else float(s) for s in specs])
    if not call_idx:
        return lambda t, active: base

    def mixed_fn(t: np.ndarray, active: np.ndarray) -> np.ndarray:
        out = base.copy()
        for i in call_idx:
            if active[i]:
                out[i] = float(specs[i](float(t[i])))
        return out
    return mixed_fn


def simulate_precopy_batch(v_mem, bandwidth, dirty_rate: BatchDirtyRate,
                           *, start_time=0.0, page: int = PAGE,
                           max_rounds: int = XEN_MAX_ROUNDS,
                           stop_dirty_pages: int = XEN_STOP_DIRTY_PAGES,
                           stop_total_factor: float = XEN_STOP_TOTAL_FACTOR,
                           init: Optional[ResumeState] = None,
                           ) -> BatchMigrationOutcome:
    """Vectorized pre-copy over (M,) lanes (paper §3.2 stages 2–3).

    Every lane runs the reference recurrence — round 0 copies all of V_mem,
    round i copies the bytes dirtied during round i-1, the dirty rate is
    sampled mid-round at each lane's own absolute time — with the three Xen
    stop conditions applied as masks. Finished lanes freeze while the rest
    keep iterating, so one call simulates M migrations of arbitrary length
    in max(rounds) vector steps.

    ``init`` resumes lanes from arbitrary mid-round state (the execution
    plane's ``lane_state()`` snapshots) instead of launch: outcomes then
    bill only the MARGINAL remaining bytes/time, which is how the
    receding-horizon controller reprices in-flight lanes under
    hypothetical candidate admissions.
    """
    v = np.atleast_1d(np.asarray(v_mem, np.float64))
    m = v.shape[0]
    if m == 0:
        # the round loop below terminates on ``stop.any()``, which an empty
        # lane set can never satisfy — answer the empty batch directly
        # (what-if sweeps legitimately evaluate "launch nothing")
        z = np.zeros(0)
        return BatchMigrationOutcome(
            total_time=z, downtime=np.zeros(0), bytes_sent=np.zeros(0),
            rounds=np.zeros(0, np.int64), stop_reason=np.zeros(0, np.int64))
    bw = np.broadcast_to(np.asarray(bandwidth, np.float64), (m,))
    t0 = np.broadcast_to(np.asarray(start_time, np.float64), (m,))
    rate = batch_rate_fn(dirty_rate, m)

    nonneg = bool(getattr(dirty_rate, "nonneg", False)) or (
        np.isscalar(dirty_rate) and not callable(dirty_rate)
        and float(dirty_rate) >= 0.0)
    if init is not None:
        return _resume_precopy_batch(
            v, bw, rate, nonneg, t0, init,
            float(stop_dirty_pages) * page, stop_total_factor * v,
            max_rounds)
    t = t0.astype(np.float64).copy()
    sent = np.zeros(m)
    rounds = np.zeros(m, np.int64)
    reason = np.full(m, REASON_MAX_ROUNDS, np.int8)
    active = np.ones(m, bool)
    thresh = float(stop_dirty_pages) * page
    cap = stop_total_factor * v
    # ``work`` holds the current round's bytes for active lanes and 0 for
    # stopped ones, so every accumulator update below is unconditional —
    # stopped lanes add exactly 0.0, which keeps them bit-frozen without a
    # mask per update. All round-local arrays are preallocated buffers
    # updated with in-place ufuncs: this loop is the fleet's hot path and
    # numpy dispatch + temporaries dominate at fleet lane counts.
    work = v.copy()
    final = np.zeros(m)                  # dirtied bytes at stop -> stop&copy
    dt = np.empty(m)
    mid = np.empty(m)
    dirtied = np.empty(m)
    tmp = np.empty(m)
    c_dirty = np.empty(m, bool)
    c_total = np.empty(m, bool)
    stop = np.empty(m, bool)
    k = 0                                # a lane active at iteration k has
    while True:                          # rounds == k+1, so the max_rounds
        k += 1                           # test is a Python scalar compare
        np.divide(work, bw, out=dt)
        np.multiply(dt, 0.5, out=mid)
        np.add(mid, t, out=mid)          # == t + 0.5*dt (exact: commutative)
        r = rate(mid, active)
        if nonneg:                       # max(0, r) == r exactly for r >= 0
            np.multiply(r, dt, out=tmp)
        else:
            np.maximum(r, 0.0, out=tmp)
            np.multiply(tmp, dt, out=tmp)
        np.minimum(tmp, v, out=dirtied)  # == min(v, max(0, r)*dt)
        sent += work
        t += dt
        # stop conditions, priority-ordered exactly as the reference loop:
        # dirty_low, then max_rounds, then total_cap
        np.less_equal(dirtied, thresh, out=c_dirty)
        np.add(sent, dirtied, out=tmp)
        np.greater(tmp, cap, out=c_total)
        if k >= max_rounds:
            np.copyto(stop, active)
        else:
            np.logical_or(c_dirty, c_total, out=stop)
            np.logical_and(stop, active, out=stop)
        if stop.any():
            later = REASON_MAX_ROUNDS if k >= max_rounds else REASON_TOTAL_CAP
            np.copyto(reason, later, where=stop & ~c_dirty)
            np.copyto(reason, REASON_DIRTY_LOW, where=stop & c_dirty)
            np.copyto(rounds, k, where=stop)
            np.copyto(final, dirtied, where=stop)
            np.logical_and(active, ~stop, out=active)
            if not active.any():
                break
        np.multiply(dirtied, active, out=work)   # zero stopped lanes exactly
    downtime = final / bw                            # stop-and-copy
    sent = sent + final
    t = t + downtime
    return BatchMigrationOutcome(total_time=t - t0, downtime=downtime,
                                 bytes_sent=sent, rounds=rounds,
                                 stop_reason=reason.astype(np.int64))


def simulate_precopy(v_mem: float, bandwidth: float, dirty_rate: DirtyRate,
                     *, start_time: float = 0.0, page: int = PAGE,
                     max_rounds: int = XEN_MAX_ROUNDS,
                     stop_dirty_pages: int = XEN_STOP_DIRTY_PAGES,
                     stop_total_factor: float = XEN_STOP_TOTAL_FACTOR,
                     ) -> MigrationOutcome:
    """Scalar pre-copy simulation — the M=1 view of the batch path."""
    batch = simulate_precopy_batch(
        [v_mem], bandwidth, dirty_rate, start_time=start_time, page=page,
        max_rounds=max_rounds, stop_dirty_pages=stop_dirty_pages,
        stop_total_factor=stop_total_factor)
    return batch.item(0)


def simulate_precopy_reference(v_mem: float, bandwidth: float,
                               dirty_rate: DirtyRate,
                               *, start_time: float = 0.0, page: int = PAGE,
                               max_rounds: int = XEN_MAX_ROUNDS,
                               stop_dirty_pages: int = XEN_STOP_DIRTY_PAGES,
                               stop_total_factor: float = XEN_STOP_TOTAL_FACTOR,
                               ) -> MigrationOutcome:
    """The original scalar loop — executable spec the batch path must match
    bit-for-bit, and the per-request baseline the concurrency sweep times.

    Round 0 copies all of V_mem; round i copies the bytes dirtied during
    round i-1. ``dirty_rate(t)`` is sampled at absolute time ``t`` so cyclic
    workloads produce cyclic migration costs.
    """
    rate = dirty_rate if callable(dirty_rate) else (lambda _t: float(dirty_rate))
    t = start_time
    sent = 0.0
    to_copy = v_mem
    rounds = 0
    reason = "max_rounds"
    while True:
        dt = to_copy / bandwidth
        # dirty bytes accrued while this round's copy is in flight (sample the
        # rate midway through the round — adequate for piecewise traces)
        dirtied = min(v_mem, max(0.0, rate(t + 0.5 * dt)) * dt)
        sent += to_copy
        t += dt
        rounds += 1
        if dirtied <= stop_dirty_pages * page:
            reason = "dirty_low"
            to_copy = dirtied
            break
        if rounds >= max_rounds:
            reason = "max_rounds"
            to_copy = dirtied
            break
        if sent + dirtied > stop_total_factor * v_mem:
            reason = "total_cap"
            to_copy = dirtied
            break
        to_copy = dirtied

    downtime = to_copy / bandwidth                   # stop-and-copy
    sent += to_copy
    t += downtime
    return MigrationOutcome(total_time=t - start_time, downtime=downtime,
                            bytes_sent=sent, rounds=rounds, stop_reason=reason)


def expected_cost(v_mem: float, bandwidth: float, dirty_rate: DirtyRate,
                  start_time: float = 0.0) -> float:
    """Scalar cost used by the 'alma-plus' window chooser: total bytes sent."""
    return simulate_precopy(v_mem, bandwidth, dirty_rate,
                            start_time=start_time).bytes_sent


def expected_cost_batch(v_mem, bandwidth, dirty_rate: BatchDirtyRate,
                        start_times, *, full: bool = False,
                        init: Optional[ResumeState] = None):
    """Vectorized expected migration cost (total bytes sent) over (M,)
    hypothetical lanes. Two callers, same math:

      * the 'alma-plus' window scan — ONE migration (scalar ``v_mem`` /
        ``bandwidth``) started at each of (M,) candidate moments;
      * the consolidation planner's packing score — (M,) planned
        migrations with per-lane sizes and per-lane *contended fair-share*
        bandwidths, all started at the consolidation event time (pass
        ``full=True`` for the whole ``BatchMigrationOutcome`` — predicted
        times tie-break packings whose byte bills are equal).
    """
    start = np.atleast_1d(np.asarray(start_times, np.float64))
    m = max(start.shape[0], np.atleast_1d(np.asarray(v_mem)).shape[0])
    out = simulate_precopy_batch(
        np.broadcast_to(np.asarray(v_mem, np.float64), (m,)), bandwidth,
        dirty_rate, start_time=np.broadcast_to(start, (m,)), init=init)
    return out if full else out.bytes_sent


def what_if_cost_batch(v_mem, bandwidth, rate_specs, start_times,
                       *, full: bool = False,
                       init: Optional[ResumeState] = None):
    """``expected_cost_batch`` over (M,) *hypothetical* lanes whose dirty
    rates are given as lane-registration specs (``core/rates.py``: tables,
    constants, ``rate_table`` objects, plain callables, None) — or as an
    already-built ``RateBank`` whose row ``i`` is lane ``i``'s table.

    Spec sequences are normalized through the same ``RateBank`` the
    execution plane registers its lanes with, so an all-tabular candidate
    batch samples every lane's rate in ONE padded lookup per round — the
    entry point the adaptive concurrency controller
    (``core/controller.py``) uses to price a whole defer-k sweep without
    per-lane Python. Passing a ``RateBank`` directly skips even that
    normalization: the stacked defer-k sweep builds one bank over its
    unique candidate tables and ``take``-gathers the flattened prefix
    layout, so pricing all n+1 prefixes re-normalizes nothing. Lanes
    whose spec cannot be tabulated fall back to per-lane sampling.
    """
    from repro_torch.core.rates import RateBank, as_rate_table
    if isinstance(rate_specs, RateBank):
        bank = rate_specs
        if bank.m == 0:
            return expected_cost_batch(np.zeros(0), bandwidth, 0.0,
                                       np.zeros(0), full=full)
        if bank.fallback:
            raise ValueError("RateBank inputs must be fully tabular "
                             "(fallback callables need per-lane specs)")
        return expected_cost_batch(v_mem, bandwidth, bank.table_fn,
                                   start_times, full=full, init=init)
    specs = list(rate_specs)
    if not specs:
        return expected_cost_batch(np.zeros(0), bandwidth, 0.0,
                                   np.zeros(0), full=full)
    bank = RateBank(specs)
    if not bank.fallback:
        rate: BatchDirtyRate = bank.table_fn
    else:
        # mixed tables + callables: hand the normalized per-lane specs to
        # the compatibility path (callables are sampled per lane)
        rate = [as_rate_table(s) or s for s in specs]
    return expected_cost_batch(v_mem, bandwidth, rate, start_times,
                               full=full, init=init)
