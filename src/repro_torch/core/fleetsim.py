"""Deterministic fleet simulator — the paper's testbed, scaled.

Counterpart of ``repro/core/fleetsim.py``. The event loop, the traces and
the migration plane are the reference's host code unchanged; the fleet's
telemetry ring, the NB model and the surveillance engine live on
``device`` (the card unless the caller asks for the CPU). The telemetry
noise comes from the same ``np.random.default_rng(seed)`` stream as in the
reference, so the recorded samples are bit-identical.

Hosts with shared migration links, jobs with phase-labeled workload traces
(dirty-rate over time), a consolidation event that emits migration requests,
and the LMCM deciding when each fires. Migration costs come from the Strunk
pre-copy model sampled against the *time-varying* dirty rate, so a migration
launched in an NLM phase genuinely costs more — which is what Tables 6/7
measure.

Execution is contention-aware and sharded: every migration the LMCM
releases is handed to the fabric (``core/fabric.py``), which partitions
in-flight transfers into per-access-link migration domains and advances
each domain's event loop (``core/plane.py``) independently, re-sharing
each network link max-min fairly at every round boundary
(``core/network.py``). Simultaneous migrations on shared links therefore
slow each other down — longer rounds, more dirtying per round, more bytes —
which is exactly the congestion effect the paper's orchestrator exists to
avoid, while disjoint domains advance without touching each other. The
LMCM's deadline/cost decisions read the fabric's realized per-domain
bandwidth through ``bandwidth_probe``.

The fleet substrate defaults to ``Topology.star`` when a host ``Placement``
is given (per-host access links joined through a core sized by
``core_oversubscription``); without a placement it falls back to the
paper's single shared migration link.

Time advances event-skipped: when nothing is in flight, ``run_with_plan``
jumps the clock straight to the next pending arrival / LMCM release /
surveillance staleness boundary (and ``run_idle`` to its end),
bulk-appending the skipped telemetry — ring contents, rng stream, fits,
and outcomes are bit-identical to ticking one second at a time
(``event_skip=False`` restores the pure per-second loop; the fast path
also needs the fleet SoA store and stock ``WorkloadTrace`` samplers).

Workload traces: phase sequences in the style of the paper's Table 3
artificial cycles (CPU/MEM/IO/IDLE), each phase with characteristic load
indexes (the NB features) and a dirty rate; plus "application" traces
recorded from real training runs of this repo's substrate. Traces carry a
``PiecewiseRate`` table, so a whole fleet's dirty rates can be sampled in
one vectorized call (``PiecewiseRate.batch``) — the fast path of
``strunk.simulate_precopy_batch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import characterize, network, strunk
from repro_torch.core.consolidation import Placement
from repro_torch.core.fabric import ShardedPlane
from repro_torch.core.guard import MigrationGuard
from repro_torch.core.orchestrator import LMCM, MigrationRequest
from repro_torch.core.rates import PiecewiseRate  # noqa: F401  (re-export)
from repro_torch.core.telemetry import DEFAULT_FIELDS, FleetTelemetry, \
    TelemetryBuffer
from repro_torch.kernels.backend import DeviceLike, resolve_device

# phase archetypes: load-index means (step_time, dirty_bytes, dirty_fraction,
# collective_bytes, compute_util, hbm_util) + dirty rate in bytes/s.
# MEM-type phases dirty memory fast (pre-copy hostile); CPU/IO/IDLE barely.
# Constants are calibrated to the paper's testbed scale (1 Gbit/s migration
# network, 0.75-2 GB VMs -> 12-90 s migrations, Tables 6-7); the TPU-fleet
# scale (50 GB/s ICI, 100 GB job state) is the same ratios x ~400 and is
# exercised by the beyond-paper examples.
PAPER_BANDWIDTH = 125e6            # 1 Gbit/s
PHASES = {
    "CPU": dict(compute_util=0.95, hbm_util=0.30, dirty_rate=3e6,
                label=characterize.CPU),
    "MEM": dict(compute_util=0.55, hbm_util=0.95, dirty_rate=150e6,
                label=characterize.MEM),
    "IO": dict(compute_util=0.25, hbm_util=0.45, dirty_rate=12e6,
               label=characterize.IO),
    "IDLE": dict(compute_util=0.03, hbm_util=0.05, dirty_rate=0.3e6,
                 label=characterize.IDLE),
}


def phase_means(name: str) -> Tuple[float, ...]:
    """A phase's load-index means in telemetry field order
    (``DEFAULT_FIELDS``) — the ONE place the per-field formulas live, so
    the scalar sampler (``WorkloadTrace.sample_indexes``) and the bulk
    recorder's precomputed tables cannot drift apart."""
    ph = PHASES[name]
    return (0.5 / max(ph["compute_util"], 0.02),        # step_time
            ph["dirty_rate"],                           # dirty_bytes
            min(1.0, ph["dirty_rate"] / 200e6),         # dirty_fraction
            ph["compute_util"] * 1e9,                   # collective_bytes
            ph["compute_util"], ph["hbm_util"])


@dataclass
class WorkloadTrace:
    """Piecewise-constant phase trace. phases: [(name, duration_s), ...]
    repeated cyclically for ``total_s`` seconds, shifted by ``offset``
    (replicas of one application de-phased across the fleet)."""
    phases: Sequence[Tuple[str, float]]
    total_s: float
    jitter: float = 0.05
    seed: int = 0
    offset: float = 0.0

    def __post_init__(self):
        ends = np.cumsum([d for _, d in self.phases]).astype(np.float64)
        self.cycle_s = float(ends[-1])
        self._names = [n for n, _ in self.phases]
        self._rate = PiecewiseRate(
            ends, [PHASES[n]["dirty_rate"] for n in self._names],
            offset=self.offset)

    def phase_at(self, t: float) -> str:
        return self._names[self._rate.index_at(t)]

    def dirty_rate(self, t: float) -> float:
        return self._rate(t)

    @property
    def rate_table(self) -> PiecewiseRate:
        return self._rate

    def sample_indexes(self, t: float, rng: np.random.Generator) -> dict:
        means = phase_means(self.phase_at(t))
        j = lambda v: float(max(0.0, v * (1 + self.jitter * rng.standard_normal())))
        # dict(zip(...)) draws one normal per field IN FIELD ORDER — the
        # rng-stream contract the bulk recorder reproduces as one array
        return dict(zip(DEFAULT_FIELDS, (j(v) for v in means)))

    def label_at(self, t: float) -> int:
        return PHASES[self.phase_at(t)]["label"]


def make_training_nb(rng_seed: int = 0, n: int = 4000,
                     device: DeviceLike = None) -> characterize.NaiveBayes:
    """Train the NB classifier on labeled synthetic phase samples — the
    paper's training-data step (it trains NB on benchmark runs)."""
    rng = np.random.default_rng(rng_seed)
    feats, labels = [], []
    trace = WorkloadTrace([("CPU", 1), ("MEM", 1), ("IO", 1), ("IDLE", 1)], 4)
    for i in range(n):
        t = rng.uniform(0, trace.cycle_s)
        s = trace.sample_indexes(t, rng)
        feats.append([s[f] for f in TelemetryBuffer().fields])
        labels.append(trace.label_at(t))
    return characterize.fit(np.asarray(feats, np.float32),
                            np.asarray(labels), device=device)


@dataclass
class SimJob:
    job_id: str
    trace: WorkloadTrace
    v_bytes: float                      # migratable state size
    telemetry: TelemetryBuffer = field(
        default_factory=lambda: TelemetryBuffer(capacity=16384))


@dataclass
class SimResult:
    migrations: List[MigrationRequest]
    total_bytes: float
    total_time: float
    mean_migration_time: float
    mean_downtime: float
    per_job: Dict[str, strunk.MigrationOutcome]
    lm_hit_rate: float                 # fraction fired inside a true LM phase
    makespan: float = 0.0              # first launch -> last completion
    link_bytes: Dict[str, float] = field(default_factory=dict)
    # --- fault-injection accounting (all zero/empty without a FaultPlan) ---
    aborted_bytes: float = 0.0         # partial bytes wasted by aborted lanes
    n_aborts: int = 0
    n_retries: int = 0                 # aborted requests re-admitted
    failed_jobs: List[str] = field(default_factory=list)   # retries exhausted
    completed_at: Dict[str, float] = field(default_factory=dict)
    # (job_id, t_abort, partial_bytes, path at abort) per aborted lane —
    # the conservation tests bill these bytes against the abort-time path
    abort_log: List[Tuple[str, float, float, Tuple[str, ...]]] = \
        field(default_factory=list)


class FleetSim:
    """Time-stepped simulation: telemetry sampling + LMCM ticks + the
    contention-aware migration plane.

    Telemetry is backed by one fleet-wide SoA ring buffer (``FleetTelemetry``)
    — one (J, F) record per step, one gather per surveillance tick — and the
    LMCM's batched surveillance engine refreshes every stale cycle fit in a
    single pipeline per step (see ``core/surveillance.py``). Migrations the
    LMCM releases run on the sharded fabric (``ShardedPlane``): each
    sampling period every migration domain's event loop advances its
    in-flight pre-copies together, re-sharing link bandwidth max-min
    fairly at round boundaries; disjoint domains advance independently.
    The substrate is a ``Topology.star`` over the placement's hosts when a
    placement is given (access links at ``bandwidth``, core sized by
    ``core_oversubscription``), else the paper's single dedicated
    1 Gbit/s migration network.
    """

    def __init__(self, jobs: Sequence[SimJob], *, policy: str,
                 bandwidth: float = PAPER_BANDWIDTH, sample_period: float = 1.0,
                 max_wait: float = 600.0, max_concurrent: int = 2,
                 warmup_s: float = 0.0, seed: int = 0,
                 topology: Optional[network.Topology] = None,
                 placement: Optional[Placement] = None,
                 min_share_frac: float = 0.0,
                 core_oversubscription: float = 1.0,
                 adaptive_concurrency: bool = False,
                 horizon: bool = False,
                 event_skip: bool = True,
                 route_aware: bool = False,
                 fault_plan=None, evacuate_on_fail: bool = True,
                 retry_backoff_s: float = 4.0, retry_max: int = 3,
                 retry_jitter: float = 0.0, retry_jitter_seed: int = 0,
                 guard: Optional[MigrationGuard] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.jobs = {j.job_id: j for j in jobs}
        self.rng = np.random.default_rng(seed)
        self.lmcm = LMCM(policy=policy, max_wait=max_wait,
                         max_concurrent=max_concurrent, bandwidth=bandwidth,
                         sample_period=sample_period,
                         min_share_frac=min_share_frac,
                         retry_backoff_s=retry_backoff_s,
                         retry_max=retry_max,
                         retry_jitter=retry_jitter,
                         retry_jitter_seed=retry_jitter_seed,
                         device=self.device)
        # fault injection (scenarios/faults.py): events fire at the first
        # sampling boundary >= their t, as event boundaries the skip
        # paths never jump over. An EMPTY plan normalizes to None — by
        # construction identical to no plan at all, which is the
        # empty-FaultPlan parity contract every existing benchmark and
        # bit-identity check relies on.
        self._fault_plan = fault_plan if fault_plan else None
        self._fault_idx = 0
        self._down_hosts: set = set()
        self._evacuate_on_fail = evacuate_on_fail
        # (job_id, t, partial_bytes, path) per aborted lane, cumulative;
        # run_with_plan slices its window out for SimResult
        self._abort_log: List[Tuple[str, float, float, Tuple[str, ...]]] = []
        self._failed_jobs: List[str] = []
        self._retry_count = 0
        self._restart_count = 0
        self.bandwidth = bandwidth
        if topology is None:
            if placement is not None:
                # the default fleet substrate: a star fabric — one access
                # link per host at the migration-network speed, joined by a
                # core sized at (n_hosts x access) / oversubscription (1:1
                # leaves the core non-binding; raise the ratio to study an
                # oversubscribed spine)
                hosts = list(placement.hosts)
                topology = network.Topology.star(
                    hosts, bandwidth,
                    core_capacity=len(hosts) * bandwidth
                    / max(core_oversubscription, 1e-9))
            else:
                topology = network.Topology.single_link(bandwidth)
        self.topology = topology
        self.placement = placement
        # prediction guard (core/guard.py): one shared watchdog instance
        # plumbed into every migration domain's plane; None (the default)
        # takes no guard code path anywhere — bit-identical to a
        # guard-less build
        self._guard = guard
        self.plane = ShardedPlane(self.topology, guard=guard)
        # multi-route fabrics (Topology.pod_spine): re-pick each launch's
        # route greedily at its release boundary (best probed share, see
        # ShardedPlane.pick_route). Requests are still stamped with route
        # 0 at submit (probe input); with the adaptive controller wired
        # in, the controller's defer-k x route sweep stamps routes itself
        # and this knob is moot. No-op on single-route topologies.
        self._route_aware = route_aware
        self.lmcm.bandwidth_probe = lambda req, extra=0, pending=(): \
            self.plane.probe_bandwidth(req.src, req.dst, extra,
                                       pending=pending)
        # the launch gate's floor reference: the request's uncontended
        # path capacity (on multi-rack substrates the ToR/core bottleneck,
        # NOT the nominal access speed)
        self.lmcm.path_capacity = lambda req: \
            self.plane.path_capacity(req.src, req.dst)
        # endpoint revalidation around dead hosts — a pure no-op (True)
        # while nothing is down, so wiring it unconditionally preserves
        # the no-fault paths bit-for-bit
        self.lmcm.retarget = self._retarget_request
        if adaptive_concurrency or horizon:
            # replace the static share-floor gate with the adaptive
            # concurrency controller: defer-k sweeps per migration domain
            # over the fabric's what-if probes (min_share_frac remains the
            # fallback policy when the controller is off). ``horizon``
            # upgrades the sweep to receding-horizon admission: the
            # controller also prices "launch at the predicted cycle
            # trough" columns read from the surveillance engine's fits,
            # reprices already-in-flight lanes, and publishes per-request
            # wake times that LMCM._defer_wake turns into exact heap
            # boundaries (so event-skip never jumps a re-admission).
            from repro_torch.core.controller import AdaptiveConcurrencyController
            self.lmcm.controller = AdaptiveConcurrencyController(
                self.plane,
                rate_of=lambda req: (
                    self.jobs[req.job_id].trace.rate_table
                    if req.job_id in self.jobs else None),
                defer_s=sample_period,
                horizon=horizon,
                trough_of=self._trough_of if horizon else None)
            if horizon:
                # horizon admission reads cycle fits even under
                # policy="immediate" — keep the engine ticking and its
                # refresh boundaries visible to the event-skip paths
                self.lmcm.force_surveillance = True
        self.dt = sample_period
        self.now = 0.0
        # adopt jobs constructed with a default (empty) buffer into the
        # fleet SoA store; pre-filled custom buffers are kept as-is
        self.telemetry = FleetTelemetry(len(jobs), capacity=16384,
                                        device=self.device)
        self._job_list = list(jobs)
        self._job_row = {j.job_id: i for i, j in enumerate(self._job_list)}
        # job rows currently under a telemetry_blackout fault: their
        # samples are overwritten with NaN AFTER the rng draw, so the
        # stream (and every non-blacked-out value) is unchanged and the
        # scalar/bulk recording paths stay bit-identical
        self._blackout_rows: set = set()
        for idx, j in enumerate(self._job_list):
            if (len(j.telemetry) == 0
                    and tuple(j.telemetry.fields) == self.telemetry.fields):
                j.telemetry = self.telemetry.view(idx)
        self._soa_record = all(
            getattr(j.telemetry, "fleet", None) is self.telemetry
            and j.telemetry.index == i
            for i, j in enumerate(self._job_list))
        # bulk (vectorized, bit-identical) telemetry recording is possible
        # when every job records into the fleet SoA store through the
        # stock WorkloadTrace sampler — the precondition for both the
        # run_idle fast path and run_with_plan's event skipping
        self._bulk_ok = bool(self._job_list) and self._soa_record and all(
            isinstance(j.trace, WorkloadTrace)
            and type(j.trace).sample_indexes is WorkloadTrace.sample_indexes
            and type(j.trace).phase_at is WorkloadTrace.phase_at
            and "sample_indexes" not in vars(j.trace)
            and "phase_at" not in vars(j.trace)
            for j in self._job_list)
        self._event_skip = event_skip
        # earliest step any cycle fit can go stale, cached: fits only
        # change at/after this boundary, so it is recomputed (O(J)) only
        # when the clock reaches it — not on every idle tick
        self._refresh_boundary: Optional[float] = None
        if self._bulk_ok:
            self._bulk_tables = self._build_bulk_tables()
        nb = make_training_nb(device=self.device)
        for j in jobs:
            # surveillance window: >=4 observed cycles, else the FFT cannot
            # resolve the period (max detectable period is window/2)
            window = int(min(4096, max(512, 4 * j.trace.cycle_s / self.dt)))
            self.lmcm.register_job(
                j.job_id, j.telemetry, nb, window=window,
                dirty_rate_fn=j.trace.dirty_rate)
        if warmup_s:
            self.run_idle(warmup_s)

    def _record_all(self) -> None:
        """One telemetry sample per job — a single (J, F) SoA append when
        every job lives in the fleet store."""
        step = int(self.now / self.dt)
        if self._soa_record:
            vals = np.empty((len(self._job_list), len(self.telemetry.fields)))
            for i, j in enumerate(self._job_list):
                s = j.trace.sample_indexes(self.now, self.rng)
                vals[i] = [s[f] for f in self.telemetry.fields]
            if self._blackout_rows:
                vals[sorted(self._blackout_rows)] = np.nan
            self.telemetry.record_fleet(step, vals)
        else:
            for i, j in enumerate(self._job_list):
                s = j.trace.sample_indexes(self.now, self.rng)
                if i in self._blackout_rows:
                    s = dict.fromkeys(s, float("nan"))
                j.telemetry.record(step, **s)

    def _step_times(self, steps: int) -> np.ndarray:
        """The next ``steps``+1 clock values under the per-second loop's
        ``now += dt`` accumulation — cumsum reproduces the float rounding
        of the sequential loop bit-for-bit ([0] is the current clock,
        [:-1] are the iteration clocks, [-1] is the clock after the last
        iteration)."""
        return np.cumsum(np.concatenate([[self.now],
                                         np.full(steps, self.dt)]))

    def _build_bulk_tables(self):
        """Per-job phase tables stacked for the bulk recorder: padded
        phase-end matrix (J, W), per-job last-phase index, cycle, offset,
        jitter, and the (J, P, F) per-phase load-index means in telemetry
        field order (the exact scalars ``sample_indexes`` derives per
        call)."""
        traces = [j.trace for j in self._job_list]
        # the rate tables already carry one (end, rate) entry per phase:
        # reuse their padded stacking (ends inf-padded, one row per job)
        ends, _, cyc, off = PiecewiseRate.stack(
            [t.rate_table for t in traces])
        base = np.zeros((len(traces), ends.shape[1],
                         len(self.telemetry.fields)))
        for i, tr in enumerate(traces):
            for p, n in enumerate(tr._names):
                base[i, p] = phase_means(n)
        return (ends, np.asarray([len(t._names) - 1 for t in traces]),
                cyc, off, np.asarray([t.jitter for t in traces]), base)

    def _record_bulk(self, times: np.ndarray) -> None:
        """One (S, J, F) telemetry append for the per-step samples at
        ``times`` — ring contents and rng stream identical to S
        ``_record_all`` calls (the Generator draws the same normal
        sequence whether sampled scalar-by-scalar or as one array, and
        every per-element op mirrors ``WorkloadTrace.sample_indexes``:
        same modulo/compare phase lookup, same ``v * (1 + jitter * z)``
        float order). No per-step or per-job Python — phase indices come
        from one padded compare against the precomputed tables. Callers
        must have checked ``self._bulk_ok``. Long windows append in
        bounded step chunks (the rng stream is sequential, so chunked
        draws equal one big draw): peak scratch stays O(chunk x J x F)
        instead of O(window x J x F) at 10k-job fleets."""
        n_jobs, n_fields = len(self._job_list), len(self.telemetry.fields)
        chunk = max(1, int(4e6 // max(1, n_jobs * n_fields)))
        for lo in range(0, len(times), chunk):
            self._record_bulk_chunk(times[lo:lo + chunk], n_jobs,
                                    n_fields)

    def _record_bulk_chunk(self, times: np.ndarray, n_jobs: int,
                           n_fields: int) -> None:
        s = len(times)
        if s == 0:
            return
        ends, last, cyc, off, jitter, base = self._bulk_tables
        z = self.rng.standard_normal((s, n_jobs, n_fields))
        tc = np.mod(times[:, None] + off, cyc)             # (S, J)
        # phase index: count of phase ends <= tc (== searchsorted
        # side="right"), clamped like PiecewiseRate.index_at
        idx = np.minimum((tc[:, :, None] >= ends).sum(axis=2), last)
        vals = np.multiply(z, jitter[None, :, None])
        vals += 1.0
        vals *= base[np.arange(n_jobs)[None, :], idx]
        np.maximum(vals, 0.0, out=vals)
        if self._blackout_rows:
            # blackout membership is constant within a chunk: telemetry
            # fault events are skip/bulk boundaries like any other fault
            vals[:, sorted(self._blackout_rows), :] = np.nan
        self.telemetry.record_fleet_bulk(
            (times / self.dt).astype(np.int64), vals)

    def run_idle(self, seconds: float) -> None:
        """Advance the clock recording telemetry only (warmup / idle
        stretches). With the fleet SoA store and stock traces this is one
        bulk append instead of O(seconds) Python iterations, with
        bit-identical ring contents, rng stream, and clock."""
        steps = int(seconds / self.dt)
        if steps <= 0:
            return
        if self._event_skip and self._bulk_ok:
            nows = self._step_times(steps)
            if self._fault_plan is None:
                self._record_bulk(nows[:-1])
                self.now = float(nows[-1])
                return
            # fault events are boundaries the bulk append may not cross:
            # record in segments, firing the due faults at each segment
            # head — chunked rng draws equal one big draw, so ring
            # contents, stream, and clock stay bit-identical to the
            # per-second loop below
            cand = nows[:-1]
            lo = 0
            while lo < steps:
                self._apply_faults(float(cand[lo]))
                t_f = self._next_fault_time()
                hi = steps if not np.isfinite(t_f) else \
                    max(lo + 1, int(np.searchsorted(cand, t_f,
                                                    side="left")))
                self._record_bulk(cand[lo:hi])
                lo = hi
            self.now = float(nows[-1])
            return
        for _ in range(steps):
            if self._fault_plan is not None:
                self._apply_faults(self.now)
            self._record_all()
            self.now += self.dt

    # -- fault injection -----------------------------------------------------
    def _next_fault_time(self) -> float:
        """Sim time of the next unapplied fault event (inf when the plan
        is exhausted or absent) — a hard skip/bulk boundary."""
        if self._fault_plan is None or \
                self._fault_idx >= len(self._fault_plan.events):
            return float("inf")
        return self._fault_plan.events[self._fault_idx].t

    def _apply_faults(self, now: float, launch_info=None) -> None:
        """Fire every fault event due at or before ``now`` (events are
        quantized to the first sampling boundary >= their t). A host
        failure aborts the in-flight lanes touching the host, re-admits
        them through the LMCM's backoff path, and (with
        ``evacuate_on_fail``) cold-restarts the VMs resident on the dead
        host; link events push the new capacity through the fabric."""
        while self._next_fault_time() <= now:
            ev = self._fault_plan.events[self._fault_idx]
            self._fault_idx += 1
            if ev.kind == "host_fail":
                self._down_hosts.add(ev.target)
                for req, outcome in self.plane.fail_host(ev.target):
                    self._handle_abort(req, outcome, now, launch_info)
                if self._evacuate_on_fail:
                    self._submit_restarts(ev.target, now)
            elif ev.kind == "host_recover":
                self._down_hosts.discard(ev.target)
            elif ev.kind == "link_fail":
                # correlated ToR/pod-uplink outage: capacity drops AND the
                # lanes riding the link abort into the retry path (which
                # re-routes around the outage on multi-route fabrics) —
                # unlike a 0.0 link_degrade, which stalls them in place
                self.plane.set_link_capacity(ev.target, ev.capacity)
                for req, outcome in self.plane.abort_link(ev.target):
                    self._handle_abort(req, outcome, now, launch_info)
            elif ev.kind == "telemetry_blackout":
                self._blackout_rows.update(
                    self._job_row[j] for j in ev.jobs if j in self._job_row)
            elif ev.kind == "telemetry_restore":
                self._blackout_rows.difference_update(
                    self._job_row[j] for j in ev.jobs if j in self._job_row)
            else:                        # link_degrade / link_restore
                self.plane.set_link_capacity(ev.target, ev.capacity)

    def _handle_abort(self, req: MigrationRequest,
                      outcome: strunk.MigrationOutcome, now: float,
                      launch_info=None) -> None:
        """Bookkeeping for one aborted lane: log the wasted partial bytes
        against the abort-time path (retries may re-route), drop the
        stale launch record, and hand the request to ``LMCM.fail`` for
        backoff re-admission or permanent failure."""
        self._abort_log.append((req.job_id, now, outcome.bytes_sent,
                                tuple(req.path)))
        if launch_info is not None:
            launch_info.pop(id(req), None)
        if self.lmcm.fail(req, outcome, now):
            self._retry_count += 1
        else:
            self._failed_jobs.append(req.job_id)

    def _handle_guard_abort(self, req: MigrationRequest,
                            outcome: strunk.MigrationOutcome, now: float,
                            launch_info=None) -> None:
        """A guard abort is misprediction feedback, not just a failed
        lane: the fit that priced the launch was wrong, so force it
        stale (refit at the next surveillance tick instead of waiting
        out the staleness epoch) and decay the job's ``trust`` — which
        gates the receding-horizon trough pricing through
        ``MigrationGuard.trusts``. The lane itself then takes the normal
        abort path (wasted-bytes log + ``LMCM.fail`` backoff)."""
        sj = self.lmcm.engine.jobs.get(req.job_id)
        if sj is not None:
            sj.trust = self._guard.decay_trust(sj.trust)
            if sj.fitted_step >= 0:
                sj.fitted_step = -1
                self.lmcm.engine._decide_cache = None
                # the cached stale boundary assumed no forced refits
                self._refresh_boundary = None
        self._handle_abort(req, outcome, now, launch_info)

    def _stamp_expectation(self, req: MigrationRequest,
                           job: SimJob) -> None:
        """Price the launch the guard will hold the lane to: the Strunk
        cost at the fair share the fabric probes for one more lane on
        the request's path, against the job's registered rate table.
        This is the plane's own cost model under the launch-time state
        of the world — divergence beyond it means contention, faults, or
        throttle-resistant dirtying the admission price did not see."""
        bw = self.plane.probe_bandwidth(req.src, req.dst, 1)
        out = strunk.what_if_cost_batch(
            [req.v_bytes], bw, [job.trace.rate_table], [self.now],
            full=True)
        req.expected_bytes = float(out.bytes_sent[0])
        req.expected_time = float(out.total_time[0])

    def _live_hosts(self) -> List[str]:
        return [h for h in self.placement.hosts
                if h not in self._down_hosts]

    def _submit_restarts(self, host: str, now: float) -> None:
        """Cold-restart the VMs resident on a dead host: their memory
        state is lost, so recovery re-sources each image from a live
        host and flows through the normal LMCM pipeline as an urgent
        request (no policy postponement — there is no workload left to
        time against; concurrency control still applies). VMs already
        covered by a live request (in flight and just re-admitted, or
        queued) are skipped — the retry path owns them."""
        if self.placement is None or host not in self.placement.hosts:
            return
        in_play = {r.job_id for r in self.lmcm.running
                   if r.decision == "running"}
        in_play |= {entry[2].job_id for entry in self.lmcm.queue
                    if entry[2].decision == "scheduled"}
        for job_id in sorted(self.placement.hosts[host].jobs):
            if job_id in in_play or job_id not in self.jobs:
                continue
            req = self._restart_request(job_id, now)
            if req is None:
                self._failed_jobs.append(job_id)
                continue
            req.urgent = True
            self._restart_count += 1
            self.lmcm.submit(req, now)

    def _restart_request(self, job_id: str, now: float
                         ) -> Optional[MigrationRequest]:
        """An urgent recovery request for a VM lost with its host: dst is
        the least-loaded live host, src a live image source (the cold
        restart streams the image, not the dead RAM). None when no live
        host remains."""
        live = self._live_hosts()
        if not live:
            return None
        dst = min(live, key=lambda h: (self.placement.hosts[h].load, h))
        src = next((h for h in live if h != dst), dst)
        req = MigrationRequest(job_id, created_at=now,
                               v_bytes=self.jobs[job_id].v_bytes,
                               src=src, dst=dst)
        req.path = self.topology.path(src, dst)
        return req

    def _retarget_request(self, req: MigrationRequest) -> bool:
        """LMCM ``retarget`` hook: keep a request's endpoints off dead
        hosts. A pure no-op (True) while nothing is down — the wiring
        itself changes no fault-free behavior. A dead destination is
        replaced by the least-loaded live host; a dead source means the
        VM's transferable state is gone, so recovery re-sources from a
        live host (cold restart from the image store). Returns False
        when no live host can serve the request."""
        if not self._down_hosts:
            return True
        if self.placement is None:
            return req.src not in self._down_hosts \
                and req.dst not in self._down_hosts
        changed = False
        if req.dst in self._down_hosts:
            live = [h for h in self._live_hosts() if h != req.src]
            if not live:
                return False
            req.dst = min(live,
                          key=lambda h: (self.placement.hosts[h].load, h))
            changed = True
        if req.src in self._down_hosts:
            live = [h for h in self._live_hosts() if h != req.dst]
            if not live:
                return False
            req.src = live[0]
            changed = True
        if changed:
            req.path = self.topology.path(req.src, req.dst)
        return True

    def _tag_request(self, req: MigrationRequest) -> None:
        """Resolve src (via the placement's O(1) job->host index) and the
        network links the transfer will traverse."""
        if self.placement is not None and not req.src:
            req.src = self.placement.host_of(req.job_id) or ""
        req.path = self.topology.path(req.src, req.dst)

    def _trough_of(self, req: MigrationRequest,
                   now: float) -> Optional[float]:
        """Controller ``trough_of`` hook: Alg. 2 RemainTime to the job's
        next predicted cycle trough, in seconds (None when the job has no
        cyclic fit — the controller then prices the plain one-period
        defer instead). With a guard wired, a fit whose
        ``confidence x trust`` falls below the guard's gate is treated
        as no fit at all: guard aborts burned the model's credibility,
        so the controller falls back to myopic pricing until refits
        re-earn it."""
        if self._guard is not None:
            sj = self.lmcm.engine.jobs.get(req.job_id)
            if (sj is not None and sj.model is not None
                    and not self._guard.trusts(sj.model.confidence,
                                               sj.trust)):
                return None
        remain = self.lmcm.engine.next_trough(
            [req.job_id], int(now / self.dt)).get(req.job_id)
        return None if remain is None else float(remain) * self.dt

    def _skip_idle_steps(self, pending: Sequence[MigrationRequest],
                         t_end: float) -> None:
        """Fast-forward over per-second iterations that would be pure
        telemetry: nothing in flight, no arrival due, no heap release,
        and no surveillance epoch going stale. The clock jumps straight
        to the next pending arrival / LMCM due / refresh boundary (or the
        horizon), bulk-appending the skipped samples — ring contents, rng
        stream, clock accumulation, and every fit/decision are
        bit-identical to ticking one second at a time (skipped iterations
        are provably no-ops: ``refresh()`` touches nothing before the
        stale boundary and ``due()`` pops nothing before the heap head).
        """
        nxt_arr = pending[0].created_at if pending else np.inf
        nxt_due = self.lmcm.next_due_time()
        # fault events are first-class boundaries the skip may NEVER
        # jump over: a crash must abort lanes / submit restarts at its
        # own quantized boundary, not at the next arrival (inf when no
        # plan — the mask below degenerates to all-True)
        nxt_fault = self._next_fault_time()
        now_step = int(self.now / self.dt)
        if not self.lmcm.uses_surveillance:
            # no-surveillance policies never tick the engine (no fits to
            # keep on schedule): only arrivals and the heap bound skips
            nxt_refresh = np.inf
        else:
            # a fit can only change at/after the cached boundary (a job
            # is stale no earlier than it), so the O(J) engine scan runs
            # once per boundary, not once per idle tick
            if (self._refresh_boundary is None
                    or now_step >= self._refresh_boundary):
                self._refresh_boundary = \
                    self.lmcm.engine.next_refresh_step(now_step)
            nxt_refresh = self._refresh_boundary
        # candidate iteration count (slack-padded estimate; the exact
        # prefix is re-checked on the generated clocks below)
        bound = min(t_end, nxt_arr, nxt_due, nxt_fault,
                    self.now + (nxt_refresh - now_step) * self.dt)
        cap = int(max(0.0, (bound - self.now) / self.dt)) + 1
        if cap <= 1:
            return
        nows = self._step_times(cap)
        cand = nows[:-1]                       # per-iteration clocks
        safe = ((cand < t_end) & (cand < nxt_arr) & (cand < nxt_due)
                & (cand < nxt_fault)
                & ((cand / self.dt).astype(np.int64) < nxt_refresh))
        stop = int(np.argmin(safe)) if not safe.all() else cap
        if stop <= 0:
            return
        self._record_bulk(cand[:stop])
        self.now = float(nows[stop])

    def run_with_plan(self, plan: Sequence[MigrationRequest],
                      horizon_s: float = 3600.0) -> SimResult:
        pending = sorted(plan, key=lambda r: r.created_at)
        per_job: Dict[str, strunk.MigrationOutcome] = {}
        done: List[MigrationRequest] = []
        completed_at: Dict[str, float] = {}
        lm_hits = 0
        # lm-hit (launched in a non-MEM phase) and launch time, recorded at
        # release but only counted for migrations that actually complete
        launch_info: Dict[int, Tuple[bool, float]] = {}
        first_launch, last_finish = np.inf, 0.0
        # window markers into the cumulative fault accounting
        n_abort0, n_fail0 = len(self._abort_log), len(self._failed_jobs)
        n_retry0 = self._retry_count
        faults_live = self._fault_plan is not None
        t_end = self.now + horizon_s
        while self.now < t_end and (pending or self.lmcm.queue
                                    or self.lmcm.running
                                    or self.plane.in_flight
                                    or (faults_live and
                                        self._next_fault_time() < t_end)):
            if faults_live:
                # fault boundary first: aborts/restarts/capacity changes
                # take effect before this iteration's releases and
                # execution (the skip path stops exactly here)
                self._apply_faults(self.now, launch_info)
            if (self._event_skip and self._bulk_ok
                    and self.plane.in_flight == 0
                    and not self.plane._pending
                    and (pending or self.lmcm.queue
                         or (faults_live and
                             np.isfinite(self._next_fault_time())))):
                self._skip_idle_steps(pending, t_end)
                if self.now >= t_end:
                    break
                if faults_live:
                    # the skip stops exactly ON a fault boundary: fire it
                    # before this iteration's telemetry/releases, matching
                    # the per-second loop's apply-then-record order
                    self._apply_faults(self.now, launch_info)
            while pending and pending[0].created_at <= self.now:
                req = pending.pop(0)
                self._tag_request(req)
                self.lmcm.submit(req, self.now)
            self._record_all()
            if self.lmcm.uses_surveillance:
                # batched fleet surveillance (the immediate baseline is
                # the paper's no-surveillance policy: it never reads a
                # cycle fit, so refreshing fits for it would be pure
                # waste at fleet scale)
                self.lmcm.tick(self.now)
            for req in self.lmcm.due(self.now):
                job = self.jobs[req.job_id]
                # accuracy metric (Figs. 8-9): did we fire in a non-MEM phase?
                launch_info[id(req)] = (job.trace.phase_at(self.now) != "MEM",
                                        self.now)
                first_launch = min(first_launch, self.now)
                if self._route_aware and self.lmcm.controller is None:
                    # greedy launch-time route choice (the controller, when
                    # wired, stamps sweep-assigned routes on req.path)
                    req.path = self.plane.pick_route(req.src, req.dst)
                if self._guard is not None:
                    # stamp the admission-time price the guard holds the
                    # lane to (NaN-free only when a guard is wired — the
                    # stamping itself must not perturb guardless runs)
                    self._stamp_expectation(req, job)
                # register the lane with its PiecewiseRate table so the
                # plane's vectorized event loop accrues its dirty bytes
                # through the batched lookup (see core/rates.py)
                self.plane.launch(req, job.trace.rate_table, self.now,
                                  path=req.path or None)
            self.now += self.dt
            # one sampling period of contended execution: every in-flight
            # migration advances together, link shares recomputed at events
            for req, outcome in self.plane.advance(self.now):
                if outcome.stop_reason == strunk.STOP_GUARD:
                    # convergence watchdog cut the lane: misprediction
                    # feedback + backoff re-admission, not a completion
                    self._handle_guard_abort(req, outcome, self.now,
                                             launch_info)
                    continue
                self.lmcm.finish(req, outcome)
                per_job[req.job_id] = outcome
                done.append(req)
                completed_at[req.job_id] = self.now
                hit, launched_at = launch_info.pop(id(req))
                lm_hits += hit
                last_finish = max(last_finish,
                                  launched_at + outcome.total_time)
                if self.placement is not None and req.dst:
                    self.placement.move(req.job_id, req.dst)
        total_bytes = sum(o.bytes_sent for o in per_job.values())
        times = [o.total_time for o in per_job.values()]
        downs = [o.downtime for o in per_job.values()]
        abort_log = list(self._abort_log[n_abort0:])
        return SimResult(
            migrations=done,
            total_bytes=total_bytes,
            total_time=float(np.sum(times)) if times else 0.0,
            mean_migration_time=float(np.mean(times)) if times else 0.0,
            mean_downtime=float(np.mean(downs)) if downs else 0.0,
            per_job=per_job,
            lm_hit_rate=lm_hits / max(1, len(done)),
            makespan=(last_finish - first_launch) if done else 0.0,
            link_bytes=dict(self.plane.link_bytes),
            aborted_bytes=float(sum(b for _, _, b, _ in abort_log)),
            n_aborts=len(abort_log),
            n_retries=self._retry_count - n_retry0,
            failed_jobs=list(self._failed_jobs[n_fail0:]),
            completed_at=completed_at,
            abort_log=abort_log,
        )


# ---------------------------------------------------------------------------
# the paper's Table 3 artificial cycles + application-like traces
# ---------------------------------------------------------------------------
def table3_traces(phase_s: float = 60.0, *, replicas: int = 1
                  ) -> Dict[str, WorkloadTrace]:
    """The paper's four Table 3 cycles; ``replicas`` > 1 instantiates each
    cycle multiple times with staggered phase offsets (the contended-fleet
    scenario: many VMs of the same applications, out of phase)."""
    def t(names, off):
        return WorkloadTrace([(n, phase_s) for n in names], total_s=3600,
                             offset=off)
    base = {
        "vm03_A": ["IO", "CPU", "CPU", "IO", "CPU", "CPU", "IO", "CPU",
                   "CPU"],
        "vm02_C": ["MEM", "IDLE", "CPU", "MEM", "IDLE", "CPU", "MEM",
                   "IDLE", "CPU"],
        "vm02_A": ["MEM", "CPU", "CPU", "MEM", "CPU", "CPU", "MEM", "CPU",
                   "CPU", "MEM", "CPU", "CPU"],
        "vm01_C": ["MEM", "IDLE", "CPU", "MEM", "IDLE", "CPU"],
    }
    if replicas == 1:
        return {name: t(names, 0.0) for name, names in base.items()}
    out: Dict[str, WorkloadTrace] = {}
    for name, names in base.items():
        cycle = phase_s * len(names)
        for r in range(replicas):
            out[f"{name}.{r}"] = t(names, r * cycle / replicas)
    return out


def application_traces(phase_s: float = 45.0, *, replicas: int = 1
                       ) -> Dict[str, WorkloadTrace]:
    """Application analogues (paper §6.3.2): long irregular phases.
    OpenModeller ~ CPU-dominant with IO bursts; BRAMS ~ complex cycle;
    Hadoop/TeraSort ~ shuffle-heavy (MEM/IO alternation). ``replicas`` > 1
    de-phases multiple instances of each application (contended fleets)."""
    base = {
        "vm03_A_openmodeller": [("IO", phase_s), ("CPU", 4 * phase_s),
                                ("MEM", phase_s), ("CPU", 3 * phase_s)],
        "vm02_C_brams": [("MEM", phase_s), ("CPU", 2 * phase_s),
                         ("MEM", 2 * phase_s), ("IO", phase_s),
                         ("CPU", 2 * phase_s), ("IDLE", phase_s)],
        "vm01_C_hadoop": [("IO", phase_s), ("MEM", 2 * phase_s),
                          ("CPU", phase_s), ("IO", 2 * phase_s)],
        "vm02_A_hadoop": [("MEM", 2 * phase_s), ("IO", phase_s),
                          ("CPU", phase_s), ("MEM", phase_s),
                          ("IO", phase_s)],
    }
    if replicas == 1:
        return {n: WorkloadTrace(spec, total_s=7200)
                for n, spec in base.items()}
    out: Dict[str, WorkloadTrace] = {}
    for n, spec in base.items():
        cycle = sum(d for _, d in spec)
        for r in range(replicas):
            out[f"{n}.{r}"] = WorkloadTrace(spec, total_s=7200,
                                            offset=r * cycle / replicas)
    return out
