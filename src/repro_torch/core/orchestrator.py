"""LMCM — the Live Migration Control Module (paper §5).

Counterpart of ``repro/core/orchestrator.py``: the same host-side queue,
decision and release logic; the surveillance engine it owns holds the
fleet's tensors on ``device`` (the card unless the caller asks for the
CPU).

ALMA's central component: it intercepts every migration request coming from
the consolidation planner and decides, per request, to

  * trigger immediately   (workload is in a suitable LM moment),
  * postpone by RemainTime (Algorithm 2) — re-evaluated at the new moment,
  * or cancel              (migration cost exceeds the remaining-work benefit,
                            or a provider/customer constraint is violated).

Policies:
  immediate   — no surveillance (paper Fig. 5a baseline)
  alma-paper  — faithful pipeline: NB -> LM/NLM -> FFT -> Alg.1 -> Alg.2,
                first-cycle-window profile, binary decisions
  alma-plus   — beyond-paper: folded (majority-vote) cycle profile, posterior-
                weighted suitability, Strunk-cost-minimizing window selection
                within the provider's max-wait horizon

Provider knobs (paper §5.1): ``max_wait`` caps postponement (long cycles must
not starve migrations), ``max_concurrent`` rate-limits simultaneous
migrations. Customer knob: ``deadline`` — if the workload is expected to end
before the migration pays off, the request is cancelled.

Scalability: all per-job surveillance (window gather -> NB classification ->
FFT cycle fit -> Algorithm 2) is delegated to the fleet-wide batched engine
in ``core/surveillance.py`` — ONE tick computes every stale job's cycle fit
(staleness epochs: a fit is reused until the window advances period/4
samples) and answers Algorithm 2 for the whole fleet in one vectorized
call. ``decide`` reads the engine's cached models; the Fig. 10 benchmark
drives ``SurveillanceEngine.tick`` directly at 10k+ jobs.

Execution feedback: released requests run on the contention-aware
migration plane (``core/plane.py``), and the plane feeds back through
``bandwidth_probe`` — the max-min fair share a request would realize right
now on its src->dst links. The deadline check and the alma-plus cost scan
judge feasibility at that realized bandwidth instead of the nominal link
speed.

Concurrency control at the release boundary (``due``) is pluggable:

  * ``controller`` (preferred) — an adaptive concurrency controller
    (``core/controller.py``) that sweeps candidate in-flight counts per
    migration domain and launches the batch minimizing predicted total
    contended bytes;
  * ``min_share_frac`` (fallback) — the static share-floor gate: a
    candidate whose realized fair share would fall below
    ``min_share_frac`` x its *uncontended path capacity* is deferred one
    sampling period. The gate probes cumulatively within the tick — each
    candidate contends against the actual paths of every same-burst
    co-launch admitted before it, not against same-path clones — so
    co-launches in disjoint domains no longer dilute each other
    spuriously, and a burst that would dilute everyone below the floor is
    deferred as a burst.

Either way, a request that can no longer be deferred without breaching the
provider's ``max_wait`` is released unconditionally.
"""
from __future__ import annotations

import heapq
import inspect
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import characterize, cycles, postpone as pp, strunk
from repro_torch.core.surveillance import SurveillanceEngine, SurveilledJob
from repro_torch.core.telemetry import TelemetryBuffer
from repro_torch.kernels.backend import DeviceLike


@dataclass
class MigrationRequest:
    job_id: str
    created_at: float
    v_bytes: float                      # state size to move
    src: str = ""
    dst: str = ""
    deadline: Optional[float] = None    # customer: expected workload end
    # --- filled by the simulator/plane ---
    path: Tuple[str, ...] = ()          # network links the transfer traverses
    # --- filled by LMCM ---
    # pending|scheduled|running|done|cancelled|failed ("failed" is the
    # terminal state of an aborted request whose retries are exhausted)
    decision: str = "pending"
    scheduled_at: float = 0.0
    outcome: Optional[strunk.MigrationOutcome] = None
    # --- failure/retry state (fault-injecting scenarios) ---
    retries: int = 0                    # re-admissions after aborts so far
    attempt_bytes: float = 0.0          # bytes wasted by aborted attempts
    # admission-time priced prediction (stamped by the simulator from the
    # controller's cost batch at launch); the execute plane's prediction
    # guard (core/guard.py) watches realized progress against these and
    # throttles/aborts diverging lanes. None = lane runs unguarded.
    expected_bytes: Optional[float] = None
    expected_time: Optional[float] = None
    # urgent requests (failure recovery: the workload is gone, there is
    # no cycle left to time against) bypass policy postponement at submit
    # and at the release boundary — concurrency control still applies
    urgent: bool = False
    # consecutive controller deferrals (receding-horizon admission): the
    # controller promotes a request to a forced launch once this reaches
    # its aging bound, so subset selection can never starve a candidate
    defers: int = 0
    # generation of this request's LIVE heap entry: cancel+resubmit leaves
    # the old entry in the heap, and decision alone cannot tell the stale
    # entry from the live one (both say "scheduled") — ``due`` only honors
    # the entry whose sequence number matches
    heap_gen: int = field(default=-1, repr=False, compare=False)


class LMCM:
    def __init__(self, *, policy: str = "alma-paper", max_wait: float = 1e4,
                 max_concurrent: int = 2, bandwidth: float = 50e9,
                 sample_period: float = 1.0,
                 surveillance: Optional[SurveillanceEngine] = None,
                 min_share_frac: float = 0.0,
                 retry_backoff_s: float = 4.0, retry_max: int = 3,
                 retry_jitter: float = 0.0, retry_jitter_seed: int = 0,
                 device: DeviceLike = None):
        assert policy in ("immediate", "alma-paper", "alma-plus")
        self.policy = policy
        self.max_wait = max_wait
        self.max_concurrent = max_concurrent
        self.bandwidth = bandwidth
        self.sample_period = sample_period     # seconds per telemetry sample
        self.engine = surveillance or SurveillanceEngine(
            folded=(policy == "alma-plus"), device=device)
        self.jobs: Dict[str, SurveilledJob] = self.engine.jobs
        self.queue: List = []                  # heap of (fire_time, seq, req)
        self._seq = 0
        self.running: List[MigrationRequest] = []
        self.log: List[MigrationRequest] = []
        # realized-bandwidth feedback from the migration plane: fair-share
        # bandwidth a request would get right now, given what's in flight.
        # Preferred signature (req, extra, pending): ``pending`` carries
        # the actual paths of same-burst co-launches not yet in flight,
        # ``extra`` approximates further ones as same-path clones; legacy
        # two-argument probes are detected once and fed the clone count
        # only. The simulator wires this to ShardedPlane.probe_bandwidth;
        # the deadline check and the alma-plus cost scan use it in place
        # of the nominal link speed, and ``due``'s fallback gate defers
        # launches whose share would fall below ``min_share_frac`` x the
        # request's uncontended path capacity (0 disables the gate).
        self.bandwidth_probe: Optional[Callable[..., float]] = None
        self._probe_pending: Tuple[Optional[Callable], bool] = (None, False)
        self.min_share_frac = min_share_frac
        # uncontended capacity of a request's src->dst path (the gate's
        # floor reference on multi-rack topologies, where the bottleneck
        # is the ToR/core link, not the nominal single-link speed); wired
        # to ShardedPlane.path_capacity by the simulator
        self.path_capacity: Optional[
            Callable[[MigrationRequest], float]] = None
        # adaptive concurrency controller (core/controller.py): when set,
        # it replaces the static share-floor gate at the release boundary
        self.controller = None
        # re-admission of aborted in-flight requests (``fail``):
        # exponential backoff base and the retry cap before a request is
        # failed permanently
        self.retry_backoff_s = retry_backoff_s
        self.retry_max = retry_max
        # deterministic backoff de-collision: a mass abort (host failure,
        # guard storm) re-admits many requests off the SAME event, so pure
        # exponential backoff re-collides them all on the same tick
        # forever. ``retry_jitter`` > 0 stretches each wait by up to that
        # fraction, keyed by a stable per-(job, attempt, seed) hash —
        # de-synchronized across jobs, reproducible across runs, and 0 by
        # default (bit-parity with the un-jittered schedule)
        self.retry_jitter = float(retry_jitter)
        self.retry_jitter_seed = int(retry_jitter_seed)
        # endpoint revalidation hook, wired by the simulator: called on a
        # request before re-admission and again at the release boundary;
        # it may rewrite src/dst/path (e.g. route around dead hosts) and
        # returns False when no valid endpoints exist — the request is
        # then failed/cancelled instead of launched at a dead host
        self.retarget: Optional[
            Callable[[MigrationRequest], bool]] = None
        # receding-horizon admission keeps reading cycle fits even under
        # policy="immediate" (the controller prices launch-at-trough
        # columns from the same fits); the simulator sets this so its
        # event-skip keeps honoring surveillance refresh boundaries
        self.force_surveillance = False

    @property
    def uses_surveillance(self) -> bool:
        """Whether this policy reads cycle fits at all — ``immediate``
        is the paper's no-surveillance baseline (Fig. 5a), so a
        simulator may skip its per-step engine ticks and staleness
        boundaries entirely."""
        return self.policy != "immediate" or self.force_surveillance

    # -- registration --------------------------------------------------------
    def register_job(self, job_id: str, telemetry: TelemetryBuffer,
                     nb: characterize.NaiveBayes, *, window: int = 512,
                     dirty_rate_fn=None) -> None:
        self.engine.register(job_id, telemetry, nb, window=window,
                             dirty_rate_fn=dirty_rate_fn)

    # -- characterization + cycle fit (paper §4) ------------------------------
    def refresh_job(self, job_id: str) -> Optional[cycles.CycleModel]:
        """Current cycle model of one job — recomputed by the surveillance
        engine only when the job's staleness epoch has lapsed."""
        return self.engine.refresh_model(job_id)

    def tick(self, now: float = 0.0) -> int:
        """One fleet surveillance pass (batched; see SurveillanceEngine).
        Staleness is tracked by telemetry step counts, not wall time, so
        ``now`` is accepted only for sim-loop symmetry. Returns the number
        of jobs whose cycle fit was recomputed."""
        return self.engine.refresh()

    # -- the decision (paper §5.2 + Fig. 5c) ----------------------------------
    def decide(self, req: MigrationRequest, now: float) -> float:
        """Returns the wait time (seconds); -1 means cancel."""
        wait = self._policy_wait(req, now)
        # provider constraint: never postpone beyond max_wait
        wait = min(wait, self.max_wait)
        # customer constraint: cancel if workload ends before migration pays
        # (judged at the REALIZED bandwidth the contended link would give us,
        # not the nominal link speed)
        if req.deadline is not None:
            t_mig = strunk.strunk_bounds(req.v_bytes,
                                         self.effective_bandwidth(req))[0]
            if now + wait + t_mig >= req.deadline:
                return -1.0
        return wait

    def _policy_wait(self, req: MigrationRequest, now: float) -> float:
        """The policy's raw postponement, before provider/customer knobs."""
        if self.policy == "immediate":
            return 0.0
        job = self.jobs.get(req.job_id)
        model = self.refresh_job(req.job_id) if job else None
        if model is None or not model.cyclic:
            return 0.0                     # acyclic: nothing to exploit
        m_now = int(now / self.sample_period) - job.origin_step
        if self.policy == "alma-paper":
            return pp.postpone(model, m_now) * self.sample_period
        return self._best_window_wait(job, model, req, now)

    def effective_bandwidth(self, req: MigrationRequest, extra: int = 0,
                            pending: Sequence[Tuple[str, ...]] = ()
                            ) -> float:
        """Bandwidth this request would realize now: the plane's fair-share
        probe when wired, capped by the nominal link speed. ``pending``
        carries the ACTUAL network paths of launches released in the same
        burst but not yet in flight; ``extra`` approximates further such
        launches as clones of this request's path (the legacy form kept
        for two-argument probes)."""
        if self.bandwidth_probe is None:
            return self.bandwidth
        if pending:
            if self._takes_pending():
                probed = self.bandwidth_probe(req, extra, tuple(pending))
            else:
                # legacy two-argument probe: fold the co-launches into the
                # same-path-clone approximation (exact on a single link)
                probed = self.bandwidth_probe(req, extra + len(pending))
        else:
            probed = self.bandwidth_probe(req, extra)
        if not np.isfinite(probed) or probed <= 0:
            return self.bandwidth
        return min(self.bandwidth, probed)

    def _takes_pending(self) -> bool:
        """Whether the wired probe accepts the third ``pending`` argument —
        decided from its signature (cached per probe object) rather than a
        try/except, which would silently mask TypeErrors raised INSIDE a
        modern probe and degrade it to the clone approximation."""
        fn = self.bandwidth_probe
        if self._probe_pending[0] is not fn:
            try:
                params = list(inspect.signature(fn).parameters.values())
                ok = (len(params) >= 3
                      or any(p.kind is p.VAR_POSITIONAL for p in params))
            except (TypeError, ValueError):
                ok = False
            self._probe_pending = (fn, ok)
        return self._probe_pending[1]

    def _floor_reference(self, req: MigrationRequest) -> float:
        """The bandwidth the share floor is a fraction OF: the request's
        uncontended path capacity when the topology is wired (a cross-rack
        transfer through an oversubscribed core can never realize the
        nominal access speed — gating it against ``self.bandwidth`` would
        defer it forever even on an idle fabric), else the nominal link
        speed."""
        if self.path_capacity is not None:
            cap = self.path_capacity(req)
            if np.isfinite(cap) and cap > 0:
                return cap
        return self.bandwidth

    def _best_window_wait(self, job: SurveilledJob, model: cycles.CycleModel,
                          req: MigrationRequest, now: float) -> float:
        """'alma-plus': scan candidate start moments across one full cycle
        (bounded by max_wait) and pick the minimum-Strunk-cost start."""
        m_now = int(now / self.sample_period) - job.origin_step
        remain = pp.postpone(model, m_now) * self.sample_period
        rate = job.dirty_rate_fn
        if rate is None:
            return remain
        # scan one cycle of candidate starts; Alg.2's moment is always a
        # candidate and wins ties (never do worse than alma-paper)
        horizon = min(model.period * self.sample_period, self.max_wait)
        candidates = np.unique(np.concatenate(
            [[min(remain, self.max_wait)],
             np.linspace(0.0, horizon, num=min(32, model.period + 1))]))
        costs = strunk.expected_cost_batch(
            req.v_bytes, self.effective_bandwidth(req), rate,
            now + candidates)
        best = costs.min()
        ok = costs <= best * 1.01
        if ok[candidates == min(remain, self.max_wait)].any():
            return float(min(remain, self.max_wait))
        return float(candidates[ok][0])

    # -- queue machinery -------------------------------------------------------
    def _push(self, req: MigrationRequest, when: float) -> None:
        """(Re)enter the heap: stamps the request with a fresh entry
        generation so any older entry for the same request goes stale."""
        req.scheduled_at = when
        self._seq += 1
        req.heap_gen = self._seq
        heapq.heappush(self.queue, (when, self._seq, req))

    def submit(self, req: MigrationRequest, now: float) -> None:
        # urgent (recovery) requests skip the policy decision: the
        # workload they restart is gone, so there is no LM moment to wait
        # for — only the release boundary's concurrency control applies
        wait = 0.0 if req.urgent else self.decide(req, now)
        if wait < 0:
            req.decision = "cancelled"
            self.log.append(req)
            return
        req.decision = "scheduled"
        self._push(req, now + wait)

    def fail(self, req: MigrationRequest,
             outcome: strunk.MigrationOutcome, now: float) -> bool:
        """Re-admission boundary for a request whose in-flight lane was
        aborted: bill the wasted attempt, then either re-enter the heap
        with exponential backoff (endpoints revalidated through
        ``retarget``, so a retry never aims at a dead host) or fail the
        request permanently. Returns True iff a retry was scheduled.

        Deadline/max-wait semantics survive re-admission: ``created_at``
        is never touched, so a retry already past the provider's
        max-wait wall force-launches through ``_admit``; a retry that
        cannot meet the customer deadline even at the backed-off start
        is failed now rather than launched doomed."""
        req.attempt_bytes += outcome.bytes_sent
        req.outcome = outcome
        if req.retries >= self.retry_max or \
                (self.retarget is not None and not self.retarget(req)):
            req.decision = "failed"
            self.log.append(req)
            return False
        req.retries += 1
        wait = self.retry_backoff_s * (2.0 ** (req.retries - 1))
        if self.retry_jitter > 0.0:
            # crc32 is stable across processes (unlike hash()), so the
            # jittered schedule is reproducible per seed while distinct
            # jobs aborted by one event fan out over [wait, wait*(1+j))
            h = zlib.crc32(f"{self.retry_jitter_seed}:{req.job_id}:"
                           f"{req.retries}".encode())
            wait *= 1.0 + self.retry_jitter * (h / 2.0 ** 32)
        if req.deadline is not None:
            t_mig = strunk.strunk_bounds(req.v_bytes,
                                         self.effective_bandwidth(req))[0]
            if now + wait + t_mig >= req.deadline:
                req.decision = "failed"
                self.log.append(req)
                return False
        req.decision = "scheduled"
        self._push(req, now + wait)
        return True

    def cancel(self, req: MigrationRequest) -> None:
        """Withdraw a request (e.g. the consolidation plan was revised).
        Heap entries are left in place; ``due`` skips non-scheduled pops,
        and the entry generation protects a cancelled-then-resubmitted
        request from its own stale entry (firing early off the old entry,
        or being dropped when the old entry is consumed first)."""
        if req.decision in ("pending", "scheduled"):
            req.decision = "cancelled"
            self.log.append(req)

    def next_due_time(self) -> float:
        """Earliest heap fire time (``inf`` when the queue is idle) — the
        event-skipping simulator's release horizon. Stale entries (from
        cancel/resubmit) are included: they make the bound conservative
        (the skipped window only shrinks), never wrong, and a stale pop
        at the boundary is a cheap no-op."""
        return self.queue[0][0] if self.queue else float("inf")

    def due(self, now: float) -> List[MigrationRequest]:
        """Pop requests whose moment has come, honoring max_concurrent and
        the concurrency policy at the release boundary: the adaptive
        controller when wired, else the cumulative share-floor gate."""
        self.running = [r for r in self.running if r.decision == "running"]
        ready: List[MigrationRequest] = []
        while (self.queue and self.queue[0][0] <= now
               and len(self.running) + len(ready) < self.max_concurrent):
            _, gen, req = heapq.heappop(self.queue)
            if req.decision != "scheduled" or gen != req.heap_gen:
                continue            # cancelled or superseded: stale entry
            # endpoint revalidation at the release boundary: a host that
            # died while the request sat in the heap is routed around
            # BEFORE the controller prices candidate paths (dead hosts
            # never reach the defer-k sweep); no valid endpoints -> cancel
            if self.retarget is not None and not self.retarget(req):
                req.decision = "cancelled"
                self.log.append(req)
                continue
            # re-check suitability at fire time (cycle may have drifted);
            # urgent recovery requests have no workload left to re-time
            if self.policy != "immediate" and not req.urgent:
                wait = self.decide(req, now)
                if wait < 0:
                    req.decision = "cancelled"
                    self.log.append(req)
                    continue
                if wait > self.sample_period and now + wait <= \
                        req.created_at + self.max_wait:
                    self._push(req, now + wait)
                    continue
            ready.append(req)
        out, deferred = self._admit(ready, now)
        for req in deferred:
            self._push(req, self._defer_wake(req, now))
        for req in out:
            req.decision = "running"
        self.running.extend(out)
        return out

    def _defer_wake(self, req: MigrationRequest, now: float) -> float:
        """Fire time for a controller-deferred request. A receding-horizon
        controller prices a specific wake (the predicted cycle trough) and
        publishes it in ``deferred_until``; honoring it here keeps
        ``next_due_time`` exact, so an event-skipping simulator stops at
        the re-admission boundary instead of jumping it. Clamped to
        ``max_wait`` so a far trough can never push a request past its
        urgency wall (``_admit`` only defers requests that can still wait
        at least one sampling period)."""
        wake = now + self.sample_period
        ctl = self.controller
        if ctl is not None:
            w = getattr(ctl, "deferred_until", {}).pop(id(req), None)
            if w is not None:
                wake = max(wake, float(w))
        return min(wake, req.created_at + self.max_wait)

    def _admit(self, ready: List[MigrationRequest], now: float
               ) -> Tuple[List[MigrationRequest], List[MigrationRequest]]:
        """Split the tick's ready burst into (launch, defer). Requests
        that cannot wait another sampling period without breaching
        ``max_wait`` always launch; the rest go through the adaptive
        controller when wired, else the share-floor gate, else all
        launch."""
        if not ready:
            return [], []
        can_defer = [now + self.sample_period <= r.created_at + self.max_wait
                     for r in ready]
        if self.controller is not None:
            forced = [r for r, ok in zip(ready, can_defer) if not ok]
            free = [r for r, ok in zip(ready, can_defer) if ok]
            chosen = {id(r) for r in
                      self.controller.select(free, now, forced=forced)}
            launch = [r for r, ok in zip(ready, can_defer)
                      if not ok or id(r) in chosen]
            return launch, [r for r in free if id(r) not in chosen]
        if self.min_share_frac <= 0.0 or self.bandwidth_probe is None:
            return ready, []
        # static fallback: cumulative share-floor gate. Each candidate is
        # probed against everything in flight PLUS the actual paths of the
        # co-launches admitted earlier in this same burst, and defers when
        # its share would fall below min_share_frac x its uncontended path
        # capacity. An idle fabric always admits the head of the burst.
        launch, defer = [], []
        pending_paths: List[Tuple[str, ...]] = []
        blind = 0               # admitted co-launches with no tagged path:
        for req, ok in zip(ready, can_defer):   # fall back to clone-counting
            gated = ok and (self.running or launch)
            if gated and (self.effective_bandwidth(
                    req, extra=blind, pending=pending_paths)
                    < self.min_share_frac * self._floor_reference(req)):
                defer.append(req)
                continue
            launch.append(req)
            if req.path:
                pending_paths.append(tuple(req.path))
            else:
                blind += 1
        return launch, defer

    def finish(self, req: MigrationRequest,
               outcome: strunk.MigrationOutcome) -> None:
        req.decision = "done"
        req.outcome = outcome
        self.log.append(req)
