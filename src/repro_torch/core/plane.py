"""Migration execution plane — batched, contention-aware pre-copy execution.

The seed executed each migration as an isolated scalar ``simulate_precopy``
call at full link bandwidth: concurrency cost nothing, so the ALMA-vs-
immediate gap the paper measures (Tables 6-7) was understated at fleet
scale. This plane advances ALL in-flight migrations together against the
shared-link network model (``core/network.py``):

  * every in-flight migration is a *lane* running the exact Strunk pre-copy
    round recurrence of ``core/strunk.py`` (round i copies the bytes
    dirtied during round i-1; the three Xen stop conditions; a final
    stop-and-copy transfer whose duration is the downtime);
  * a lane's bandwidth is its max-min fair share of the links on its
    src->dst path, recomputed at every event boundary — another migration
    starting, finishing, or completing a round changes everyone's share;
  * dirty bytes accrue per event chunk (rate sampled mid-chunk), which
    degenerates to the reference's mid-round sampling when a round runs
    uninterrupted — an uncontended single lane is bit-equal to
    ``strunk.simulate_precopy_reference`` (asserted in tests).

``advance(until)`` is the event loop: compute fair shares, find the
earliest round completion, move every lane forward by that chunk, settle
completed rounds, repeat.

Two executions of each event chunk:

  * **vectorized** (default) — lanes register their dirty-rate spec with a
    ``rates.RateBank`` (``PiecewiseRate`` tables, constants, or plain
    callables; see ``core/rates.py`` for the lane-registration API), so
    dirty-byte accrual is ONE padded table lookup per chunk; link shares
    come from ``network.fair_share_dense`` over a cached link x lane
    incidence matrix; per-link byte counters are one matrix-vector
    product. No O(lanes) Python inside the event loop.
  * **scalar reference** (``vectorized=False``) — the original per-lane
    loop, kept as the executable specification. Uncontended lanes are
    bit-equal between the two (and to ``simulate_precopy_reference``);
    contended multi-link cases agree to float summation order.

``FleetSim`` drives the plane one sampling period at a time (through the
sharded fabric, ``core/fabric.py``); benchmarks drive it to drain.
Per-link byte counters support the conservation invariant (bytes through a
link <= capacity x elapsed time) and the link-utilization columns of the
table6/7 benchmarks. ``_absorb`` merges another plane's lanes in — the
fabric uses it when a new lane's path bridges two previously independent
migration domains.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import network, strunk
from repro_torch.core.guard import MigrationGuard, expectation_of, throttled_spec
from repro_torch.core.rates import RateBank, RateSpec, as_rate_table

_COPY, _STOP = 0, 1


@dataclass
class _LaneMeta:
    req: object                          # orchestrator.MigrationRequest
    spec: RateSpec                       # raw rate spec (table/const/callable)
    rate_fn: Optional[object]            # scalar callable view of ``spec``
    path: Tuple[str, ...]
    t_start: float
    path_ids: Optional[np.ndarray] = None  # Topology.ids_of(path) fast view
    spec0: RateSpec = None               # pre-throttle spec (None: unthrottled)


@dataclass
class LaneState:
    """Mid-round snapshot of one in-flight lane — one row of the
    receding-horizon sweep's in-flight repricing input. ``sent`` counts
    the bytes already charged to the lane's links (completed transfers
    plus the progressed part of the current one, the same accounting the
    abort path uses); the remaining fields map 1:1 onto
    ``strunk.ResumeState`` so a what-if batch can resume the lane under
    hypothetical fair shares."""
    job_id: str
    path: Tuple[str, ...]
    spec: RateSpec
    v: float
    rem: float
    acc: float
    sent: float
    rounds: int
    stopped: bool
    reason: int


class MigrationPlane:
    """Event-driven executor for concurrent pre-copy migrations."""

    # SoA lane arrays, resized together on every launch/drop/merge
    _SOA_FIELDS = ("_v", "_rem", "_round", "_acc", "_sent", "_rounds",
                   "_down", "_phase", "_reason", "_exp_b", "_exp_t",
                   "_t0", "_thr", "_thr_round")

    def __init__(self, topology: network.Topology, *,
                 page: int = strunk.PAGE,
                 max_rounds: int = strunk.XEN_MAX_ROUNDS,
                 stop_dirty_pages: int = strunk.XEN_STOP_DIRTY_PAGES,
                 stop_total_factor: float = strunk.XEN_STOP_TOTAL_FACTOR,
                 vectorized: bool = True,
                 guard: Optional[MigrationGuard] = None):
        self.topology = topology
        self._guard = guard
        self.caps = topology.capacities
        # id-indexed snapshot of ``caps`` (aligned with topology.link_ids):
        # the integer fast path of probe_bandwidth/path_capacity reads
        # this; set_link_capacity keeps it in sync with the dict
        self._caps_all = topology.caps_vector().copy()
        self.max_rounds = max_rounds
        self.stop_total_factor = stop_total_factor
        self.vectorized = vectorized
        self._thresh = float(stop_dirty_pages) * page
        self._fallback_bw = max(self.caps.values(), default=np.inf)
        self.now = 0.0
        self._meta: List[_LaneMeta] = []
        # completions produced by launch()'s internal catch-up advance are
        # parked here and handed to the caller on the next advance()
        self._backlog: List[Tuple[object, strunk.MigrationOutcome]] = []
        # SoA lane state, one row per in-flight migration
        self._v = np.zeros(0)            # migratable bytes
        self._rem = np.zeros(0)          # bytes left in the current transfer
        self._round = np.zeros(0)        # size of the current transfer
        self._acc = np.zeros(0)          # dirty bytes accrued this round
        self._sent = np.zeros(0)
        self._rounds = np.zeros(0, np.int64)
        self._down = np.zeros(0)
        self._phase = np.zeros(0, np.int8)
        self._reason = np.zeros(0, np.int8)
        # prediction-guard rows (core/guard.py): admission-time expectation
        # (NaN = unguarded lane), launch clock, throttle-ladder step, and
        # the round count at the last escalation (one step per round)
        self._exp_b = np.zeros(0)
        self._exp_t = np.zeros(0)
        self._t0 = np.zeros(0)
        self._thr = np.zeros(0, np.int64)
        self._thr_round = np.zeros(0, np.int64)
        # vectorized-chunk banks: extended in place on launch/merge,
        # rebuilt lazily only after lane drops. Membership fair shares
        # and scratch sizing are deferred separately (_shares_stale): a
        # release burst extends the banks B times but solves ONCE, at
        # the next advance.
        self._banks_stale = True
        self._shares_stale = False
        self._rates: Optional[RateBank] = None
        self._link_order: List[str] = []
        self._link_row: Dict[str, int] = {}
        self._inc = np.zeros((0, 0))         # (L, M) float incidence
        self._caps_vec = np.zeros(0)
        self._link_vec = np.zeros(0)         # per-chunk byte accumulator
        self._job_ids: List[str] = []
        # persistent accounting
        self._link_bytes: Dict[str, float] = {}
        self._share_jobs: List[str] = []
        self._share_vec = np.zeros(0)
        self._link_set_cache: Optional[frozenset] = frozenset()

    # -- introspection -------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._meta)

    def jobs_in_flight(self) -> List[str]:
        return [m.req.job_id for m in self._meta]

    def paths_in_flight(self) -> List[Tuple[str, ...]]:
        """Network path of every in-flight lane (the fabric's probe input)."""
        return [m.path for m in self._meta]

    def ids_in_flight(self) -> List[Optional[np.ndarray]]:
        """Precomputed link-id array per in-flight lane (None where a
        lane's path has links unknown to the topology — the probe fast
        path falls back to the dict walk)."""
        return [m.path_ids for m in self._meta]

    @property
    def link_set(self) -> frozenset:
        """Links any in-flight lane touches — the plane's migration domain.
        Cached (the fabric reads it per launch/probe across every domain);
        launches extend it incrementally, drops invalidate it."""
        if self._link_set_cache is None:
            self._link_set_cache = frozenset(
                l for m in self._meta for l in m.path)
        return self._link_set_cache

    @property
    def link_bytes(self) -> Dict[str, float]:
        """Bytes moved per link so far (completed + in-flight chunks)."""
        self._fold_link_vec()
        return dict(self._link_bytes)

    @property
    def last_shares(self) -> Dict[str, float]:
        """Fair-share bandwidth per job at the most recent event boundary."""
        return {j: float(s) for j, s in zip(self._share_jobs,
                                            self._share_vec)}

    def probe_bandwidth(self, src: str, dst: str, extra: int = 0,
                        pending: Sequence[Sequence[str]] = ()) -> float:
        """Fair-share bandwidth a NEW src->dst migration would receive right
        now, given everything already in flight — the realized-bandwidth
        signal the LMCM feeds into its deadline/cost decisions. ``pending``
        carries the ACTUAL paths of co-launches committed in the same
        release burst but not yet on the plane; ``extra`` approximates
        further committed launches as same-path clones (the legacy,
        conservative-on-multilink form).

        Hot path: when every path resolves through the topology's
        precomputed link-id tables, the solve runs over integer arrays
        (``network.fair_share_ids`` — bit-parity mirror of the dict walk);
        any unknown link falls back to the dict oracle wholesale."""
        topo = self.topology
        path = topo.path(src, dst)
        ids = topo.ids_of(path)
        if ids is not None and \
                all(m.path_ids is not None for m in self._meta):
            pend_ids = [topo.ids_of(tuple(p)) for p in pending]
            if all(p is not None for p in pend_ids):
                id_paths = [m.path_ids for m in self._meta]
                id_paths += pend_ids + [ids] * (extra + 1)
                share = float(network.fair_share_ids(
                    id_paths, self._caps_all)[-1])
                return share if np.isfinite(share) else self._fallback_bw
        paths = [m.path for m in self._meta]
        paths += [tuple(p) for p in pending]
        paths += [path] * (extra + 1)
        share = float(network.fair_share(paths, self.caps)[-1])
        return share if np.isfinite(share) else self._fallback_bw

    def what_if_shares(self, new_paths: Sequence[Sequence[str]]
                       ) -> np.ndarray:
        """Max-min fair shares the hypothetical lanes ``new_paths`` would
        realize if all launched right now alongside everything in flight —
        the adaptive concurrency controller's candidate-batch input.
        Returns one share per new path (unlinked lanes get the fallback
        bandwidth)."""
        pend = [tuple(p) for p in new_paths]
        if not pend:
            return np.zeros(0)
        paths = [m.path for m in self._meta] + pend
        shares = network.fair_share(paths, self.caps)[len(self._meta):]
        return np.where(np.isfinite(shares), shares, self._fallback_bw)

    def what_if_shares_sweep(self, fixed_paths: Sequence[Sequence[str]],
                             cand_paths: Sequence[Sequence[str]]
                             ) -> np.ndarray:
        """All n+1 nested what-if batches of the defer-k sweep in ONE
        stacked solve: row k holds the fair shares of the F ``fixed_paths``
        lanes plus the first k ``cand_paths`` lanes, all launched right now
        alongside everything in flight (columns past F+k are inactive and
        read 0). Equivalent to n+1 ``what_if_shares`` calls over growing
        prefixes; see ``network.fair_share_masked``."""
        return network.what_if_prefix_shares(
            [m.path for m in self._meta], fixed_paths, cand_paths,
            self.caps, self._fallback_bw)

    def what_if_pair_shares(self, fixed_paths: Sequence[Sequence[str]],
                            pair_paths: Sequence[Sequence[str]]
                            ) -> np.ndarray:
        """Fair share each (candidate, route) pair would realize ON ITS OWN
        against everything in flight plus the ``fixed_paths`` lanes — the
        route-selection stage of the defer-k x route sweep, all pairs in
        one stacked solve (see ``network.what_if_pair_shares``)."""
        return network.what_if_pair_shares(
            [m.path for m in self._meta], fixed_paths, pair_paths,
            self.caps, self._fallback_bw)

    def what_if_subset_shares(self, fixed_paths: Sequence[Sequence[str]],
                              cand_paths: Sequence[Sequence[str]],
                              masks) -> np.ndarray:
        """Fair shares of K arbitrary candidate subsets in one stacked
        solve, KEEPING the in-flight base columns: row k holds the shares
        of every in-flight lane, every ``fixed_paths`` lane, and the
        ``cand_paths`` lanes selected by ``masks[k]``. The receding-
        horizon generalization of ``what_if_shares_sweep`` — base columns
        let the sweep reprice mid-flight lanes per scenario (see
        ``lane_state``), and arbitrary masks price non-prefix subsets."""
        return network.what_if_subset_shares(
            [m.path for m in self._meta], fixed_paths, cand_paths, masks,
            self.caps, self._fallback_bw)

    def lane_state(self, links=None) -> List[LaneState]:
        """Per-lane mid-round snapshots in ``paths_in_flight`` order (the
        base-column order of the what-if solves). ``links`` is accepted
        for interface parity with ``fabric.ShardedPlane`` — a monolithic
        plane is one domain, so every lane is returned regardless."""
        out: List[LaneState] = []
        for i, m in enumerate(self._meta):
            out.append(LaneState(
                job_id=m.req.job_id, path=m.path, spec=m.spec,
                v=float(self._v[i]), rem=float(self._rem[i]),
                acc=float(self._acc[i]),
                sent=max(0.0, float(self._sent[i]
                                    + (self._round[i] - self._rem[i]))),
                rounds=int(self._rounds[i]),
                stopped=bool(self._phase[i] == _STOP),
                reason=int(self._reason[i])))
        return out

    def path_capacity(self, src: str, dst: str) -> float:
        """Uncontended capacity of the src->dst path: the tightest link a
        lone migration would traverse (the launch gate's floor reference —
        a cross-rack transfer can never exceed its ToR/core bottleneck, so
        gating it against the nominal access speed would starve it)."""
        path = self.topology.path(src, dst)
        if not path:
            return self._fallback_bw
        ids = self.topology.ids_of(path)
        if ids is not None:
            return float(self._caps_all[ids].min())
        return min(self.caps[l] for l in path)

    def link_live_counts(self) -> Dict[str, int]:
        """In-flight lane count per link (route de-confliction input for
        ``pick_route`` and the controller's greedy route assignment)."""
        counts: Dict[str, int] = {}
        for m in self._meta:
            for l in dict.fromkeys(m.path):
                counts[l] = counts.get(l, 0) + 1
        return counts

    def pick_route(self, src: str, dst: str,
                   pending: Sequence[Sequence[str]] = ()
                   ) -> Tuple[str, ...]:
        """The candidate route a src->dst launch should ride right now:
        best probed fair share against everything in flight (plus
        ``pending`` same-burst co-launches), ties broken toward fewer live
        lanes on the route's links, then the lowest route index — i.e. the
        fixed-shortest path. Single-route (flat) pairs return ``path()``
        unchanged. This is the launch-time greedy the benchmarks' "route-
        aware" mode uses when no admission controller is wired in; the
        controller's stacked sweep prices routes through
        ``what_if_pair_shares`` instead."""
        routes = self.topology.routes(src, dst)
        if len(routes) == 1:
            return routes[0]
        shares = self.what_if_pair_shares(
            [tuple(p) for p in pending], list(routes))
        live = self.link_live_counts()
        best, best_key = 0, None
        for j, r in enumerate(routes):
            load = sum(live.get(l, 0) for l in r)
            key = (float(shares[j]), -load, -j)
            if best_key is None or key > best_key:
                best, best_key = j, key
        return routes[best]

    def domain_links(self) -> List[frozenset]:
        """Link sets of the live migration domains — a monolithic plane is
        one domain (interface parity with ``fabric.ShardedPlane``)."""
        return [self.link_set] if self._meta else []

    # -- fault injection -----------------------------------------------------
    def set_link_capacity(self, link: str, capacity: float) -> None:
        """Apply a capacity change (degradation, failure at 0.0, or
        restoration) to this plane's view of ``link``. The link keeps its
        identity — paths, incidence, and domain membership are unchanged —
        and the next event chunk's fair-share solve sees the new value
        (a 0-capacity link freezes its flows at share 0; every solver
        stays finite, the lanes simply stall until restored)."""
        capacity = float(capacity)
        self.caps[link] = capacity
        self._fallback_bw = max(self.caps.values(), default=np.inf)
        idx = self.topology.link_ids.get(link)
        if idx is not None:
            self._caps_all[idx] = capacity
        row = self._link_row.get(link)
        if row is not None and row < len(self._caps_vec):
            self._caps_vec[row] = capacity
            self._shares_stale = True    # banks stay valid; re-solve only

    def abort(self, job_id: str
              ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Settle ``job_id``'s in-flight lane early. Returns ``[]`` when
        the job is not in flight, else one ``(request, outcome)`` pair
        whose ``stop_reason`` is ``strunk.STOP_ABORTED``. ``bytes_sent``
        counts exactly the bytes already charged to the lane's links —
        completed transfers plus the partial current one — so per-link
        byte conservation holds across abort -> retry."""
        return self._abort_rows(
            [i for i, m in enumerate(self._meta)
             if m.req.job_id == job_id])

    def fail_host(self, host: str
                  ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Abort every in-flight lane with ``host`` as an endpoint (a
        dead source kills the copy at its origin; a dead destination
        loses the state already received)."""
        return self._abort_rows(
            [i for i, m in enumerate(self._meta)
             if m.req.src == host or m.req.dst == host])

    def abort_link(self, link: str
                   ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Abort every in-flight lane whose path crosses ``link`` — a
        hard ToR/pod-uplink outage kills the transfers riding it while
        lanes on other routes are untouched (unlike a degradation to 0.0,
        which stalls flows in place until restored). The capacity change
        itself is the caller's move (``set_link_capacity(link, 0.0)``)."""
        return self._abort_rows(
            [i for i, m in enumerate(self._meta) if link in m.path])

    def _abort_rows(self, rows: List[int],
                    stop_reason: str = strunk.STOP_ABORTED
                    ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Drop the lanes at ``rows`` through the same keep-index path a
        completion uses (banks rebuild lazily; the link-set cache and
        drained union-find incarnations are the fabric's to release).
        ``stop_reason`` distinguishes fault aborts (``STOP_ABORTED``) from
        convergence-guard aborts (``STOP_GUARD``)."""
        if not rows:
            return []
        aborted: List[Tuple[object, strunk.MigrationOutcome]] = []
        for i in rows:
            m = self._meta[i]
            # bytes already charged to the links: completed transfers
            # (_sent) plus the progressed part of the current one
            partial = float(self._sent[i] + (self._round[i] - self._rem[i]))
            aborted.append((m.req, strunk.MigrationOutcome(
                total_time=self.now - m.t_start,
                downtime=float(self._down[i]),
                bytes_sent=max(0.0, partial),
                rounds=int(self._rounds[i]),
                stop_reason=stop_reason)))
        dead = set(rows)
        keep = [i for i in range(len(self._meta)) if i not in dead]
        self._meta = [self._meta[i] for i in keep]
        for name in self._SOA_FIELDS:
            setattr(self, name, getattr(self, name)[keep])
        self._banks_stale = True
        self._link_set_cache = None
        return aborted

    # -- lifecycle -----------------------------------------------------------
    def launch(self, req, rate: RateSpec, now: float, *,
               path: Optional[Sequence[str]] = None,
               expect: Optional[Tuple[float, float]] = None) -> None:
        """Start executing ``req`` at time ``now`` (>= plane time).

        ``rate`` is the lane's dirty-rate spec — a ``rates.PiecewiseRate``
        table (preferred: the vectorized event loop accrues its dirty bytes
        through one batched lookup), a constant, an object exposing
        ``rate_table``, a plain callable of absolute time (compatibility:
        sampled per lane per event), or None.

        ``expect`` is the lane's admission-time prediction,
        ``(expected_bytes, expected_time)`` as priced by the controller's
        cost batch; defaults to the ``expected_bytes``/``expected_time``
        attributes stamped on ``req`` (NaN when absent). When the plane
        carries a ``MigrationGuard``, lanes whose realized progress
        diverges from this expectation are throttled then aborted (see
        ``core/guard.py``); without an expectation a lane is exempt.
        """
        if now > self.now:
            self._backlog.extend(self.advance(now))
        if rate is None or callable(rate):
            rate_fn = rate               # PiecewiseRate is itself callable
        else:
            # constants and objects exposing ``rate_table`` normalize to a
            # table, which doubles as the scalar-path callable
            rate = rate_fn = as_rate_table(rate)
        p = tuple(path) if path is not None else \
            self.topology.path(req.src, req.dst)
        v = float(req.v_bytes)
        meta = _LaneMeta(req, rate, rate_fn, p, now,
                         path_ids=self.topology.ids_of(p))
        self._meta.append(meta)
        self._v = np.append(self._v, v)
        self._rem = np.append(self._rem, v)
        self._round = np.append(self._round, v)
        self._acc = np.append(self._acc, 0.0)
        self._sent = np.append(self._sent, 0.0)
        self._rounds = np.append(self._rounds, 0)
        self._down = np.append(self._down, 0.0)
        self._phase = np.append(self._phase, _COPY)
        self._reason = np.append(self._reason, strunk.REASON_MAX_ROUNDS)
        exp_b, exp_t = expect if expect is not None else expectation_of(req)
        self._exp_b = np.append(self._exp_b, float(exp_b))
        self._exp_t = np.append(self._exp_t, float(exp_t))
        self._t0 = np.append(self._t0, now)
        self._thr = np.append(self._thr, 0)
        self._thr_round = np.append(self._thr_round, -1)
        if self._banks_fresh:
            self._extend_banks(meta)     # O(1) Python, no membership rescan
        else:
            self._banks_stale = True
        if self._link_set_cache is not None:
            self._link_set_cache = self._link_set_cache | frozenset(p)

    def _fold_link_vec(self) -> None:
        """Flush the vectorized per-chunk link accumulator into the
        persistent per-link byte dict."""
        if self._link_vec.any():
            for l, b in zip(self._link_order, self._link_vec):
                self._link_bytes[l] = self._link_bytes.get(l, 0.0) + float(b)
            self._link_vec[:] = 0.0

    def _rebuild_banks(self) -> None:
        """Re-derive the rate bank, link incidence, caps vector, and the
        event-chunk scratch buffers from the current lane membership
        (lazily, after lane drops — launches and domain merges extend the
        banks in place instead, see ``_extend_banks``/``_merge_banks``)."""
        self._fold_link_vec()
        self._rates = RateBank([m.spec for m in self._meta])
        self._inc, self._caps_vec, self._link_order, self._link_row = \
            network.build_incidence([m.path for m in self._meta],
                                    self.caps)
        self._link_vec = np.zeros(len(self._link_order))
        self._job_ids = [m.req.job_id for m in self._meta]
        self._refresh_shares()
        self._alloc_scratch()
        self._banks_stale = False
        self._shares_stale = False

    def _refresh_shares(self) -> None:
        # fair shares are a function of lane MEMBERSHIP only (paths + link
        # capacities — not of per-round state), so one solve per
        # rebuild/extend/merge covers every chunk until the next
        # launch/drop/merge
        shares = network.DenseFairShare(self._inc, self._caps_vec)()
        np.copyto(shares, self._fallback_bw, where=~np.isfinite(shares))
        self._share_cache = shares

    def _alloc_scratch(self) -> None:
        # per-chunk scratch: the event loop below is all in-place ufuncs
        n = len(self._meta)
        self._b_tdone = np.empty(n)
        self._b_mask = np.empty(n, bool)
        self._b_complete = np.empty(n, bool)
        self._b_copy = np.empty(n, bool)
        self._b_f1 = np.empty(n)
        self._b_f2 = np.empty(n)
        self._b_moved = np.empty(n)
        self._b_ltmp = np.empty(len(self._link_order))

    @property
    def _banks_fresh(self) -> bool:
        return self.vectorized and not self._banks_stale \
            and self._rates is not None

    def _extend_banks(self, meta: _LaneMeta) -> None:
        """Append one freshly launched lane to the live banks in place —
        the launch-time alternative to a full ``_rebuild_banks`` (no
        per-lane Python over the existing membership). Produces exactly
        the state a rebuild would: new links keep first-appearance order
        (the new lane is last), table rows gather/concatenate into the
        identical padded layout, and the membership fair-share solve runs
        over the extended incidence."""
        self._rates = RateBank.concat(self._rates, RateBank([meta.spec]))
        new_links = [l for l in dict.fromkeys(meta.path)
                     if l not in self._link_row]
        for l in new_links:
            self._link_row[l] = len(self._link_order)
            self._link_order.append(l)
        n_links, n = len(self._link_order), len(self._meta)
        inc = np.zeros((n_links, n))
        inc[:self._inc.shape[0], :self._inc.shape[1]] = self._inc
        for l in dict.fromkeys(meta.path):
            inc[self._link_row[l], n - 1] = 1.0
        self._inc = inc
        if new_links:
            self._caps_vec = np.concatenate(
                [self._caps_vec, [self.caps[l] for l in new_links]])
            self._link_vec = np.concatenate(
                [self._link_vec, np.zeros(len(new_links))])
        self._job_ids.append(meta.req.job_id)
        self._shares_stale = True        # ONE solve at the next advance

    def _merge_banks(self, other: "MigrationPlane") -> None:
        """Stitch ``other``'s live banks onto this plane's — the
        domain-merge alternative to a full rebuild. The two domains are
        disjoint by construction (they merge because a NEW lane bridges
        them), so the merged incidence is block-diagonal and the link
        order is this plane's followed by the other's — exactly what a
        rebuild over the concatenated lane list derives."""
        self._rates = RateBank.concat(self._rates, other._rates)
        off = len(self._link_order)
        for l in other._link_order:
            self._link_row[l] = off + other._link_row[l]
        self._link_order = self._link_order + other._link_order
        l1, m1 = self._inc.shape
        l2, m2 = other._inc.shape
        inc = np.zeros((l1 + l2, m1 + m2))
        inc[:l1, :m1] = self._inc
        inc[l1:, m1:] = other._inc
        self._inc = inc
        self._caps_vec = np.concatenate([self._caps_vec, other._caps_vec])
        self._link_vec = np.zeros(l1 + l2)   # both folded by the caller
        self._job_ids = self._job_ids + other._job_ids
        self._shares_stale = True        # ONE solve at the next advance

    def advance(self, until: float):
        """Run the event loop to ``until`` (or until drained); returns the
        list of (request, MigrationOutcome) completed in this window, plus
        any completions a launch-time catch-up produced earlier."""
        finished: List[Tuple[object, strunk.MigrationOutcome]] = \
            self._backlog
        self._backlog = []
        if not self._meta:
            # a mass abort can empty the plane between advances: the
            # clean no-op is a clock fast-forward plus backlog handoff —
            # no bank rebuild or fair-share solve over zero lanes
            if self.now < until and np.isfinite(until):
                self.now = until
            self._fold_link_vec()
            return finished
        while self._meta and self.now < until:
            if self.vectorized:
                if self._banks_stale:
                    self._rebuild_banks()
                elif self._shares_stale:
                    self._refresh_shares()
                    self._alloc_scratch()
                    self._shares_stale = False
                # membership-cached fair shares + time-to-completion
                mask, t_done = self._b_mask, self._b_tdone
                shares = self._share_cache
                t_done.fill(np.inf)
                np.greater(shares, 0.0, out=mask)
                np.divide(self._rem, shares, out=t_done, where=mask)
                np.less_equal(self._rem, 0.0, out=mask)
                np.copyto(t_done, 0.0, where=mask)
            else:
                shares = network.fair_share([m.path for m in self._meta],
                                            self.caps)
                shares = np.where(np.isfinite(shares), shares,
                                  self._fallback_bw)
                t_done = np.where(
                    self._rem <= 0.0, 0.0,
                    np.divide(self._rem, shares,
                              out=np.full_like(self._rem, np.inf),
                              where=shares > 0))
            window = until - self.now
            t_min = float(t_done.min())
            # a chunk truncated by the window must land the clock on
            # ``until`` EXACTLY (now + (until - now) != until in floats):
            # the fabric merges domains only at equal event times
            truncated = not (t_min < window)
            dt = window if truncated else t_min
            mid = self.now + 0.5 * dt
            if self.vectorized:
                complete, copying = self._b_complete, self._b_copy
                np.less_equal(t_done, dt * (1 + 1e-12), out=complete)
                np.equal(self._phase, _COPY, out=copying)
                f1, f2, moved = self._b_f1, self._b_f2, self._b_moved
                # dirty accrual: max(0, r)*dt, exactly zeroed off-copy lanes
                r = self._rates.sample(mid, copying)
                np.maximum(r, 0.0, out=f1)
                np.multiply(f1, dt, out=f1)
                np.multiply(f1, copying, out=f1)
                np.add(self._acc, f1, out=self._acc)
                # per-link byte counters: one matvec over the incidence
                np.multiply(shares, dt, out=moved)
                np.copyto(moved, self._rem, where=complete)
                np.matmul(self._inc, moved, out=self._b_ltmp)
                np.add(self._link_vec, self._b_ltmp, out=self._link_vec)
                # downtime accrues on stop-and-copy lanes (= not copying)
                np.subtract(1.0, copying, out=f2)
                np.multiply(f2, dt, out=f2)
                np.add(self._down, f2, out=self._down)
                np.multiply(shares, dt, out=f1)
                np.subtract(self._rem, f1, out=self._rem)
                np.copyto(self._rem, 0.0, where=complete)
                self._share_jobs = self._job_ids
            else:
                complete = t_done <= dt * (1 + 1e-12)
                for i, meta in enumerate(self._meta):
                    if self._phase[i] == _COPY and meta.rate_fn is not None:
                        self._acc[i] += \
                            max(0.0, float(meta.rate_fn(mid))) * dt
                    moved = float(self._rem[i]) if complete[i] \
                        else float(shares[i]) * dt
                    for l in meta.path:
                        self._link_bytes[l] = \
                            self._link_bytes.get(l, 0.0) + moved
                self._down = self._down + np.where(self._phase == _STOP,
                                                   dt, 0.0)
                self._rem = np.where(complete, 0.0,
                                     self._rem - shares * dt)
                self._share_jobs = [m.req.job_id for m in self._meta]
            # the clock may only land PAST ``until`` through float rounding
            # (now + dt can round up even when dt < until - now): clamp, so
            # domain merges always meet at the advance target
            nxt = self.now + dt
            self.now = until if (truncated or nxt > until) else nxt
            self._share_vec = shares
            drop: List[int] = []
            for i in np.flatnonzero(complete):
                out = self._settle(int(i))
                if out is not None:
                    finished.append((self._meta[i].req, out))
                    drop.append(int(i))
            if drop:
                keep = [i for i in range(len(self._meta)) if i not in drop]
                self._meta = [self._meta[i] for i in keep]
                for name in self._SOA_FIELDS:
                    setattr(self, name, getattr(self, name)[keep])
                self._banks_stale = True
                self._link_set_cache = None
            # convergence watchdog: every settle is a round boundary for
            # some lane — re-check the whole fleet's realized-vs-predicted
            # divergence (one vectorized pass; guard aborts flow out
            # through ``finished`` like any completion, so the fabric's
            # link-release path needs no special casing)
            if self._guard is not None and self._meta and complete.any():
                finished.extend(self._guard_check())
        # window boundary check: catches time divergence on lanes that
        # never settle inside this advance (e.g. stalled at share 0)
        if self._guard is not None and self._meta:
            finished.extend(self._guard_check())
        # an infinite drain must not poison the clock: time only ever
        # fast-forwards to a finite target
        if not self._meta and self.now < until and np.isfinite(until):
            self.now = until
        self._fold_link_vec()
        return finished

    # -- prediction guard ----------------------------------------------------
    def _guard_check(self) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """One vectorized watchdog pass over every in-flight lane: compare
        realized progress (the abort path's exact byte accounting) against
        the admission-time expectation and fire the policy ladder —
        auto-converge throttling at ``throttle_ratio``, abort-and-retry
        with ``stop_reason == strunk.STOP_GUARD`` at ``abort_ratio``.
        Lanes already in stop-and-copy are left to finish (aborting a
        migration during its final downtime burst only wastes it)."""
        g = self._guard
        sent = np.maximum(0.0, self._sent + (self._round - self._rem))
        div = g.divergence(sent, self.now - self._t0,
                           self._exp_b, self._exp_t)
        copying = self._phase == _COPY
        abort = copying & (div >= g.abort_ratio)
        throttle = copying & ~abort & (div >= g.throttle_ratio)
        # escalate the ladder at most once per pre-copy round: a diverged
        # lane mid-round keeps its current cap until the next settle
        throttle &= self._rounds > self._thr_round
        for i in np.flatnonzero(throttle):
            self._throttle_row(int(i))
        if not abort.any():
            return []
        rows = [int(i) for i in np.flatnonzero(abort)]
        g.n_aborts += len(rows)
        return self._abort_rows(rows, stop_reason=strunk.STOP_GUARD)

    def _throttle_row(self, i: int) -> None:
        """Apply the next auto-converge step to lane ``i``: swap its spec
        for a progressively scaled table (``guard.throttled_spec`` — the
        composable transform every repricing consumer shares) and flag the
        banks for a lazy rebuild. Past the throttle floor the ladder stops
        escalating and only the abort rung remains."""
        g = self._guard
        self._thr_round[i] = int(self._rounds[i])
        f = g.factor_for(int(self._thr[i]) + 1)
        if f is None:
            return
        m = self._meta[i]
        if m.spec0 is None:
            m.spec0 = m.spec
        spec = throttled_spec(m.spec0, f)
        m.spec = spec
        m.rate_fn = spec if (spec is None or callable(spec)) \
            else as_rate_table(spec)
        self._thr[i] += 1
        g.n_throttles += 1
        self._banks_stale = True

    def _settle(self, i: int) -> Optional[strunk.MigrationOutcome]:
        """A lane's current transfer just completed: close the round (apply
        the Xen stop conditions in the reference's priority order) or, if it
        was the stop-and-copy, produce the outcome."""
        if self._phase[i] == _COPY:
            self._sent[i] += self._round[i]
            self._rounds[i] += 1
            dirtied = min(float(self._v[i]), float(self._acc[i]))
            stop: Optional[int] = None
            if dirtied <= self._thresh:
                stop = strunk.REASON_DIRTY_LOW
            elif self._rounds[i] >= self.max_rounds:
                stop = strunk.REASON_MAX_ROUNDS
            elif self._sent[i] + dirtied > self.stop_total_factor * self._v[i]:
                stop = strunk.REASON_TOTAL_CAP
            self._round[i] = dirtied
            self._rem[i] = dirtied
            self._acc[i] = 0.0
            if stop is not None:
                self._phase[i] = _STOP
                self._reason[i] = stop
            return None
        self._sent[i] += self._round[i]
        meta = self._meta[i]
        return strunk.MigrationOutcome(
            total_time=self.now - meta.t_start,
            downtime=float(self._down[i]),
            bytes_sent=float(self._sent[i]),
            rounds=int(self._rounds[i]),
            stop_reason=strunk.STOP_REASONS[int(self._reason[i])])

    # relative event-clock tolerance for domain merges: the fabric advances
    # both planes to a common target before bridging, and truncated chunks
    # land on ``until`` exactly — but the vectorized path's in-place ufunc
    # summation can leave a freshly drained/launched domain within a few
    # ULPs of the target (float addition order), so merges accept clocks
    # equal to within this relative epsilon and snap to the host plane's.
    ABSORB_EPS = 1e-9

    def _absorb(self, other: "MigrationPlane") -> None:
        """Merge ``other``'s in-flight lanes into this plane — both planes
        must sit at the same event time (the fabric advances them to a
        common ``now`` before bridging two migration domains), equal to
        within ``ABSORB_EPS`` relative (see above)."""
        tol = self.ABSORB_EPS * max(1.0, abs(self.now), abs(other.now))
        if not (abs(other.now - self.now) <= tol):   # NaN-safe: also rejects
            raise ValueError(f"cannot absorb plane at t={other.now} "
                             f"into plane at t={self.now}")
        other.now = self.now                         # snap within tolerance
        other._fold_link_vec()
        self._fold_link_vec()
        # disjoint domains (the normal fabric merge) stitch their live
        # banks instead of flagging a rebuild; overlapping-link planes
        # (possible when called directly) fall back to the lazy rebuild
        incremental = (self._banks_fresh and other._banks_fresh
                       and not any(l in self._link_row
                                   for l in other._link_order))
        self._meta.extend(other._meta)
        for name in self._SOA_FIELDS:
            setattr(self, name, np.concatenate(
                [getattr(self, name), getattr(other, name)]))
        for l, b in other._link_bytes.items():
            self._link_bytes[l] = self._link_bytes.get(l, 0.0) + b
        self._backlog.extend(other._backlog)
        other._meta, other._backlog = [], []
        if incremental:
            self._merge_banks(other)
        else:
            self._banks_stale = True
        self._link_set_cache = None
        other._link_set_cache = None
