"""Adaptive concurrency controller — closing the loop from probe to policy.

The paper's LMCM decides *when* each migration fires (Algorithm 2 picks the
next LM moment; ``orchestrator.decide`` is that decision point), but it
treats *how many* may fire together as a static provider knob
(``max_concurrent``, later refined by the ``min_share_frac`` share-floor
gate). PR 2/3 measured why that is the wrong shape: at >= 16 concurrent
lanes the shared link — not the moment — becomes the bound, and a fixed
floor can neither exploit an idle fabric nor recognize that two lanes with
near-zero dirty rates share a link for free.

This controller governs the SAME decision boundary as Algorithm 2 —
``LMCM.due``, the moment a scheduled request is released — but along the
orthogonal axis the paper leaves static: at each boundary it sweeps the
candidate in-flight counts (*defer-k* over the ready queue, per migration
domain) and launches the batch that minimizes **predicted total contended
bytes**, tie-broken by predicted summed migration time, then by launching
more. Where Algorithm 2 asks "is this a suitable LM moment for job j?",
the controller asks "how many of the ready lanes should this moment
carry?" — the concurrency/bandwidth co-scheduling that He & Buyya's
taxonomy (2112.02593) and Wang et al.'s SDN planning (1412.4980) identify
as the biggest traffic lever an orchestrator leaves unused.

Inputs (all shipped by PR 3's fabric):

  * ``plane.domain_links()`` / ``plane.what_if_shares(paths)`` — per-domain
    membership and the max-min fair shares a hypothetical launch batch
    would realize against exactly the domains it intersects;
  * ``strunk.what_if_cost_batch`` — the batched pre-copy cost of a whole
    candidate batch at those shares, rates sampled through the same
    ``RateBank`` tables the execution plane uses;
  * ``plane.path_capacity`` — the uncontended bottleneck a deferred lane
    is priced at.

The model, per migration domain (connected component of "shares a link"
over the candidates' paths plus the live domains):

  * launching ``k`` candidates prices each at its what-if fair share from
    ``now`` (forced co-launches — requests past the provider's max-wait
    wall — are included in the share solve and the bill);
  * deferring the rest prices each at its uncontended path capacity from
    ``now + defer_s`` — deliberately optimistic: a deferred lane re-enters
    the sweep at the next boundary, so the estimate is re-judged every
    tick, and the optimism biases toward deferral, the direction that
    minimizes contended bytes (pricing the tail at its predicted *actual*
    start times was tried and measured worse: long serial horizons make
    deferral look phase-risky and push the sweep back toward concurrency);
  * marginal dilution of already-in-flight lanes is NOT billed (their
    remaining cost is mid-round state the what-if cannot cheaply reprice);
    the omission biases toward deferral, which is the safe direction.

Progress guarantees live with the caller: candidates the LMCM cannot defer
past ``max_wait`` bypass the sweep entirely, and an idle domain always
releases its head-of-line candidate (``select`` never returns an empty
batch for a component with nothing in flight), so the controller can be
strictly lazier than the static gate without ever stalling the fabric.

Cost of a decision (the fleet-scale constraint): the sweep is ONE-SOLVE.
The n+1 nested "launch the first k" batches share one (L, M) incidence,
so their fair shares come from a single stacked progressive filling
(``plane.what_if_shares_sweep`` -> ``network.fair_share_masked``), every
prefix is priced in ONE flattened ``strunk.what_if_cost_batch`` call
(rate tables gathered from one ``RateBank`` — ``bank.take`` — instead of
n+1 re-normalizations), and per-k totals are segment sums over the
flattened outcome. Candidate grouping unions paths through
``network.LinkUnionFind`` — near-linear in candidates + live domains
instead of quadratic pairwise set intersections. The pre-refactor per-k
loop is kept verbatim as ``_sweep_reference`` (``sweep="reference"``):
its per-lane pre-copy recurrences and per-k share solves are the
executable spec the stacked path must match — same selected k, same
(bytes, time, -k) score tuple — asserted by tests/test_controlplane.py
over random topologies and by the controlplane_scaling benchmark.

On hierarchical fabrics (``Topology.pod_spine``) the sweep gains the
*route* axis: a (src, dst) pair exposes k candidate routes (one per spine
plane), and the decision becomes **defer-k x route**. A route stage runs
first per multi-route component: every (lane, route) pair is priced as if
launched alone against the in-flight set — all pairs through ONE stacked
``fair_share_masked`` solve over one tall incidence
(``plane.what_if_pair_shares``) and ONE flattened cost batch — and routes
are assigned greedily in queue order, exact score ties de-conflicted
toward less-claimed links (``_assign_routes``). The defer-k stage then
sweeps prefixes over the ASSIGNED paths exactly as on a flat fabric, and
launching requests get their route stamped on ``req.path``. The per-pair
loop is kept verbatim inside ``sweep="reference"`` — identical (k, route)
selections are asserted by tests/test_route_sweep.py.

``horizon=True`` grows the sweep a third axis: **now vs trough**. The
myopic sweep prices deferral at one fixed re-evaluation delay and only
over queue-order prefixes; the receding-horizon sweep (a) prices each
candidate's deferral at its own predicted workload trough (Algorithm 2's
RemainTime through ``trough_of`` — the paper's postponement becomes a
COLUMN of the admission score instead of an upstream verdict), (b) scores
arbitrary candidate subsets — queue-order prefixes plus benefit-order
prefixes, so a disjoint cheap-now candidate cannot starve behind a
cross-rack-glued head — through ``plane.what_if_subset_shares``, and (c)
bills the marginal dilution of already-running lanes by resuming their
mid-round state (``plane.lane_state`` -> ``strunk.ResumeState``) under
each scenario's shares. Deferred candidates carry their trough wake in
``deferred_until`` (the LMCM turns it into a heap re-admission so
event-skip stops there) and their would-be links in claims that seed
route tie de-confliction. Progress is explicit: a candidate OVERTAKEN
``aging_limit`` times (a later-queued candidate launched past it while it
deferred — the one starvation mode subset reordering introduces; plain
queue-order waiting does not age) is promoted to forced.
``horizon=False`` (default) leaves every myopic code path byte-identical
to PR 8.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import network, strunk


def _default_path_of(plane):
    def path_of(req) -> Tuple[str, ...]:
        if getattr(req, "path", None):
            return tuple(req.path)
        return plane.topology.path(req.src, req.dst)
    return path_of


def _default_routes_of(plane):
    """Candidate routes of a request: the topology's per-pair route set.
    A pre-stamped ``req.path`` that IS one of those routes does not pin
    the choice (FleetSim stamps route 0 on every request at submit; the
    sweep may still re-route it), but a custom path outside the route set
    is honored as a fixed single route."""
    def routes_of(req) -> Tuple[Tuple[str, ...], ...]:
        routes = plane.topology.routes(req.src, req.dst)
        stamped = tuple(getattr(req, "path", None) or ())
        if stamped and stamped not in routes:
            return (stamped,)
        return routes
    return routes_of


class AdaptiveConcurrencyController:
    """Defer-k launch selection over the ready queue, per migration domain.

    ``plane`` is a ``fabric.ShardedPlane`` or ``plane.MigrationPlane``
    (both expose ``domain_links`` / ``what_if_shares_sweep`` /
    ``path_capacity``). ``rate_of(req)`` returns the request's dirty-rate
    spec in the lane-registration form of ``core/rates.py`` (a
    ``PiecewiseRate`` table keeps the whole sweep vectorized); ``defer_s``
    is the re-evaluation delay deferred candidates are priced at (the
    LMCM's sampling period).

    ``sweep`` selects the sweep engine: ``"stacked"`` (default) answers
    all n+1 prefixes with one share solve + one flattened cost batch —
    O(one solve) per component per tick; ``"reference"`` is the original
    per-k loop (one share solve + one pre-copy batch PER prefix), kept as
    the executable spec and as the honest baseline the
    ``controlplane_scaling`` benchmark times the stacked path against.
    Both select the same k with the same score tuple.

    ``horizon=True`` switches to the receding-horizon subset sweep (see
    module docstring): per-candidate trough-priced deferral via
    ``trough_of(req, now) -> seconds-until-trough | None``, subset
    selection over queue- and benefit-order prefixes, in-flight lane
    repricing, trough wakes in ``deferred_until`` (consumed by the LMCM's
    deferral push), and a hard no-starvation bound — a candidate overtaken
    ``aging_limit`` times by later-queued launches is promoted to a
    forced launch.
    """

    def __init__(self, plane, *,
                 rate_of: Optional[Callable[[object], object]] = None,
                 path_of: Optional[Callable[[object], Tuple[str, ...]]] = None,
                 routes_of: Optional[Callable[
                     [object], Tuple[Tuple[str, ...], ...]]] = None,
                 defer_s: float = 1.0, sweep: str = "stacked",
                 horizon: bool = False,
                 trough_of: Optional[Callable[
                     [object, float], Optional[float]]] = None,
                 aging_limit: int = 8):
        assert sweep in ("stacked", "reference")
        self.plane = plane
        self.rate_of = rate_of or (lambda req: None)
        self.path_of = path_of or _default_path_of(plane)
        if routes_of is not None:
            self.routes_of = routes_of
        elif path_of is not None:
            # a custom path resolver pins each request to that one path
            self.routes_of = lambda req: (self.path_of(req),)
        else:
            self.routes_of = _default_routes_of(plane)
        self.defer_s = defer_s
        self.sweep = sweep
        self.horizon = bool(horizon)
        self.trough_of = trough_of
        self.aging_limit = int(aging_limit)
        # id(req) -> absolute wake time of the most recent horizon
        # deferral (rebuilt every select; the LMCM consumes it to push
        # trough-timed re-admissions into its heap)
        self.deferred_until: Dict[int, float] = {}
        # id(req) -> (wake, path): links a horizon-deferred candidate is
        # about to take — counted as live by route tie de-confliction
        # until the wake passes or the request launches. Never populated
        # with horizon=False (bit-parity with the PR 8 assignment).
        self._deferred_claims: Dict[int, Tuple[float, Tuple[str, ...]]] = {}

    # -- selection -----------------------------------------------------------
    def select(self, candidates: Sequence, now: float, *,
               forced: Sequence = ()) -> List:
        """The subset of ``candidates`` to launch at ``now``. ``forced``
        are requests launching regardless (max-wait wall); they are not
        returned but their paths contend in every what-if evaluation.

        On multi-route fabrics this is the defer-k x route sweep: the
        route stage assigns every lane in a multi-route component its
        route first (each (lane, route) pair priced against the in-flight
        set in one stacked solve, greedily de-conflicted on ties), then
        the defer-k stage sweeps prefixes over the assigned paths.
        Launching requests (forced + the chosen prefix) get their
        assigned route stamped on ``req.path`` so the execution plane
        rides it; deferred candidates stay unstamped and are re-routed at
        the next boundary. Single-route components skip the route stage —
        flat fabrics behave exactly as before.

        With ``horizon=True`` the per-component decision is the subset
        sweep (``_sweep_subset``): chosen candidates need not be a queue
        prefix, deferred candidates get trough wakes in
        ``deferred_until`` plus link claims for route de-confliction, and
        candidates overtaken ``aging_limit`` times are promoted to forced
        launches before the sweep (no starvation)."""
        aged: List = []
        if self.horizon:
            self._prune_claims(now)
            self.deferred_until = {}
            aged = [r for r in candidates
                    if getattr(r, "defers", 0) >= self.aging_limit]
            if aged:
                aged_ids = {id(r) for r in aged}
                forced = list(forced) + aged
                candidates = [r for r in candidates
                              if id(r) not in aged_ids]
                for r in aged:
                    self._deferred_claims.pop(id(r), None)
        if not candidates:
            return aged
        cand_routes = [self.routes_of(r) for r in candidates]
        forced_routes = [self.routes_of(r) for r in forced]
        cand_links = [tuple(l for p in rs for l in p) for rs in cand_routes]
        forced_links = [tuple(l for p in rs for l in p)
                        for rs in forced_routes]
        chosen: List = list(aged)    # aged launch regardless, so they must
        # be RETURNED (membership in the chosen set is what the LMCM acts
        # on); they also contend as forced lanes in every what-if above
        for idxs, busy, f_idx in self._components(cand_links, forced_links):
            group = [candidates[i] for i in idxs]
            g_routes = [cand_routes[i] for i in idxs]
            g_forced = [forced[i] for i in f_idx]
            g_froutes = [forced_routes[i] for i in f_idx]
            multi = any(len(rs) != 1 for rs in g_froutes + g_routes)
            if not multi:
                g_fpaths = [rs[0] for rs in g_froutes]
                g_paths = [rs[0] for rs in g_routes]
            else:
                g_fpaths, g_paths = self._route_stage(
                    g_forced, g_froutes, group, g_routes, now)
            if self.horizon:
                sel, delays, troughy = self._sweep_subset(
                    group, g_paths, g_forced, g_fpaths, now)
                if not sel and not busy and not g_forced \
                        and not troughy.all():
                    # idle domain with no predicted trough to wait for:
                    # release the head of line (when EVERY candidate has a
                    # trough wake scheduled, waiting IS the decision — the
                    # aging bound and the max-wait wall still guarantee
                    # progress)
                    sel = [0]
            else:
                k = self._best_k(group, g_paths, g_forced, g_fpaths, now)
                if k == 0 and not busy and not g_forced:
                    k = 1    # idle domain: always release the head of line
                sel = list(range(k))
            if multi:        # stamp assigned routes on what launches NOW
                for r, p in zip(g_forced, g_fpaths):
                    r.path = p
                for j in sel:
                    group[j].path = g_paths[j]
            chosen.extend(group[j] for j in sel)
            if self.horizon:
                sel_set = set(sel)
                # aging counts OVERTAKES, not waiting: a deferred candidate
                # ages only when a later-queued candidate launched past it
                # (the starvation mode subset reordering introduces).
                # Queue-order waiting behind a draining head is the myopic
                # schedule, not starvation, and must not trip the bound.
                overtake = max(sel) if sel else -1
                for j, r in enumerate(group):
                    if j in sel_set:
                        self._deferred_claims.pop(id(r), None)
                    else:
                        if j < overtake:
                            r.defers = getattr(r, "defers", 0) + 1
                        wake = now + float(delays[j])
                        self.deferred_until[id(r)] = wake
                        self._deferred_claims[id(r)] = (wake, g_paths[j])
                for r in g_forced:
                    self._deferred_claims.pop(id(r), None)
        return chosen

    def _prune_claims(self, now: float) -> None:
        """Drop deferred-link claims whose wake has passed — the claim
        either re-enters this very select() as a live candidate or the
        request is gone (launched elsewhere, cancelled, expired)."""
        dead = [k for k, (wake, _) in self._deferred_claims.items()
                if wake <= now]
        for k in dead:
            del self._deferred_claims[k]

    # -- the route stage (stage A of defer-k x route) ------------------------
    def _route_stage(self, forced: Sequence,
                     forced_routes: Sequence[Tuple[Tuple[str, ...], ...]],
                     group: Sequence,
                     group_routes: Sequence[Tuple[Tuple[str, ...], ...]],
                     now: float
                     ) -> Tuple[List[Tuple[str, ...]],
                                List[Tuple[str, ...]]]:
        """Assign every lane of a multi-route component its route.

        Each (lane, route) pair is priced as if it launched ALONE against
        everything in flight — pair j's fair share and pre-copy cost, all
        pairs answered by ONE stacked masked solve
        (``plane.what_if_pair_shares``) and ONE flattened cost batch in
        the default engine, or by the per-pair loop under
        ``sweep="reference"`` (the executable spec: same shares, same
        costs, identical assignments). ``_assign_routes`` then picks
        greedily, de-conflicting exact score ties toward less-claimed
        links. Returns (forced paths, candidate paths) in input order."""
        lanes = list(forced) + list(group)
        routes = list(forced_routes) + list(group_routes)
        pair_lane = [i for i, rs in enumerate(routes) for _ in rs]
        pair_paths = [tuple(p) for rs in routes for p in rs]
        v_lane = np.asarray([r.v_bytes for r in lanes], np.float64)
        specs = [self.rate_of(r) for r in lanes]
        if self.sweep == "stacked":
            from repro_torch.core.rates import RateBank
            shares = self.plane.what_if_pair_shares([], pair_paths)
            idx = np.asarray(pair_lane, np.intp)
            bank = RateBank(specs)
            rate_arg = bank.take(idx) if not bank.fallback \
                else [specs[i] for i in pair_lane]
            priced = strunk.what_if_cost_batch(
                v_lane[idx], shares, rate_arg,
                np.full(len(pair_paths), now), full=True)
            p_bytes, p_time = priced.bytes_sent, priced.total_time
        else:
            p_bytes = np.empty(len(pair_paths))
            p_time = np.empty(len(pair_paths))
            for j, (i, p) in enumerate(zip(pair_lane, pair_paths)):
                share = self.plane.what_if_shares([p])
                out = strunk.what_if_cost_batch(
                    v_lane[i:i + 1], share, [specs[i]],
                    np.asarray([now]), full=True)
                p_bytes[j] = out.bytes_sent[0]
                p_time[j] = out.total_time[0]
        assigned = self._assign_routes(routes, p_bytes, p_time)
        n_f = len(forced)
        return assigned[:n_f], assigned[n_f:]

    def _assign_routes(self, routes: Sequence[Tuple[Tuple[str, ...], ...]],
                       p_bytes: np.ndarray, p_time: np.ndarray
                       ) -> List[Tuple[str, ...]]:
        """Greedy deterministic route assignment over the priced pairs:
        lanes in order (forced first, then queue order), each taking its
        (bytes, time)-minimal route; EXACT score ties break toward the
        route whose links carry fewer claimed lanes — in-flight lanes
        plus earlier assignments — then toward the lowest route index
        (= the fixed-shortest path). Shared by both sweep engines, so
        stacked-vs-reference assignment parity reduces to share/cost
        parity of the pair pricing. Horizon-deferred candidates' claimed
        links count as live too: they will take those links at their
        trough wake, so spreading must not collapse onto them (the claim
        dict is empty with ``horizon=False`` — PR 8 bit-parity)."""
        claimed = dict(self.plane.link_live_counts())
        for _wake, p in self._deferred_claims.values():
            for l in dict.fromkeys(p):
                claimed[l] = claimed.get(l, 0) + 1
        assigned: List[Tuple[str, ...]] = []
        j = 0
        for rs in routes:
            best = None
            for m, p in enumerate(rs):
                load = sum(claimed.get(l, 0) for l in p)
                key = (float(p_bytes[j + m]), float(p_time[j + m]), load, m)
                if best is None or key < best[0]:
                    best = (key, p)
            _, p = best
            for l in p:
                claimed[l] = claimed.get(l, 0) + 1
            assigned.append(p)
            j += len(rs)
        return assigned

    # -- grouping ------------------------------------------------------------
    def _components(self, cand_paths: Sequence[Tuple[str, ...]],
                    forced_paths: Sequence[Tuple[str, ...]]
                    ) -> List[Tuple[List[int], bool, List[int]]]:
        """Connected components of "shares a link" over candidate paths,
        forced-launch paths, and the live migration domains, via one
        ``network.LinkUnionFind`` pass — near-linear in paths + domains
        (the old pairwise set-intersection merge was O(n^2) in candidates
        and re-hashed every domain's frozenset each tick). Yields
        (candidate indexes, has-in-flight-lanes, forced indexes) per
        component, ordered by smallest candidate index; path-less
        candidates are unconstrained singletons."""
        uf = network.LinkUnionFind()
        comps: dict = {}                 # root (or singleton tag) -> state

        def entry(root):
            c = comps.get(root)
            if c is None:
                c = comps[root] = ([], False, [])
            return c

        roots = [uf.union_path(p) for p in cand_paths]
        f_roots = [uf.union_path(p) for p in forced_paths]
        d_roots = [uf.union_path(d) for d in self.plane.domain_links()]
        # a second find per path collapses the unions that happened after
        # the path's own union_path call
        for i, r in enumerate(roots):
            if r is None:                # path-less: its own component
                comps[("solo", i)] = ([i], False, [])
            else:
                entry(uf.find(r))[0].append(i)
        for i, r in enumerate(f_roots):
            if r is not None:
                entry(uf.find(r))[2].append(i)
        for r in d_roots:
            if r is not None:
                root = uf.find(r)
                c = entry(root)
                comps[root] = (c[0], True, c[2])
        out = [(idxs, busy, f_idx) for idxs, busy, f_idx in comps.values()
               if idxs]
        return sorted(out, key=lambda c: c[0][0])

    # -- the sweep -----------------------------------------------------------
    def _best_k(self, group: Sequence, paths: Sequence[Tuple[str, ...]],
                forced: Sequence, forced_paths: Sequence[Tuple[str, ...]],
                now: float) -> int:
        """Candidate in-flight count minimizing predicted total contended
        bytes over this component: launch ``group[:k]`` now at what-if
        fair shares (alongside the forced launches), defer ``group[k:]``
        to ``now + defer_s`` at uncontended path capacity. Tie-break:
        summed predicted migration time, then larger k (never defer for
        free). Dispatches to the one-solve stacked sweep (default) or the
        per-k reference loop (``sweep="reference"``)."""
        fn = self._sweep_stacked if self.sweep == "stacked" \
            else self._sweep_reference
        return fn(group, paths, forced, forced_paths, now)[0]

    def _deferred_tails(self, v: np.ndarray, idle_bw: np.ndarray,
                        specs: Sequence, now: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
        # a lane's deferred cost does not depend on k: price every
        # candidate's deferral ONCE, and read "defer the k..n-1 tail" off
        # suffix sums instead of re-simulating it n+1 times
        deferred = strunk.what_if_cost_batch(
            v, idle_bw, specs, np.full(len(v), now + self.defer_s),
            full=True)
        tail_bytes = np.concatenate(
            [np.cumsum(deferred.bytes_sent[::-1])[::-1], [0.0]])
        tail_time = np.concatenate(
            [np.cumsum(deferred.total_time[::-1])[::-1], [0.0]])
        return tail_bytes, tail_time

    def _sweep_inputs(self, group: Sequence, forced: Sequence, now: float):
        v = np.asarray([r.v_bytes for r in group], np.float64)
        specs = [self.rate_of(r) for r in group]
        v_forced = np.asarray([r.v_bytes for r in forced], np.float64)
        specs_forced = [self.rate_of(r) for r in forced]
        idle_bw = np.asarray(
            [self.plane.path_capacity(r.src, r.dst) for r in group])
        tails = self._deferred_tails(v, idle_bw, specs, now)
        return v, specs, v_forced, specs_forced, tails

    def _sweep_stacked(self, group: Sequence,
                       paths: Sequence[Tuple[str, ...]], forced: Sequence,
                       forced_paths: Sequence[Tuple[str, ...]], now: float
                       ) -> Tuple[int, Tuple[float, float, int]]:
        """One-solve sweep: all n+1 prefix batches share ONE stacked
        fair-share solve and ONE flattened pre-copy cost batch.

        Prefixes are nested, so the F+n distinct (lane, start-time) pairs
        repeat across prefixes with only the SHARE varying — the flattened
        batch lays out prefix k's lanes contiguously (forced first, then
        candidates 0..k-1, identical to the reference's per-k layout), the
        rate tables are gathered from one ``RateBank`` over the F+n unique
        specs, and per-k totals are contiguous-slice segment sums —
        bit-identical to the reference's per-k ``.sum()`` calls (same
        values, same lengths, same pairwise order)."""
        from repro_torch.core.rates import RateBank
        n, n_f = len(group), len(forced)
        v, specs, v_forced, specs_forced, (tail_bytes, tail_time) = \
            self._sweep_inputs(group, forced, now)
        # (n+1, F+n) shares: row k = fair shares of forced + group[:k]
        shares = self.plane.what_if_shares_sweep(forced_paths, paths)
        # flattened layout: segment k holds forced + group[:k]
        counts = n_f + np.arange(n + 1)
        seg = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(int(seg[-1])) - np.repeat(seg[:-1], counts)
        row = np.repeat(np.arange(n + 1), counts)
        v_all = np.concatenate([v_forced, v])
        specs_all = specs_forced + specs
        bank = RateBank(specs_all)
        # un-tabulatable specs (plain callables) take the reference's
        # per-lane compatibility path; tabular banks gather in one go
        rate_arg = bank.take(within) if not bank.fallback \
            else [specs_all[i] for i in within]
        launched = strunk.what_if_cost_batch(
            v_all[within], shares[row, within], rate_arg,
            np.full(len(within), now), full=True)
        best: Optional[Tuple[Tuple[float, float, int], int]] = None
        for k in range(n + 1):
            lo, hi = int(seg[k]), int(seg[k + 1])
            score = (float(launched.bytes_sent[lo:hi].sum()
                           + tail_bytes[k]),
                     float(launched.total_time[lo:hi].sum() + tail_time[k]),
                     -k)
            if best is None or score < best[0]:
                best = (score, k)
        return best[1], best[0]

    def _sweep_reference(self, group: Sequence,
                         paths: Sequence[Tuple[str, ...]], forced: Sequence,
                         forced_paths: Sequence[Tuple[str, ...]], now: float
                         ) -> Tuple[int, Tuple[float, float, int]]:
        """The pre-refactor per-k loop, kept verbatim as the executable
        spec: one fair-share solve and one pre-copy cost batch PER prefix.
        The stacked sweep must select the same k with the same score
        tuple."""
        n, n_f = len(group), len(forced)
        v, specs, v_forced, specs_forced, (tail_bytes, tail_time) = \
            self._sweep_inputs(group, forced, now)
        best: Optional[Tuple[Tuple[float, float, int], int]] = None
        for k in range(n + 1):
            launch_paths = list(forced_paths) + list(paths[:k])
            shares = self.plane.what_if_shares(launch_paths)
            launched = strunk.what_if_cost_batch(
                np.concatenate([v_forced, v[:k]]), shares,
                specs_forced + specs[:k],
                np.full(n_f + k, now), full=True)
            score = (float(launched.bytes_sent.sum() + tail_bytes[k]),
                     float(launched.total_time.sum() + tail_time[k]),
                     -k)
            if best is None or score < best[0]:
                best = (score, k)
        return best[1], best[0]

    # -- the receding-horizon subset sweep (horizon=True) --------------------
    def _score_subsets(self, group: Sequence,
                       paths: Sequence[Tuple[str, ...]], forced: Sequence,
                       forced_paths: Sequence[Tuple[str, ...]], now: float):
        """Score every scenario subset of the receding-horizon sweep over
        one component. Returns ``(subsets, scores, delays, troughy)``:
        the candidate-index subsets evaluated (queue-order prefixes first,
        then benefit-order prefixes, deduped), their (bytes, time, -count)
        scores, the per-candidate deferral delay (seconds until the
        predicted trough, floored at ``defer_s``), and which candidates
        actually have a trough prediction.

        Scenario i's bill = marginal resume cost of every in-flight lane
        of the component (``plane.lane_state`` -> ``strunk.ResumeState``)
        + the forced launches + the selected candidates, all at row i's
        shares from ONE ``what_if_subset_shares`` solve and ONE flattened
        resumable cost batch, + each deferred candidate priced at its own
        trough ``now + delays[j]`` at uncontended capacity. Queue prefixes
        are always among the scenarios, so the winning score can never
        exceed the myopic defer-k ladder's on the same inputs (the
        subset <= prefix property test reads exactly this invariant)."""
        from repro_torch.core.rates import RateBank
        n, n_f = len(group), len(forced)
        v = np.asarray([r.v_bytes for r in group], np.float64)
        specs = [self.rate_of(r) for r in group]
        v_forced = np.asarray([r.v_bytes for r in forced], np.float64)
        specs_forced = [self.rate_of(r) for r in forced]
        idle_bw = np.asarray(
            [self.plane.path_capacity(r.src, r.dst) for r in group])
        delays = np.full(n, float(self.defer_s))
        troughy = np.zeros(n, bool)
        if self.trough_of is not None:
            for j, r in enumerate(group):
                d = self.trough_of(r, now)
                if d is not None and np.isfinite(d):
                    delays[j] = max(float(self.defer_s), float(d))
                    troughy[j] = True
        bank_c = RateBank(specs)
        two = np.concatenate([np.arange(n), np.arange(n)])
        # one batch prices every candidate twice at uncontended capacity:
        # launched alone NOW (the benefit-ordering key) and deferred to
        # its own trough T+delta (the per-candidate deferred tail —
        # deliberately optimistic, same bias as the myopic sweep)
        both = strunk.what_if_cost_batch(
            np.concatenate([v, v]), np.concatenate([idle_bw, idle_bw]),
            bank_c.take(two) if not bank_c.fallback else specs + specs,
            np.concatenate([np.full(n, now), now + delays]), full=True)
        alone_bytes = both.bytes_sent[:n]
        d_bytes = both.bytes_sent[n:]
        d_time = both.total_time[n:]
        # in-flight lanes of this component, aligned 1:1 with the base
        # columns of the subset solve (same link set -> same domains in
        # the same creation order)
        links = {l for p in list(forced_paths) + list(paths) for l in p}
        lanes = self.plane.lane_state(links) if links else []
        n_b = len(lanes)
        orders = [(list(range(n)), range(n + 1))]
        if n > 1:
            # benefit order: most launch-now gain first (ties: queue
            # order). At large n the ladder is strided — the queue ladder
            # stays complete (the subset <= prefix guarantee needs only
            # it), so thinning the benefit rows trades a little selection
            # resolution for half the scenario rows at 64+ candidates.
            gain = alone_bytes - d_bytes
            bo = sorted(range(n), key=lambda j: (gain[j], j))
            orders.append(
                (bo, range(1, n + 1) if n <= 32 else range(1, n, 2)))
        subsets: List[Tuple[int, ...]] = []
        seen = set()
        for o, ks in orders:
            for k in ks:
                s = tuple(sorted(o[:k]))
                if s not in seen:
                    seen.add(s)
                    subsets.append(s)
        masks = np.zeros((len(subsets), n), bool)
        for i, s in enumerate(subsets):
            masks[i, list(s)] = True
        shares = self.plane.what_if_subset_shares(forced_paths, paths,
                                                  masks)
        # flattened (scenario, entry) cost batch over the unified entry
        # axis [in-flight lanes | forced | candidates]: every row carries
        # all base+forced entries plus its mask's candidates (row order
        # within the flat axis is irrelevant — totals are bincount sums)
        k_n = len(subsets)
        n_bf = n_b + n_f
        rows_c, cols_c = np.nonzero(masks)
        flat_entry = np.concatenate(
            [np.tile(np.arange(n_bf, dtype=np.intp), k_n),
             n_bf + cols_c.astype(np.intp)])
        flat_row = np.concatenate(
            [np.repeat(np.arange(k_n, dtype=np.intp), n_bf),
             rows_c.astype(np.intp)])
        v_all = np.concatenate(
            [np.asarray([s.v for s in lanes], np.float64), v_forced, v])
        specs_all = [s.spec for s in lanes] + specs_forced + specs
        zf = np.zeros(n_f + n)
        init = strunk.ResumeState(
            rem=np.concatenate(
                [np.asarray([s.rem for s in lanes], np.float64),
                 v_forced, v]),
            acc=np.concatenate(
                [np.asarray([s.acc for s in lanes], np.float64), zf]),
            sent=np.concatenate(
                [np.asarray([s.sent for s in lanes], np.float64), zf]),
            rounds=np.concatenate(
                [np.asarray([s.rounds for s in lanes], np.int64),
                 np.zeros(n_f + n, np.int64)]),
            stopped=np.concatenate(
                [np.asarray([s.stopped for s in lanes], bool),
                 np.zeros(n_f + n, bool)]),
            reason=np.concatenate(
                [np.asarray([s.reason for s in lanes], np.int64),
                 np.full(n_f + n, strunk.REASON_MAX_ROUNDS, np.int64)])
        ).take(flat_entry)
        bank = RateBank(specs_all)
        rate_arg = bank.take(flat_entry) if not bank.fallback \
            else [specs_all[i] for i in flat_entry]
        priced = strunk.what_if_cost_batch(
            v_all[flat_entry], shares[flat_row, flat_entry], rate_arg,
            np.full(len(flat_entry), now), init=init, full=True)
        row_bytes = np.bincount(flat_row, weights=priced.bytes_sent,
                                minlength=k_n)
        row_time = np.bincount(flat_row, weights=priced.total_time,
                               minlength=k_n)
        tail_b = d_bytes.sum() - masks @ d_bytes
        tail_t = d_time.sum() - masks @ d_time
        scores = [(float(row_bytes[i] + tail_b[i]),
                   float(row_time[i] + tail_t[i]), -len(s))
                  for i, s in enumerate(subsets)]
        return subsets, scores, delays, troughy

    def _sweep_subset(self, group: Sequence,
                      paths: Sequence[Tuple[str, ...]], forced: Sequence,
                      forced_paths: Sequence[Tuple[str, ...]], now: float
                      ) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """Pick the minimal-score scenario subset (ties resolve to the
        earliest-listed subset — queue-order prefixes come first, so an
        exact tie keeps the myopic choice). Returns (sorted candidate
        indexes to launch now, per-candidate deferral delays, trough
        availability mask)."""
        subsets, scores, delays, troughy = self._score_subsets(
            group, paths, forced, forced_paths, now)
        best = min(range(len(subsets)), key=lambda i: scores[i])
        return list(subsets[best]), delays, troughy
