"""Sharded datacenter fabric — per-domain migration planes.

At datacenter scale the fleet is not one flat migration network: hosts hang
off per-rack access links joined by a core (``network.Topology.star`` /
``multi_rack``), and two migrations interact only if their paths share a
link. ``ShardedPlane`` exploits that: it partitions the in-flight lanes
into *migration domains* — connected components of the "shares a link"
relation — and runs one independent ``MigrationPlane`` event loop per
domain.

Why shard instead of one big plane:

  * **event decoupling** — a round boundary in one rack's domain no longer
    forces an event chunk (fair-share recompute + dirty resample) on every
    other rack's lanes; per-step work scales with the busiest domain, not
    the fleet.
  * **structural isolation** — a domain's event loop sees exactly the
    lanes it would see running alone, so migrations in disjoint domains
    are bit-equal to running each domain by itself (asserted in
    ``tests/test_fabric.py``). Core-link traffic is the only coupling:
    a lane whose path crosses shared (core) links bridges the domains it
    touches, which are then merged (``MigrationPlane._absorb``) and
    advance as one until they drain.

Domains are dynamic: they form at launch, merge when a cross-rack lane
bridges them, and dissolve when their lanes drain (byte accounting is
folded into the fabric's persistent per-link counters). Domain membership
is kept in a link-keyed union-find (``network.LinkUnionFind``: path
compression + union by size, one root per domain): resolving a launch
path to the domains it touches is one ``find`` per path link — O(alpha),
independent of how many domains are live — instead of an intersection
scan over every domain's link set, and a domain merge unions two roots
while ``MigrationPlane._absorb`` stitches the per-root execution state
(SoA lanes, rate bank, incidence) in place rather than rebuilding it from
the merged lane list. A drained domain's component is deleted wholesale
(its links revert to unregistered).

The fabric presents the same surface as a single plane — ``launch`` /
``advance`` / ``probe_bandwidth`` / ``link_bytes`` / ``last_shares`` — so
``FleetSim`` and the LMCM's realized-bandwidth feedback are agnostic to
the sharding; ``probe_bandwidth`` computes the fair share against the
intersecting domains only (disjoint domains cannot affect a new lane's
share), and ``what_if_shares_sweep`` answers the adaptive controller's
whole defer-k prefix ladder in one stacked solve.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import network, strunk
from repro_torch.core.plane import MigrationPlane
from repro_torch.core.rates import RateSpec


class ShardedPlane:
    """Fabric of per-domain ``MigrationPlane`` event loops (same surface
    as a single plane; see module docstring for the domain model)."""

    def __init__(self, topology: network.Topology, *, vectorized: bool = True,
                 **plane_kw):
        self.topology = topology
        self.caps = topology.capacities
        # id-indexed mirror of ``caps`` for the integer probe fast path
        self._caps_all = topology.caps_vector().copy()
        self.vectorized = vectorized
        self._plane_kw = plane_kw
        self._fallback_bw = max(self.caps.values(), default=np.inf)
        self.now = 0.0
        self._domains: List[MigrationPlane] = []
        # link-keyed domain membership: find(link) -> root -> plane.
        # _domains stays the ordered iteration surface (creation order,
        # which fixes lane order inside merged planes and the base-path
        # order of probes — both bit-parity-relevant)
        self._uf = network.LinkUnionFind()
        self._root_domain: Dict[str, MigrationPlane] = {}
        self._domain_root: Dict[int, str] = {}            # id(plane) -> root
        self._unlinked: Optional[MigrationPlane] = None   # path-less lanes
        self._dom_seq = 0
        # the union-find is keyed by link *incarnations*: a link whose
        # last live lane completed detaches from its component (domains
        # are components of the LIVE "shares a link" relation — matching
        # a new launch against a drained link's old domain would couple
        # event chunking across lanes that share nothing), and its next
        # use re-registers a fresh key. Ghost keys are reaped wholesale
        # when their domain drains (``pop_component``).
        self._link_key: Dict[str, str] = {}               # live link -> key
        self._live: Dict[str, int] = {}                   # live lanes per link
        self._lane_links: Dict[int, frozenset] = {}       # id(req) -> links
        self._gen = 0
        self._pending: List[Tuple[object, strunk.MigrationOutcome]] = []
        self._retired_link_bytes: Dict[str, float] = {}
        # final shares of domains that dissolved during the MOST RECENT
        # advance only — mirrors MigrationPlane.last_shares ("shares at
        # the latest event boundary") without retaining every job ever run
        self._dissolved_shares: Dict[str, float] = {}
        self.merges = 0                  # domain-bridging events (telemetry)

    # -- introspection -------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return sum(d.in_flight for d in self._domains)

    @property
    def domain_count(self) -> int:
        return len(self._domains)

    def jobs_in_flight(self) -> List[str]:
        return [j for d in self._domains for j in d.jobs_in_flight()]

    def domain_links(self) -> List[frozenset]:
        """Link sets of the live domains (diagnostics / tests / the
        adaptive controller's candidate grouping)."""
        return [d.link_set for d in self._domains]

    def link_live_counts(self) -> Dict[str, int]:
        """In-flight lane count per link (route de-confliction input for
        ``pick_route`` and the controller's greedy route assignment)."""
        return dict(self._live)

    def domain_paths(self) -> List[List[Tuple[str, ...]]]:
        """Per-domain in-flight lane paths (the controller's what-if
        baseline for each migration domain)."""
        return [d.paths_in_flight() for d in self._domains]

    @property
    def link_bytes(self) -> Dict[str, float]:
        out = dict(self._retired_link_bytes)
        for d in self._domains:
            for l, b in d.link_bytes.items():
                out[l] = out.get(l, 0.0) + b
        return out

    @property
    def last_shares(self) -> Dict[str, float]:
        """Fair shares at each live domain's latest event boundary (plus
        the final shares of domains that drained in the last advance)."""
        shares = dict(self._dissolved_shares)
        for d in self._domains:
            shares.update(d.last_shares)
        return shares

    def _hit_domains(self, links: Iterable[str]) -> List[MigrationPlane]:
        """The live domains whose in-flight lanes touch any of ``links``
        — one union-find lookup per link (O(alpha) each, independent of
        the domain count), returned in domain-creation order (=
        ``self._domains`` order, which probe base-path ordering and merge
        targeting both rely on)."""
        hits: Dict[int, MigrationPlane] = {}
        for l in links:
            key = self._link_key.get(l)
            if key is not None:
                d = self._root_domain[self._uf.find(key)]
                hits[id(d)] = d
        return sorted(hits.values(), key=lambda d: d._fabric_seq)

    def probe_bandwidth(self, src: str, dst: str, extra: int = 0,
                        pending: Sequence[Sequence[str]] = ()) -> float:
        """Fair-share bandwidth a NEW src->dst migration would realize,
        computed against the domains its path intersects — lanes in
        disjoint domains cannot affect the share, so the probe is
        per-domain (the LMCM's ``bandwidth_probe`` wiring lands here).
        ``pending`` carries the actual paths of same-burst co-launches not
        yet on the fabric (they widen the intersecting-domain set: a
        co-launch can couple the probed lane to a domain its own path
        never touches); ``extra`` approximates further committed launches
        as same-path clones (legacy form)."""
        topo = self.topology
        path = topo.path(src, dst)
        pend = [tuple(p) for p in pending]
        pset = frozenset(path).union(*map(frozenset, pend)) if pend \
            else frozenset(path)
        hits = self._hit_domains(pset)
        ids = topo.ids_of(path)
        if ids is not None:
            # integer fast path: all lanes' link-id arrays are precomputed
            # (``fair_share_ids`` is the dict walk's bit-parity mirror)
            base_ids = [pi for d in hits for pi in d.ids_in_flight()]
            pend_ids = [topo.ids_of(p) for p in pend]
            if all(x is not None for x in base_ids) and \
                    all(x is not None for x in pend_ids):
                id_paths = base_ids + pend_ids + [ids] * (extra + 1)
                share = float(network.fair_share_ids(
                    id_paths, self._caps_all)[-1])
                return share if np.isfinite(share) else self._fallback_bw
        paths = [p for d in hits for p in d.paths_in_flight()]
        paths += pend + [path] * (extra + 1)
        share = float(network.fair_share(paths, self.caps)[-1])
        return share if np.isfinite(share) else self._fallback_bw

    def what_if_shares(self, new_paths: Sequence[Sequence[str]]
                       ) -> np.ndarray:
        """Max-min fair shares the hypothetical lanes ``new_paths`` would
        realize if all launched right now — solved against the union of
        the domains any of them intersects (domains are maximal
        components, so no other lane can affect the answer). One share per
        new path; unlinked lanes get the fallback bandwidth."""
        pend = [tuple(p) for p in new_paths]
        if not pend:
            return np.zeros(0)
        base = self._base_paths(l for p in pend for l in p)
        shares = network.fair_share(base + pend, self.caps)[len(base):]
        return np.where(np.isfinite(shares), shares, self._fallback_bw)

    def _base_paths(self, links: Iterable[str]) -> List[Tuple[str, ...]]:
        return [p for d in self._hit_domains(links)
                for p in d.paths_in_flight()]

    def what_if_shares_sweep(self, fixed_paths: Sequence[Sequence[str]],
                             cand_paths: Sequence[Sequence[str]]
                             ) -> np.ndarray:
        """All n+1 nested what-if batches of the defer-k sweep in ONE
        stacked solve: row k holds the fair shares of the F ``fixed_paths``
        lanes plus the first k ``cand_paths`` lanes against the domains the
        sweep intersects (columns past F+k are inactive and read 0).
        Equivalent to n+1 ``what_if_shares`` calls over growing prefixes;
        see ``network.fair_share_masked``."""
        base = self._base_paths(
            l for paths in (fixed_paths, cand_paths) for p in paths
            for l in p)
        return network.what_if_prefix_shares(
            base, fixed_paths, cand_paths, self.caps, self._fallback_bw)

    def what_if_pair_shares(self, fixed_paths: Sequence[Sequence[str]],
                            pair_paths: Sequence[Sequence[str]]
                            ) -> np.ndarray:
        """Fair share each (candidate, route) pair would realize ON ITS
        OWN against the ``fixed_paths`` lanes and the domains any pair or
        fixed lane intersects — the route-selection stage of the defer-k x
        route sweep, all pairs in one stacked solve (see
        ``network.what_if_pair_shares``)."""
        base = self._base_paths(
            l for paths in (fixed_paths, pair_paths) for p in paths
            for l in p)
        return network.what_if_pair_shares(
            base, fixed_paths, pair_paths, self.caps, self._fallback_bw)

    def what_if_subset_shares(self, fixed_paths: Sequence[Sequence[str]],
                              cand_paths: Sequence[Sequence[str]],
                              masks) -> np.ndarray:
        """Fair shares of K arbitrary candidate subsets against the
        domains the sweep intersects, base columns INCLUDED (row k: every
        intersecting in-flight lane + every fixed lane + the candidates
        ``masks[k]`` selects). Base-column order is ``_base_paths`` over
        the fixed+candidate links — the same order ``lane_state`` returns
        snapshots in, so the controller can reprice lane j at column j.
        See ``network.what_if_subset_shares``."""
        base = self._base_paths(
            l for paths in (fixed_paths, cand_paths) for p in paths
            for l in p)
        return network.what_if_subset_shares(
            base, fixed_paths, cand_paths, masks, self.caps,
            self._fallback_bw)

    def lane_state(self, links=None):
        """Mid-round snapshots of every lane in the domains touching
        ``links`` (all domains when None) — aligned one-to-one with
        ``_base_paths(links)``, i.e. with the base columns of
        ``what_if_subset_shares`` over the same link set."""
        if links is None:
            hits = self._domains
        else:
            hits = self._hit_domains(links)
        return [s for d in hits for s in d.lane_state()]

    def path_capacity(self, src: str, dst: str) -> float:
        """Uncontended capacity of the src->dst path (tightest link a lone
        migration would traverse) — the launch gate's floor reference."""
        path = self.topology.path(src, dst)
        if not path:
            return self._fallback_bw
        ids = self.topology.ids_of(path)
        if ids is not None:
            return float(self._caps_all[ids].min())
        return min(self.caps[l] for l in path)

    def pick_route(self, src: str, dst: str,
                   pending: Sequence[Sequence[str]] = ()
                   ) -> Tuple[str, ...]:
        """The candidate route a src->dst launch should ride right now
        (same contract as ``MigrationPlane.pick_route``): best probed
        fair share against the intersecting domains, ties broken toward
        fewer live lanes on the route's links, then the lowest route
        index. Flat pairs return ``path()`` unchanged."""
        routes = self.topology.routes(src, dst)
        if len(routes) == 1:
            return routes[0]
        shares = self.what_if_pair_shares(
            [tuple(p) for p in pending], list(routes))
        best, best_key = 0, None
        for j, r in enumerate(routes):
            load = sum(self._live.get(l, 0) for l in r)
            key = (float(shares[j]), -load, -j)
            if best_key is None or key > best_key:
                best, best_key = j, key
        return routes[best]

    # -- lifecycle -----------------------------------------------------------
    def _new_domain(self) -> MigrationPlane:
        d = MigrationPlane(self.topology, vectorized=self.vectorized,
                           **self._plane_kw)
        d._fabric_seq = self._dom_seq
        self._dom_seq += 1
        self._domains.append(d)
        return d

    def _on_finished(self, done):
        """Completion bookkeeping: a finished lane releases its links —
        a link whose live count reaches zero detaches from the union-find
        (its key is dropped; the ghost node is reaped at domain drain)."""
        for req, _ in done:
            for l in self._lane_links.pop(id(req), ()):
                left = self._live[l] - 1
                if left:
                    self._live[l] = left
                else:
                    del self._live[l]
                    del self._link_key[l]
        return done

    # -- fault injection -----------------------------------------------------
    def set_link_capacity(self, link: str, capacity: float) -> None:
        """Push a capacity change (fault injection) through the topology,
        the fabric's own probe view, and every live domain — future
        domains snapshot the mutated topology at creation."""
        self.topology.set_capacity(link, capacity)
        self.caps[link] = float(capacity)
        self._fallback_bw = max(self.caps.values(), default=np.inf)
        idx = self.topology.link_ids.get(link)
        if idx is not None:
            self._caps_all[idx] = float(capacity)
        for d in self._domains:
            d.set_link_capacity(link, capacity)

    def abort(self, job_id: str
              ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Settle ``job_id``'s in-flight lane early across the fabric
        (see ``MigrationPlane.abort``): the lane's links release their
        union-find incarnations exactly as a completion would, and a
        domain fully drained by the abort dissolves immediately."""
        return self._abort_where(lambda d: d.abort(job_id))

    def fail_host(self, host: str
                  ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Abort every in-flight lane with ``host`` as an endpoint."""
        return self._abort_where(lambda d: d.fail_host(host))

    def abort_link(self, link: str
                   ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        """Abort every in-flight lane whose path crosses ``link`` — a
        hard ToR/pod-uplink outage (see ``MigrationPlane.abort_link``;
        the capacity change is the caller's move)."""
        return self._abort_where(lambda d: d.abort_link(link))

    def _abort_where(self, abort_fn
                     ) -> List[Tuple[object, strunk.MigrationOutcome]]:
        aborted: List[Tuple[object, strunk.MigrationOutcome]] = []
        for d in list(self._domains):
            out = abort_fn(d)
            if not out:
                continue
            aborted.extend(self._on_finished(out))
            if not d.in_flight:
                self._dissolve(d)
                self._domains.remove(d)
        return aborted

    def launch(self, req, rate: RateSpec, now: float, *,
               path: Optional[Sequence[str]] = None) -> None:
        """Start executing ``req`` at ``now`` in the domain its path
        belongs to — creating it, or merging the domains the path bridges
        (e.g. a cross-rack lane joining two busy racks through the core).
        Domain resolution is one union-find lookup per path link and a
        merge is one union per bridged domain — O(alpha), with
        ``MigrationPlane._absorb`` stitching the bridged domains' live
        execution state in place. ``rate`` follows the lane-registration
        API of ``core/rates.py``."""
        p = tuple(path) if path is not None else \
            self.topology.path(req.src, req.dst)
        pset = frozenset(p)
        if pset:
            hits = self._hit_domains(pset)
        else:
            # unlinked lanes never contend; keep them in one side domain
            hits = [self._unlinked] if self._unlinked is not None else []
        if not hits:
            target = self._new_domain()
            if not pset:
                self._unlinked = target
        else:
            target = hits[0]
            for other in hits[1:]:
                t = max(now, target.now, other.now)
                self._pending.extend(self._on_finished(target.advance(t)))
                self._pending.extend(self._on_finished(other.advance(t)))
                target._absorb(other)
                self._domains.remove(other)
                self.merges += 1
        if pset:
            old_roots = [self._domain_root[id(d)] for d in hits]
            for l in pset:
                if l not in self._link_key:
                    self._gen += 1
                    self._link_key[l] = f"{l}#{self._gen}"
                self._live[l] = self._live.get(l, 0) + 1
            root = self._uf.union_path(self._link_key[l] for l in p)
            for r in old_roots:
                root = self._uf.union(root, r)
                self._root_domain.pop(r, None)
            for d in hits:
                self._domain_root.pop(id(d), None)
            self._root_domain[root] = target
            self._domain_root[id(target)] = root
            self._lane_links[id(req)] = pset
        target.launch(req, rate, now, path=p)
        self.now = max(self.now, now)

    def advance(self, until: float):
        """Advance every domain's event loop to ``until`` (or drain);
        returns completions across all domains (plus any produced by
        launch-time catch-ups and merges). Drained domains dissolve —
        their byte accounting folds into the fabric counters and their
        union-find component is deleted wholesale."""
        finished = self._pending
        self._pending = []
        live: List[MigrationPlane] = []
        self._dissolved_shares = {}
        for d in self._domains:
            finished.extend(self._on_finished(d.advance(until)))
            if not np.isfinite(until):
                self.now = max(self.now, d.now)
            if d.in_flight:
                live.append(d)
            else:
                self._dissolve(d)
        self._domains = live
        if np.isfinite(until):
            self.now = max(self.now, until)
        return finished

    def _dissolve(self, d: MigrationPlane) -> None:
        """Retire a drained domain (drain or mass abort): fold its byte
        accounting into the fabric counters, surface its final shares,
        and delete its union-find component wholesale — ghost link
        incarnations are reaped with it."""
        for l, b in d.link_bytes.items():
            self._retired_link_bytes[l] = \
                self._retired_link_bytes.get(l, 0.0) + b
        self._dissolved_shares.update(d.last_shares)
        root = self._domain_root.pop(id(d), None)
        if root is not None:
            self._root_domain.pop(root, None)
            self._uf.pop_component(root)
        if d is self._unlinked:
            self._unlinked = None
