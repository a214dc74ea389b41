"""Migration-fabric network model — topology, domains, and max-min sharing.

The paper's testbed moves every live migration over one dedicated 1 Gbit/s
migration network (§6.1); its central claim is that *simultaneous*
migrations congest that network and degrade applications (§1, Tables 6-7).
He & Buyya's taxonomy (arXiv:2112.02593) and Wang et al.'s SDN migration
planning (arXiv:1412.4980) both single out bandwidth sharing among
concurrent migrations as the first-order effect an orchestrator must model
— and both argue the model must be topology-aware once the fleet outgrows
a single flat link. This module provides that model:

  * ``Topology`` — hosts mapped to the *access* links their migration
    traffic traverses, plus optional *shared* links (a core uplink) that
    are crossed only when a transfer leaves its access domain.  Factories:
    ``single_link`` (the paper's shared migration network), ``star``
    (per-host access links + core), ``multi_rack`` (per-rack access links
    + core — the sharded-fabric substrate), and ``pod_spine`` — the
    3-tier hierarchical fabric::

        spine tier      spine:s0          spine:s1       (one link per
                        /      \\          /      \\        spine plane)
        pod tier   pod:p0s0 pod:p1s0  pod:p0s1 pod:p1s1  (per-pod uplink
                        |        |        |        |      per plane)
        access    acc:p0r0 acc:p0r1  acc:p1r0 acc:p1r1   (ToR per rack)
                    |   |    |   |     |   |    |   |
        hosts     p0r0h*  p0r1h*    p1r0h*   p1r1h*

    Cross-pod traffic picks ONE spine plane m and traverses
    ``acc -> pod:p_src s_m -> spine:s_m -> pod:p_dst s_m -> acc``;
    intra-pod cross-rack traffic crosses one pod uplink; intra-rack
    traffic only its ToR. Every (src, dst) pair therefore exposes
    ``n_spines`` *candidate routes* (``Topology.routes``) — the route
    axis the admission controller sweeps — with ``path()`` pinned to
    route 0 (the fixed-shortest-path baseline). Per-tier
    oversubscription shrinks pod uplinks and spines relative to the
    access capacity below them.
  * ``fair_share`` — max-min fair bandwidth allocation across concurrent
    transfers via progressive filling (water-filling): repeatedly find the
    most-contended link, freeze every flow crossing it at that link's equal
    share, and redistribute the slack to the remaining flows.
    ``fair_share_dense`` is the same algorithm over a precomputed link x
    lane incidence matrix — the migration plane's per-event hot path.
    ``fair_share_masked`` batches K *scenarios* (lane subsets of one
    incidence) through one stacked filling — the adaptive controller's
    defer-k prefix sweep solves all n+1 "launch the first k" batches in a
    single call.
  * ``LinkUnionFind`` — path-compressed, size-balanced union-find over
    link ids with a per-root link-membership set. Migration domains are
    connected components of "shares a link"; the fabric and the adaptive
    controller both key them by link through this structure, so a
    launch/merge is O(alpha) instead of a scan over every live domain
    (or, in the controller's old grouping, O(n^2) pairwise set
    intersections).

Migration domains: two transfers interact iff their paths share a link.
Because shared (core) links are only on *cross-domain* paths, transfers
confined to disjoint access links form independent domains — the sharded
execution fabric (``core/fabric.py``) advances each domain's event loop
separately, and a domain's trajectory is bit-equal to running it alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, \
    Set, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Link:
    link_id: str
    capacity: float                     # bytes/s


class Topology:
    """Host -> migration-link mapping with per-link capacities.

    ``host_links`` maps each host to its access links; ``shared_links``
    (e.g. a core uplink) are traversed only when source and destination
    have *different* access links — intra-domain transfers never touch
    the core.  Hosts absent from ``host_links`` fall back to
    ``default_path`` (for the common "one shared migration network" model
    this means every migration, tagged or not, contends on the same link).

    ``path(src, dst)`` returns the tuple of link ids a migration from
    ``src`` to ``dst`` traverses; the plane charges the transfer against
    every link on the path.
    """

    def __init__(self, links: Sequence[Link],
                 host_links: Dict[str, Tuple[str, ...]] | None = None,
                 default_path: Tuple[str, ...] = (),
                 shared_links: Tuple[str, ...] = (),
                 route_map: Mapping[Tuple[Tuple[str, ...], Tuple[str, ...]],
                                   Sequence[Sequence[str]]] | None = None,
                 link_tiers: Mapping[str, int] | None = None,
                 pods: Mapping[str, str] | None = None):
        self.links: Dict[str, Link] = {l.link_id: l for l in links}
        self.host_links = dict(host_links or {})
        self.default_path = tuple(default_path)
        self.shared_links = tuple(shared_links)
        # (src_access_sig, dst_access_sig) -> candidate routes; route 0 is
        # the canonical fixed-shortest path that ``path()`` returns.
        self.route_map: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]],
                             Tuple[Tuple[str, ...], ...]] = {
            (tuple(ks), tuple(kd)): tuple(tuple(p) for p in v)
            for (ks, kd), v in (route_map or {}).items()}
        self.link_tiers = dict(link_tiers or {})   # link -> 0 acc/1 pod/2 spine
        self._pods = dict(pods or {})              # host -> pod id
        for h, ls in self.host_links.items():
            for l in ls:
                if l not in self.links:
                    raise KeyError(f"host {h!r} references unknown link {l!r}")
        for l in self.shared_links:
            if l not in self.links:
                raise KeyError(f"unknown shared link {l!r}")
        for key, routes in self.route_map.items():
            if not routes:
                raise ValueError(f"route_map entry {key!r} has no routes")
            for p in routes:
                for l in p:
                    if l not in self.links:
                        raise KeyError(
                            f"route_map entry {key!r} references unknown "
                            f"link {l!r}")
        for l in self.link_tiers:
            if l not in self.links:
                raise KeyError(f"link_tiers references unknown link {l!r}")
        # Precomputed lookup tables (the dict walks stay as the parity
        # oracle; hot callers go through integer link ids).
        self.link_ids: Dict[str, int] = {
            l: i for i, l in enumerate(self.links)}
        self._caps_vec = np.asarray(
            [l.capacity for l in self.links.values()], np.float64)
        self._access_cache: Dict[str, Tuple[str, ...]] = {}
        self._routes_cache: Dict[Tuple[str, str],
                                 Tuple[Tuple[str, ...], ...]] = {}
        self._ids_cache: Dict[Tuple[str, ...], Optional[np.ndarray]] = {}

    @property
    def capacities(self) -> Dict[str, float]:
        return {i: l.capacity for i, l in self.links.items()}

    def set_capacity(self, link_id: str, capacity: float) -> None:
        """Mutate one link's capacity in place (fault injection: a
        degraded or failed link keeps its identity — paths and domain
        membership are unchanged — but fair shares recompute against the
        new value; 0.0 freezes the link's flows at share 0). Live planes
        snapshot ``capacities`` at construction, so callers push the
        change through ``MigrationPlane.set_link_capacity`` /
        ``ShardedPlane.set_link_capacity``, which route here."""
        old = self.links[link_id]          # KeyError on unknown links
        self.links[link_id] = Link(old.link_id, float(capacity))
        self._caps_vec[self.link_ids[link_id]] = float(capacity)

    def access_of(self, host: str) -> Tuple[str, ...]:
        """The host's access links — its migration-domain signature."""
        hit = self._access_cache.get(host)
        if hit is None:
            hit = tuple(l for l in self.host_links.get(host,
                                                       self.default_path)
                        if l not in self.shared_links)
            self._access_cache[host] = hit
        return hit

    def path(self, src: str, dst: str) -> Tuple[str, ...]:
        """Links traversed by a src->dst migration (order-stable dedup).
        Shared links are included only when the endpoints live in
        different access domains. On routed topologies this is route 0 of
        ``routes(src, dst)`` — the fixed-shortest-path baseline."""
        a_src, a_dst = self.access_of(src), self.access_of(dst)
        routed = self.route_map.get((a_src, a_dst))
        if routed is not None:
            return routed[0]
        out: List[str] = []
        seq = (a_src + (self.shared_links if a_src != a_dst else ())
               + a_dst)
        for l in seq:
            if l not in out:
                out.append(l)
        if not out:
            out = list(self.default_path)
        return tuple(out)

    def routes(self, src: str, dst: str) -> Tuple[Tuple[str, ...], ...]:
        """All candidate routes for a src->dst migration. Route 0 is the
        canonical ``path()``; unrouted pairs expose exactly one route."""
        key = (src, dst)
        hit = self._routes_cache.get(key)
        if hit is None:
            a_src, a_dst = self.access_of(src), self.access_of(dst)
            hit = self.route_map.get((a_src, a_dst))
            if hit is None:
                hit = (self.path(src, dst),)
            self._routes_cache[key] = hit
        return hit

    def n_routes(self) -> int:
        """Maximum candidate-route count over all pairs (1 when flat)."""
        return max((len(r) for r in self.route_map.values()), default=1)

    def pod_of(self, host: str) -> Optional[str]:
        """Pod id of ``host`` (None on non-hierarchical topologies)."""
        return self._pods.get(host)

    def tier_of(self, link: str) -> int:
        """Fabric tier of ``link``: 0 access/ToR, 1 pod, 2 spine.
        Links without an explicit tier are access."""
        return self.link_tiers.get(link, 0)

    # -- precomputed link-id tables (hot-path mirrors of the dict walks) --
    def caps_vector(self) -> np.ndarray:
        """Capacity per ``link_ids`` index, kept in sync by
        ``set_capacity``. The returned array is live — callers that
        snapshot capacities must copy."""
        return self._caps_vec

    def ids_of(self, path: Sequence[str]) -> Optional[np.ndarray]:
        """``path`` as an integer link-index array (cached), or None when
        any link is unknown — the caller falls back to the dict walk."""
        key = tuple(path)
        hit = self._ids_cache.get(key, False)
        if hit is False:
            try:
                hit = np.asarray([self.link_ids[l] for l in key], np.intp)
            except KeyError:
                hit = None
            self._ids_cache[key] = hit
        return hit

    def path_ids(self, src: str, dst: str) -> Optional[np.ndarray]:
        """Precomputed link-index array of ``path(src, dst)``."""
        return self.ids_of(self.path(src, dst))

    def route_ids(self, src: str, dst: str
                  ) -> Tuple[Optional[np.ndarray], ...]:
        """Per-route link-index arrays of ``routes(src, dst)``."""
        return tuple(self.ids_of(p) for p in self.routes(src, dst))

    # -- factories -----------------------------------------------------------
    @classmethod
    def single_link(cls, capacity: float,
                    link_id: str = "migration-net") -> "Topology":
        """The paper's testbed: one shared migration network for everyone."""
        return cls([Link(link_id, capacity)], default_path=(link_id,))

    @classmethod
    def star(cls, hosts: Sequence[str], access_capacity: float,
             core_capacity: float | None = None) -> "Topology":
        """Per-host access links, optionally through a shared core link.
        Cross-host transfers traverse src access -> core -> dst access;
        same-host transfers stay on the host's access link."""
        links = [Link(f"acc:{h}", access_capacity) for h in hosts]
        host_links = {h: (f"acc:{h}",) for h in hosts}
        shared: Tuple[str, ...] = ()
        if core_capacity is not None:
            links.append(Link("core", core_capacity))
            shared = ("core",)
        return cls(links, host_links, shared_links=shared)

    @classmethod
    def multi_rack(cls, racks: Union[int, Mapping[str, Sequence[str]]],
                   access_capacity: float,
                   core_capacity: float | None = None, *,
                   hosts_per_rack: int = 4) -> "Topology":
        """Rack-level access (ToR) links plus an optional shared core —
        the sharded-fabric substrate. ``racks`` is either a mapping
        ``{rack_id: [host, ...]}`` or an int (auto-named ``r{i}h{j}``).
        Intra-rack migrations contend only on their rack link; cross-rack
        migrations additionally cross the core."""
        if isinstance(racks, int):
            racks = {f"r{i}": [f"r{i}h{j}" for j in range(hosts_per_rack)]
                     for i in range(racks)}
        links = [Link(f"acc:{r}", access_capacity) for r in racks]
        host_links = {h: (f"acc:{r}",)
                      for r, hs in racks.items() for h in hs}
        shared: Tuple[str, ...] = ()
        if core_capacity is not None:
            links.append(Link("core", core_capacity))
            shared = ("core",)
        return cls(links, host_links, shared_links=shared)

    @classmethod
    def pod_spine(cls, pods: int, racks_per_pod: int,
                  hosts_per_rack: int = 2, *,
                  access_capacity: float,
                  pod_oversubscription: float = 1.0,
                  spine_oversubscription: float = 1.0,
                  n_spines: int = 2) -> "Topology":
        """3-tier access -> pod -> spine fabric with per-tier
        oversubscription and multi-path routing (module docstring diagram).

        Hosts ``p{i}r{j}h{k}`` hang off per-rack ToR links
        ``acc:p{i}r{j}`` at ``access_capacity``. Each pod owns one uplink
        per spine plane, ``pod:p{i}s{m}``; a pod's aggregate uplink
        capacity is ``racks_per_pod * access / pod_oversubscription``,
        split evenly across the planes. Each plane's spine link
        ``spine:s{m}`` carries ``pods * uplink / spine_oversubscription``.
        1:1 oversubscription is non-blocking at each tier boundary; 1:4
        means the tier above admits a quarter of the capacity below it.

        Every distinct-rack (src, dst) pair exposes ``n_spines`` candidate
        routes — route m rides plane m end to end (intra-pod: ToR ->
        pod uplink m -> ToR; cross-pod: additionally spine m and the
        destination pod's plane-m uplink). Same-rack pairs have the single
        ToR route. ``path()`` pins route 0 (the fixed-shortest-path
        baseline the route-aware controller is benchmarked against).
        """
        if pods < 1 or racks_per_pod < 1 or n_spines < 1:
            raise ValueError("pods, racks_per_pod, n_spines must be >= 1")
        uplink = racks_per_pod * access_capacity / (
            pod_oversubscription * n_spines)
        spine_cap = pods * uplink / spine_oversubscription
        links = []
        host_links: Dict[str, Tuple[str, ...]] = {}
        tiers: Dict[str, int] = {}
        pod_map: Dict[str, str] = {}
        rack_of: Dict[Tuple[int, int], str] = {}
        for i in range(pods):
            for j in range(racks_per_pod):
                acc = f"acc:p{i}r{j}"
                links.append(Link(acc, access_capacity))
                tiers[acc] = 0
                rack_of[(i, j)] = acc
                for k in range(hosts_per_rack):
                    h = f"p{i}r{j}h{k}"
                    host_links[h] = (acc,)
                    pod_map[h] = f"p{i}"
        for i in range(pods):
            for m in range(n_spines):
                up = f"pod:p{i}s{m}"
                links.append(Link(up, uplink))
                tiers[up] = 1
        for m in range(n_spines):
            sp = f"spine:s{m}"
            links.append(Link(sp, spine_cap))
            tiers[sp] = 2
        route_map: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]],
                        Tuple[Tuple[str, ...], ...]] = {}
        for (pi, ri), a_src in rack_of.items():
            for (pj, rj), a_dst in rack_of.items():
                if a_src == a_dst:
                    continue
                if pi == pj:               # intra-pod, cross-rack
                    routes = tuple(
                        (a_src, f"pod:p{pi}s{m}", a_dst)
                        for m in range(n_spines))
                else:                      # cross-pod: one plane end to end
                    routes = tuple(
                        (a_src, f"pod:p{pi}s{m}", f"spine:s{m}",
                         f"pod:p{pj}s{m}", a_dst)
                        for m in range(n_spines))
                route_map[((a_src,), (a_dst,))] = routes
        return cls(links, host_links, route_map=route_map,
                   link_tiers=tiers, pods=pod_map)


def fair_share(paths: Sequence[Sequence[str]],
               capacities: Dict[str, float]) -> np.ndarray:
    """Max-min fair rates (bytes/s) for concurrent flows over shared links.

    Progressive filling: every flow's rate grows uniformly until some link
    saturates; flows crossing the saturated link freeze at that share, the
    rest keep growing on the slack. A flow with an empty path is
    unconstrained and gets ``inf`` (the caller decides what that means).
    """
    n = len(paths)
    rates = np.zeros(n)
    frozen = np.zeros(n, bool)
    members: Dict[str, List[int]] = {}
    for i, p in enumerate(paths):
        for l in dict.fromkeys(p):          # dedup, keep order
            members.setdefault(l, []).append(i)
    while True:
        bottleneck = None
        for l, idxs in members.items():
            live = [i for i in idxs if not frozen[i]]
            if not live:
                continue
            rem = capacities[l] - float(rates[idxs].sum())
            share = max(rem, 0.0) / len(live)
            if bottleneck is None or share < bottleneck[0]:
                bottleneck = (share, l)
        if bottleneck is None:
            break
        share, l = bottleneck
        for i in members[l]:
            if not frozen[i]:
                rates[i] = share
                frozen[i] = True
    rates[~frozen] = np.inf                 # flows crossing no link
    return rates


def fair_share_ids(path_ids: Sequence[Optional[np.ndarray]],
                   caps_vec: np.ndarray) -> np.ndarray:
    """``fair_share`` over precomputed integer link-index arrays
    (``Topology.ids_of``) instead of link-name tuples.

    Same progressive filling, same member insertion order, same
    summation (``rates[idxs].sum()`` over the identical index lists) —
    bit-parity with the dict oracle is by construction, and the planes'
    probe hot paths skip the per-call name hashing and path dict walks.
    A lane whose ids are ``None`` (or empty) is unconstrained -> ``inf``.
    """
    n = len(path_ids)
    rates = np.zeros(n)
    frozen = np.zeros(n, bool)
    members: Dict[int, List[int]] = {}
    for i, p in enumerate(path_ids):
        if p is None:
            continue
        for l in dict.fromkeys(int(x) for x in p):
            members.setdefault(l, []).append(i)
    while True:
        bottleneck = None
        for l, idxs in members.items():
            live = [i for i in idxs if not frozen[i]]
            if not live:
                continue
            rem = float(caps_vec[l]) - float(rates[idxs].sum())
            share = max(rem, 0.0) / len(live)
            if bottleneck is None or share < bottleneck[0]:
                bottleneck = (share, l)
        if bottleneck is None:
            break
        share, l = bottleneck
        for i in members[l]:
            if not frozen[i]:
                rates[i] = share
                frozen[i] = True
    rates[~frozen] = np.inf
    return rates


class DenseFairShare:
    """Reusable max-min fair-share solver over a fixed (L, M) incidence.

    The same progressive-filling algorithm as ``fair_share`` — identical
    bottleneck selection order (first minimum in link order); per-link
    sums run over the dense lane axis, so results can differ from the
    sparse version by float summation order (ULPs) only when three or
    more flows tie. All scratch arrays are preallocated and every step is
    an in-place ufunc or a matmul into a buffer: this sits on the
    migration plane's per-event hot path, where numpy dispatch and
    temporaries dominate at fleet lane counts. The returned rates array
    is a reused buffer — callers consume it before the next call. Lanes
    crossing no link get ``inf``.
    """

    def __init__(self, incidence: np.ndarray, capacities: np.ndarray):
        self.inc = np.ascontiguousarray(incidence, np.float64)
        self.caps = np.asarray(capacities, np.float64)
        n_links, m = self.inc.shape
        self.rates = np.empty(m)
        self._live = np.empty(m)           # 1.0 while unfrozen
        self._unfrozen = np.empty(m, bool)
        self._mask = np.empty(m, bool)
        self._n_live = np.empty(n_links)
        self._used = np.empty(n_links)
        self._share = np.empty(n_links)
        self._empty = np.empty(n_links, bool)
        self._occupied = np.empty(n_links, bool)

    def __call__(self) -> np.ndarray:
        inc, caps, rates, live = self.inc, self.caps, self.rates, self._live
        if inc.shape[0] == 0:           # no links at all: every lane is
            rates.fill(np.inf)          # unconstrained (the caller's
            return rates                # fallback bandwidth applies)
        rates.fill(0.0)
        live.fill(1.0)
        while True:
            np.matmul(inc, live, out=self._n_live)
            np.matmul(inc, rates, out=self._used)
            np.subtract(caps, self._used, out=self._share)
            np.maximum(self._share, 0.0, out=self._share)
            np.less_equal(self._n_live, 0.0, out=self._empty)
            np.logical_not(self._empty, out=self._occupied)
            np.divide(self._share, self._n_live, out=self._share,
                      where=self._occupied)
            np.copyto(self._share, np.inf, where=self._empty)
            l = int(np.argmin(self._share))
            s = float(self._share[l])
            if not np.isfinite(s):
                break
            np.greater(live, 0.0, out=self._unfrozen)
            np.greater(inc[l], 0.0, out=self._mask)
            np.logical_and(self._mask, self._unfrozen, out=self._mask)
            np.copyto(rates, s, where=self._mask)
            np.copyto(live, 0.0, where=self._mask)
        np.greater(live, 0.0, out=self._unfrozen)
        np.copyto(rates, np.inf, where=self._unfrozen)
        return rates


def fair_share_dense(incidence: np.ndarray, capacities: np.ndarray
                     ) -> np.ndarray:
    """One-shot ``DenseFairShare`` (tests / callers without a cached
    incidence); the plane holds a solver instance instead."""
    return DenseFairShare(incidence, capacities)().copy()


# Auto-switch ``fair_share_masked`` to the CSR-style path once the dense
# (K, M) x (M, L) matmuls touch this many cells per round. High enough
# that every flat-fabric test/benchmark stays on the dense path
# bit-unchanged; tall 3-tier sweeps (pods x racks x spines links, many
# (lane, route) columns) cross it.
_SPARSE_CELLS = 1 << 18


def _fair_share_masked_sparse(inc: np.ndarray, caps: np.ndarray,
                              active: np.ndarray) -> np.ndarray:
    """CSR-style ``fair_share_masked``: per-link member-column index
    arrays replace the dense matmuls, so each filling round touches only
    the columns that actually cross a link — the win once the incidence
    is tall and sparse (a 3-tier fabric's lanes each cross <= 5 of
    hundreds of links). Same per-scenario arithmetic and first-minimum
    bottleneck order as the dense path; results can differ from dense by
    float summation order (ULPs) only, and match the python
    ``fair_share`` summation exactly when a scenario's active columns are
    a prefix (per-link sums run over ascending member columns)."""
    k_n, m = active.shape
    n_links = inc.shape[0]
    cols = [np.flatnonzero(inc[l] > 0.0) for l in range(n_links)]
    rates = np.zeros((k_n, m))
    live = active.astype(np.float64)
    n_live = np.empty((k_n, n_links))
    share = np.empty((k_n, n_links))
    occupied = np.empty((k_n, n_links), bool)
    rows = np.arange(k_n)
    while True:
        for l in range(n_links):
            c = cols[l]
            n_live[:, l] = live[:, c].sum(axis=1)
            share[:, l] = caps[l] - rates[:, c].sum(axis=1)
        np.maximum(share, 0.0, out=share)
        np.greater(n_live, 0.0, out=occupied)
        np.divide(share, n_live, out=share, where=occupied)
        np.copyto(share, np.inf, where=~occupied)
        l_star = np.argmin(share, axis=1)
        s = share[rows, l_star]
        open_k = np.isfinite(s)
        if not open_k.any():
            break
        for k in np.flatnonzero(open_k):
            c = cols[l_star[k]]
            sel = c[live[k, c] > 0.0]
            rates[k, sel] = s[k]
            live[k, sel] = 0.0
    rates[live > 0.0] = np.inf
    return rates


def fair_share_masked(incidence: np.ndarray, capacities: np.ndarray,
                      active: np.ndarray, *,
                      sparse: Optional[bool] = None) -> np.ndarray:
    """Max-min fair shares for K lane subsets of ONE (L, M) incidence.

    ``active`` is a (K, M) bool mask: row k is an independent progressive-
    filling scenario over the lanes it selects (the other columns are
    absent — zero demand, zero membership). Returns (K, M) rates: inactive
    lanes get 0, active lanes crossing no link get ``inf``.

    This is the stacked solver behind the defer-k prefix sweep: the n+1
    nested "launch the first k candidates" batches differ only in their
    active mask, so every per-scenario quantity — per-link live-lane
    counts, committed bandwidth, the candidate share — is one (K, L) ufunc
    or matmul, and each iteration freezes at least one link per open
    scenario (<= L+1 iterations total, vs K full solves).

    Per scenario the arithmetic is per-link-local, exactly as in
    ``DenseFairShare``: a link's remaining capacity and live count involve
    only its member lanes, so the values a scenario's lanes freeze at do
    not depend on which other scenarios (or which disjoint sub-components)
    share the call.

    ``sparse`` switches to the CSR-style per-link member-array path
    (``None`` auto-picks it once the dense matmuls would sweep
    ``_SPARSE_CELLS`` incidence cells per round — tall 3-tier fabrics;
    flat fabrics keep the dense path bit-unchanged).
    """
    inc = np.ascontiguousarray(incidence, np.float64)
    caps = np.asarray(capacities, np.float64)
    active = np.asarray(active, bool)
    k_n, m = active.shape
    n_links = inc.shape[0]
    rates = np.zeros((k_n, m))
    if n_links == 0:                     # no links: every active lane is
        rates[active] = np.inf           # unconstrained
        return rates
    if sparse is None:
        sparse = n_links >= 32 and k_n * m >= _SPARSE_CELLS
    if sparse:
        return _fair_share_masked_sparse(inc, caps, active)
    live = active.astype(np.float64)
    inc_t = np.ascontiguousarray(inc.T)              # (M, L)
    n_live = np.empty((k_n, n_links))
    used = np.empty((k_n, n_links))
    share = np.empty((k_n, n_links))
    occupied = np.empty((k_n, n_links), bool)
    mask = np.empty((k_n, m), bool)
    rows = np.arange(k_n)
    while True:
        np.matmul(live, inc_t, out=n_live)
        np.matmul(rates, inc_t, out=used)
        np.subtract(caps, used, out=share)
        np.maximum(share, 0.0, out=share)
        np.greater(n_live, 0.0, out=occupied)
        np.divide(share, n_live, out=share, where=occupied)
        np.copyto(share, np.inf, where=~occupied)
        l_star = np.argmin(share, axis=1)            # (K,) per-scenario
        s = share[rows, l_star]                      # bottleneck share
        open_k = np.isfinite(s)
        if not open_k.any():
            break
        # freeze each open scenario's bottleneck members at its share
        np.greater(inc[l_star], 0.0, out=mask)       # gather rows: (K, M)
        np.logical_and(mask, live > 0.0, out=mask)
        np.logical_and(mask, open_k[:, None], out=mask)
        np.copyto(rates, s[:, None], where=mask)
        np.copyto(live, 0.0, where=mask)
    rates[live > 0.0] = np.inf           # active lanes crossing no link
    return rates


def build_incidence(paths: Sequence[Sequence[str]],
                    capacities: Dict[str, float]
                    ) -> Tuple[np.ndarray, np.ndarray, List[str],
                               Dict[str, int]]:
    """First-appearance link order, (L, M) 0/1 incidence, capacity
    vector, and link->row map for ``paths`` — the ONE construction behind
    both the migration plane's cached banks and the stacked prefix sweep
    (their bit-parity depends on sharing the same dedup/ordering)."""
    order = list(dict.fromkeys(l for p in paths for l in p))
    row = {l: i for i, l in enumerate(order)}
    inc = np.zeros((len(order), len(paths)))
    for j, p in enumerate(paths):
        for l in dict.fromkeys(p):
            inc[row[l], j] = 1.0
    return inc, np.asarray([capacities[l] for l in order]), order, row


def what_if_prefix_shares(base_paths: Sequence[Sequence[str]],
                          fixed_paths: Sequence[Sequence[str]],
                          cand_paths: Sequence[Sequence[str]],
                          capacities: Dict[str, float],
                          fallback_bw: float) -> np.ndarray:
    """Fair shares of all n+1 nested defer-k launch batches in one solve.

    Row k of the returned (n+1, F+n) array holds the max-min shares the F
    ``fixed_paths`` lanes plus the first k ``cand_paths`` lanes would
    realize against the ``base_paths`` lanes already in flight — i.e. the
    answers of n+1 ``fair_share(base + fixed + cand[:k])`` calls, read
    from ONE (L, M) incidence with one ``fair_share_masked`` invocation.
    Active lanes crossing no link get ``fallback_bw``; columns past F+k
    are inactive in row k and read 0.
    """
    paths = [tuple(p) for p in base_paths] + [tuple(p) for p in fixed_paths]
    cand = [tuple(p) for p in cand_paths]
    n_base_fixed, n = len(paths), len(cand)
    paths += cand
    inc, caps_vec, _, _ = build_incidence(paths, capacities)
    active = np.zeros((n + 1, len(paths)), bool)
    active[:, :n_base_fixed] = True
    # row k launches candidates 0..k-1
    active[:, n_base_fixed:] = np.tril(np.ones((n + 1, n), bool), -1)
    shares = fair_share_masked(inc, caps_vec, active)[:, len(base_paths):]
    return np.where(np.isfinite(shares), shares, fallback_bw)


def what_if_subset_shares(base_paths: Sequence[Sequence[str]],
                          fixed_paths: Sequence[Sequence[str]],
                          cand_paths: Sequence[Sequence[str]],
                          masks, capacities: Dict[str, float],
                          fallback_bw: float) -> np.ndarray:
    """Fair shares of K arbitrary candidate subsets in one stacked solve,
    base columns INCLUDED.

    Row k of the returned (K, B + F + n) array holds the max-min shares of
    every ``base_paths`` lane (already in flight), every ``fixed_paths``
    lane, and the ``cand_paths`` lanes selected by ``masks[k]`` — i.e. the
    answer of ``fair_share(base + fixed + [cand[j] for j in masks[k]])``,
    K scenarios over ONE (L, M) incidence. The receding-horizon admission
    sweep needs both generalizations over ``what_if_prefix_shares``: the
    kept base columns let it reprice mid-flight lanes under each
    hypothetical admission, and arbitrary masks price non-prefix subsets
    (queue-order AND benefit-order prefixes in one call). Active lanes
    crossing no link get ``fallback_bw``; inactive columns read 0.
    """
    masks = np.asarray(masks, bool)
    k_n, n = masks.shape
    paths = ([tuple(p) for p in base_paths]
             + [tuple(p) for p in fixed_paths]
             + [tuple(p) for p in cand_paths])
    if len(cand_paths) != n:
        raise ValueError(f"{n}-wide masks for {len(cand_paths)} candidates")
    n_bf = len(base_paths) + len(fixed_paths)
    if not paths:
        return np.zeros((k_n, 0))
    inc, caps_vec, _, _ = build_incidence(paths, capacities)
    active = np.concatenate([np.ones((k_n, n_bf), bool), masks], axis=1)
    shares = fair_share_masked(inc, caps_vec, active)
    return np.where(np.isfinite(shares), shares, fallback_bw)


def pair_active_mask(n_base: int, n_fixed: int, n_pairs: int) -> np.ndarray:
    """The (n_pairs, n_base + n_fixed + n_pairs) scenario mask of the
    route sweep: row j activates every base/fixed lane plus exactly pair
    column j — one (candidate, route) hypothesis per scenario, so each
    route is priced against the in-flight set without seeing its
    siblings. Exposed so tests can assert one-route-per-lane validity."""
    n_bf = n_base + n_fixed
    active = np.zeros((n_pairs, n_bf + n_pairs), bool)
    active[:, :n_bf] = True
    active[:, n_bf:] = np.eye(n_pairs, dtype=bool)
    return active


def what_if_pair_shares(base_paths: Sequence[Sequence[str]],
                        fixed_paths: Sequence[Sequence[str]],
                        pair_paths: Sequence[Sequence[str]],
                        capacities: Dict[str, float],
                        fallback_bw: float) -> np.ndarray:
    """Fair share each (candidate, route) pair would realize on its own
    against the in-flight + forced lanes — all P pairs in ONE solve.

    ``pair_paths`` flattens the (candidate, route) axis: entry j is one
    candidate lane routed one particular way. Scenario j solves
    ``fair_share(base + fixed + [pair_paths[j]])`` — the same per-pair
    sparse call the reference route sweep makes — but all P scenarios
    share one (L, M) incidence and one ``fair_share_masked`` stacked
    filling (mask from ``pair_active_mask``). Returns the (P,) diagonal:
    pair j's share in scenario j, ``fallback_bw`` where unconstrained.
    """
    n_pairs = len(pair_paths)
    if n_pairs == 0:
        return np.zeros(0)
    paths = ([tuple(p) for p in base_paths]
             + [tuple(p) for p in fixed_paths]
             + [tuple(p) for p in pair_paths])
    n_bf = len(base_paths) + len(fixed_paths)
    inc, caps_vec, _, _ = build_incidence(paths, capacities)
    active = pair_active_mask(len(base_paths), len(fixed_paths), n_pairs)
    shares = fair_share_masked(inc, caps_vec, active)
    diag = shares[np.arange(n_pairs), n_bf + np.arange(n_pairs)]
    return np.where(np.isfinite(diag), diag, fallback_bw)


class LinkUnionFind:
    """Path-compressed, size-balanced union-find over link ids, with a
    per-root membership set (the links of each component).

    Migration domains are connected components of the "shares a link"
    relation; keying them by link makes domain lookup/merge O(alpha):
    ``ShardedPlane`` resolves a launch path to its domains with one
    ``find`` per link (instead of scanning every live domain's link set)
    and the adaptive controller's candidate grouping unions paths in
    near-linear time (instead of quadratic pairwise set intersections).
    Components can be deleted wholesale (``pop_component``) — the fabric
    dissolves a domain when its lanes drain.
    """

    __slots__ = ("_parent", "_size", "_links")

    def __init__(self) -> None:
        self._parent: Dict[str, str] = {}
        self._size: Dict[str, int] = {}
        self._links: Dict[str, Set[str]] = {}

    def add(self, link: str) -> str:
        """Register ``link`` as a singleton component (no-op if present);
        returns its root."""
        if link not in self._parent:
            self._parent[link] = link
            self._size[link] = 1
            self._links[link] = {link}
            return link
        return self.find(link)

    def find(self, link: str) -> Optional[str]:
        """Root of ``link``'s component (None if unregistered), with
        path compression."""
        parent = self._parent
        root = parent.get(link)
        if root is None:
            return None
        while parent[root] != root:
            root = parent[root]
        while parent[link] != root:      # compress
            parent[link], link = root, parent[link]
        return root

    def union(self, a: str, b: str) -> str:
        """Join the components of ``a`` and ``b`` (registering either as
        needed); returns the merged root. Size-balanced: the smaller
        root's membership set folds into the larger's."""
        ra, rb = self.add(a), self.add(b)
        if ra == rb:
            return ra
        if self._size[ra] < self._size[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        self._size[ra] += self._size.pop(rb)
        self._links[ra] |= self._links.pop(rb)
        return ra

    def union_path(self, path: Iterable[str]) -> Optional[str]:
        """Union every link of ``path`` into one component; returns its
        root (None for an empty path)."""
        root: Optional[str] = None
        for l in path:
            root = self.add(l) if root is None else self.union(root, l)
        return root

    def pop_component(self, link: str) -> Set[str]:
        """Delete ``link``'s entire component (a drained domain's links
        revert to unregistered); returns the removed membership set."""
        root = self.find(link)
        if root is None:
            return set()
        links = self._links.pop(root)
        for l in links:
            del self._parent[l]
        del self._size[root]
        return links
