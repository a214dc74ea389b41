"""Server-consolidation planner (paper §3.3) — the upstream policy whose
migration plans ALMA intercepts.

First-fit-decreasing heuristics (the paper notes heuristics dominate in
practice for scalability): given per-job loads and host capacities, pack
jobs onto the fewest hosts; every job that must move becomes a
MigrationRequest tagged with its src/dst hosts, which the migration fabric
resolves to network links. ALMA does not modify this policy — it only
re-times its requests (Fig. 2/5c).

Contention-aware packing: on a sharded fabric (``network.Topology.star`` /
``multi_rack``) two packings with the SAME host count can have wildly
different migration bills — one keeps every move inside its rack, the
other funnels the whole fleet through the core. When a ``topology`` is
passed, ``consolidate_ffd`` generates several candidate packings (classic
FFD, rack-affinity FFD that prefers destinations sharing the job's access
links, and a stay-first variant that avoids moves entirely when the
current host fits) and scores each by

  ``(hosts used,  predicted contended bytes,  predicted summed time)``

lexicographically — consolidation remains the primary objective, but ties
break on the *predicted contended migration cost*: every planned
transfer's max-min fair share over the topology
(``network.fair_share``) feeds ``strunk.expected_cost_batch``, so a plan
that would melt the core loses to one that migrates rack-locally. Without
a topology the classic FFD plan is returned unchanged.

On hierarchical fabrics (``Topology.pod_spine``) the byte term is
*tier-weighted*: a transfer's bytes are scaled by the highest fabric tier
its path climbs to (``TIER_WEIGHTS`` — spine bytes cost 4x ToR bytes,
pod-uplink bytes 2x), because oversubscribed upper tiers are the scarce,
fleet-shared resource. Two extra pod-affinity candidate packings (same
rack first, then same pod, then the rest) join the sweep so a plan that
keeps moves under one pod can actually win that scoring. Flat topologies
have every link at tier 0 — weighted bytes equal raw bytes and the
pre-existing behavior is unchanged.

``Placement.host_of`` is on the per-request path of every consolidation
event; it is backed by a job->host index maintained by ``assign``/``move``
(the FFD packer places through ``assign``), not a linear scan over hosts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import network, strunk
from repro_torch.core.orchestrator import MigrationRequest


@dataclass
class Host:
    host_id: str
    capacity: float                    # abstract load units (e.g. chips)
    jobs: Dict[str, float] = field(default_factory=dict)

    @property
    def load(self) -> float:
        return sum(self.jobs.values())

    @property
    def free(self) -> float:
        return self.capacity - self.load


@dataclass
class Placement:
    hosts: Dict[str, Host]
    _index: Dict[str, str] = field(default_factory=dict, repr=False,
                                   compare=False)

    def __post_init__(self):
        self._index = {j: h.host_id for h in self.hosts.values()
                       for j in h.jobs}

    def host_of(self, job_id: str) -> Optional[str]:
        return self._index.get(job_id)

    def assign(self, job_id: str, host_id: str, load: float) -> None:
        """Place a job on a host, keeping the job->host index in sync."""
        self.hosts[host_id].jobs[job_id] = load
        self._index[job_id] = host_id

    def move(self, job_id: str, dst: str) -> None:
        """Apply a completed migration: relocate the job to ``dst``."""
        src = self._index.get(job_id)
        if src is None or src == dst:
            return
        load = self.hosts[src].jobs.pop(job_id)
        self.hosts[dst].jobs[job_id] = load
        self._index[job_id] = dst


def _pack(placement: Placement, now: float,
          state_bytes: Dict[str, float],
          host_order_for=None, stay_first: bool = False
          ) -> Tuple[Placement, List[MigrationRequest]]:
    """One FFD pass. ``host_order_for(src)`` returns the candidate-host
    scan order for a job currently on ``src`` (None -> most-loaded-first
    for every job — classic FFD); ``stay_first`` tries the job's current
    host before any other."""
    jobs: List[Tuple[str, float, str]] = []
    for h in placement.hosts.values():
        for j, load in h.jobs.items():
            jobs.append((j, load, h.host_id))
    jobs.sort(key=lambda t: -t[1])

    default_order = [h.host_id for h in
                     sorted(placement.hosts.values(), key=lambda h: -h.load)]
    new_p = Placement({hid: Host(hid, placement.hosts[hid].capacity)
                       for hid in default_order})
    plan: List[MigrationRequest] = []

    for job_id, load, src in jobs:
        order = list(host_order_for(src)) if host_order_for else \
            list(default_order)
        if stay_first and src in order:
            order.remove(src)
            order.insert(0, src)
        for hid in order:
            h = new_p.hosts[hid]
            if h.free >= load:
                new_p.assign(job_id, hid, load)
                if hid != src:
                    plan.append(MigrationRequest(
                        job_id=job_id, created_at=now,
                        v_bytes=state_bytes.get(job_id, 0.0),
                        src=src, dst=hid))
                break
        else:  # no capacity anywhere: keep in place
            new_p.assign(job_id, src, load)

    return new_p, plan


# Byte multiplier per fabric tier (index = Topology.tier_of): access/ToR
# bytes at par, pod-uplink bytes 2x, spine bytes 4x — upper tiers are the
# oversubscribed, fleet-shared resource a consolidation plan should spare.
TIER_WEIGHTS = (1.0, 2.0, 4.0)


def _path_weight(topology: network.Topology,
                 path: Sequence[str]) -> float:
    """Tier weight of a transfer: the multiplier of the HIGHEST tier its
    path climbs to (1.0 for empty paths and flat topologies)."""
    w = 1.0
    for l in path:
        tw = TIER_WEIGHTS[min(topology.tier_of(l), len(TIER_WEIGHTS) - 1)]
        if tw > w:
            w = tw
    return w


def plan_cost(plan: Sequence[MigrationRequest],
              topology: network.Topology, *,
              dirty_rates: Optional[Dict[str, object]] = None,
              bandwidth: Optional[float] = None,
              now: float = 0.0) -> Dict[str, float]:
    """Predicted cost of executing ``plan`` as one simultaneous burst on
    ``topology``: each transfer runs at its max-min fair share of the
    links on its src->dst path (everything else in the plan in flight),
    and the contended pre-copy cost comes from
    ``strunk.expected_cost_batch`` at those shares. Returns predicted
    total ``bytes``, tier-weighted ``weighted_bytes`` (spine bytes priced
    above ToR bytes — equal to ``bytes`` on flat topologies), summed lane
    ``time``, and the share vector."""
    if not plan:
        return {"bytes": 0.0, "weighted_bytes": 0.0, "time": 0.0,
                "shares": np.zeros(0)}
    caps = topology.capacities
    fallback = bandwidth if bandwidth is not None \
        else max(caps.values(), default=np.inf)
    paths = [topology.path(r.src, r.dst) for r in plan]
    shares = network.fair_share(paths, caps)
    shares = np.where(np.isfinite(shares), shares, fallback)
    v = np.asarray([r.v_bytes for r in plan], np.float64)
    rates = [(dirty_rates or {}).get(r.job_id, 0.0) for r in plan]
    sim = strunk.expected_cost_batch(v, shares, rates,
                                     np.full(len(plan), now), full=True)
    weights = np.asarray([_path_weight(topology, p) for p in paths])
    return {"bytes": float(sim.bytes_sent.sum()),
            "weighted_bytes": float((sim.bytes_sent * weights).sum()),
            "time": float(sim.total_time.sum()),
            "shares": shares}


def consolidate_ffd(placement: Placement, *, now: float = 0.0,
                    state_bytes: Optional[Dict[str, float]] = None,
                    topology: Optional[network.Topology] = None,
                    dirty_rates: Optional[Dict[str, object]] = None,
                    bandwidth: Optional[float] = None
                    ) -> Tuple[Placement, List[MigrationRequest]]:
    """First-fit-decreasing repack. Returns (new placement, migration plan).

    Classic behavior (no ``topology``): target hosts are the most-loaded
    first (consolidate into few), jobs are placed largest-first; a job
    that lands on a different host than it occupies now yields a
    MigrationRequest carrying src/dst for the fabric's link resolution.

    With a ``topology``, candidate packings (classic / rack-affinity /
    stay-first, plus pod-affinity variants on hierarchical fabrics; see
    module docstring) are scored by ``(hosts_used, predicted tier-weighted
    contended bytes, predicted summed time)`` and the best plan wins — ``dirty_rates`` (per-job ``PiecewiseRate``
    tables or constants) sharpen the byte prediction; ``bandwidth`` caps
    the share of unconstrained paths.
    """
    state_bytes = state_bytes or {}
    classic = _pack(placement, now, state_bytes)
    if topology is None:
        return classic

    loaded_desc = [h.host_id for h in
                   sorted(placement.hosts.values(), key=lambda h: -h.load)]
    # one ordered host list per access signature, built once: local hosts
    # first (loaded-desc), then the rest — rack_affinity is called per job
    access_order: Dict[Tuple[str, ...], List[str]] = {}
    for hid in loaded_desc:
        acc = topology.access_of(hid)
        if acc not in access_order:
            local = [h for h in loaded_desc
                     if topology.access_of(h) == acc]
            rest = [h for h in loaded_desc
                    if topology.access_of(h) != acc]
            access_order[acc] = local + rest

    def rack_affinity(src: str) -> List[str]:
        return access_order.get(topology.access_of(src), loaded_desc)

    candidates = [
        classic,
        _pack(placement, now, state_bytes, host_order_for=rack_affinity),
        _pack(placement, now, state_bytes, host_order_for=rack_affinity,
              stay_first=True),
    ]

    if any(topology.pod_of(hid) is not None for hid in loaded_desc):
        # hierarchical fabric: pod-affinity scan orders — same rack first,
        # then same pod (cheap pod-uplink hop), then the rest — so a plan
        # that never climbs to the spine can win the tier-weighted scoring
        pod_order: Dict[Tuple, List[str]] = {}
        for hid in loaded_desc:
            key = (topology.access_of(hid), topology.pod_of(hid))
            if key not in pod_order:
                acc, pod = key
                local = [h for h in loaded_desc
                         if topology.access_of(h) == acc]
                same_pod = [h for h in loaded_desc
                            if topology.access_of(h) != acc
                            and topology.pod_of(h) == pod]
                rest = [h for h in loaded_desc
                        if topology.access_of(h) != acc
                        and topology.pod_of(h) != pod]
                pod_order[key] = local + same_pod + rest

        def pod_affinity(src: str) -> List[str]:
            return pod_order.get(
                (topology.access_of(src), topology.pod_of(src)),
                loaded_desc)

        candidates.append(_pack(placement, now, state_bytes,
                                host_order_for=pod_affinity))
        candidates.append(_pack(placement, now, state_bytes,
                                host_order_for=pod_affinity,
                                stay_first=True))

    def score(cand: Tuple[Placement, List[MigrationRequest]]):
        new_p, plan = cand
        cost = plan_cost(plan, topology, dirty_rates=dirty_rates,
                         bandwidth=bandwidth, now=now)
        return (hosts_used(new_p), cost["weighted_bytes"], cost["time"])

    return min(candidates, key=score)


def hosts_used(placement: Placement) -> int:
    return sum(1 for h in placement.hosts.values() if h.jobs)
