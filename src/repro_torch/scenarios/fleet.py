"""Deterministic scenario fleets for the fault-injection suite.

One seeded builder (``build_fleet``) produces the substrate every
scenario shares: a ``Topology.multi_rack`` fabric (per-rack ToR links
through a shared core), a ``Placement`` with per-host headroom so
evacuations have somewhere to go, and a de-phased VM population on the
``SCENARIO_PHASES`` cycle — replicas of one application shifted by
``k * cycle / n_vms`` so the fleet is never phase-synchronized (the
paper's contended-fleet setup, Table 3 style).

The helpers below it are the suite's shared vocabulary: a warmup long
enough for the surveillance FFT to lock the cycle (``default_warmup``),
a greedy projected-load evacuation planner (``evacuation_plan``), and
the recovery/SLA report every scenario emits (``scenario_report``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import network
from repro_torch.core.consolidation import Host, Placement
from repro_torch.core.fleetsim import FleetSim, PAPER_BANDWIDTH, SimJob, \
    WorkloadTrace
from repro_torch.core.orchestrator import MigrationRequest

# the suite's common workload cycle: a long cyclic-LM window (CPU), a
# pre-copy-hostile stretch (MEM), and an IO tail — 240 s per cycle, so
# ALMA has a real window to aim for and a real window to avoid
SCENARIO_PHASES = [("CPU", 120.0), ("MEM", 60.0), ("IO", 60.0)]
SCENARIO_CYCLE_S = float(sum(d for _, d in SCENARIO_PHASES))


@dataclass
class ScenarioFleet:
    """A built scenario substrate: jobs + fabric + placement, plus the
    derived indices the scenarios key off (rack membership, VM homes)."""
    jobs: List[SimJob]
    topology: network.Topology
    placement: Placement
    hosts: List[str]
    rack_of: Dict[str, str]
    cycle_s: float = SCENARIO_CYCLE_S
    bandwidth: float = PAPER_BANDWIDTH
    seed: int = 0
    v_bytes: Dict[str, float] = field(default_factory=dict)

    def jobs_on(self, host: str) -> List[str]:
        return sorted(self.placement.hosts[host].jobs)

    def host_of(self, job_id: str) -> Optional[str]:
        return self.placement.host_of(job_id)

    def rack_peers(self, host: str) -> List[str]:
        """Live-in-the-same-rack candidates, the preferred evacuation
        targets (intra-rack moves never cross the core)."""
        r = self.rack_of[host]
        return [h for h in self.hosts if self.rack_of[h] == r and h != host]

    def sim(self, policy: str, **kw) -> FleetSim:
        """A FleetSim over this fleet; scenario kwargs (fault_plan,
        warmup_s, retry knobs, device, ...) pass straight through."""
        kw.setdefault("bandwidth", self.bandwidth)
        kw.setdefault("seed", self.seed)
        return FleetSim(self.jobs, policy=policy, topology=self.topology,
                        placement=self.placement, **kw)


def build_fleet(*, n_racks: int = 2, hosts_per_rack: int = 3,
                vms_per_host: int = 2, seed: int = 0,
                bandwidth: float = PAPER_BANDWIDTH,
                core_oversubscription: float = 1.0,
                headroom: float = 2.0) -> ScenarioFleet:
    """The suite's seeded substrate.

    ``n_racks`` ToR links (auto-named hosts ``r{i}h{j}``) through a core
    sized at ``n_racks * bandwidth / core_oversubscription``; every host
    gets ``vms_per_host`` unit-load VMs and ``headroom`` spare capacity
    (evacuating one host must be *feasible*, or drain scenarios measure
    nothing). VM k runs the common cycle shifted by ``k * cycle / n_vms``
    and carries ``v_bytes ~ U(0.75, 2.0) GB`` — the paper's VM scale, so
    migrations take tens of seconds and faults genuinely land mid-flight.
    Deterministic in ``seed``.
    """
    topology = network.Topology.multi_rack(
        n_racks, bandwidth,
        core_capacity=n_racks * bandwidth / max(core_oversubscription, 1e-9),
        hosts_per_rack=hosts_per_rack)
    hosts = [f"r{i}h{j}" for i in range(n_racks)
             for j in range(hosts_per_rack)]
    rack_of = {h: h.split("h")[0] for h in hosts}
    rng = np.random.default_rng(seed)
    n_vms = len(hosts) * vms_per_host
    placement = Placement({h: Host(h, float(vms_per_host) + headroom)
                           for h in hosts})
    jobs: List[SimJob] = []
    v_bytes: Dict[str, float] = {}
    for k in range(n_vms):
        host = hosts[k % len(hosts)]
        job_id = f"vm{k:03d}"
        trace = WorkloadTrace(SCENARIO_PHASES, total_s=7200,
                              offset=k * SCENARIO_CYCLE_S / n_vms)
        vb = float(rng.uniform(0.75e9, 2.0e9))
        jobs.append(SimJob(job_id, trace, vb))
        placement.assign(job_id, host, 1.0)
        v_bytes[job_id] = vb
    return ScenarioFleet(jobs=jobs, topology=topology, placement=placement,
                         hosts=hosts, rack_of=rack_of,
                         bandwidth=bandwidth, seed=seed, v_bytes=v_bytes)


def default_warmup(policy: str, cycle_s: float = SCENARIO_CYCLE_S) -> float:
    """Warmup before the scenario clock starts: the surveillance window
    needs >= 4 observed cycles to resolve the period, plus one cycle of
    slack. The immediate baseline reads no fits, so it skips warmup —
    and keeps boot_storm's cold-ring premise literal."""
    return 0.0 if policy == "immediate" else 5.0 * cycle_s


def evacuation_plan(fleet: ScenarioFleet, host: str, t: float, *,
                    deadline: Optional[float] = None,
                    exclude: Sequence[str] = ()) -> List[MigrationRequest]:
    """Drain ``host``: one request per resident VM, targets chosen
    greedily by *projected* free capacity (actual free minus what this
    plan has already routed there), preferring rack-local destinations
    so the drain stays off the core. ``exclude`` removes hosts that are
    (or are about to be) unavailable."""
    banned = {host, *exclude}
    projected = {h: fleet.placement.hosts[h].free
                 for h in fleet.hosts if h not in banned}
    if not projected:
        return []
    local = set(fleet.rack_peers(host))
    plan: List[MigrationRequest] = []
    for job_id in fleet.jobs_on(host):
        load = fleet.placement.hosts[host].jobs[job_id]
        fits = [h for h, free in projected.items() if free >= load]
        pool = fits or list(projected)
        # rack-local first, then most projected headroom, then name
        dst = min(pool, key=lambda h: (h not in local, -projected[h], h))
        projected[dst] -= load
        plan.append(MigrationRequest(
            job_id=job_id, created_at=t, v_bytes=fleet.v_bytes[job_id],
            src=host, dst=dst, deadline=deadline))
    return plan


# -- reporting ---------------------------------------------------------------
def percentiles(values: Sequence[float]) -> Dict[str, float]:
    """p50/p95/max of a recovery-time sample (NaNs when empty — a
    scenario with nothing recovered reports that, not zeros)."""
    if not len(values):
        return {"p50": float("nan"), "p95": float("nan"),
                "max": float("nan")}
    a = np.asarray(values, dtype=np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "max": float(a.max())}


def sla_violations(plan: Sequence[MigrationRequest],
                   completed_at: Dict[str, float]) -> int:
    """SLA accounting over a scenario's requests: permanently failed,
    cancelled (unroutable), or completed past their own deadline."""
    bad = 0
    for req in plan:
        if req.decision in ("failed", "cancelled"):
            bad += 1
        elif req.deadline is not None:
            done = completed_at.get(req.job_id)
            if done is None or done > req.deadline:
                bad += 1
    return bad


def scenario_report(result, plan: Sequence[MigrationRequest],
                    t0: float) -> Dict:
    """The per-scenario summary every suite entry emits: makespan,
    per-VM recovery time (scenario start -> completion) percentiles,
    bytes (useful + wasted-by-abort), and SLA violations."""
    recovery = [done - t0 for done in result.completed_at.values()]
    return {
        "makespan_s": float(result.makespan),
        "recovery_s": percentiles(recovery),
        "completed": len(result.completed_at),
        "requested": len(plan),
        "total_bytes": float(result.total_bytes),
        "aborted_bytes": float(result.aborted_bytes),
        "n_aborts": int(result.n_aborts),
        "n_retries": int(result.n_retries),
        "failed_jobs": sorted(set(result.failed_jobs)),
        "sla_violations": sla_violations(plan, result.completed_at),
        "lm_hit_rate": float(result.lm_hit_rate),
    }
