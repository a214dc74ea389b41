"""Four kubevirt-style datacenter scenarios on the fault-injecting fleet.

Each scenario builds the shared seeded substrate (``fleet.build_fleet``),
drives ``FleetSim`` — with a ``FaultPlan`` where the scenario calls for
real failures — and emits one ``scenario_report`` dict: makespan, per-VM
recovery-time percentiles (p50/p95/max), bytes moved and bytes wasted by
aborts, and SLA violations. All four are deterministic in ``seed``.

``host_drain``
    Planned maintenance: evacuate one host under a deadline. No faults —
    this measures the orchestrator's ability to honor an SLA while still
    timing launches against the workload cycle.
``node_failure``
    The host dies 20 s into an urgent drain, mid-flight: lanes abort
    with partial bytes billed, retries re-route around the corpse, and
    the scenario reports RTO — the worst time-to-recovered over the
    victim's VMs, measured from the crash.
``boot_storm``
    J VMs re-register with cold telemetry rings (warmup 0) and request
    migrations in a staggered burst — the cold-start stress on the
    surveillance path: no fits exist, max-wait alone forces progress.
``rolling_upgrade``
    A wave of drains under the concurrency budget: hosts are drained one
    at a time on one live simulator (sequential ``run_with_plan`` calls,
    placement carrying over), the kubevirt node-upgrade loop.

Each takes ``device`` (``None`` is the card, which raises without one;
``"cpu"`` as the tests run it) and hands it to ``FleetSim``, whose
telemetry, NB model and surveillance engine live there.

CLI:  python -m repro_torch.scenarios.suite --scenario node_failure \
          --policy alma-paper --seed 0 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

from repro_torch.kernels.backend import DeviceLike
from repro_torch.scenarios.faults import FaultPlan
from repro_torch.scenarios.fleet import ScenarioFleet, build_fleet, \
    default_warmup, evacuation_plan, percentiles, scenario_report


def _fleet(seed: int, fleet_kw: Optional[Dict]) -> ScenarioFleet:
    return build_fleet(seed=seed, **(fleet_kw or {}))


def host_drain(*, policy: str = "alma-paper", seed: int = 0,
               deadline_s: float = 480.0, victim: Optional[str] = None,
               horizon_s: float = 4000.0,
               fleet_kw: Optional[Dict] = None,
               device: DeviceLike = None) -> Dict:
    """Planned evacuation of one host under a deadline (maintenance
    drain). The deadline rides on every request, so the LMCM may
    postpone into a cyclic-LM window only as far as the SLA allows."""
    fleet = _fleet(seed, fleet_kw)
    victim = victim or fleet.hosts[0]
    sim = fleet.sim(policy, warmup_s=default_warmup(policy), device=device)
    t0 = sim.now
    plan = evacuation_plan(fleet, victim, t0, deadline=t0 + deadline_s)
    res = sim.run_with_plan(plan, horizon_s=horizon_s)
    rep = scenario_report(res, plan, t0)
    rep.update({
        "scenario": "host_drain", "policy": policy, "seed": seed,
        "victim": victim, "deadline_s": deadline_s,
        "drained": not fleet.placement.hosts[victim].jobs,
        "deadline_met": (rep["sla_violations"] == 0
                         and rep["completed"] == rep["requested"]),
    })
    return rep


def node_failure(*, policy: str = "alma-paper", seed: int = 0,
                 t_fail_s: float = 20.0, mttr_s: float = 600.0,
                 victim: Optional[str] = None, horizon_s: float = 4000.0,
                 fleet_kw: Optional[Dict] = None,
                 device: DeviceLike = None) -> Dict:
    """Unplanned host death mid-drain. An urgent evacuation starts at
    t0 (hardware alert: no postponement), the host crashes ``t_fail_s``
    later with lanes in flight — partial bytes are settled and wasted,
    aborted requests back off and re-route (dead source => cold restart
    from a live image host), and any VM still resident is restarted
    urgently. RTO is the worst victim-VM recovery measured from the
    crash; infinite if any victim VM never recovers."""
    fleet = _fleet(seed, fleet_kw)
    victim = victim or fleet.hosts[0]
    victims = set(fleet.jobs_on(victim))
    warm = default_warmup(policy)
    t_fail = warm + t_fail_s
    sim = fleet.sim(policy, warmup_s=warm,
                    fault_plan=FaultPlan.host_failure(
                        t_fail, victim, recover_at=t_fail + mttr_s),
                    device=device)
    t0 = sim.now
    plan = evacuation_plan(fleet, victim, t0)
    for req in plan:
        req.urgent = True              # failure-imminent drain: fire now
    res = sim.run_with_plan(plan, horizon_s=horizon_s)
    rep = scenario_report(res, plan, t0)
    victim_rec = [res.completed_at[j] - t_fail for j in victims
                  if j in res.completed_at and res.completed_at[j] > t_fail]
    lost = victims - set(res.completed_at)
    rep.update({
        "scenario": "node_failure", "policy": policy, "seed": seed,
        "victim": victim, "t_fail": t_fail, "mttr_s": mttr_s,
        "victim_vms": len(victims),
        "victim_recovery_s": percentiles(victim_rec),
        "rto_s": (float("inf") if lost
                  else max(victim_rec, default=0.0)),
    })
    return rep


def boot_storm(*, policy: str = "alma-paper", seed: int = 0,
               stagger_s: float = 2.0, max_wait: float = 300.0,
               horizon_s: float = 4000.0,
               fleet_kw: Optional[Dict] = None,
               device: DeviceLike = None) -> Dict:
    """Every VM re-registers with a COLD telemetry ring (warmup 0 for
    all policies — that premise is the scenario) and requests a
    migration in a staggered burst: a one-host round-robin shift, so
    each host sheds and receives the same load. With no cycle fits the
    surveillance policies must make progress on max-wait alone."""
    fleet = _fleet(seed, fleet_kw)
    sim = fleet.sim(policy, warmup_s=0.0, max_wait=max_wait, device=device)
    t0 = sim.now
    plan = []
    from repro_torch.core.orchestrator import MigrationRequest
    for k, job in enumerate(fleet.jobs):
        src = fleet.host_of(job.job_id)
        dst = fleet.hosts[(fleet.hosts.index(src) + 1) % len(fleet.hosts)]
        plan.append(MigrationRequest(
            job_id=job.job_id, created_at=t0 + k * stagger_s,
            v_bytes=job.v_bytes, src=src, dst=dst))
    res = sim.run_with_plan(plan, horizon_s=horizon_s)
    rep = scenario_report(res, plan, t0)
    rep.update({
        "scenario": "boot_storm", "policy": policy, "seed": seed,
        "n_jobs": len(plan), "stagger_s": stagger_s,
        "max_wait": max_wait,
    })
    return rep


def rolling_upgrade(*, policy: str = "alma-paper", seed: int = 0,
                    rack: str = "r0", max_concurrent: int = 2,
                    wave_horizon_s: float = 4000.0,
                    fleet_kw: Optional[Dict] = None,
                    device: DeviceLike = None) -> Dict:
    """Drain one rack's hosts in sequence under the concurrency budget
    (the kubevirt node-upgrade loop). One live simulator carries the
    placement across waves, so each wave evacuates onto the fleet the
    previous waves produced; a wave must fully drain before the next
    host goes down for upgrade."""
    fleet = _fleet(seed, fleet_kw)
    targets = [h for h in fleet.hosts if fleet.rack_of[h] == rack]
    sim = fleet.sim(policy, warmup_s=default_warmup(policy),
                    max_concurrent=max_concurrent, device=device)
    t_start = sim.now
    waves = []
    all_plan = []
    recovery = []
    for i, host in enumerate(targets):
        t0 = sim.now
        # the NEXT host to be upgraded is about to go down — do not
        # evacuate onto it
        nxt = targets[i + 1:i + 2]
        plan = evacuation_plan(fleet, host, t0, exclude=nxt)
        res = sim.run_with_plan(plan, horizon_s=wave_horizon_s)
        all_plan.extend(plan)
        recovery.extend(done - t0 for done in res.completed_at.values())
        waves.append({
            "host": host,
            "drained": not fleet.placement.hosts[host].jobs,
            "wave_makespan_s": float(res.makespan),
            "completed": len(res.completed_at),
            "requested": len(plan),
            "total_bytes": float(res.total_bytes),
        })
    total_bytes = sum(w["total_bytes"] for w in waves)
    completed = sum(w["completed"] for w in waves)
    requested = sum(w["requested"] for w in waves)
    return {
        "scenario": "rolling_upgrade", "policy": policy, "seed": seed,
        "rack": rack, "max_concurrent": max_concurrent,
        "makespan_s": float(sim.now - t_start),
        "recovery_s": percentiles(recovery),
        "completed": completed, "requested": requested,
        "total_bytes": float(total_bytes),
        "aborted_bytes": 0.0, "n_aborts": 0, "n_retries": 0,
        "failed_jobs": [],
        "sla_violations": requested - completed,
        "all_drained": all(w["drained"] for w in waves),
        "waves": waves,
    }


SCENARIOS = {
    "host_drain": host_drain,
    "node_failure": node_failure,
    "boot_storm": boot_storm,
    "rolling_upgrade": rolling_upgrade,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), required=True)
    ap.add_argument("--policy", default="alma-paper")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    rep = SCENARIOS[args.scenario](policy=args.policy, seed=args.seed,
                                   device=args.device)
    print(json.dumps(rep, indent=2, default=str))


if __name__ == "__main__":
    main()
