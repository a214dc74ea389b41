"""Fault-injecting datacenter scenarios for the fleet simulator.

``faults`` — seeded deterministic :class:`FaultPlan` schedules (host
crash/recover, link degrade/restore) that ``FleetSim`` drives as
first-class event boundaries; ``fleet`` — the shared seeded scenario
substrate and report helpers; ``suite`` — the four kubevirt-style
scenarios (host_drain, node_failure, boot_storm, rolling_upgrade) and
their CLI.
"""
from repro_torch.scenarios.faults import FaultEvent, FaultPlan
from repro_torch.scenarios.fleet import ScenarioFleet, build_fleet, \
    default_warmup, evacuation_plan, percentiles, scenario_report
from repro_torch.scenarios.suite import SCENARIOS, boot_storm, host_drain, \
    node_failure, rolling_upgrade

__all__ = [
    "FaultEvent", "FaultPlan", "ScenarioFleet", "build_fleet",
    "default_warmup", "evacuation_plan", "percentiles", "scenario_report",
    "SCENARIOS", "boot_storm", "host_drain", "node_failure",
    "rolling_upgrade",
]
