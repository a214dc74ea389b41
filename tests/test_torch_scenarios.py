"""The port's fault-injection scenarios (``repro_torch.scenarios``) on the
CPU against the JAX package: the four suite scenarios' reports (makespan,
recovery percentiles, bytes, aborts, retries, SLA accounting) for both
policies at small fleets, the ``FaultPlan`` builders, a faulted run's
abort log and per-link bytes, event-skip on and off under faults inside
the port, and the suite CLI with ``--device cpu``.

Every comparison is exact: the scenarios are host numpy over the same
seeded substrate, and the port's surveillance decisions equal the
reference's (``tests/test_torch_fleetsim.py``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as jsc  # noqa: E402
import repro_torch.scenarios as tsc  # noqa: E402
from repro_torch.scenarios import suite  # noqa: E402

CPU = "cpu"
SMALL = {"n_racks": 2, "hosts_per_rack": 2, "vms_per_host": 2}


def _same(a, b):
    """Equal reports, NaN percentiles (nothing recovered) included."""
    return json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


@pytest.mark.parametrize("policy", ["alma-paper", "immediate"])
@pytest.mark.parametrize("name", ["host_drain", "node_failure",
                                  "boot_storm", "rolling_upgrade"])
def test_scenario_reports_match_reference(name, policy):
    for fleet_kw in (None, SMALL):
        want = jsc.SCENARIOS[name](policy=policy, seed=0,
                                   fleet_kw=fleet_kw)
        got = tsc.SCENARIOS[name](policy=policy, seed=0, fleet_kw=fleet_kw,
                                  device=CPU)
        assert _same(got, want), (name, policy, fleet_kw)
        assert got["requested"] > 0


def test_node_failure_aborts_and_recovers_as_reference():
    """The faulted scenario really faults: lanes abort with partial bytes
    and retry, every victim VM recovers, and the RTO equals the
    reference's."""
    got = tsc.node_failure(policy="alma-paper", seed=1, device=CPU)
    want = jsc.node_failure(policy="alma-paper", seed=1)
    assert got["n_aborts"] > 0 and got["n_retries"] > 0
    assert got["aborted_bytes"] > 0 and not got["failed_jobs"]
    assert np.isfinite(got["rto_s"]) and got["rto_s"] > 0
    assert _same(got, want)


def _faulted(pkg, policy, *, event_skip=True, **kw):
    fleet = pkg.build_fleet(seed=0)
    victim = fleet.hosts[0]
    sim = fleet.sim(policy, warmup_s=0.0, event_skip=event_skip,
                    fault_plan=pkg.FaultPlan.host_failure(
                        20.0, victim, recover_at=320.0), **kw)
    plan = pkg.evacuation_plan(fleet, victim, sim.now,
                               exclude=fleet.rack_peers(victim))
    for req in plan:
        req.urgent = True
    return sim, sim.run_with_plan(plan, horizon_s=2500.0)


@pytest.mark.parametrize("policy", ["immediate", "alma-paper"])
def test_faulted_run_matches_reference(policy):
    """A cross-core drain whose source dies at t = 20 s: abort log, per-link
    bytes, completion times and aborted bytes equal the reference's."""
    _, want = _faulted(jsc, policy)
    _, got = _faulted(tsc, policy, device=CPU)
    assert got.n_aborts == want.n_aborts > 0
    assert got.abort_log == want.abort_log
    assert got.link_bytes == want.link_bytes
    assert got.completed_at == want.completed_at
    assert got.aborted_bytes == want.aborted_bytes
    assert got.total_bytes == want.total_bytes


def test_event_skip_bit_identical_under_faults():
    """Inside the port, faults are event boundaries: skip on and off give
    the same run, telemetry ring and rng stream."""
    (s1, r1), (s0, r0) = (_faulted(tsc, "alma-paper", event_skip=skip,
                                   device=CPU) for skip in (True, False))
    assert r1.n_aborts == r0.n_aborts > 0
    assert (r1.total_bytes, r1.total_time, r1.aborted_bytes) == \
        (r0.total_bytes, r0.total_time, r0.aborted_bytes)
    assert r1.link_bytes == r0.link_bytes
    assert r1.completed_at == r0.completed_at
    assert r1.abort_log == r0.abort_log
    assert s1.now == s0.now
    assert torch.equal(s1.telemetry._data, s0.telemetry._data)
    assert np.array_equal(s1.telemetry._steps, s0.telemetry._steps)
    assert s1.rng.bit_generator.state == s0.rng.bit_generator.state


def _events(plan):
    return [(e.t, e.kind, e.target, e.capacity, e.jobs) for e in plan]


def test_fault_plan_builders_match_reference():
    """Every builder, the seeded ones included, and ``shifted`` give the
    reference's events in the reference's order; an empty plan is falsy
    and an unknown kind raises."""
    def build(m):
        F = m.FaultPlan
        return [
            F.host_failure(10.0, "h0", recover_at=60.0),
            F.host_failure(5.0, "h1"),
            F.link_brownout(5.0, "core", 1e6, restore_at=9.0,
                            restore_capacity=1e9),
            F.access_outage(3.0, "pod:p0s0", restore_at=400.0,
                            restore_capacity=125e6),
            F.random(["a", "b", "c"], {"l": 1e9, "m": 2e9}, horizon_s=100.0,
                     seed=3, n_host_faults=2, n_link_faults=2),
            F.telemetry_blackout(7.0, ["j0", "j1", "j2", "j3"],
                                 duration_s=30.0, frac=0.5, seed=4),
            F.telemetry_blackout(7.0, ["j0", "j1"], duration_s=5.0),
            F([m.FaultEvent(5.0, "host_fail", "b"),
               m.FaultEvent(1.0, "host_fail", "a"),
               m.FaultEvent(5.0, "host_recover", "a")]).shifted(100.0),
        ]
    for got, want in zip(build(tsc), build(jsc), strict=True):
        assert _events(got) == _events(want)
    assert not tsc.FaultPlan() and len(tsc.FaultPlan()) == 0
    with pytest.raises(ValueError):
        tsc.FaultEvent(0.0, "meteor_strike", "h0")
    with pytest.raises(ValueError):
        tsc.FaultPlan.link_brownout(5.0, "core", 1e6, restore_at=9.0)


def test_fleet_builder_and_helpers_match_reference():
    for kw in ({}, SMALL, {"n_racks": 3, "core_oversubscription": 2.0}):
        j, t = jsc.build_fleet(seed=2, **kw), tsc.build_fleet(seed=2, **kw)
        assert t.hosts == j.hosts and t.rack_of == j.rack_of
        assert t.v_bytes == j.v_bytes
        assert t.topology.capacities == j.topology.capacities
        for h in t.hosts:
            jp = jsc.evacuation_plan(j, h, 5.0, deadline=50.0)
            tp = tsc.evacuation_plan(t, h, 5.0, deadline=50.0)
            assert [(r.job_id, r.src, r.dst, r.v_bytes, r.deadline)
                    for r in tp] == \
                [(r.job_id, r.src, r.dst, r.v_bytes, r.deadline) for r in jp]
    assert tsc.default_warmup("immediate") == jsc.default_warmup("immediate")
    assert tsc.default_warmup("alma-paper") == \
        jsc.default_warmup("alma-paper")
    assert tsc.percentiles([3.0, 1.0, 2.0]) == \
        jsc.percentiles([3.0, 1.0, 2.0])


def test_suite_cli_runs_on_cpu(capsys):
    suite.main(["--scenario", "node_failure", "--policy", "immediate",
                "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    want = jsc.node_failure(policy="immediate", seed=0)
    assert _same(got, json.loads(json.dumps(want, default=str)))
    assert got["scenario"] == "node_failure" and got["n_aborts"] > 0


def test_scenarios_default_to_the_card():
    """No device: the card, which raises here rather than running on the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsc.host_drain(policy="immediate", seed=0)
