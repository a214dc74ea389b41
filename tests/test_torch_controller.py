"""The port's adaptive concurrency controller (``core/controller.py``) and
its FleetSim wiring (``adaptive_concurrency``, ``horizon``, the
``_trough_of`` hook) on the CPU against the JAX package.

Everything here is host numpy or exact decisions, so every comparison is
exact: launched job ids in order, stamped routes, ``scheduled_at``,
decisions, stop reasons and rounds; bytes, times and per-link bytes are
equal floats (both packages run the same numpy code on the same inputs).
Inside the port, event-skip on and off are bit-identical under the
receding-horizon controller, and the stacked sweep selects what the
reference sweep selects.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.controller as jctl  # noqa: E402
import repro.core.fabric as jfab  # noqa: E402
import repro.core.fleetsim as jfs  # noqa: E402
import repro.core.network as jnet  # noqa: E402
import repro.core.orchestrator as jorch  # noqa: E402
import repro.core.rates as jrates  # noqa: E402
from repro.core.consolidation import Host as JHost  # noqa: E402
from repro.core.consolidation import Placement as JPlacement  # noqa: E402
import repro_torch.core.controller as tctl  # noqa: E402
import repro_torch.core.fabric as tfab  # noqa: E402
import repro_torch.core.fleetsim as tfs  # noqa: E402
import repro_torch.core.network as tnet  # noqa: E402
import repro_torch.core.orchestrator as torch_orch  # noqa: E402
import repro_torch.core.rates as trates  # noqa: E402
from repro_torch.core.consolidation import Host as THost  # noqa: E402
from repro_torch.core.consolidation import Placement as TPlacement  # noqa: E402

CAP = 125e6
JAX = dict(ctl=jctl, fab=jfab, fs=jfs, net=jnet, orch=jorch, rates=jrates,
           Host=JHost, Placement=JPlacement, kw={})
PORT = dict(ctl=tctl, fab=tfab, fs=tfs, net=tnet, orch=torch_orch,
            rates=trates, Host=THost, Placement=TPlacement,
            kw={"device": "cpu"})


# ---------------------------------------------------------------------------
# one decision point: controller.select
# ---------------------------------------------------------------------------
def _decision_point(pkg, seed):
    """A seeded pod/spine decision point (background lanes in flight,
    candidates, forced launches), built anew for each package and engine:
    ``select`` stamps routes on the requests it launches."""
    net, R = pkg["net"], pkg["orch"].MigrationRequest
    PiecewiseRate = pkg["rates"].PiecewiseRate
    rng = np.random.default_rng(seed)
    pods, racks = int(rng.integers(2, 4)), int(rng.integers(2, 4))
    topo = net.Topology.pod_spine(
        pods, racks, access_capacity=CAP,
        pod_oversubscription=float(rng.choice([1.0, 2.0, 4.0])),
        spine_oversubscription=float(rng.choice([1.0, 2.0])),
        n_spines=int(rng.integers(2, 4)))
    plane = pkg["fab"].ShardedPlane(topo)
    rates, troughs = {}, {}

    def req(tag, i):
        p, r = int(rng.integers(pods)), int(rng.integers(racks))
        q, s = int(rng.integers(pods)), int(rng.integers(racks))
        out = R(f"{tag}{i}", 0.0, float(rng.uniform(0.2e9, 2e9)),
                src=f"p{p}r{r}h0", dst=f"p{q}r{s}h1")
        rates[out.job_id] = PiecewiseRate(
            [60.0, 120.0], [float(rng.uniform(0, 160e6)),
                            float(rng.uniform(0, 20e6))],
            offset=float(rng.uniform(0, 120)))
        troughs[out.job_id] = (float(rng.uniform(2.0, 90.0))
                               if rng.random() < 0.5 else None)
        return out

    for i in range(int(rng.integers(0, 4))):
        r = req("bg", i)
        plane.launch(r, rates[r.job_id], 0.0)
    plane.advance(float(rng.uniform(0, 5)))
    cands = [req("c", i) for i in range(int(rng.integers(1, 9)))]
    forced = [req("f", i) for i in range(int(rng.integers(0, 3)))]
    return plane, rates, troughs, cands, forced


def _select(pkg, seed, mode):
    plane, rates, troughs, cands, forced = _decision_point(pkg, seed)
    kw = ({"horizon": True,
           "trough_of": lambda r, now: troughs[r.job_id]}
          if mode == "horizon" else {"sweep": mode})
    ctl = pkg["ctl"].AdaptiveConcurrencyController(
        plane, rate_of=lambda q: rates[q.job_id], **kw)
    sel = ctl.select(cands, plane.now, forced=forced)
    return ([r.job_id for r in sel], [tuple(r.path or ()) for r in sel],
            [tuple(r.path or ()) for r in forced],
            [r.defers for r in cands],
            [ctl.deferred_until.get(id(r)) for r in cands])


@pytest.mark.parametrize("mode", ["stacked", "reference", "horizon"])
def test_selections_match_reference(mode):
    """Launched ids in order, the routes stamped on launched and forced
    requests, each candidate's deferral count and the published wakes,
    over 24 seeded decision points; inside the port the stacked sweep
    selects what the reference sweep selects."""
    launched = 0
    for seed in range(24):
        got = _select(PORT, seed, mode)
        assert got == _select(JAX, seed, mode), seed
        if mode == "stacked":
            assert got[:3] == _select(PORT, seed, "reference")[:3], seed
        launched += len(got[0])
    assert launched > 0


def test_horizon_off_is_the_myopic_sweep():
    """``horizon=False`` selects as both myopic engines and leaves no
    deferral bookkeeping, in the port as in the reference."""
    for seed in range(8):
        picks = {}
        for mode in ("stacked", "reference"):
            plane, rates, _, cands, forced = _decision_point(PORT, seed)
            ctl = tctl.AdaptiveConcurrencyController(
                plane, rate_of=lambda q: rates[q.job_id], sweep=mode,
                horizon=False)
            picks[mode] = [r.job_id for r in
                           ctl.select(cands, plane.now, forced=forced)]
            assert all(r.defers == 0 for r in cands)
            assert ctl.deferred_until == {} and ctl._deferred_claims == {}
        assert picks["stacked"] == picks["reference"], seed


# ---------------------------------------------------------------------------
# FleetSim with the controller
# ---------------------------------------------------------------------------
def _table3(pkg, **kw):
    """The 8-job Table 3 fleet of ``chip_smoke.py`` phase 4."""
    fs = pkg["fs"]
    traces = fs.table3_traces(phase_s=60.0, replicas=2)
    jobs = [fs.SimJob(j, tr, 1e9 + 1e8 * i)
            for i, (j, tr) in enumerate(traces.items())]
    sim = fs.FleetSim(jobs, policy="alma-paper", warmup_s=1200.0, seed=3,
                      **kw, **pkg["kw"])
    plan = [pkg["orch"].MigrationRequest(j.job_id, sim.now + 37.0 * i,
                                         j.v_bytes)
            for i, j in enumerate(jobs)]
    return sim, plan, 3600.0


def _cyclic(pkg, horizon, skip=True, n_jobs=6):
    """MEM/IDLE cycles under ``policy="immediate"``: the receding-horizon
    arm defers to troughs (``tests/test_horizon.py``'s fleet)."""
    fs = pkg["fs"]
    jobs = [fs.SimJob(f"j{i}",
                      fs.WorkloadTrace([("MEM", 60.0), ("IDLE", 60.0)],
                                       3600.0, offset=15.0 * i), 1e9)
            for i in range(n_jobs)]
    sim = fs.FleetSim(jobs, policy="immediate", warmup_s=500.0,
                      max_concurrent=n_jobs, seed=5,
                      adaptive_concurrency=not horizon, horizon=horizon,
                      event_skip=True, **pkg["kw"])
    sim._event_skip = skip
    plan = [pkg["orch"].MigrationRequest(j.job_id, sim.now + 5.0, j.v_bytes)
            for j in jobs]
    return sim, plan, 2500.0


def _contended(pkg):
    """An IO/CPU burst of 8 on one link (``tests/test_controller.py``'s)."""
    fs = pkg["fs"]
    jobs = [fs.SimJob(f"j{i}", fs.WorkloadTrace([("IO", 60), ("CPU", 60)],
                                                3600, offset=15.0 * i), 1e9)
            for i in range(8)]
    sim = fs.FleetSim(jobs, policy="immediate", warmup_s=60.0,
                      max_concurrent=8, seed=5, min_share_frac=0.0,
                      adaptive_concurrency=True, **pkg["kw"])
    plan = [pkg["orch"].MigrationRequest(j.job_id, sim.now + 5.0, j.v_bytes)
            for j in jobs]
    return sim, plan, 4000.0


def _pod_spine(pkg, **kw):
    """Cross-pod lanes on two spine planes, horizon admission with routes
    (``tests/test_route_failover.py``'s fabric, cyclic load)."""
    fs, net = pkg["fs"], pkg["net"]
    topo = net.Topology.pod_spine(
        2, 2, access_capacity=CAP, pod_oversubscription=1.0,
        spine_oversubscription=1.0, n_spines=2)
    jobs = [fs.SimJob(f"j{i}",
                      fs.WorkloadTrace([("MEM", 60.0), ("CPU", 60.0)],
                                       3600.0, offset=20.0 * i), 2e9)
            for i in range(4)]
    placement = pkg["Placement"]({h: pkg["Host"](h, 4.0)
                                  for h in sorted(topo.host_links)})
    for i, j in enumerate(jobs):
        placement.assign(j.job_id, f"p0r{i % 2}h{(i // 2) % 2}", 1.0)
    sim = fs.FleetSim(jobs, policy="alma-paper", warmup_s=600.0, seed=1,
                      max_concurrent=8, topology=topo, placement=placement,
                      **kw, **pkg["kw"])
    plan = [pkg["orch"].MigrationRequest(
        j.job_id, sim.now + 2.0, j.v_bytes,
        src=placement.host_of(j.job_id), dst=f"p1r{i % 2}h{(i // 2) % 2}")
        for i, j in enumerate(jobs)]
    return sim, plan, 3000.0


CASES = {
    "table3 adaptive": lambda pkg: _table3(pkg, adaptive_concurrency=True),
    "table3 adaptive, 2 in flight": lambda pkg: _table3(
        pkg, adaptive_concurrency=True, max_concurrent=2),
    "table3 horizon": lambda pkg: _table3(pkg, horizon=True),
    "cyclic horizon": lambda pkg: _cyclic(pkg, True),
    "cyclic adaptive": lambda pkg: _cyclic(pkg, False),
    "contended adaptive": _contended,
    "pod/spine horizon, route_aware": lambda pkg: _pod_spine(
        pkg, horizon=True, route_aware=True),
    "pod/spine adaptive": lambda pkg: _pod_spine(
        pkg, adaptive_concurrency=True),
}


def _result(pkg, case):
    sim, plan, horizon_s = CASES[case](pkg)
    res = sim.run_with_plan(plan, horizon_s=horizon_s)
    return sim, res


def _summary(res):
    return ([(r.job_id, r.created_at, r.scheduled_at, r.decision,
              tuple(r.path or ()), r.outcome.stop_reason, r.outcome.rounds,
              r.outcome.bytes_sent, r.outcome.total_time, r.outcome.downtime)
             for r in res.migrations],
            res.total_bytes, res.total_time, res.makespan, res.lm_hit_rate,
            sorted(res.link_bytes.items()), res.n_aborts, res.n_retries,
            sorted(res.completed_at.items()))


@pytest.mark.parametrize("case", list(CASES))
def test_fleetsim_controller_matches_reference(case):
    """Every migration (created, scheduled, decision, path, stop reason,
    rounds, bytes, time, downtime) and the ``SimResult`` totals and
    per-link bytes equal the reference's."""
    _, want = _result(JAX, case)
    sim, got = _result(PORT, case)
    assert sim.lmcm.controller is not None
    assert len(got.migrations) == len(want.migrations) > 0
    assert _summary(got) == _summary(want)


def test_horizon_wires_the_trough_hook():
    """``horizon=True`` wires the trough hook and keeps surveillance
    ticking under ``policy="immediate"``; the hook reads the engine's
    current fits as the reference's does."""
    sims = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        sim, plan, horizon_s = _cyclic(pkg, True)
        sim.run_with_plan(plan, horizon_s=horizon_s)
        sims[name] = sim
    sim = sims["port"]
    ctl = sim.lmcm.controller
    assert ctl.horizon and ctl.trough_of is not None
    assert sim.lmcm.force_surveillance
    for i in range(6):
        req = torch_orch.MigrationRequest(f"j{i}", sim.now, 1e9)
        jreq = jorch.MigrationRequest(f"j{i}", sim.now, 1e9)
        got = sim._trough_of(req, sim.now)
        assert got == sims["jax"]._trough_of(jreq, sims["jax"].now)
        assert got is not None


def test_event_skip_bit_identical_under_horizon():
    """Inside the port: the event-skipping run reproduces the per-second
    loop exactly with trough-deferred candidates in idle stretches
    (bytes, times, links, clock, telemetry ring, rng stream)."""
    out = {}
    for skip in (True, False):
        sim, plan, horizon_s = _cyclic(PORT, True, skip=skip)
        out[skip] = (sim.run_with_plan(plan, horizon_s=horizon_s), sim)
    (r1, s1), (r0, s0) = out[True], out[False]
    assert len(r1.per_job) == 6
    assert _summary(r1) == _summary(r0)
    assert s1.now == s0.now
    assert torch.equal(s1.telemetry._data, s0.telemetry._data)
    assert np.array_equal(s1.telemetry._steps, s0.telemetry._steps)
    assert s1.rng.bit_generator.state == s0.rng.bit_generator.state
