"""Port FleetSim on the CPU against the JAX package: the slice's main path
end to end (telemetry -> LMCM decide/due -> surveillance -> pre-copy on the
migration plane). Per request, ``scheduled_at`` and the stop reason are
exact, bytes and time within rtol 1e-9, and ``lm_hit_rate`` is equal, for
``alma-paper`` and the ``immediate`` baseline."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.fleetsim as jfs  # noqa: E402
import repro_torch.core.fleetsim as tfs  # noqa: E402
from repro.core.orchestrator import MigrationRequest as JaxRequest  # noqa: E402
from repro_torch.core.orchestrator import MigrationRequest  # noqa: E402

CPU = "cpu"


def _run(mod, request_cls, policy, **kw):
    traces = mod.table3_traces(phase_s=60.0, replicas=2)      # 8 jobs
    jobs = [mod.SimJob(j, tr, 1e9 + 1e8 * i)
            for i, (j, tr) in enumerate(traces.items())]
    sim = mod.FleetSim(jobs, policy=policy, warmup_s=1200.0, seed=3, **kw)
    plan = [request_cls(j.job_id, sim.now + 37.0 * i, j.v_bytes)
            for i, j in enumerate(jobs)]
    return sim.run_with_plan(plan, horizon_s=3600.0)


@pytest.mark.parametrize("policy", ["alma-paper", "immediate"])
def test_run_with_plan_matches_reference(policy):
    want = _run(jfs, JaxRequest, policy)
    got = _run(tfs, MigrationRequest, policy, device=CPU)
    assert len(got.migrations) == len(want.migrations) == 8
    for g, w in zip(got.migrations, want.migrations):
        assert (g.job_id, g.scheduled_at, g.decision) == \
            (w.job_id, w.scheduled_at, w.decision)
        assert g.outcome.stop_reason == w.outcome.stop_reason
        assert g.outcome.rounds == w.outcome.rounds
        assert g.outcome.bytes_sent == pytest.approx(w.outcome.bytes_sent,
                                                     rel=1e-9)
        assert g.outcome.total_time == pytest.approx(w.outcome.total_time,
                                                     rel=1e-9)
    assert got.lm_hit_rate == want.lm_hit_rate
    assert got.total_bytes == pytest.approx(want.total_bytes, rel=1e-9)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-9)


def test_quickstart_steps_2_3():
    """Characterize + recognize a 120 s cycle, then watch Alg. 2 move a
    request out of the MEM phase (``examples/quickstart.py`` steps 2-3)."""
    trace = tfs.WorkloadTrace([("MEM", 30), ("CPU", 60), ("IDLE", 30)], 3600)
    sim = tfs.FleetSim([tfs.SimJob("job0", trace, v_bytes=1e9)],
                       policy="alma-paper", warmup_s=600.0, device=CPU)
    model = sim.lmcm.refresh_job("job0")
    assert model.period == 120 and model.cyclic
    req = sim.run_with_plan([MigrationRequest("job0", sim.now, 1e9)],
                            horizon_s=600.0).migrations[0]
    assert trace.phase_at(req.created_at) == "MEM"
    assert trace.phase_at(req.scheduled_at) != "MEM"

    jtrace = jfs.WorkloadTrace([("MEM", 30), ("CPU", 60), ("IDLE", 30)], 3600)
    jsim = jfs.FleetSim([jfs.SimJob("job0", jtrace, v_bytes=1e9)],
                        policy="alma-paper", warmup_s=600.0)
    jmodel = jsim.lmcm.refresh_job("job0")
    assert model.confidence == pytest.approx(jmodel.confidence, rel=1e-4)
    np.testing.assert_array_equal(model.profile_lm, jmodel.profile_lm)
    jreq = jsim.run_with_plan([JaxRequest("job0", jsim.now, 1e9)],
                              horizon_s=600.0).migrations[0]
    assert req.scheduled_at == jreq.scheduled_at

