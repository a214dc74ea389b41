"""Port surveillance engine on the CPU against the JAX package over several
ticks of one seeded 64-job fleet: per tick ``remain`` and ``refitted`` are
equal, ``confidence`` within rtol 1e-4, and every job's LM series equal —
through the first full-window fit, the incremental classify splice of
later ticks, and a NaN telemetry blackout that starves some windows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fleetsim import make_training_nb as jax_training_nb  # noqa: E402
from repro.core.fleetsim import table3_traces  # noqa: E402
from repro.core.surveillance import SurveillanceEngine as JaxEngine  # noqa: E402
from repro.core.telemetry import FleetTelemetry as JaxFleet  # noqa: E402
from repro.core.telemetry import TelemetryBuffer as JaxBuffer  # noqa: E402
from repro_torch.core.characterize import naive_bayes_from_arrays  # noqa: E402
from repro_torch.core.surveillance import SurveillanceEngine  # noqa: E402
from repro_torch.core.telemetry import FleetTelemetry, TelemetryBuffer  # noqa: E402

CPU = "cpu"
J, WINDOW = 64, 128


def _samples(steps, seed=0):
    """(steps, J, F) load indexes of table3 traces (4 s phases, so several
    cycles fit a 128-sample window), de-phased per job."""
    rng = np.random.default_rng(seed)
    traces = list(table3_traces(phase_s=4.0).values())
    t0 = rng.uniform(0, 60, J)
    out = np.empty((steps, J, 6))
    for j in range(J):
        tr = traces[j % len(traces)]
        for s in range(steps):
            d = tr.sample_indexes(t0[j] + s, rng)
            out[s, j] = list(d.values())
    return out


@pytest.fixture(scope="module")
def setup():
    jnb = jax_training_nb()
    tnb = naive_bayes_from_arrays(np.asarray(jnb.bin_edges),
                                  np.asarray(jnb.log_likelihood),
                                  np.asarray(jnb.log_prior), device=CPU)
    return jnb, tnb, _samples(WINDOW + 200)


def _check_tick(jr, tr, jeng, teng):
    assert tr.refitted == jr.refitted
    assert tr.fleet == jr.fleet
    assert tr.remain == jr.remain
    assert tr.confidence.keys() == jr.confidence.keys()
    for k, c in jr.confidence.items():
        assert tr.confidence[k] == pytest.approx(c, rel=1e-4, abs=1e-7)
    for k, job in jeng.jobs.items():
        tj = teng.jobs[k]
        assert tj.fitted_step == job.fitted_step
        assert tj.origin_step == job.origin_step
        np.testing.assert_array_equal(tj.lm_series.numpy(), job.lm_series)
        assert (tj.model is None) == (job.model is None)
        if job.model is not None:
            assert tj.model.period == job.model.period
            np.testing.assert_array_equal(tj.model.profile_lm,
                                          job.model.profile_lm)


@pytest.mark.parametrize("overlap", [False, True])
def test_ticks_match_reference(setup, overlap):
    jnb, tnb, vals = setup
    jfleet = JaxFleet(J, capacity=2 * WINDOW)
    tfleet = FleetTelemetry(J, capacity=2 * WINDOW, device=CPU)
    jeng, teng = JaxEngine(), SurveillanceEngine(overlap=overlap, device=CPU)
    for i in range(J):
        jeng.register(f"j{i}", jfleet.view(i), jnb, window=WINDOW)
        teng.register(f"j{i}", tfleet.view(i), tnb, window=WINDOW)
    blackout = slice(0, 12)
    step = 0
    # first fit, slid windows (splice), a blackout, then recovery
    for n_rec in (WINDOW, 7, 23, 40, 70, 30):
        for _ in range(n_rec):
            v = vals[step].copy()
            if 150 <= step < 230:
                v[blackout] = np.nan
            jfleet.record_fleet(step, v)
            tfleet.record_fleet(step, v)
            step += 1
        jr, tr = jeng.tick(step - 1), teng.tick(step - 1)
        assert tr.pending == overlap
        _check_tick(jr, tr, jeng, teng)
        if step == 268:        # window 140..267 holds 80 blacked-out samples
            starved = [teng.jobs[f"j{i}"].model.period for i in range(12)]
            assert starved == [0] * 12        # demoted to acyclic
    assert all(teng.jobs[f"j{i}"].model.period > 1 for i in (1, 2, 3))


def test_mixed_backing_stores_one_gather(setup):
    _, _, vals = setup
    jfleet = JaxFleet(3, capacity=WINDOW)
    tfleet = FleetTelemetry(3, capacity=WINDOW, device=CPU)
    jlone, tlone = JaxBuffer(capacity=256), TelemetryBuffer(capacity=256)
    for s in range(WINDOW + 5):
        jfleet.record_fleet(s, vals[s, :3])
        tfleet.record_fleet(s, vals[s, :3])
    vals[60, 3, 2] = np.nan
    for s in range(90):
        kw = dict(zip(tfleet.fields, vals[s, 3]))
        jlone.record(s, **kw)
        tlone.record(s, **kw)
    want = JaxBuffer.window_matrix([jfleet.view(0), jlone, jfleet.view(2)],
                                   WINDOW, return_mask=True)
    got = TelemetryBuffer.window_matrix([tfleet.view(0), tlone,
                                         tfleet.view(2)], WINDOW,
                                        return_mask=True, device=CPU)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(tfleet.view(1).window(50),
                                  jfleet.view(1).window(50))


def test_fleet_bulk_record_matches_reference(setup):
    _, _, vals = setup
    jfleet = JaxFleet(J, capacity=50)
    tfleet = FleetTelemetry(J, capacity=50, device=CPU)
    steps = np.arange(120)
    jfleet.record_fleet_bulk(steps, vals[:120])
    tfleet.record_fleet_bulk(steps, vals[:120])
    jfleet.record_job(5, 120, compute_util=0.5)
    tfleet.record_job(5, 120, compute_util=0.5)
    for n in (10, 50, 60):
        jw, jm = jfleet.window_matrix(n)
        tw, tm = tfleet.window_matrix(n)
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tfleet.latest_steps(),
                                  jfleet.latest_steps())


def test_shards_are_refused():
    with pytest.raises(NotImplementedError):
        SurveillanceEngine(shards=2, device=CPU)
