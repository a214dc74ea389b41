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
from repro_torch.core.surveillance import SurveillanceEngine, _FitStore  # noqa: E402
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


def _check_job(job, tj):
    """One job's state in the port's engine against the reference's."""
    assert tj.fitted_step == job.fitted_step
    assert tj.origin_step == job.origin_step
    np.testing.assert_array_equal(tj.lm_series.numpy(), job.lm_series)
    assert (tj.model is None) == (job.model is None)
    if job.model is not None:
        assert tj.model.period == job.model.period
        np.testing.assert_array_equal(tj.model.profile_lm,
                                      job.model.profile_lm)
        np.testing.assert_array_equal(tj.model.array_lm, job.model.array_lm)
        np.testing.assert_array_equal(tj.model.array_nlm,
                                      job.model.array_nlm)
        assert tj.model.confidence == pytest.approx(
            job.model.confidence, rel=1e-4, abs=1e-7)


def _check_tick(jr, tr, jeng, teng):
    assert tr.refitted == jr.refitted
    assert tr.fleet == jr.fleet
    assert tr.remain == jr.remain
    assert tr.confidence.keys() == jr.confidence.keys()
    for k, c in jr.confidence.items():
        assert tr.confidence[k] == pytest.approx(c, rel=1e-4, abs=1e-7)
    assert list(teng.jobs) == list(jeng.jobs)
    for k, job in jeng.jobs.items():
        _check_job(job, teng.jobs[k])


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


@pytest.mark.parametrize("case", ["churn", "invalidate", "blackout",
                                  "folded"])
def test_lifecycle_matches_reference(setup, case):
    """Both engines through one lifecycle: 48 jobs registered, a forced
    refit, then ticks on slid windows (the classify splice). ``churn``
    unregisters six jobs, registers 16 more plus one on a buffer of its
    own, which grows the port's store past its first 64 rows, and
    registers one id anew (a handle to each of two replaced jobs is kept,
    and reads the fit it had);
    ``invalidate`` forces a third of the fits stale before each tick as
    ``FleetSim`` does on a guard abort (``fitted_step = -1``, the decide
    cache cleared); ``blackout`` starves 12 windows of samples; ``folded``
    takes the phase-folded profiles. Each job's fit and each tick's
    decisions are equal, and an ``lm_series`` read before a refit keeps its
    values after it."""
    jnb, tnb, vals = setup
    folded = case == "folded"
    jfleet = JaxFleet(J, capacity=2 * WINDOW)
    tfleet = FleetTelemetry(J, capacity=2 * WINDOW, device=CPU)
    jlone, tlone = JaxBuffer(capacity=256), TelemetryBuffer(capacity=256)
    jeng = JaxEngine(folded=folded)
    teng = SurveillanceEngine(folded=folded, device=CPU)
    both = [(jeng, jfleet, jnb, jlone), (teng, tfleet, tnb, tlone)]
    step = 0

    def register(rows):
        for eng, fleet, nb, _ in both:
            for i in rows:
                eng.register(f"j{i}", fleet.view(i), nb, window=WINDOW)

    def record(n):
        nonlocal step
        for _ in range(n):
            v = vals[step].copy()
            if case == "blackout" and 150 <= step < 230:
                v[:12] = np.nan
            for _, fleet, _, lone in both:
                fleet.record_fleet(step, v)
                lone.record(step, **dict(zip(tfleet.fields, v[J - 1])))
            step += 1

    register(range(48))
    record(WINDOW)
    assert teng.refresh(force=True) == jeng.refresh(force=True) == 48
    kept = None
    for n_rec in (7, 23, 40, 70, 30):
        if case == "churn" and kept is None:
            kept = [(jeng.jobs[k], teng.jobs[k]) for k in ("j3", "j5")]
            for k in ("j3", "j10", "j20", "j21", "j22", "j23"):
                jeng.unregister(k)
                teng.unregister(k)
            register(range(48, 64))
            for eng, _, nb, lone in both:
                eng.register("lone", lone, nb, window=WINDOW)
            register([5])
            # 42 live rows at the 65th registration: the store doubled and
            # kept only them; the re-registered j5 freed its row
            assert teng._store.cap == 128 and teng._store.n == 60
            assert teng._store.live[:60].sum() == 59
        record(n_rec)
        if case == "invalidate":
            for eng in (jeng, teng):
                for k in list(eng.jobs)[::3]:
                    if eng.jobs[k].fitted_step >= 0:
                        eng.jobs[k].fitted_step = -1
                eng._decide_cache = None
        before = [(j.lm_series, j.lm_series.clone())
                  for j in teng.jobs.values()]
        jr, tr = jeng.tick(step - 1), teng.tick(step - 1)
        _check_tick(jr, tr, jeng, teng)
        assert tr.refitted > 0
        for series, copy in before:
            assert torch.equal(series, copy)
        for job, tj in kept or ():
            _check_job(job, tj)
    if case == "blackout":
        assert [teng.jobs[f"j{i}"].model.period for i in range(12)] != \
            [0] * 12                       # recovered
    assert teng.next_refresh_step(step) == jeng.next_refresh_step(step)


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


def test_registering_a_fleet_grows_the_store_by_doubling(setup,
                                                         monkeypatch):
    """16,384 registrations reallocate the fit store O(log n) times,
    doubling from 64 rows."""
    _, tnb, _ = setup
    takes = []
    take = _FitStore._take

    def counted(self, *a):
        takes.append(1)
        return take(self, *a)

    monkeypatch.setattr(_FitStore, "_take", counted)
    n = 16384
    fleet = FleetTelemetry(n, capacity=4, device=CPU)
    eng = SurveillanceEngine(device=CPU)
    for i, view in enumerate(fleet.views()):
        eng.register(f"j{i}", view, tnb, window=4)
    assert eng._store.n == eng._store.cap == n
    assert len(takes) == 1 + int(np.log2(n // 64))


def test_unregistered_rows_are_reclaimed(setup):
    """Rows freed by ``unregister`` are reclaimed when the store runs out
    of rows, in place of doubling while at most half are live; a handle to
    a job that left keeps reading the fit it had, and the jobs that stay
    keep theirs."""
    _, tnb, vals = setup
    fleet = FleetTelemetry(J, capacity=WINDOW, device=CPU)
    for s in range(WINDOW):
        fleet.record_fleet(s, vals[s])
    eng = SurveillanceEngine(device=CPU)
    for i in range(J):
        eng.register(f"j{i}", fleet.view(i), tnb, window=WINDOW)
    eng.refresh(force=True)
    gone, stays = eng.jobs["j7"], eng.jobs["j60"]
    fits = [(j.model, j.lm_series, j.origin_step, j.fitted_step)
            for j in (gone, stays)]
    for i in range(48):
        eng.unregister(f"j{i}")
    for i in range(40):
        eng.register(f"k{i}", fleet.view(i), tnb, window=WINDOW)
    st = eng._store
    assert (st.cap, st.n) == (64, 56) and st.live[:st.n].all()
    assert st.jobs[stays.row] is stays and gone._store is not st
    for job, (model, lm, origin, fitted) in zip((gone, stays), fits):
        assert job.model is model
        assert torch.equal(job.lm_series, lm)
        assert (job.origin_step, job.fitted_step) == (origin, fitted)
    fleet.record_fleet(WINDOW, vals[WINDOW])
    assert eng.refresh(force=True) == 56
    fresh = SurveillanceEngine(device=CPU)
    for k, job in eng.jobs.items():
        fresh.register(k, job.telemetry, tnb, window=WINDOW)
    fresh.refresh(force=True)
    for k, job in eng.jobs.items():
        want = fresh.jobs[k]
        assert (job.model.period, job.origin_step, job.fitted_step) == (
            want.model.period, want.origin_step, want.fitted_step)
        assert torch.equal(job.lm_series, want.lm_series)
    assert torch.equal(gone.lm_series, fits[0][1])
    assert gone.fitted_step == fits[0][3]


def test_shards_beyond_the_world_size_are_refused():
    """Without a process group there is one rank: two shards are refused
    (``core/shard.decide_mesh``); one shard is the unsharded path."""
    with pytest.raises(ValueError):
        SurveillanceEngine(shards=2, device=CPU)
    assert SurveillanceEngine(shards=1, device=CPU).mesh is None
