"""The port's span-and-counter recorder (``repro_torch.runtime.spans``) on
the CPU: off, a span site records nothing; on, spans nest with their
parents and keys; the surveillance tick, the pre-copy engine and the
decode step record their stages in order, with counts equal to what the
program returns; and the results are bit-identical with the recorder on
and off."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import characterize, cycles, precopy  # noqa: E402
from repro_torch.core.surveillance import SurveillanceEngine  # noqa: E402
from repro_torch.core.telemetry import FleetTelemetry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402

J, WINDOW = 24, 64


@pytest.fixture
def recorder():
    """A clean recorder, off again afterwards; ``take()`` stops it and
    returns what it held."""
    spans.disable()
    spans.drain()

    def take():
        spans.disable()
        return spans.drain()

    yield take
    spans.disable()
    spans.drain()


def _children(recorded, i):
    """Indices of the spans whose parent is span ``i``."""
    return [k for k, s in enumerate(recorded) if s.parent == i]


def _names(recorded, i):
    return [recorded[k].name for k in _children(recorded, i)]


def _at(recorded, name, n=0):
    return [i for i, s in enumerate(recorded) if s.name == name][n]


def test_off_records_nothing(recorder):
    assert not spans.enabled()
    site = spans.span("a", 1)
    assert site is spans.span("b") is spans._NOOP
    with site:
        spans.count("c", [1, 2])
    assert spans.drain() == ([], {})


def test_nesting_gives_parents_and_keys(recorder):
    spans.enable()
    with spans.span("a", 7):
        with spans.span("b"):
            spans.count("n", 5)
        with spans.span("c", ("attn", 3)):
            other = threading.Thread(
                target=lambda: spans.span("t").__enter__().__exit__())
            other.start()
            other.join(timeout=30)
            assert not other.is_alive()
    spans.count("top", 1)
    with spans.span("d"):
        pass
    recorded, counters = recorder()
    assert [s.name for s in recorded] == ["a", "b", "c", "t", "d"]
    assert [s.parent for s in recorded] == [-1, 0, 0, -1, -1]
    assert [s.key for s in recorded] == [7, None, ("attn", 3), None, None]
    assert all(s.start <= s.end for s in recorded)
    a, b, c = recorded[:3]
    assert a.start <= b.start <= b.end <= c.start <= c.end <= a.end
    assert counters == {"n": [(1, 5)], "top": [(-1, 1)]}
    assert spans.drain() == ([], {})


def test_the_recorder_follows_the_profiler(recorder):
    from torch.profiler import ProfilerActivity, profile
    assert spans.FOLLOWS_PROFILER
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.enabled()
        with spans.span("inside"):
            torch.ones(3).sum()
    assert not spans.enabled()
    with spans.span("after"):
        pass
    recorded, _ = spans.drain()
    assert [s.name for s in recorded] == ["inside"]


def test_a_profiler_leaves_an_explicit_recording_alone(recorder):
    from torch.profiler import ProfilerActivity, profile
    spans.enable()
    with spans.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("inside"):
            pass
    assert spans.enabled()
    with spans.span("after"):
        pass
    recorded, _ = recorder()
    assert [s.name for s in recorded] == ["before", "inside", "after"]


def test_a_recording_keeps_at_most_its_limit(recorder, monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    spans.enable()
    with pytest.warns(RuntimeWarning, match="3 records undrained") as said:
        for i in range(5):
            with spans.span("s", i):
                spans.count("c", i)
    assert len(said) == 1
    recorded, counters = spans.drain()
    assert [s.key for s in recorded] == [0, 1]
    assert counters == {"c": [(0, 0)]}
    with spans.span("again"):              # a drain makes room again
        pass
    assert [s.name for s in recorder()[0]] == ["again"]


# ---------------------------------------------------------------------------
# the surveillance tick
# ---------------------------------------------------------------------------
def _nb():
    """NB on features that name their class: feature c high for class c."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 2000)
    feats = 0.05 * rng.standard_normal((2000, 6))
    feats[np.arange(2000), labels] += 1.0
    return characterize.fit(feats.astype(np.float32), labels, device="cpu")


def _values(step: int) -> np.ndarray:
    """(J, 6): each VM alternates CPU and MEM with a period of its own."""
    rng = np.random.default_rng(step)
    period = 8 + np.arange(J) % 5 * 4
    cls = ((step + 3 * np.arange(J)) % period < period // 2).astype(int)
    out = 0.05 * rng.standard_normal((J, 6))
    out[np.arange(J), cls] += 1.0
    return out


def _fleet(nb, overlap=False):
    fleet = FleetTelemetry(J, capacity=WINDOW, device="cpu")
    for s in range(WINDOW):
        fleet.record_fleet(s, _values(s))
    eng = SurveillanceEngine(device="cpu", overlap=overlap)
    for i, view in enumerate(fleet.views()):
        eng.register(f"vm{i}", view, nb, window=WINDOW)
    return fleet, eng


def _run_ticks(fleet, eng):
    """A forced refit and a tick, then 8 more samples and a tick (every
    fit stale)."""
    step = WINDOW - 1
    eng.refresh(force=True)
    out = [eng.tick(step)]
    for _ in range(8):
        step += 1
        fleet.record_fleet(step, _values(step))
    out.append(eng.tick(step))
    return [(r.remain, r.refitted, r.fleet) for r in out]


def test_tick_records_its_stages_in_order(recorder):
    fleet, eng = _fleet(_nb())
    spans.enable()
    results = _run_ticks(fleet, eng)
    recorded, counters = recorder()
    top = _names(recorded, -1)
    assert top == ["surveillance.refresh", "surveillance.tick"] + [
        "telemetry.record_fleet"] * 8 + ["surveillance.tick"]
    forced = _at(recorded, "surveillance.refresh")
    stages = ["surveillance.select", "surveillance.gather",
              "surveillance.classify", "cycles.fit", "surveillance.commit"]
    assert _names(recorded, forced) == stages
    fit = _at(recorded, "cycles.fit")
    assert _names(recorded, fit) == ["cycles.to_host", "cycles.spectrum",
                                     "cycles.refine", "cycles.models"]
    ticks = [i for i, s in enumerate(recorded)
             if s.name == "surveillance.tick"]
    assert [recorded[i].key for i in ticks] == [WINDOW - 1, WINDOW + 7]
    # the first tick finds nothing stale: the staleness scan, the packing
    # the forced refit left to do, and the decide
    assert _names(recorded, ticks[0]) == ["surveillance.refresh",
                                          "surveillance.pack",
                                          "surveillance.decide"]
    assert _names(recorded, _children(recorded, ticks[0])[0]) == [
        "surveillance.select"]
    second = _at(recorded, "surveillance.refresh", 2)
    assert recorded[second].parent == ticks[1]
    assert _names(recorded, second) == stages
    # every fit stale: refit, packed again, decided
    assert _names(recorded, ticks[1]) == _names(recorded, ticks[0])
    assert [(r, n) for _, r, n in results] == [(0, J), (J, J)]
    assert counters == {}


@pytest.mark.parametrize("overlap", [False, True])
def test_tick_decisions_are_the_same_with_the_recorder_on(recorder, overlap):
    nb = _nb()
    off = _run_ticks(*_fleet(nb, overlap))
    spans.enable()
    on = _run_ticks(*_fleet(nb, overlap))
    recorded, _ = recorder()
    assert on == off
    # under overlap the thunk's host copy is a decide span of its own
    assert sum(s.name == "surveillance.decide"
               for s in recorded) == (4 if overlap else 2)


@pytest.mark.parametrize("folded", [False, True])
def test_model_views_are_built_on_read_and_match_the_list_view(monkeypatch,
                                                               folded):
    """A forced refit and a tick build no ``CycleModel``; reading
    ``job.model`` builds one a job, once until the next refit, each equal
    to ``fit_cycle_batch``'s for the job's series: cyclic rows, a constant
    LM row, a constant NLM row, and a row demoted to acyclic because most
    of its window is NaN."""
    built = []
    build = cycles.model_view

    def counted(*a, **kw):
        built.append(1)
        return build(*a, **kw)

    monkeypatch.setattr(cycles, "model_view", counted)
    fleet = FleetTelemetry(J, capacity=WINDOW, device="cpu")
    for s in range(WINDOW):
        v = _values(s)
        v[:2] = 0.0
        v[0, 0] = v[1, 1] = 1.0             # always CPU (LM), always MEM
        if s >= 8:
            v[2] = np.nan
        fleet.record_fleet(s, v)
    eng = SurveillanceEngine(device="cpu", folded=folded)
    for i, view in enumerate(fleet.views()):
        eng.register(f"vm{i}", view, _nb(), window=WINDOW)
    jobs = list(eng.jobs.values())
    eng.refresh(force=True)
    eng.tick(WINDOW - 1)
    assert not built and all(job._view is None for job in jobs)
    models = [job.model for job in jobs]
    assert all(job.model is m for job, m in zip(jobs, models))
    assert len(built) == J
    want = cycles.fit_cycle_batch(torch.stack([j.lm_series for j in jobs]),
                                  folded=folded)
    for got, m in zip(models[:2] + models[3:], want[:2] + want[3:]):
        assert (got.period, got.confidence) == (m.period, m.confidence)
        for a in ("profile_lm", "array_lm", "array_nlm"):
            np.testing.assert_array_equal(getattr(got, a), getattr(m, a))
    assert [(m.period, m.profile_lm.tolist()) for m in models[:2]] == [
        (0, [1]), (0, [0])]
    assert sum(m.period > 1 for m in models[3:]) == J - 3
    lm = jobs[2].lm_series.numpy()
    assert (models[2].period, models[2].confidence) == (0, 0.0)
    assert models[2].profile_lm.tolist() == [int(2 * lm.sum() >= len(lm))]
    built.clear()
    fleet.record_fleet(WINDOW, _values(WINDOW))
    eng.refresh(force=True)
    assert jobs[5].model is not models[5]
    assert len(built) == 1


# ---------------------------------------------------------------------------
# the pre-copy engine
# ---------------------------------------------------------------------------
def _live():
    rng = np.random.default_rng(3)
    state = {"w": torch.as_tensor(rng.standard_normal((40, 64)),
                                  dtype=torch.float32),
             "h": torch.as_tensor(rng.standard_normal(300),
                                  dtype=torch.float32).to(torch.bfloat16),
             "n": torch.tensor(0, dtype=torch.int32)}
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        k = calls["n"]
        state["w"][k % 40] += 0.5                 # one row a step
        state["n"] = state["n"] + 1

    return state, step


CFG = precopy.PrecopyConfig(block_elems=64, max_rounds=5,
                            stop_dirty_blocks=0)


def test_migration_records_its_rounds_and_pause(recorder, monkeypatch):
    state, step = _live()
    scan, dirty = precopy.dirty_scan, []

    def counted(live, shadow, block):
        masks, n, b = scan(live, shadow, block)
        dirty.append([bool(m.any()) for m in masks])
        return masks, n, b

    monkeypatch.setattr(precopy, "dirty_scan", counted)
    spans.enable()
    dest, rep = precopy.migrate(lambda: state, step, CFG)
    recorded, counters = recorder()
    rounds = rep.outcome.rounds
    assert _names(recorded, -1) == ["precopy.migrate"]
    assert _names(recorded, 0) == (["precopy.clone"]
                                   + ["precopy.round"] * rounds
                                   + ["precopy.stop_and_copy"])
    per_round = [i for i in _children(recorded, 0)
                 if recorded[i].name == "precopy.round"]
    assert [recorded[i].key for i in per_round] == list(range(1, rounds + 1))
    for k, i in enumerate(per_round):
        send = ["precopy.send"] if k < rounds - 1 else []
        assert _names(recorded, i) == ["precopy.step", "precopy.scan"] + send
    stop = _at(recorded, "precopy.stop_and_copy")
    assert _names(recorded, stop) == ["precopy.scan", "precopy.send"]

    sizes = [t.numel() * t.element_size() for t in tree.leaves(state)]
    assert sum(sizes) == rep.v_mem
    scans = counters["precopy.scan_bytes"]
    assert list(counters) == ["precopy.scan_bytes"]
    assert len(scans) == rounds + 1 == len(dirty)
    for (at, (read, in_dirty)), touched in zip(scans, dirty):
        # each scan reads every leaf
        assert recorded[at].name == "precopy.scan"
        assert read == rep.v_mem
        assert in_dirty == sum(b for b, t in zip(sizes, touched) if t)
    # leaves in key order: "h" is never written, "n" and a row of "w" are
    assert touched == [False, True, True]
    for a, b in zip(tree.leaves(dest), tree.leaves(state)):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_migration_is_the_same_with_the_recorder_on(recorder):
    def run():
        state, step = _live()
        dest, rep = precopy.migrate(lambda: state, step, CFG)
        return ([t.clone() for t in tree.leaves(dest)],
                rep.per_round_dirty_bytes, rep.outcome)

    off = run()
    spans.enable()
    on = run()
    recorded, _ = recorder()
    assert recorded
    assert on[1:] == off[1:]
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# the model step
# ---------------------------------------------------------------------------
def test_decode_step_records_one_block_a_layer(recorder):
    cfg = get_config("internlm2_1p8b").smoke()
    params = lm.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), dtype=torch.int32)
    spans.enable()
    logits, cache = make_prefill_step(cfg, cache_len=16)(
        params, {"tokens": tokens})
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    make_decode_step(cfg)(params, tok, cache)
    recorded, _ = recorder()
    assert _names(recorded, -1) == ["lm.forward", "lm.decode_step"]
    blocks = [("attn", i) for i in range(cfg.num_layers)]
    fwd, dec = _at(recorded, "lm.forward"), _at(recorded, "lm.decode_step")
    assert _names(recorded, fwd) == ["lm.embed"] + ["lm.block"] * len(blocks)
    assert _names(recorded, dec) == (["lm.embed"] + ["lm.block"] * len(blocks)
                                     + ["lm.head"])
    for i in (fwd, dec):
        assert [recorded[k].key for k in _children(recorded, i)
                if recorded[k].name == "lm.block"] == blocks
