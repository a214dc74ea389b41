"""The check that decides ``correct`` fails a broken timed path: each cell
driven small on the CPU (the look for a card skipped), with each fault the
cell can have planted underneath it in the program's own functions, and
its control, which must read well above the program."""
import json
import subprocess
import sys
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _cells_of(*drivers):
    """The cells of ``BENCHMARK.json`` whose traffic runs one of
    ``drivers``, in its order."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]
            if json.loads((ROOT / "portbench" / "workloads"
                           / f"{w['name']}.json").read_text())["driver"]
            in drivers]


TICKS = _cells_of("tick")
SERVING = _cells_of("decode_migrate", "prefill_batches")
# one chip: no exchange between chips to leave out; the stop-and-copy
# only where a migration runs
FAULTS = ([(c, f) for c in TICKS + SERVING
           for f in ("unchanged", "half", "altered")]
          + [(c, "no_final_copy") for c in _cells_of("decode_migrate")])


def _plant_tick(monkeypatch, fault):
    """``SurveillanceEngine.tick`` answering wrong: the first answer every
    tick, half the fleet's decisions missing, or one VM in 64 off by one."""
    from repro_torch.core import surveillance as S
    tick, first = S.SurveillanceEngine.tick, {}

    def broken(self, now_step):
        res = tick(self, now_step)
        remain = res.remain
        if fault == "unchanged":
            remain = first.setdefault("remain", remain)
        elif fault == "half":
            remain = {k: v for i, (k, v) in enumerate(remain.items())
                      if i % 2 == 0}
        else:
            remain = {k: v + (1 if i % 64 == 0 else 0)
                      for i, (k, v) in enumerate(remain.items())}
        return S.TickResult(remain, res.refitted, res.fleet, res.confidence)

    monkeypatch.setattr(S.SurveillanceEngine, "tick", broken)


def _frozen(cache):
    if isinstance(cache, torch.Tensor):
        return cache.clone()
    if isinstance(cache, dict):
        return {k: _frozen(v) for k, v in cache.items()}
    return type(cache)(_frozen(v) for v in cache)


def _plant_serving(monkeypatch, fault):
    """The decode step broken: its cache never written, half the batch's
    tokens replaced (each step the other half), one token a step altered where it is produced (each
    step another sequence's, so that every request the check samples holds
    one), or the stop-and-copy sending nothing."""
    import repro_torch.train as T
    if fault == "no_final_copy":
        from repro_torch.core import precopy
        scan, count = precopy.dirty_scan, {"n": 0}

        def lossy(live, shadow, block):
            masks, n, b = scan(live, shadow, block)
            count["n"] += 1
            if count["n"] % 4 == 0:          # max_rounds 3, then the stop
                masks = [torch.zeros_like(m) for m in masks]
            return masks, n, b

        monkeypatch.setattr(precopy, "dirty_scan", lossy)
        return
    make = T.make_decode_step
    steps = {"n": 0}

    def make_broken(arch, **kw):
        step = make(arch, **kw)

        def broken(params, tok, cache):
            if fault == "unchanged":
                nxt, logits, _ = step(params, tok, _frozen(cache))
                return nxt, logits, cache
            nxt, logits, cache = step(params, tok, cache)
            nxt = nxt.clone()
            if fault == "half":                # each step the other half
                h = len(nxt) // 2
                lo = h if steps["n"] % 2 else 0
                nxt[lo:lo + h] = 0
            else:
                i = steps["n"] % len(nxt)
                nxt[i, 0] = (nxt[i, 0] + 1) % logits.shape[-1]
            steps["n"] += 1
            return nxt, logits, cache
        return broken

    monkeypatch.setattr(T, "make_decode_step", make_broken)


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_fault_is_not_correct(run_small, monkeypatch, cell, fault):
    if cell in TICKS:
        _plant_tick(monkeypatch, fault)
    else:
        _plant_serving(monkeypatch, fault)
    # a second's window, so that a batch fills before the check reads it
    out = run_small(cell, seed=17, seconds=1.0)
    assert not all(c.ok for c in out["checks"]), [
        (c.name, c.value, c.limit) for c in out["checks"]]


@pytest.mark.parametrize("cell", TICKS + SERVING)
def test_a_sound_run_is_correct(run_small, cell):
    out = run_small(cell, seed=23)
    assert all(c.ok for c in out["checks"]), [
        (c.name, c.value, c.limit) for c in out["checks"]]


@pytest.mark.parametrize("cell", TICKS + SERVING)
def test_the_control_reads_far_above_the_program(run_small, cell):
    """The control (float8 for the bf16 model; the decide plane without
    its lag refinement) at a small size: three times the program's reading
    at least, and above the cell's limit where that limit is a count."""
    out = run_small(cell, seed=29, control=True)
    (name, low), = [(k, v) for k, v in out["lower_reading"].items()
                    if k in out["control_reading"]]
    high = out["control_reading"][name]
    assert high > 0 and high >= 3 * low, (name, low, high)


def test_controls_script_runs_small():
    sizes = {"vms": 64, "window": 128, "extra_steps": 180,
             "warmup_ticks": 1, "check_share": 0.5}
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "controls.py"),
         "--workload", "tick-16k-refit", "--seconds", "0.2", "--seeds", "3",
         "--device", "cpu", "--sizes", json.dumps(sizes)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["lower"]["decision_mismatch_share"] == 0
    assert line["control"]["decision_mismatch_share"] > 0


@pytest.mark.parametrize("cell", TICKS + SERVING)
def test_a_traced_run_reads_its_span_and_counter_metrics(run_small, cell):
    """A traced run small on the CPU: every per-layer metric of the cell
    that reads the benchmark's spans or the program's counters gives a
    number (those of the device trace need the card)."""
    from portbench.lib import harness as H
    out = run_small(cell, seed=31, trace=True)
    assert all(c.ok for c in out["checks"])
    for m in H.benchmark()["per_layer"]:
        if cell in m["workloads"] and m["source"] != "device_trace":
            v = H.load_module("layer_metrics", m["name"]).read(out["record"])
            assert v is not None and v > 0, m["name"]
