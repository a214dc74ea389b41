"""``lib/calls.py``: every kernel entry of ``ops`` recorded inside a traced
window. Each cell's traced run, small on the CPU, gives the counters it
gave when each driver wrapped its own kernels (the wrappers below are
those drivers' own, installed around the window as they were), and every
per-layer reader reads the same value from either."""
import contextlib
import copy
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _hand_made(calls: dict):
    """The drivers' own wrappers before ``lib/calls.py``: (entry of ops,
    its wrapper) each, recording into ``calls``."""
    from repro_torch.kernels import ops
    spec, scores = ops.power_spectrum, ops.autocorr_score
    many, attn = ops.dirty_blocks_many, ops.flash_attention

    def spec_rec(x, *a, **kw):
        calls["spectrum"].append(tuple(x.shape))
        return spec(x, *a, **kw)

    def scores_rec(x, lags, *a, **kw):
        calls["autocorr"].append((*x.shape, lags.tolist()))
        return scores(x, lags, *a, **kw)

    def many_rec(news, olds, *a, **kw):
        calls["scans"].append(([(n.numel(), n.element_size()) for n in news
                                if n.is_floating_point()], kw["block"]))
        return many(news, olds, *a, **kw)

    def attn_rec(q, k, v, **kw):
        calls["attention"].append((q.shape[0], q.shape[1], k.shape[1],
                                   q.shape[2], q.shape[3],
                                   q.element_size(), kw.get("window", 0)))
        return attn(q, k, v, **kw)

    return {"power_spectrum": spec_rec, "autocorr_score": scores_rec,
            "dirty_blocks_many": many_rec, "flash_attention": attn_rec}


@pytest.fixture
def before(monkeypatch):
    """The hand-made wrappers set around every traced window, and each
    serving replica kept: the counters as the drivers made them."""
    from portbench.lib import serve, trace
    from repro_torch.kernels import ops
    got = {"calls": {k: [] for k in ("spectrum", "autocorr", "scans",
                                     "attention")}, "replicas": []}
    window, init = trace.Tracer.window, serve.Replica.__init__

    @contextlib.contextmanager
    def wrapped(self):
        with monkeypatch.context() as m:
            for name, fn in _hand_made(got["calls"]).items():
                m.setattr(ops, name, fn)
            with window(self):
                yield

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        got["replicas"].append(self)

    monkeypatch.setattr(trace.Tracer, "window", wrapped)
    monkeypatch.setattr(serve.Replica, "__init__", keep)
    return got


def _old_counters(cell, out, got) -> dict:
    """What the cell's driver recorded before: its kernels' calls, and its
    operation counts from ``counts.lm``."""
    from portbench.counts import lm as C
    from portbench.lib import harness as H
    from portbench.tests.conftest import small_sizes
    rec = out["record"]
    wl, cfg = H.cell_files(cell)
    calls = got["calls"]
    if wl["driver"] == "tick":
        return {"refitted": rec.counters["refitted"],
                "spectrum": calls["spectrum"], "autocorr": calls["autocorr"]}
    sizes = small_sizes(cfg)
    cfg, B = {**cfg, **sizes["config"]}, sizes["batch"]
    if wl["driver"] == "prefill_batches":
        return {"attention": calls["attention"],
                "prefill_flops": out["attempted"] * C.prefill_flops(
                    cfg, B, sizes["prompt"])}
    end = got["replicas"][-1].pos
    n = len(rec.spans.get("decode", []))
    return {"scans": calls["scans"],
            "migrations": rec.counters["migrations"],
            "decode_flops": sum(C.decode_flops(cfg, B, end - k)
                                for k in range(n))}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_gives_the_counters_it_gave_before(run_small, before,
                                                       cell):
    from portbench.lib import calls, harness as H, program as P
    out = run_small(cell, seed=41, trace=True)
    rec = out["record"]
    old = _old_counters(cell, out, before)
    assert any(old[k] for k in old if k in ("spectrum", "scans",
                                            "attention"))
    for key, value in old.items():
        assert rec.counters[key] == value, key
    assert {c for c, _ in calls.ENTRIES.values()} <= set(rec.counters)
    P.recording(rec)                     # drained once, then shared
    then = copy.copy(rec)
    then.counters = old
    for name in [m["name"] for m in H.benchmark()["per_layer"]
                 if cell in m["workloads"]]:
        read = H.load_module("layer_metrics", name).read
        assert read(then) == read(rec), name


def test_ssm_scan_is_recorded_with_its_distinct_inputs():
    """A Mamba2 layer and an RWKV6 layer's prefill through ``ops.ssm_scan``
    inside ``recorded``: one record a call, the broadcast B, C and decay
    counted once, the bonus and initial state where given."""
    from portbench.lib import calls
    from repro_torch.kernels import ops
    B, H, S, Dk, Dv = 2, 3, 8, 4, 5
    qk = torch.randn(B, S, Dk)[:, None].expand(B, H, S, Dk)
    v = torch.randn(B, H, S, Dv)
    w = (-torch.rand(B, H, S))[..., None].expand(B, H, S, Dk)
    bonus, s0 = torch.randn(H, Dk), torch.randn(B, H, Dk, Dv)
    entries = {n: getattr(ops, n) for n in calls.ENTRIES}
    with calls.recorded() as got:
        ops.ssm_scan(qk, qk, v, w)
        ops.ssm_scan(v[..., :Dk], v[..., :Dk], v, w.contiguous(),
                     bonus=bonus, initial_state=s0)
    assert {n: getattr(ops, n) for n in calls.ENTRIES} == entries
    assert got["ssm_scan"] == [
        (B, H, S, Dk, Dv, ((B * S * Dk, 4),) * 2 + ((B * H * S * Dv, 4),
                                                    (B * H * S, 4)),
         False, False),
        (B, H, S, Dk, Dv, ((B * H * S * Dk, 4),) * 2
         + ((B * H * S * Dv, 4), (B * H * S * Dk, 4), (H * Dk, 4),
            (B * H * Dk * Dv, 4)), True, True)]
    assert all(got[c] == [] for c in ("spectrum", "autocorr", "scans",
                                      "attention"))
