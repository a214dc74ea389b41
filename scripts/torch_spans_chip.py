"""The port's span recorder (``repro_torch.runtime.spans``) on the
benchmark's cells: where the device's idle time goes, and what the
recorder costs when it is on. Not part of a benchmark run.

    python3 scripts/torch_spans_chip.py [--cells C ...] [--seconds 10]

First the host cost of one span site, off and on. Then for each cell,
all in one process: an untraced run that turns the recorder on and off
in turns, a tick (from one ``record_fleet`` to the next) or a decode step
(``Replica.decode``, to its tokens on the host) at a time, and reports
each half's host times; then one traced run (``--trace 1``'s window, the
recorder on with the profiler), whose idle gaps are cut at the program's
spans (``portbench/lib/program.named_gaps``): its per-layer metrics, the
idle time by the name of the span it falls in, each program span's host
time, and each migration's modelled downtime beside ``stop_copy_ms``.
One JSON line a run goes to ``--out`` (``build/spans_chip.jsonl``).
``--device cpu --sizes JSON`` runs the cells small without a card, as
the benchmark's tests do.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = ["tick-16k-refit", "internlm2-decode-migrate", "internlm2-prefill"]


def site_ns(n: int = 200_000) -> dict:
    """Host ns of one ``with spans.span(name, key)`` site and of
    one ``count``, the recorder off and on."""
    from repro_torch.runtime import spans
    out = {}
    for on in (False, True):
        if on:
            spans.enable()
        t = time.perf_counter()
        for i in range(n):
            with spans.span("lm.block", ("attn", i)):
                pass
        t_span = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n):
            spans.count("c", i)
        t_count = time.perf_counter() - t
        spans.disable()
        spans.drain()
        out["on" if on else "off"] = {"span": 1e9 * t_span / n,
                                      "count": 1e9 * t_count / n}
    return out


class Probes:
    """What the drivers do not return: the tracer and the benchmark's
    spans of the traced window, each migration's modelled downtime, and
    the host time of each tick and each decode step. With ``alternate``
    the recorder is on for every other tick or decode step, and each time
    is kept beside the recorder's state."""

    def __init__(self):
        from portbench.lib import serve, trace
        from repro_torch.core import precopy
        from repro_torch.core.telemetry import FleetTelemetry
        from repro_torch.runtime import spans
        self.tracer = self.bench = None
        self.alternate = False
        self.downtime, self.decode_s, self.tick_s = [], [], []
        self.tick0 = None
        read, migrate = trace.Tracer.read, precopy.migrate
        decode, record = serve.Replica.decode, FleetTelemetry.record_fleet

        def state(n: int):
            """The recorder's state for the n-th step: None (as it is)
            unless alternating."""
            if not self.alternate:
                return None
            on = n % 2 == 1
            (spans.enable if on else spans.disable)()
            return on

        def read_kept(tracer, rec, bench):
            self.tracer, self.bench = tracer, bench
            return read(tracer, rec, bench)

        def migrate_kept(*a, **kw):
            dest, rep = migrate(*a, **kw)
            self.downtime.append(rep.outcome.downtime)
            return dest, rep

        def decode_timed(replica):
            on = state(len(self.decode_s))
            t = time.perf_counter()
            decode(replica)
            self.decode_s.append((on, time.perf_counter() - t))

        def record_timed(fleet, *a, **kw):
            t = time.perf_counter()
            if self.tick0 is not None:
                self.tick_s.append((self.tick0[0], t - self.tick0[1]))
            self.tick0 = (state(len(self.tick_s)), t)
            return record(fleet, *a, **kw)

        trace.Tracer.read = read_kept
        precopy.migrate = migrate_kept
        serve.Replica.decode = decode_timed
        FleetTelemetry.record_fleet = record_timed

    def clear(self):
        self.downtime.clear()
        self.decode_s.clear()
        self.tick_s.clear()
        self.tick0 = None


def _halves(times) -> dict:
    """Median host ms of the steps with the recorder off and on (or of
    all, where it did not alternate)."""
    out = {}
    for on, key in ((False, "off"), (True, "on"), (None, "all")):
        t = [s for o, s in times if o is on]
        if t:
            out[key] = {"n": len(t), "median": 1e3 * statistics.median(t)}
    return out


def _program_by_name(spans) -> dict:
    """name -> [spans, host ms]."""
    out: dict = {}
    for s in spans:
        if s.end is not None:
            n = out.setdefault(s.name, [0, 0.0])
            n[0] += 1
            n[1] += 1e3 * (s.end - s.start)
    return out


def one_run(cell, seed, traced, args, probes) -> dict:
    from portbench.lib import harness as H
    from portbench.lib import program as P
    from repro_torch.runtime import spans
    wl, cfg = H.cell_files(cell)
    ctx = H.Ctx(cell, wl, cfg, H.seed_int(seed), args.seconds, traced,
                device=args.device, sizes=json.loads(args.sizes))
    probes.clear()
    probes.alternate = not traced
    try:
        out = H.load_module("drivers", wl["driver"]).run(ctx)
    finally:
        probes.alternate = False
        if not traced:
            spans.disable()
            spans.drain()
    line = {"cell": cell, "seed": seed, "trace": traced,
            "setup_s": out["setup_s"], "window_s": out["window_s"],
            "attempted": out["attempted"], "metrics": out["metrics"],
            "correct": all(c.ok for c in out["checks"]),
            "decode_step_ms": _halves(probes.decode_s),
            "tick_ms": _halves(probes.tick_s)}
    if not traced:
        return line
    rec = out["record"]
    line["per_layer"] = {
        m["name"]: H.load_module("layer_metrics", m["name"]).read(rec)
        for m in H.benchmark()["per_layer"] if cell in m["workloads"]}
    program = P.recording(rec)[0]
    program_by = _program_by_name(program)
    idle: dict = {}
    for name, s in P.named_gaps(probes.tracer, probes.bench, program):
        idle[name] = idle.get(name, 0.0) + s
    total = sum(idle.values())
    # the window's migrations are the last ones (set-up's came first)
    n_down = len(probes.downtime)
    n_stop = program_by.get("precopy.stop_and_copy", [0])[0]
    line.update(
        window_s=rec.window_s, busy_s=rec.busy_s, idle_s=total,
        idle_by_name=sorted(([n, s] for n, s in idle.items()),
                            key=lambda kv: -kv[1]),
        idle_program_share=(sum(s for n, s in idle.items()
                                if n in program_by) / total
                            if total else None),
        old_idle_gaps=rec.breakdown()["idle_gaps"],
        program_ms=program_by,
        benchmark_ms={k: [len(v), 1e3 * sum(v)]
                      for k, v in rec.spans.items()},
        downtime_ms=[1e3 * t for t in probes.downtime[n_down - n_stop:]])
    return line


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=CELLS)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=3_100_000_007)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="{}")
    ap.add_argument("--out", default=str(ROOT / "build" / "spans_chip.jsonl"))
    args = ap.parse_args(argv)
    run._environment()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_spans_chip: no card", file=sys.stderr)
            return 3
        print(f"card: {run._card_line()}; torch {torch.__version__}",
              flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    probes = Probes()
    with open(out, "a") as f:
        sites = {"site_ns": site_ns()}
        f.write(json.dumps(sites) + "\n")
        print(json.dumps(sites), flush=True)
        for c, cell in enumerate(args.cells):
            for seed, traced in ((args.seed + 10 * c, False),
                                 (args.seed + 10 * c + 1, True)):
                line = one_run(cell, seed, traced, args, probes)
                f.write(json.dumps(line) + "\n")
                f.flush()
                brief = {k: line[k] for k in
                         ("cell", "seed", "trace", "metrics", "correct",
                          "decode_step_ms", "tick_ms", "per_layer",
                          "idle_program_share", "downtime_ms")
                         if k in line}
                if "idle_by_name" in line:
                    brief["idle_top"] = line["idle_by_name"][:8]
                print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
