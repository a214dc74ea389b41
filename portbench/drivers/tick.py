"""Traffic of the LMCM's surveillance loop: back to back, every VM records
one telemetry sample (``FleetTelemetry.record_fleet``) and the engine ticks
(``SurveillanceEngine.tick``: refit the stale cycle fits, then Algorithm 2
for the whole fleet, the decisions on the host). With ``force_refit`` each
tick first refits every VM (``refresh(force=True)``, fig10's full
analysis); otherwise staleness epochs refit only the VMs whose window has
moved by a quarter period. ``stagger`` spreads the VMs' first fits over
that many steps in set-up, as VMs that joined the fleet at different
moments, so that their refits do not all fall on one tick.

The fleet (``vms``, ``window``, the classifier's and the staleness
settings) is the configuration's. Traffic keys: ``extra_steps`` (telemetry made past the
first window; steps beyond it reuse it, a whole number of Table 3 cycles
back), ``force_refit``, ``stagger``, ``warmup_ticks``, ``check_share``
(the chance that a window tick's decisions are kept for the check),
``check_max``, ``traced_ticks``.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench.lib import harness as H

def _column(step: int, window: int, extra: int) -> int:
    """The column of the made telemetry recorded at ``step``."""
    return step if step < window + extra else window + (step - window) % extra


def run(ctx: H.Ctx) -> dict:
    import torch
    from repro_torch.core import characterize
    from repro_torch.core.surveillance import SurveillanceEngine
    from repro_torch.core.telemetry import FleetTelemetry
    from portbench.gen import table3

    n = int(ctx.conf("vms"))
    win = int(ctx.conf("window"))
    extra = int(ctx.traffic("extra_steps"))
    force = bool(ctx.traffic("force_refit"))
    stagger = int(ctx.traffic("stagger"))
    dev = ctx.device
    if dev == "cuda":
        from repro_torch.kernels import build
        build.build_all()

    vals = table3.fleet_values(ctx.seed, n, win + extra)
    feats, labels = table3.training_set(ctx.seed, int(ctx.conf("nb_samples")))
    nb = characterize.fit(feats, labels, n_bins=int(ctx.conf("nb_bins")),
                          alpha=float(ctx.conf("nb_alpha")), device=dev)
    fleet = FleetTelemetry(n, capacity=win, device=dev)
    fleet.record_fleet_bulk(np.arange(win),
                            vals[:, :win].transpose(1, 0, 2))
    eng = SurveillanceEngine(device=dev, min_samples=int(ctx.conf(
        "min_samples")), acyclic_refit=int(ctx.conf("acyclic_refit")))
    ids = [f"vm{i:05d}" for i in range(n)]
    for i, view in enumerate(fleet.views()):
        eng.register(ids[i], view, nb, window=win)

    log: List[tuple] = []
    step = win - 1
    rows_all = np.arange(n)
    for k in range(stagger):                       # first fits, staggered
        if k:
            step += 1
            fleet.record_fleet(step, vals[:, _column(step, win, extra)])
        rows = rows_all[rows_all % stagger == k]
        eng.refresh([ids[r] for r in rows], force=True)
        log.append(("fit", step, None if stagger == 1 else rows))

    spans = H.Spans(ctx, tracing=ctx.trace)
    kept: Dict[int, dict] = {}
    state = {"step": step, "tick": 0, "prev": None, "refitted": []}
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 4]))
    keep_share = float(ctx.traffic("check_share"))
    keep_max = int(ctx.traffic("check_max"))

    def one_tick(keep: bool) -> None:
        s = state["step"] = state["step"] + 1
        with spans("record"):
            fleet.record_fleet(s, vals[:, _column(s, win, extra)])
        if force:
            with spans("refresh"):
                state["refitted"].append(eng.refresh(force=True))
            log.append(("fit", s, None))
        with spans("tick"):
            res = eng.tick(s)
            remain = res.remain
        if not force:
            state["refitted"].append(res.refitted)
        log.append(("tick", s))
        state["prev"] = remain
        if keep:
            kept[state["tick"]] = remain
        state["tick"] += 1

    for _ in range(int(ctx.traffic("warmup_ticks"))):
        one_tick(False)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    spans.clear()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()

    record = None
    if ctx.trace:
        from portbench.lib.trace import Record, Tracer
        record = Record(ctx.cell, ctx.workload, ctx.config)
        tracer = Tracer(ctx.device)
        state["refitted"] = []
        with tracer.window():
            for _ in range(int(ctx.traffic("traced_ticks"))):
                one_tick(False)
        tracer.read(record, spans)
        record.counters["refitted"] = list(state["refitted"])
        n_ticks, t_win = int(ctx.traffic("traced_ticks")), record.window_s
        kept[state["tick"] - 1] = state["prev"]
    else:
        def body(i):
            one_tick(bool(rng.random() < keep_share) and len(kept) < keep_max)
        n_ticks, t_win = H.window(ctx.seconds, body, ctx.sync)
        kept[state["tick"] - 1] = state["prev"]     # the last tick's, always
    peak = H.peak_bytes(ctx)
    fits = _fits(eng, ids)

    del eng, fleet, nb
    H.free_device(ctx)
    checks, extra_out = check(ctx, vals, feats, labels, log, kept, fits, ids)
    return {"setup_s": setup_s, "window_s": t_win, "attempted": n_ticks,
            "failed": 0, "peak_bytes": peak, "record": record,
            "metrics": {"tick_ms": 1e3 * t_win / n_ticks},
            "checks": checks, **extra_out}


def _fits(eng, ids) -> Dict[str, np.ndarray]:
    """Each VM's cycle fit as the last tick left it: its period (0
    acyclic, -1 none) and the first step of the window it was fit on
    (read once the window has closed, from the engine's per-VM state)."""
    period = np.full(len(ids), -1, np.int64)
    origin = np.full(len(ids), -1, np.int64)
    for i, jid in enumerate(ids):
        job = eng.jobs[jid]
        if job.model is not None:
            period[i] = int(job.model.period)
            origin[i] = int(job.origin_step)
    return {"period": period, "origin": origin}


def check(ctx: H.Ctx, vals, feats, labels, log, kept, fits, ids) -> tuple:
    """The window's outputs against the reference's replay of the same
    traffic: every VM's RemainTime at each kept tick, and at the last tick
    also every VM's period and the window its fit used. A VM counts once
    at a tick where any of them differs. With ``ctx.control`` also the
    control's reading: the reference without the lag refinement in the
    program's place."""
    import torch
    ref = H.load_module("refs", ctx.workload["config"])
    dev = ctx.device
    win = int(ctx.conf("window"))
    extra = int(ctx.traffic("extra_steps"))
    vals_dev = torch.as_tensor(vals, device=dev)
    t0 = time.perf_counter()

    def values(steps, rows):
        cols = torch.as_tensor([_column(int(s), win, extra) for s in steps],
                               device=dev)
        return vals_dev[rows.to(dev)][:, cols]

    nb = ref.nb_fit(feats, labels, bins=int(ctx.conf("nb_bins")),
                    alpha=float(ctx.conf("nb_alpha")), n_classes=4,
                    device=dev)
    cfg = {"window": win, "min_period": int(ctx.conf("min_period")),
           "acyclic_refit": int(ctx.conf("acyclic_refit"))}
    wanted = sorted(kept)
    want, last = ref.replay(cfg, nb, values, len(ids), log, wanted, dev)
    compared = len(wanted) * len(ids)
    bad = sum(ref.mismatches(kept[t], ids, want[t],
                             fits if t == wanted[-1] else None,
                             last if t == wanted[-1] else None)
              for t in wanted)
    limit = float(ctx.workload["limits"]["decision_mismatch_share"])
    checks = [H.Check("decision_mismatch_share", bad / compared, limit)]
    out = {"check_s": time.perf_counter() - t0, "compared": compared,
           "lower_reading": {"decision_mismatch_share": bad / compared}}
    if ctx.control:
        ctrl, ctrl_last = ref.replay(cfg, nb, values, len(ids), log, wanted,
                                     dev, refine=False)
        got = {k: v.cpu().numpy() for k, v in ctrl_last.items()}
        out["control_reading"] = {"decision_mismatch_share": sum(
            ref.mismatches(dict(zip(ids, ctrl[t].tolist())), ids, want[t],
                           got if t == wanted[-1] else None,
                           last if t == wanted[-1] else None)
            for t in wanted) / compared}
    return checks, out
