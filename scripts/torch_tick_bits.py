"""Bit check of the port's surveillance tick between two checkouts.

``run`` drives one checkout's ``SurveillanceEngine`` through the traffic of
a ``portbench`` tick workload (the same fleet, classifier and telemetry
from ``--seed``, set up and ticked as ``portbench/drivers/tick.py`` does)
for ``--ticks`` ticks after the workload's warm-up, and writes every tick's
decisions and the last tick's fit of every VM to an ``.npz``. With
``--staleness`` the fleet is refit every 25th tick only, staleness epochs
decide the rest (the classify splice), and every 9th tick a fifth of the
fits are made stale and the decide cache cleared, as ``FleetSim`` does on a
guard abort. ``compare`` says whether two such files are equal, bit for
bit, and where they first differ. The checkout's own ``src`` and
``portbench`` are imported; nothing of JAX is::

    python scripts/torch_tick_bits.py run --checkout DIR --seed N \\
        --ticks 650 --out a.npz [--staleness] [--vms 256 --device cpu]
    python scripts/torch_tick_bits.py compare a.npz b.npz
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run(args) -> None:
    root = os.path.abspath(args.checkout)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch
    from repro_torch.core import characterize
    from repro_torch.core.surveillance import SurveillanceEngine
    from repro_torch.core.telemetry import FleetTelemetry
    from portbench.drivers.tick import _column
    from portbench.gen import table3

    with open(os.path.join(root, "portbench", "workloads",
                           f"{args.workload}.json")) as f:
        work = json.load(f)
    with open(os.path.join(root, "portbench", "configs",
                           f"{work['config']}.json")) as f:
        conf = json.load(f)
    traffic = work["traffic"]
    n = args.vms or int(conf["vms"])
    win, extra = int(conf["window"]), int(traffic["extra_steps"])
    dev = args.device
    if dev == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    vals = table3.fleet_values(args.seed, n, win + extra)
    feats, labels = table3.training_set(args.seed, int(conf["nb_samples"]))
    nb = characterize.fit(feats, labels, n_bins=int(conf["nb_bins"]),
                          alpha=float(conf["nb_alpha"]), device=dev)
    fleet = FleetTelemetry(n, capacity=win, device=dev)
    fleet.record_fleet_bulk(np.arange(win), vals[:, :win].transpose(1, 0, 2))
    eng = SurveillanceEngine(device=dev,
                             min_samples=int(conf["min_samples"]),
                             acyclic_refit=int(conf["acyclic_refit"]))
    ids = [f"vm{i:05d}" for i in range(n)]
    for i, view in enumerate(fleet.views()):
        eng.register(ids[i], view, nb, window=win)
    step = win - 1
    eng.refresh(force=True)
    warm = int(traffic["warmup_ticks"])
    remain = np.full((args.ticks, n), -1, np.int32)
    refitted = np.zeros(args.ticks, np.int64)
    times = []
    for k in range(warm + args.ticks):
        step += 1
        t0 = time.perf_counter()
        fleet.record_fleet(step, vals[:, _column(step, win, extra)])
        if args.staleness:
            if k % 25 == 0:
                eng.refresh(force=True)
            if k % 9 == 4:
                for jid in ids[k % 5::5]:
                    job = eng.jobs[jid]
                    if job.fitted_step >= 0:
                        job.fitted_step = -1
                eng._decide_cache = None
        elif traffic["force_refit"]:
            eng.refresh(force=True)
        res = eng.tick(step)
        got = res.remain
        times.append(time.perf_counter() - t0)
        if k >= warm:
            remain[k - warm] = [got.get(i, -1) for i in ids]
            refitted[k - warm] = res.refitted
    jobs = [eng.jobs[i] for i in ids]
    models = [j.model for j in jobs]
    period = np.asarray([m.period if m else -1 for m in models])
    profile = np.full((n, win), -2, np.int8)
    lm = np.full((n, win), -2, np.int8)
    for r, (j, m) in enumerate(zip(jobs, models)):
        if m is not None:
            profile[r, :len(m.profile_lm)] = m.profile_lm
        series = j.lm_series.cpu().numpy()
        lm[r, :len(series)] = series
    np.savez_compressed(
        args.out, remain=remain, refitted=refitted, period=period,
        confidence=np.asarray([m.confidence if m else -1.0 for m in models]),
        origin=np.asarray([j.origin_step for j in jobs]),
        fitted=np.asarray([j.fitted_step for j in jobs]),
        profile=profile, lm=lm,
        conf_dict=np.asarray([res.confidence.get(i, -1.0) for i in ids]))
    ms = 1e3 * np.asarray(times[warm:])
    print(json.dumps({"checkout": args.checkout, "seed": args.seed,
                      "vms": n, "ticks": args.ticks, "last_step": step,
                      "staleness": args.staleness,
                      "tick_ms_median": float(np.median(ms)),
                      "cyclic": int((period > 1).sum())}))


def compare(args) -> int:
    import numpy as np
    a, b = np.load(args.a), np.load(args.b)
    out = {"equal": True}
    for key in a.files:
        x, y = a[key], b[key]
        same = x.shape == y.shape and x.tobytes() == y.tobytes()
        if not same:
            out["equal"] = False
            rows = (np.flatnonzero((x != y).reshape(len(x), -1).any(axis=1))
                    if x.shape == y.shape else [])
            out[key] = {"first_row": int(rows[0]) if len(rows) else None,
                        "rows": len(rows)}
    out["ticks"] = int(len(a["remain"]))
    out["vms"] = int(a["remain"].shape[1])
    print(json.dumps(out))
    return 0 if out["equal"] else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--checkout", default=".")
    r.add_argument("--workload", default="tick-16k-refit")
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--ticks", type=int, required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--staleness", action="store_true")
    r.add_argument("--vms", type=int, default=0,
                   help="fleet size (default the configuration's)")
    r.add_argument("--device", default="cuda")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args()
    if args.cmd == "run":
        run(args)
        return 0
    return compare(args)


if __name__ == "__main__":
    sys.exit(main())
