"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path, the paper's ALMA decide loop, at the fleet
size its users run, and holds both hand-written kernels against their
plain PyTorch versions:

  1. build   — compile ``csrc/dft_power.cu`` and ``csrc/autocorr.cu`` with
               nvcc (one process each, in parallel);
  2. kernels — each kernel against its plain version at the tick's shape,
               at FleetSim's Table 3 windows (1,440 and 2,880 samples,
               with the lag grids its refinement scores there) and at
               the window bounds 600 and 4,096, and against itself (a
               second launch must be bit-equal), with times of kernel,
               plain version and the PyTorch library call
               (``torch.fft.rfft`` for the spectrum) beside the least
               time the card could take (bytes, or FFT-count flops);
  3. tick    — a 16,384-job fleet (window 512, 6 telemetry fields, the
               paper's Table 3 traces) through ``SurveillanceEngine.tick``,
               cold, steady and with every job refit (traced with
               ``torch.profiler`` for the device's busy share), checked
               against a CPU engine on 1,024 jobs;
  4. fleet   — quickstart steps 2-3 and an 8-job ``run_with_plan``,
               ``alma-paper`` against ``immediate``, checked against the
               same runs on the CPU.

Every phase raises on failure. The kernels' launch counters are set to 0
before phases 3 and 4 and read after each: both kernels must have run in
both. The last lines are the card (``nvidia-smi``), one JSON object per
kernel, and ``{"ok": true, "device": ...}``.

Run from the repository root with one CUDA device: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
FLEET, WINDOW, CHECK_JOBS = 16384, 512, 1024
STEADY_TICKS = 8          # one sample per job, then a tick, this many times
# H100 SXM published peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def _median_ms(fn, reps: int = 20) -> float:
    import torch
    fn()                                        # warm
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _rfft_flops(m: int) -> float:
    """Flops of one real FFT of length m: the usual 2.5 m log2 m count."""
    return 2.5 * m * math.log2(max(m, 2))


def _spectrum_flops(B: int, N: int) -> float:
    """The least work of the power spectrum: per row a mean removal
    (2N), one real FFT and |.|^2 of the N//2+1 bins (3 each)."""
    return B * (2.0 * N + _rfft_flops(N) + 3.0 * (N // 2 + 1))


def _autocorr_flops(J: int, N: int, lags) -> float:
    """The least work of the lag scores: per row the cheaper of the direct
    products (2 per term, sum over lags of N - lag) and Wiener-Khinchin
    (real FFT of the row zero-padded to N + the largest lag, |.|^2,
    inverse real FFT)."""
    lag = lags.clamp(0, N)
    direct = 2.0 * float((N - lag).sum())
    m = N + int(lag.max())
    wk = 2.0 * _rfft_flops(m) + 3.0 * (m // 2 + 1)
    return J * min(direct, wk)


def _fleet_lags(torch, N: int):
    """The shared lag grid ``cycles._refine_period_batch`` scores at window
    N when the FFT periods are the Table 3 cycles (360, 540, 720 s at
    dt = 1 s) that fit in the window."""
    import numpy as np
    from repro_torch.core.cycles import _lag_window
    p0 = np.asarray([p for p in (360, 540, 720) if p <= N // 2], np.int64)
    lo, hi = _lag_window(p0, N, 2, N // 2)
    ok = hi >= lo
    return torch.arange(int(lo[ok].min()), int(hi[ok].max()) + 1)


def phase_kernels(torch, ops_mod, ref, dft, autocorr):
    """Each kernel against its plain version on the card. Returns the
    record of each kernel at the main path's shape."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    # spectrum: rtol/atol of tests/test_kernels.py. Above N = 2048 the f32
    # sum over N terms leaves an absolute error set by the row's energy
    # (the spectrum's peak), not by the bin's own power, so atol there is
    # 1e-5 of the peak. (8, 1440) and (8, 2880) are FleetSim's Table 3
    # windows (4 cycles of 360 and 720 s).
    for B, N in [(FLEET, WINDOW), (1024, 4096), (37, 600), (8, 1440),
                 (8, 2880)]:
        x = torch.randn(B, N, device="cuda", generator=g) + 3.0
        got = dft.power_spectrum(x, center=True)
        want = ref.power_spectrum_ref(x, center=True)
        torch.cuda.synchronize()
        atol = 2e-2 if N <= 2048 else 1e-5 * float(want.max())
        err = (got - want).abs()
        if not bool((err <= 2e-4 * want.abs() + atol).all()):
            raise AssertionError(f"dft_power disagrees at {(B, N)}: max abs "
                                 f"err {float(err.max())}")
        if not torch.equal(got, dft.power_spectrum(x, center=True)):
            raise AssertionError(f"dft_power not deterministic at {(B, N)}")
        ms = _median_ms(lambda: dft.power_spectrum(x, center=True))
        plain = _median_ms(lambda: ref.power_spectrum_ref(x, center=True), 5)
        lib = _median_ms(lambda: torch.fft.rfft(
            x - x.mean(dim=1, keepdim=True)).abs().square())
        F = N // 2 + 1
        bound, by = _bound_ms(_spectrum_flops(B, N), 4.0 * (B * N + B * F))
        print(f"[kernels] dft_power B={B} N={N}: max_abs_err "
              f"{float(err.max()):.6g} (atol {atol:.3g}) kernel {ms:.4f} ms "
              f"plain {plain:.4f} ms rfft {lib:.4f} ms bound {bound:.6g} ms "
              f"({by})")
        if (B, N) == (FLEET, WINDOW):
            records["dft_power"] = dict(
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib)
    # autocorr: rtol 2e-4 / atol 2e-3 of tests/test_kernels.py
    lag_sets = [(FLEET, WINDOW, torch.arange(2, 257)),
                (1024, 4096, torch.randint(0, 4096, (64,), generator=g,
                                           device="cuda")),
                (37, 600, torch.tensor([0, 1, 2, 5, 59, 120, 300, 598, 599,
                                        600, 601, 900, -4])),
                (8, 1440, _fleet_lags(torch, 1440)),
                (8, 2880, _fleet_lags(torch, 2880))]
    for J, N, lags in lag_sets:
        x = torch.randn(J, N, device="cuda", generator=g)
        x = x - x.mean(dim=1, keepdim=True)
        lags = lags.to(device="cuda", dtype=torch.int32)
        got = autocorr.autocorr_score(x, lags)
        want = ref.autocorr_score_ref(x, lags)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if not bool((err <= 2e-4 * want.abs() + 2e-3).all()):
            raise AssertionError(f"autocorr disagrees at {(J, N)}: max abs "
                                 f"err {float(err.max())}")
        if not torch.equal(got, autocorr.autocorr_score(x, lags)):
            raise AssertionError(f"autocorr not deterministic at {(J, N)}")
        ms = _median_ms(lambda: autocorr.autocorr_score(x, lags))
        plain = _median_ms(lambda: ref.autocorr_score_ref(x, lags), 5)
        L = lags.shape[0]
        bound, by = _bound_ms(_autocorr_flops(J, N, lags),
                              4.0 * (J * N + L + J * L))
        print(f"[kernels] autocorr J={J} N={N} L={L}: max_abs_err "
              f"{float(err.max()):.6g} kernel {ms:.4f} ms plain "
              f"{plain:.4f} ms bound {bound:.6g} ms ({by})")
        if (J, N) == (FLEET, WINDOW):
            records["autocorr"] = dict(
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None)
    return records


def _sample_matrix(np, trace, t0, steps, rng, phase_means):
    """Vectorized ``WorkloadTrace.sample_indexes`` over jobs x steps:
    (J, steps, F) load-index rows in telemetry field order."""
    tc = (t0[:, None] + np.arange(steps, dtype=np.float64)) % trace.cycle_s
    cum = np.cumsum([d for _, d in trace.phases])
    pi = np.searchsorted(cum, tc.ravel(), side="right").reshape(tc.shape)
    base = np.asarray([phase_means(n) for n, _ in trace.phases])[pi]
    return np.maximum(0.0, base * (1.0 + trace.jitter
                                   * rng.standard_normal(base.shape)))


def phase_tick(torch, np, ops_mod):
    """A FLEET-job surveillance fleet on Table 3 traces, one cold and one
    steady tick on the card, checked against a CPU engine."""
    from repro_torch.core.fleetsim import make_training_nb, phase_means, \
        table3_traces
    from repro_torch.core.surveillance import SurveillanceEngine
    from repro_torch.core.telemetry import DEFAULT_FIELDS, FleetTelemetry

    rng = np.random.default_rng(SEED)
    traces = list(table3_traces().values())
    steps = WINDOW + STEADY_TICKS
    vals = np.empty((FLEET, steps, len(DEFAULT_FIELDS)))
    idx = np.arange(FLEET)
    for k, tr in enumerate(traces):
        rows = idx[idx % len(traces) == k]
        vals[rows] = _sample_matrix(np, tr, rng.uniform(0, tr.cycle_s,
                                                        rows.size),
                                    steps, rng, phase_means)

    def make(device, n):
        fleet = FleetTelemetry(n, capacity=WINDOW, device=device)
        fleet.record_fleet_bulk(np.arange(WINDOW),
                                vals[:n, :WINDOW].transpose(1, 0, 2))
        eng = SurveillanceEngine(device=device)
        nb = make_training_nb(device=device)
        for i, view in enumerate(fleet.views()):
            eng.register(f"job{i:05d}", view, nb, window=WINDOW)
        return fleet, eng

    def run(fleet, eng, n):
        """Cold tick, then STEADY_TICKS x (record one sample, tick).
        Returns (cold remain, last remain, cold s, mean steady s, refits)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = eng.tick(WINDOW - 1)
        remain_cold = cold.remain
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        refits = [cold.refitted]
        t0 = time.perf_counter()
        for s in range(WINDOW, WINDOW + STEADY_TICKS):
            fleet.record_fleet(s, vals[:n, s])
            res = eng.tick(s)
            remain = res.remain
            refits.append(res.refitted)
        torch.cuda.synchronize()
        t_steady = (time.perf_counter() - t0) / STEADY_TICKS
        return remain_cold, remain, t_cold, t_steady, refits

    fleet, eng = make("cuda", FLEET)
    ops_mod.reset_launch_counts()
    remain_cold, remain_steady, t_cold, t_steady, refits = run(
        fleet, eng, FLEET)
    launches = ops_mod.launch_counts()
    print(f"[tick] {FLEET} jobs x window {WINDOW}: cold {t_cold:.4f} s, "
          f"steady {t_steady:.4f} s per tick (mean of {STEADY_TICKS}), "
          f"refitted per tick {refits}, launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"tick did not run both kernels: {launches}")
    if len(remain_steady) != FLEET or refits[0] != FLEET:
        raise AssertionError("tick did not fit the whole fleet")
    t_full, profile = _full_refit_profile(torch, eng)
    periods = np.asarray([eng.jobs[f"job{i:05d}"].model.period
                          for i in range(FLEET)])
    confs = np.asarray([eng.jobs[f"job{i:05d}"].model.confidence
                        for i in range(FLEET)])
    if not (np.isfinite(confs).all() and (periods >= 0).all()
            and (periods <= WINDOW // 2).all()):
        raise AssertionError("tick produced out-of-range fits")

    cfleet, ceng = make("cpu", CHECK_JOBS)
    c_cold, c_steady, _, _, _ = run(cfleet, ceng, CHECK_JOBS)
    ids = [f"job{i:05d}" for i in range(CHECK_JOBS)]
    bad = [i for i in ids
           if (remain_cold[i], remain_steady[i],
               eng.jobs[i].model.period) !=
           (c_cold[i], c_steady[i], ceng.jobs[i].model.period)]
    if bad:
        raise AssertionError(f"{len(bad)} of {CHECK_JOBS} jobs differ from "
                             f"the CPU engine, first {bad[:5]}")
    print(f"[tick] remain and period equal the CPU engine on {CHECK_JOBS} "
          f"jobs; cyclic share {float((periods > 1).mean()):.4f}")
    return launches, {"tick_cold_s": t_cold, "tick_steady_s": t_steady,
                      "tick_full_s": t_full, **profile}


def _full_refit_profile(torch, eng):
    """Time a tick that refits every job (``refresh(force=True)``, the
    classify splicing the slid window), then trace one more under
    ``torch.profiler`` and print where its device time goes."""
    from torch.profiler import ProfilerActivity, profile
    now = WINDOW + STEADY_TICKS - 1

    def full_tick():
        eng.refresh(force=True)
        return eng.tick(now).remain

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full_tick()
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        full_tick()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels and copies only: an operator's own entry repeats the device
    # time of what it launched
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    busy_us = sum(dev_us(e) for e in events)
    print(f"[tick] full refit of {FLEET} jobs: {t_full:.4f} s untraced; "
          f"traced wall {wall_us / 1e6:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        if dev_us(e) > 0:
            print(f"[tick]   {dev_us(e) / 1e3:10.4f} ms  x{e.count:<5d} "
                  f"{e.key[:70]}")
    if busy_us <= 0:
        print("[tick] device time not measured by the profiler")
        return t_full, {}
    return t_full, {"tick_full_traced_s": wall_us / 1e6,
                    "tick_full_device_busy_s": busy_us / 1e6,
                    "tick_full_idle_share": 1.0 - busy_us / wall_us}


def _fleet_run(policy, device):
    from repro_torch.core import fleetsim as fs
    from repro_torch.core.orchestrator import MigrationRequest
    traces = fs.table3_traces(phase_s=60.0, replicas=2)
    jobs = [fs.SimJob(j, tr, 1e9 + 1e8 * i)
            for i, (j, tr) in enumerate(traces.items())]
    sim = fs.FleetSim(jobs, policy=policy, warmup_s=1200.0, seed=3,
                      device=device)
    plan = [MigrationRequest(j.job_id, sim.now + 37.0 * i, j.v_bytes)
            for i, j in enumerate(jobs)]
    return sim.run_with_plan(plan, horizon_s=3600.0)


def phase_fleet(torch, ops_mod):
    from repro_torch.core import fleetsim as fs
    from repro_torch.core.orchestrator import MigrationRequest

    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    trace = fs.WorkloadTrace([("MEM", 30), ("CPU", 60), ("IDLE", 30)], 3600)
    sim = fs.FleetSim([fs.SimJob("job0", trace, v_bytes=1e9)],
                      policy="alma-paper", warmup_s=600.0, device="cuda")
    model = sim.lmcm.refresh_job("job0")
    req = sim.run_with_plan([MigrationRequest("job0", sim.now, 1e9)],
                            horizon_s=600.0).migrations[0]
    print(f"[fleet] quickstart: period {model.period} (truth 120), "
          f"confidence {model.confidence:.4f}, requested t={req.created_at:.0f}"
          f" ({trace.phase_at(req.created_at)}), fired t={req.scheduled_at:.0f}"
          f" ({trace.phase_at(req.scheduled_at)})")
    if model.period != 120 or trace.phase_at(req.scheduled_at) == "MEM":
        raise AssertionError("quickstart did not postpone out of MEM")
    results = {}
    for policy in ("alma-paper", "immediate"):
        t1 = time.perf_counter()
        res = _fleet_run(policy, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        ref = _fleet_run(policy, "cpu")
        got = [(r.job_id, r.scheduled_at, r.outcome.stop_reason)
               for r in res.migrations]
        want = [(r.job_id, r.scheduled_at, r.outcome.stop_reason)
                for r in ref.migrations]
        if got != want or abs(res.total_bytes - ref.total_bytes) > \
                1e-9 * ref.total_bytes:
            raise AssertionError(f"{policy} run differs from the CPU run")
        print(f"[fleet] {policy}: {len(res.migrations)} migrations, "
              f"{res.total_bytes / 1e9:.4f} GB, mean time "
              f"{res.mean_migration_time:.4f} s, makespan "
              f"{res.makespan:.4f} s, lm_hit_rate {res.lm_hit_rate:.4f}, "
              f"wall {wall:.4f} s (equal to the CPU run)")
        results[policy] = res
    launches = ops_mod.launch_counts()
    print(f"[fleet] launches {launches} in {time.perf_counter() - t0:.4f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"FleetSim did not run both kernels: {launches}")
    if results["alma-paper"].total_bytes >= \
            results["immediate"].total_bytes:
        raise AssertionError("alma-paper moved no fewer bytes than immediate")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import autocorr, build, dft, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    secs = build.build_all(verbose=True)
    print(f"[build] {secs:.4f} s")
    records = phase_kernels(torch, ops, ref, dft, autocorr)
    tick_launches, tick_times = phase_tick(torch, np, ops)
    fleet_launches = phase_fleet(torch, ops)

    sources = {"dft_power": ("src/repro_torch/kernels/csrc/dft_power.cu",
                             "src/repro/kernels/dft.py:141",
                             "power_spectrum"),
               "autocorr": ("src/repro_torch/kernels/csrc/autocorr.cu",
                            "src/repro/kernels/autocorr.py:65",
                            "autocorr_score")}
    kernels = []
    for name, (src, replaces, op) in sources.items():
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=tick_launches[op] + fleet_launches[op], **records[name]))
    print("[tick] " + json.dumps(tick_times))
    print(_card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
