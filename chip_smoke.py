"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's two paths, the paper's ALMA decide loop at the fleet
size its users run and live pre-copy of a full-width serving replica, and
holds every hand-written kernel against its plain PyTorch version:

  1. build   — compile ``csrc/dft_power.cu``, ``csrc/autocorr.cu`` and
               ``csrc/dirty_delta.cu`` with nvcc (one process each, in
               parallel);
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
               same runs on the CPU;
  5. serve   — the dirty-block kernel against its plain version, bit for
               bit (the 1.89 GB bf16 ``w_gate`` stack, f32, f16 and f64
               leaves, a ragged tail, an unaligned view, a NaN block); then
               ``h2o_danube3_4b`` at full width in bf16 (13.96 GB of
               params and KV cache) prefills 16 x 4,096 tokens and
               pre-copies while one decode step runs per round, the
               destination checked bit for bit and each round's dirty
               blocks against the ring slots the decode wrote; then the
               same model, 2 layers deep in f32, on the card against the
               CPU.

Every phase raises on failure. The kernels' launch counters are set to 0
before each path (phases 3, 4 and 5's migration) and read after it: each
kernel of the path must have run in it. The last lines are the card
(``nvidia-smi``), one JSON object per kernel, and
``{"ok": true, "device": ...}``.

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
CYCLE_OPS = ("power_spectrum", "autocorr_score")   # the decide loop's kernels
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
    if min(launches[op] for op in CYCLE_OPS) < 1:
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
    now = WINDOW + STEADY_TICKS - 1

    def full_tick():
        eng.refresh(force=True)
        return eng.tick(now).remain

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full_tick()
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    wall_us, busy_us = _traced(torch, full_tick, "tick")
    print(f"[tick] full refit of {FLEET} jobs: {t_full:.4f} s untraced; "
          f"traced wall {wall_us / 1e6:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s")
    if busy_us <= 0:
        return t_full, {}
    return t_full, {"tick_full_traced_s": wall_us / 1e6,
                    "tick_full_device_busy_s": busy_us / 1e6,
                    "tick_full_idle_share": 1.0 - busy_us / wall_us}


def _traced(torch, fn, tag: str):
    """Run ``fn`` once under ``torch.profiler``; print its top device
    entries. Returns (wall us, device busy us: kernels and copies only, as
    an operator's own entry repeats the device time of what it launched)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        if dev_us(e) > 0:
            print(f"[{tag}]   {dev_us(e) / 1e3:10.4f} ms  x{e.count:<5d} "
                  f"{e.key[:70]}")
    busy_us = sum(dev_us(e) for e in events)
    if busy_us <= 0:
        print(f"[{tag}] device time not measured by the profiler")
    return wall_us, busy_us


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
    if min(launches[op] for op in CYCLE_OPS) < 1:
        raise AssertionError(f"FleetSim did not run both kernels: {launches}")
    if results["alma-paper"].total_bytes >= \
            results["immediate"].total_bytes:
        raise AssertionError("alma-paper moved no fewer bytes than immediate")
    return launches


# ---------------------------------------------------------------------------
# phase 5: live pre-copy of a full-width serving replica
# ---------------------------------------------------------------------------
ARCH = "h2o_danube3_4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 16, 4096, 64
PCFG = dict(block_elems=1 << 12, max_rounds=8, stop_dirty_blocks=2)
SCAN_LIMIT = 1.25        # a round's scan against its bytes bound (PERF.md)


def _bit_equal(torch, a, b) -> bool:
    """Equal bit for bit, NaN payloads aside (both NaN at the same place)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(
        a.masked_fill(nan_a, 0).view(torch.int32),
        b.masked_fill(nan_b, 0).view(torch.int32)))


def _same_bytes(torch, a, b) -> bool:
    return a.dtype == b.dtype and bool(torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _delta_pair(torch, g, n, dtype, block, nan=False):
    """(new, old) flat leaves on the card: old random; new equal to it but
    one element in every 7th block (+1), one whole block (+0.5) and, with
    ``nan``, a NaN in block 3."""
    old = torch.randn(n, device="cuda", generator=g,
                      dtype=torch.float32).to(dtype)
    new = old.clone()
    nb = -(-n // block)
    hit = torch.clamp(torch.arange(0, nb, 7, device="cuda") * block
                      + block // 3, max=n - 1)
    new[hit] += 1
    mid = (nb // 2) * block
    new[mid: mid + block] += 0.5
    if nan:
        new[3 * block + 1] = float("nan")
    return new, old


def phase_dirty_delta(torch, ref, dirty_delta):
    """B3 against its plain version, bit for bit, at the replica's two
    largest leaf shapes (a KV ring and the stacked ``w_gate``) and the
    edges; a second launch must equal the first. Returns the record at the
    ``w_gate`` shape."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n_ring = 24 * SERVE_BATCH * 4096 * 8 * 120   # K or V ring of ARCH
    n_main = 24 * 3840 * 10240                   # stacked w_gate of ARCH
    cases = [("KV ring bf16", n_ring, torch.bfloat16, 4096, False, 0),
             ("w_gate bf16", n_main, torch.bfloat16, 4096, False, 0),
             ("f32 leaf", 1 << 26, torch.float32, 4096, False, 0),
             ("ragged tail bf16", 1_000_003, torch.bfloat16, 4096, False, 0),
             ("f16", 10_000_019, torch.float16, 4096, False, 0),
             ("f16, block 1001", 10_000_019, torch.float16, 1001, False, 0),
             ("f64", 5_000_011, torch.float64, 4096, False, 0),
             ("unaligned f32 view", 3_000_001, torch.float32, 4096, False, 1),
             ("NaN block f32", 1 << 20, torch.float32, 4096, True, 0),
             ("NaN block bf16", 1 << 20, torch.bfloat16, 512, True, 0)]
    record = None
    for name, n, dtype, block, nan, skip in cases:
        new, old = _delta_pair(torch, g, n + skip, dtype, block, nan)
        new, old = new[skip:], old[skip:]
        n = new.numel()
        got = dirty_delta.max_abs_delta(new, old, block)
        want = ref.max_abs_delta_ref(new, old, block)
        torch.cuda.synchronize()
        nb = -(-n // block)
        if got.shape != (nb, 1) or not _bit_equal(torch, got, want):
            raise AssertionError(f"dirty_delta disagrees on {name}: max abs "
                                 f"err {float((got - want).abs().nan_to_num().max())}")
        if not _bit_equal(torch, got, dirty_delta.max_abs_delta(new, old,
                                                                block)):
            raise AssertionError(f"dirty_delta not deterministic on {name}")
        dirty = int((got[:, 0] > 0).sum())
        n_nan = int(torch.isnan(got).sum())
        if not 0 < dirty < nb or n_nan != int(nan):
            raise AssertionError(f"{name}: {dirty} of {nb} blocks dirty, "
                                 f"{n_nan} NaN")
        ms = _median_ms(lambda: dirty_delta.max_abs_delta(new, old, block))
        plain = _median_ms(lambda: ref.max_abs_delta_ref(new, old, block), 5)
        bound, by = _bound_ms(2.0 * n, 2.0 * n * new.element_size()
                              + 4.0 * nb)
        print(f"[serve] dirty_delta {name}: n={n} block={block} "
              f"{nb} blocks ({dirty} dirty, {n_nan} NaN), bit-equal, kernel "
              f"{ms:.4f} ms plain {plain:.4f} ms bound {bound:.6g} ms ({by})")
        if name == "w_gate bf16":
            record = dict(max_abs_err=float(
                (got - want).abs().nan_to_num().max()), ms=ms, plain_ms=plain,
                          bound_ms=bound, bound_by=by, library_ms=None)
        del new, old, got, want
        torch.cuda.empty_cache()
    return record


def _ring_dirty_bytes(cfg, batch: int, W: int, slot: int, block: int) -> int:
    """Bytes of the blocks that writing one ring slot of every (layer,
    sequence) dirties in the K and V rings (L, B, W, Hkv, hd), plus the
    one block of the int32 ``pos`` leaf."""
    seg = cfg.num_kv_heads * cfg.head_dim
    blocks = set()
    for lb in range(cfg.num_layers * batch):
        start = (lb * W + slot) * seg
        blocks.update(range(start // block, (start + seg - 1) // block + 1))
    return 2 * len(blocks) * block * 2 + block * 4


def phase_placement(torch):
    """Pre-copy into host memory: a 96 MiB tree on the card, written in
    place between rounds, migrates with a placement onto the CPU. The scan
    stays on the card against its source-side record, so the rounds and
    bytes equal an unplaced run's, and the host copy ends bit-equal."""
    from repro_torch import tree
    from repro_torch.core import precopy

    runs = []
    for place in (None, lambda t: tree.map(lambda x: x.cpu(), t)):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        state = {"w": torch.randn(1 << 24, device="cuda", generator=g),
                 "b": torch.randn(1 << 24, device="cuda", generator=g
                                  ).to(torch.bfloat16),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        k = [0]

        def step():
            k[0] += 1
            state["w"][k[0] * 12288: k[0] * 12288 + 9000] += 1
            state["step"] += 1

        dest, rep = precopy.migrate(lambda: state, step,
                                    precopy.PrecopyConfig(**PCFG),
                                    placement=place)
        if not all(_same_bytes(torch, a.to(b.device), b) for a, b in
                   zip(tree.leaves(dest), tree.leaves(state))):
            raise AssertionError("placed destination differs from live")
        runs.append((rep.per_round_dirty_bytes, rep.outcome,
                     {t.device.type for t in tree.leaves(dest)}))
    if runs[0][:2] != runs[1][:2] or runs[1][2] != {"cpu"}:
        raise AssertionError(f"placement changed the migration: {runs}")
    print(f"[serve] pre-copy card -> host: {runs[1][1].rounds} rounds, "
          f"per-round bytes {runs[1][0]} equal the unplaced run's, host "
          f"copy bit-equal")


def phase_serve(torch, ops_mod, ref, dirty_delta):
    """The full-width replica: prefill, then pre-copy while decode runs;
    returns the launch counts of the migration and the numbers to keep."""
    from repro_torch import tree
    from repro_torch.core import precopy
    from repro_torch.launch.serve import build_replica

    t0 = time.perf_counter()
    r = build_replica(ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS,
                      smoke=False, seed=SEED, device="cuda")
    cfg, params, batch, prefill, decode = (r.cfg, r.params, r.batch,
                                           r.prefill, r.decode)
    W = min(SERVE_PROMPT + SERVE_TOKENS, cfg.sliding_window)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    if logits.shape != (SERVE_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("prefill logits are not finite or misshapen")
    box = {"cache": cache, "produced": 0,
           "tok": logits.argmax(-1)[:, None].to(torch.int32)}

    def decode_once():
        box["tok"], _, box["cache"] = decode(params, box["tok"], box["cache"])
        box["produced"] += 1

    def state():
        return {"params": params, "cache": box["cache"]}

    n_params = sum(t.numel() for t in tree.leaves(params))
    v_params = precopy.total_bytes(params)
    print(f"[serve] {ARCH} full width, {n_params} params ({v_params / 1e9:.4f}"
          f" GB bf16), init {t_init:.4f} s; prefill {SERVE_BATCH} x "
          f"{SERVE_PROMPT} tokens in {t_prefill:.4f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.4f} GB")

    ops_mod.reset_launch_counts()
    dest, rep = precopy.migrate(state, decode_once,
                                precopy.PrecopyConfig(**PCFG))
    launches = ops_mod.launch_counts()
    out = rep.outcome
    live = state()
    if not all(_same_bytes(torch, a, b) for a, b in
               zip(tree.leaves(dest), tree.leaves(live))):
        raise AssertionError("destination differs from the live replica")
    slots = [(SERVE_PROMPT + k) % W for k in range(box["produced"])]
    want = [rep.v_mem] + [_ring_dirty_bytes(cfg, SERVE_BATCH, W, s,
                                            PCFG["block_elems"])
                          for s in slots[:out.rounds - 1] + slots[-1:]]
    if rep.per_round_dirty_bytes != want or box["produced"] != out.rounds:
        raise AssertionError(f"per-round dirty bytes {rep.per_round_dirty_bytes}"
                             f" != the ring slots' {want}")
    n_float = sum(t.is_floating_point() for t in tree.leaves(live))
    if launches["dirty_blocks"] != n_float * len(rep.scan_seconds):
        raise AssertionError(f"migration launched {launches}")
    blocks = sum(-(-t.numel() // PCFG["block_elems"])
                 for t in tree.leaves(live))
    scan_bound, _ = _bound_ms(0.0, 2.0 * rep.v_mem + 4.0 * blocks)
    scan_ms = [1e3 * s for s in rep.scan_seconds]
    print(f"[serve] state {rep.v_mem / 1e9:.4f} GB (KV cache "
          f"{(rep.v_mem - v_params) / 1e9:.4f} GB); migrate {out.rounds} "
          f"rounds, stop {out.stop_reason}, bytes sent / v_mem "
          f"{out.bytes_sent / rep.v_mem:.6f}, wall {rep.wall_time:.4f} s; "
          f"per-round dirty bytes {rep.per_round_dirty_bytes[1:]} equal the "
          f"ring slots written; destination bit-equal; launches {launches}")
    print(f"[serve] scan ms per round {[round(t, 4) for t in scan_ms]} "
          f"against a bound of {scan_bound:.4f} ms (bytes)")
    if max(scan_ms) > SCAN_LIMIT * scan_bound:
        raise AssertionError(f"a scan took {max(scan_ms):.4f} ms, over "
                             f"{SCAN_LIMIT} x its bound")

    # B3 against its plain version on both rings, one decode step on
    block = PCFG["block_elems"]
    decode_once()
    slot = (SERVE_PROMPT + box["produced"] - 1) % W
    ring_blocks = (_ring_dirty_bytes(cfg, SERVE_BATCH, W, slot, block)
                   - 4 * block) // (4 * block)
    for new, old in zip(tree.leaves(state()), tree.leaves(dest)):
        if new.dim() != 5:
            continue
        got = dirty_delta.max_abs_delta(new.reshape(-1), old.reshape(-1),
                                        block)
        want = ref.max_abs_delta_ref(new.reshape(-1), old.reshape(-1), block)
        dirty = int((got > 0).sum())
        if not _bit_equal(torch, got, want) or dirty != ring_blocks:
            raise AssertionError(f"dirty_delta on a {tuple(new.shape)} ring: "
                                 f"{dirty} dirty blocks, want {ring_blocks}")
        del got, want
    print(f"[serve] dirty_delta on both KV rings after a decode step: "
          f"bit-equal to the plain version, {ring_blocks} dirty blocks each")

    # one more pre-copy round, traced: decode, scan, merge
    def one_round():
        decode_once()
        masks, _, _ = precopy.dirty_scan(state(), dest, PCFG["block_elems"])
        precopy.merge_dirty(state(), dest, masks, PCFG["block_elems"])

    wall_us, busy_us = _traced(torch, one_round, "serve")
    idle = 1.0 - busy_us / wall_us if busy_us > 0 else None
    print(f"[serve] one traced pre-copy round: wall {wall_us / 1e3:.4f} ms, "
          f"device busy {busy_us / 1e3:.4f} ms, idle share {idle}")
    if not all(_same_bytes(torch, a, b) for a, b in
               zip(tree.leaves(dest), tree.leaves(state()))):
        raise AssertionError("traced round left the destination behind")

    # decode resumes on the destination, as on the live replica
    t_live, l_live, _ = decode(params, box["tok"], box["cache"])
    tok, l_dest, dcache = decode(dest["params"], box["tok"], dest["cache"])
    if not torch.equal(t_live, tok):
        raise AssertionError("decode on the destination picks other tokens")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 8
    for _ in range(steps):
        tok, _, dcache = decode(dest["params"], tok, dcache)
    torch.cuda.synchronize()
    t_tok = (time.perf_counter() - t0) / steps
    print(f"[serve] decode resumed on the destination (tokens equal, logits "
          f"max diff {float((l_live - l_dest).abs().max())}); decode "
          f"{1e3 * t_tok:.4f} ms per step of {SERVE_BATCH} tokens")
    del r, params, batch, dest, live, box, cache, dcache, logits
    torch.cuda.empty_cache()
    return launches, {
        "state_gb": rep.v_mem / 1e9, "prefill_s": t_prefill,
        "decode_ms_per_step": 1e3 * t_tok, "scan_ms": scan_ms,
        "scan_bound_ms": scan_bound, "rounds": out.rounds,
        "stop_reason": out.stop_reason,
        "bytes_sent_over_v_mem": out.bytes_sent / rep.v_mem,
        "migrate_wall_s": rep.wall_time, "round_traced_ms": wall_us / 1e3,
        "round_device_busy_ms": busy_us / 1e3, "round_idle_share": idle}


def phase_serve_cpu_check(torch):
    """The same model 2 layers deep in f32 (batch 2, prompt 128, 8 greedy
    tokens) on the card and on the CPU, from the same weights. TF32 is
    off, so the two differ only in summation order: logits within rtol
    1e-3 / atol 1e-3, tokens equal."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import lm
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg = get_config(ARCH).replace(num_layers=2, param_dtype="float32")
    p_card = lm.init_params(cfg, SEED, device="cuda")
    runs = {}
    for dev, params in (("cuda", p_card),
                        ("cpu", tree.map(lambda t: t.cpu(), p_card))):
        batch = make_batch(cfg, 2, 128, device=dev)
        batch.pop("targets")
        logits, cache = make_prefill_step(cfg, 128 + 8)(params, batch)
        decode = make_decode_step(cfg)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        rows, toks = [logits.cpu()], [tok.cpu()]
        for _ in range(8):
            tok, logits, cache = decode(params, tok, cache)
            rows.append(logits.cpu())
            toks.append(tok.cpu())
        runs[dev] = torch.stack(rows), torch.cat(toks, 1)
    (lg, tg), (lc, tc) = runs["cuda"], runs["cpu"]
    err = (lg - lc).abs()
    if not torch.equal(tg, tc) or \
            not bool((err <= 1e-3 + 1e-3 * lc.abs()).all()):
        raise AssertionError(f"card and CPU differ: tokens equal "
                             f"{torch.equal(tg, tc)}, max abs err "
                             f"{float(err.max())}")
    print(f"[serve] full width, 2 layers, f32: card and CPU logits max abs "
          f"err {float(err.max()):.6g} (size {float(lc.abs().max()):.4f}), "
          f"9 x 2 greedy tokens equal")
    return float(err.max())


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
    from repro_torch.kernels import autocorr, build, dft, dirty_delta, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    secs = build.build_all(verbose=True)
    print(f"[build] {secs:.4f} s")
    records = phase_kernels(torch, ops, ref, dft, autocorr)
    tick_launches, tick_times = phase_tick(torch, np, ops)
    fleet_launches = phase_fleet(torch, ops)
    records["dirty_delta"] = phase_dirty_delta(torch, ref, dirty_delta)
    phase_placement(torch)
    serve_launches, serve_times = phase_serve(torch, ops, ref, dirty_delta)
    serve_times["card_vs_cpu_max_abs_err"] = phase_serve_cpu_check(torch)

    sources = {"dft_power": ("src/repro_torch/kernels/csrc/dft_power.cu",
                             "src/repro/kernels/dft.py:141",
                             "power_spectrum"),
               "autocorr": ("src/repro_torch/kernels/csrc/autocorr.cu",
                            "src/repro/kernels/autocorr.py:65",
                            "autocorr_score"),
               "dirty_delta": ("src/repro_torch/kernels/csrc/dirty_delta.cu",
                               "src/repro/kernels/dirty_delta.py:56",
                               "dirty_blocks")}
    kernels = []
    for name, (src, replaces, op) in sources.items():
        launches = sum(path[op] for path in (tick_launches, fleet_launches,
                                             serve_launches))
        if launches < 1:
            raise AssertionError(f"{name} never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, **records[name]))
    print("[tick] " + json.dumps(tick_times))
    print("[serve] " + json.dumps(serve_times))
    print(_card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
