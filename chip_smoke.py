"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's paths, the paper's ALMA decide loop at the fleet size
its users run (also under the adaptive concurrency controller and in a
host-failure scenario), live pre-copy of a full-width serving replica
(attention and SSM-hybrid), serving of an RWKV model, of a full-width
qwen3-8b and of the MoE models (qwen3-moe-30b-a3b at full width and
depth, kimi-k2's prefix-dense wiring at full width), training of a
full-width internlm2-1.8b and the live pre-copy of its training state,
and holds every hand-written kernel against its plain PyTorch version:

  1. build   — compile ``csrc/dft_power.cu``, ``csrc/autocorr.cu``,
               ``csrc/dirty_delta.cu``, ``csrc/ssm_scan.cu`` and
               ``csrc/flash_attention.cu`` with nvcc (one process each, in
               parallel);
  2. kernels — each kernel against its plain version at the tick's shape,
               at FleetSim's Table 3 windows (1,440 and 2,880 samples,
               with the lag grids its refinement scores there) and at
               the window bounds 600 and 4,096, the spectrum also at N
               of 2, 3, 16,384 (its FFT route's every radix) and 7 and
               1,031 (its direct route), and against itself (a second
               launch must be bit-equal), with times of kernel, plain
               version and the PyTorch library call (``torch.fft.rfft``
               for the spectrum) beside the least time the card could
               take (bytes, or FFT-count flops); the lag scores also at
               (64, 16,384, lags 1..8,192), (37, 1,031, lags 2..515), a
               grid whose first tile is consecutive and the rest
               scattered, and one that starts at clamped negatives, each
               case printing the route of every lag tile
               (``autocorr.tile_routes``) and Wiener-Khinchin's time in
               f32 as a reference of several calls (not a library call),
               and, after phase 3, at each shape the tick sent;
  3. tick    — a 16,384-job fleet (window 512, 6 telemetry fields, the
               paper's Table 3 traces) through ``SurveillanceEngine.tick``,
               cold, steady and with every job refit (traced with
               ``torch.profiler`` for the device's busy share), checked
               against a CPU engine on 1,024 jobs; prints the (J, N, L)
               of each lag-score call it made;
  4. fleet   — quickstart steps 2-3 and an 8-job ``run_with_plan``,
               ``alma-paper`` against ``immediate``, then ``alma-paper``
               with ``adaptive_concurrency=True`` and with ``horizon=True``
               and the suite's ``node_failure`` scenario, each checked
               against the same run on the CPU (selections,
               ``scheduled_at``, ``SimResult``) and each launching both
               cycle-fit kernels; every (B, N) of the spectrum and (J, N,
               lags) of the lag scores these card runs sent is then held
               against the plain version as in phase 2;
  5. serve   — the dirty-block kernel against its plain version, bit for
               bit (the 1.89 GB bf16 ``w_gate`` stack, f32, f16 and f64
               leaves, a ragged tail, an unaligned view, a NaN block); then
               ``h2o_danube3_4b`` at full width in bf16 (13.96 GB of
               params and KV cache) prefills 16 x 4,096 tokens (24 B5
               launches, sliding window 4,096), prefills again with CUDA
               events around its parts, and pre-copies while one decode
               step runs per round, each scan timed on the host clock and
               with CUDA events, the destination checked bit for bit and
               each round's dirty blocks against the ring slots the decode
               wrote; then the same model, 2 layers deep in f32, on the
               card against the CPU;
  6. ssm     — first (before any replica is built) the chunked SSM-scan
               kernel against its plain version at zamba2's and rwkv6's
               prefill shapes and on the edges (S of 1, 33 and 4,095, a
               decay below the clamp, an initial state, f32 inputs, the
               smoke widths, q/k shared by an odd number of heads,
               zamba2's layout in f32, odd widths, a d stride of 2, a
               per-token decay with q/k per head), the edges against
               the step recurrence too, each bit-equal on a second
               launch; its bound is the least time on this card for the
               scan's bytes or its flops as 3xTF32 tensor-core
               products; after phase 5, a full-width, full-depth
               ``zamba2_2p7b`` replica (bf16) prefills 16 x 4,096
               tokens (45 B4 and 9 B5 launches) and
               pre-copies with one decode step per round, each round's
               pair of trees also scanned by the dirty-block kernel's plain
               version (every SSD- and conv-state block dirty, the ring
               slots written, totals equal); ``rwkv6_1p6b`` at full width
               and depth prefills and decodes; each model prefills once
               more with CUDA events around its layers, B4 and B5 (where
               its time goes); both models shallow in f32 on the card
               against the CPU;
  7. attn    — first (right after phase 6's kernel checks) the
               flash-attention kernel B5 against the naive oracle at the
               three prefills' head shapes, at internlm2's training shape
               (4 x 2,048 tokens, 16 heads, kv 8, head_dim 128, bf16,
               causal; phase 8's) and on the edges in f32 and
               bf16 (S of 1, 33, 127 and 4,095, windows 64, 128 and 500,
               G = 9, the smoke widths), each bit-equal on a second launch
               and on inputs of another layout, bf16 also in layouts its
               TMA loads cannot take (a base one element off, a d stride
               of S) against their contiguous copies; bf16 outputs within
               the rounding the kernel's contract allows (``_attn_check``);
               the window at S = 16,384 in f32 and bf16 against the
               chunked plain version, its time against the causal one;
               times of B5, the plain version and
               ``scaled_dot_product_attention`` at zamba2's, qwen3's and
               danube's prefill shapes, B5 there held against the oracle
               too; the same at the MoE prefills' head shapes (qwen3-moe's
               (8, 32, 4, 4,096, 128); the reference's kimi-k2, whose GQA
               at D = 112 stands in for Kimi-K2's MLA, (4, 64, 8, 4,096,
               112)), each bit-equal on a second launch. After phase 6,
               ``qwen3_8b`` at full width and depth
               (bf16, 8.19e9 params) prefills 16 x 4,096 tokens (36 B5
               launches), decodes 8 steps and prefills again with CUDA
               events; then 2 layers deep in f32, prompt 1,024, on the
               card against the CPU. In every replica's event-timed
               second prefill, B5's first application is held against the
               oracle on the same q, k, v (the counted prefill's peak
               memory stays the model's own).
  8. train   — after phase 7, ``internlm2_1p8b`` at full width and depth
               (bf16 params, AdamW, block remat, 26.4 GB of state) trains
               on 4 x 2,048-token batches of ``SyntheticCorpus``: a
               warm-up step, 4 counted steps with telemetry (each 48 B5
               launches, the forward twice under remat, and 1 B3 launch),
               one step split by CUDA events (B5, the plain attention
               backward, the optimizer, B3, the rest); then
               ``elastic.rescale`` pre-copies that training state on the
               card while it trains, one step a round, each scan's
               per-leaf dirty blocks held against B3's plain version, the
               destination bit-equal at handoff and trained one step
               more; then one f32 AdamW step at full width of internlm2 (2
               layers), a zamba2 group and one rwkv6 layer on the card
               against the CPU (B5, and B4 in SSD and RWKV mode, under
               grad); then the smoke-scale ``Trainer`` with a failure
               injected at step 7, restored to the uninterrupted run's
               final loss bit for bit, and an incremental checkpointer (a
               full save and 4 deltas, B3 once a delta) whose every
               restore is bit-exact;
  9. moe     — after phase 8's memory is released, ``qwen3_moe_30b_a3b``
               at full width and depth (bf16, 30.5e9 seeded params, 61.06
               GB) prefills 8 x 4,096 tokens (48 B5 launches; 16 x 4,096
               does not fit beside the weights), decodes 8 steps and
               prefills again with CUDA events around attention, B5,
               routing, dispatch, the expert products and the combine,
               counting each layer's capacity drops, then once more at a
               routing within capacity (``_balance_routers``); one MoE
               layer is relaunched bit-equal; ``kimi_k2_1t_a32b`` at full
               width (its attention the reference's GQA), 2
               layers deep (its dense layer and one MoE layer of 384
               experts; 39.87 GB), prefills 4 x 4,096 (2 B5 launches at D
               = 112) and decodes 4 steps; then card against CPU in f32
               (qwen3-moe 2 layers at full width, kimi-k2's smoke
               config): every MoE call's routing, drops and output judged
               on the card's input (``_judge_routing``: near ties counted,
               outputs held where the routing agrees).

Every phase raises on failure. The kernels' launch counters are set to 0
before each path (phases 3, 4 and each of its controller and scenario
runs, 5's prefill and migration, 6's two prefills and its migration, 7's
prefill, 8's counted steps, its migration, its card-against-CPU steps,
its trainers and its incremental checkpoints, 9's two counted prefills)
and read after it: each kernel of the path must have run in
it. The last lines are the card
(``nvidia-smi``), one JSON object per kernel, and ``{"ok": true,
"device": ...}``.

Run from the repository root with one CUDA device: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
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
# bf16 on the tensor cores (a bf16 product with f32 accumulation is the
# same work there): the least time of bf16 attention
PEAK_BF16_TENSOR_FLOPS = 989e12
# TF32 on the tensor cores; an f32 product that keeps 2e-4 there takes
# three of them (3xTF32: hi*hi + hi*lo + lo*hi)
PEAK_TF32_TENSOR_FLOPS, TF32_SPLIT_PRODUCTS = 495e12, 3
# the caching allocator's setting for the whole run (PYTORCH_CUDA_ALLOC_CONF,
# unless the caller sets its own), as ``repro_torch.launch.train`` sets it
ALLOC_CONF = "expandable_segments:True"


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


def _stream_ms(fn, n: int = 50) -> float:
    """ms per call of ``n`` calls issued back to back (median of 5 such
    runs): the device's time for a kernel whose host-side launch would
    otherwise show in ``_median_ms``'s one-call windows."""
    def run():
        for _ in range(n):
            fn()
    return _median_ms(run, 5) / n


def _bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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
    # The FFT route takes every 5-smooth N (each radix 2, 3, 4, 5 and 8
    # appears below), the direct route the rest (7, the prime 1031).
    for B, N in [(FLEET, WINDOW), (1024, 4096), (37, 600), (8, 1440),
                 (8, 2880), (64, 2), (64, 3), (64, 7), (16, 16384),
                 (37, 1031)]:
        x, err, atol = _dft_case(torch, ref, dft, g, B, N)
        ms = _median_ms(lambda: dft.power_spectrum(x, center=True))
        plain = _median_ms(lambda: ref.power_spectrum_ref(x, center=True), 5)
        lib = _median_ms(lambda: torch.fft.rfft(
            x - x.mean(dim=1, keepdim=True)).abs().square())
        F = N // 2 + 1
        bound, by = _bound_ms(_spectrum_flops(B, N), 4.0 * (B * N + B * F))
        print(f"[kernels] dft_power B={B} N={N} route {dft.route(N)} "
              f"{dft.fft_plan(N) or ''}: max_abs_err "
              f"{float(err.max()):.6g} (atol {atol:.3g}) kernel {ms:.4f} ms "
              f"plain {plain:.4f} ms rfft {lib:.4f} ms bound {bound:.6g} ms "
              f"({by})")
        if (B, N) == (FLEET, WINDOW):
            dev = _stream_ms(lambda: dft.power_spectrum(x, center=True))
            lib_dev = _stream_ms(lambda: torch.fft.rfft(
                x - x.mean(dim=1, keepdim=True)).abs().square())
            print(f"[kernels] dft_power B={B} N={N} back to back: kernel "
                  f"{dev:.4f} ms, rfft {lib_dev:.4f} ms")
            records["dft_power"] = dict(
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib)
    # autocorr: rtol 2e-4 / atol 2e-3 of tests/test_kernels.py. The tick's
    # shape and FleetSim's windows take the tensor route on every tile;
    # random and scattered lags the CUDA route; the mixed grid (its first
    # 105 lags consecutive, the rest scattered) and the one starting at
    # clamped negatives both
    lag_sets = [(FLEET, WINDOW, torch.arange(2, 257)),
                (1024, 4096, torch.randint(0, 4096, (64,), generator=g,
                                           device="cuda")),
                (37, 600, torch.tensor([0, 1, 2, 5, 59, 120, 300, 598, 599,
                                        600, 601, 900, -4])),
                (8, 1440, _fleet_lags(torch, 1440)),
                (8, 2880, _fleet_lags(torch, 2880)),
                (64, 16384, torch.arange(1, 8193)),
                (37, 1031, torch.arange(2, 516)),
                (37, 1031, torch.cat([
                    torch.arange(2, 107, device="cuda"),
                    torch.randint(-3, 1041, (95,), generator=g,
                                  device="cuda")])),
                (37, 600, torch.arange(-20, 280))]
    for J, N, lags in lag_sets:
        rec = _autocorr_case(torch, ref, autocorr, g, J, N, lags,
                             back_to_back=(J, N) == (FLEET, WINDOW))
        if (J, N) == (FLEET, WINDOW):
            records["autocorr"] = rec
    return records


def _dft_case(torch, ref, dft, g, B, N):
    """B1 against its plain version on B seeded rows of N (offset 3, so
    ``center`` matters): rtol 2e-4, atol 2e-2 up to N = 2048 and 1e-5 of
    the spectrum's peak above, a second launch bit-equal. Returns (x, the
    element-wise error, atol)."""
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
    return x, err, atol


def _runs(routes) -> str:
    """``["tensor", "tensor", "cuda"]`` -> ``"tensor x2, cuda x1"``."""
    out = []
    for r in routes:
        if out and out[-1][0] == r:
            out[-1][1] += 1
        else:
            out.append([r, 1])
    return ", ".join(f"{r} x{n}" for r, n in out)


def _autocorr_case(torch, ref, autocorr, g, J, N, lags, *,
                   back_to_back=False):
    """B2 against its plain version on J seeded mean-removed rows of N at
    the lag grid ``lags``: rtol 2e-4 / atol 2e-3, a second launch
    bit-equal; prints each tile's route (``autocorr.tile_routes``), the
    kernel's, the plain version's and Wiener-Khinchin's times beside the
    bound. Returns the kernel's record."""
    x = torch.randn(J, N, device="cuda", generator=g)
    x = x - x.mean(dim=1, keepdim=True)
    lags = lags.to(device="cuda", dtype=torch.int32)
    L = lags.shape[0]
    lt = autocorr.plan(J, N, L, autocorr.sm_count(x.device)).lt
    print(f"[kernels] autocorr J={J} N={N} L={L} lags {int(lags[0])}.."
          f"{int(lags[-1])} tiles of {lt}: routes "
          f"{_runs(autocorr.tile_routes(lags.tolist(), N, lt))}")
    got = autocorr.autocorr_score(x, lags)
    want = ref.autocorr_score_ref(x, lags)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 2e-4 * want.abs() + 2e-3).all()):
        raise AssertionError(f"autocorr disagrees at {(J, N, L)}: max abs "
                             f"err {float(err.max())}")
    if not torch.equal(got, autocorr.autocorr_score(x, lags)):
        raise AssertionError(f"autocorr not deterministic at {(J, N, L)}")
    ms = _median_ms(lambda: autocorr.autocorr_score(x, lags))
    plain = _median_ms(lambda: ref.autocorr_score_ref(x, lags), 5)
    m = N + int(lags.clamp(0, N).max())
    idx = lags.clamp(0, N).long()
    wk = _median_ms(lambda: torch.fft.irfft(
        torch.fft.rfft(x, m).abs().square(), m)[:, idx])
    bound, by = _bound_ms(_autocorr_flops(J, N, lags),
                          4.0 * (J * N + L + J * L))
    print(f"[kernels] autocorr J={J} N={N} L={L}: max_abs_err "
          f"{float(err.max()):.6g} kernel {ms:.4f} ms plain {plain:.4f} ms "
          f"bound {bound:.6g} ms ({by}); Wiener-Khinchin in f32 (rfft, "
          f"abs^2, irfft, gather: several calls, not one library call) "
          f"{wk:.4f} ms")
    if back_to_back:
        dev = _stream_ms(lambda: autocorr.autocorr_score(x, lags))
        print(f"[kernels] autocorr J={J} N={N} L={L} back to back: kernel "
              f"{dev:.4f} ms")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None)


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
    steady tick on the card, checked against a CPU engine. Returns the
    launches, the times and the (J, N, lags) of each B2 call on the card."""
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
    # record what B2 receives: the cycle fit calls ops.autocorr_score
    # through the module; the launch counter stays on the kernel's wrapper
    scores, b2_calls = ops_mod.autocorr_score, []

    def recording(x, lags):
        b2_calls.append((*x.shape, lags))
        return scores(x, lags)

    ops_mod.autocorr_score = recording
    try:
        ops_mod.reset_launch_counts()
        remain_cold, remain_steady, t_cold, t_steady, refits = run(
            fleet, eng, FLEET)
        launches = ops_mod.launch_counts()
        t_full, profile = _full_refit_profile(torch, eng)
    finally:
        ops_mod.autocorr_score = scores
    print("[tick] B2 received (J, N, L, lags): " + ", ".join(
        f"({J}, {N}, {lags.numel()}, {int(lags[0])}..{int(lags[-1])})"
        for J, N, lags in b2_calls))
    print(f"[tick] {FLEET} jobs x window {WINDOW}: cold {t_cold:.4f} s, "
          f"steady {t_steady:.4f} s per tick (mean of {STEADY_TICKS}), "
          f"refitted per tick {refits}, launches {launches}")
    if min(launches[op] for op in CYCLE_OPS) < 1:
        raise AssertionError(f"tick did not run both kernels: {launches}")
    if len(remain_steady) != FLEET or refits[0] != FLEET:
        raise AssertionError("tick did not fit the whole fleet")
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
                      "tick_full_s": t_full, **profile}, b2_calls


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


def _fleet_run(policy, device, **kw):
    from repro_torch.core import fleetsim as fs
    from repro_torch.core.orchestrator import MigrationRequest
    traces = fs.table3_traces(phase_s=60.0, replicas=2)
    jobs = [fs.SimJob(j, tr, 1e9 + 1e8 * i)
            for i, (j, tr) in enumerate(traces.items())]
    sim = fs.FleetSim(jobs, policy=policy, warmup_s=1200.0, seed=3,
                      device=device, **kw)
    plan = [MigrationRequest(j.job_id, sim.now + 37.0 * i, j.v_bytes)
            for i, j in enumerate(jobs)]
    return sim.run_with_plan(plan, horizon_s=3600.0)


@contextlib.contextmanager
def _capturing(ops_mod, seen):
    """Record the shape of every B1 call, (B, N), and every B2 call,
    (J, N, lags), that the cycle fit makes through ``ops`` while the block
    runs, into ``seen["dft_power"]`` and ``seen["autocorr"]``. The launch
    counters stay on the kernels' wrappers."""
    spectrum, scores = ops_mod.power_spectrum, ops_mod.autocorr_score

    def spectrum_rec(x, **kw):
        seen["dft_power"].add(tuple(x.shape))
        return spectrum(x, **kw)

    def scores_rec(x, lags):
        seen["autocorr"].add((*x.shape, tuple(lags.tolist())))
        return scores(x, lags)

    ops_mod.power_spectrum, ops_mod.autocorr_score = spectrum_rec, scores_rec
    try:
        yield
    finally:
        ops_mod.power_spectrum, ops_mod.autocorr_score = spectrum, scores


def _hold_captured(torch, seen):
    """Phase 2's B1 and B2 checks, at phase 2's tolerances, on seeded
    inputs at each distinct shape in ``seen`` (from ``_capturing``)."""
    from repro_torch.kernels import autocorr, dft, ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst, routes = 0.0, {}
    for B, N in sorted(seen["dft_power"]):
        _, err, _ = _dft_case(torch, ref, dft, g, B, N)
        worst = max(worst, float(err.max()))
        routes[dft.route(N)] = routes.get(dft.route(N), 0) + 1
    print(f"[fleet] B1 received {len(seen['dft_power'])} distinct (B, N): "
          + ", ".join(f"({B}, {N})" for B, N in sorted(seen["dft_power"])))
    print(f"[fleet] B1 held at each (phase 2's tolerance, bit-equal "
          f"relaunch): routes {routes}, max_abs_err {worst:.6g}")
    print(f"[fleet] B2 received {len(seen['autocorr'])} distinct "
          "(J, N, L, lags): " + ", ".join(
              f"({J}, {N}, {len(lags)}, {lags[0]}..{lags[-1]})"
              for J, N, lags in sorted(seen["autocorr"])))
    for J, N, lags in sorted(seen["autocorr"]):
        _autocorr_case(torch, ref, autocorr, g, J, N,
                       torch.tensor(lags, dtype=torch.int32))


def phase_fleet(torch, ops_mod):
    """The quickstart and the 8-job fleet under ``alma-paper`` and
    ``immediate`` on the card against CPU runs, then the controller's runs
    (``phase_controller``); every B1 and B2 shape the card runs sent is
    then held against its plain version. Returns the launches of both."""
    from repro_torch.core import fleetsim as fs
    from repro_torch.core.orchestrator import MigrationRequest

    seen = {"dft_power": set(), "autocorr": set()}
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    trace = fs.WorkloadTrace([("MEM", 30), ("CPU", 60), ("IDLE", 30)], 3600)
    with _capturing(ops_mod, seen):
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
        with _capturing(ops_mod, seen):
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
    controller = phase_controller(torch, ops_mod, seen)
    _hold_captured(torch, seen)
    return launches, controller


def _same_within(a, b, rtol: float = 1e-9) -> bool:
    """Equal nested values: floats within ``rtol`` (NaN equal to NaN),
    everything else exactly."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b or \
            abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_within(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_within(x, y, rtol)
                                        for x, y in zip(a, b))
    return a == b


def _sim_record(res):
    """A ``SimResult`` as plain values: per migration its decision,
    schedule, path and outcome, then the totals and per-link bytes."""
    return {"migrations": [
        (r.job_id, r.created_at, r.scheduled_at, r.decision,
         tuple(r.path or ()), r.outcome.stop_reason, r.outcome.rounds,
         float(r.outcome.bytes_sent), float(r.outcome.total_time),
         float(r.outcome.downtime)) for r in res.migrations],
        "total_bytes": float(res.total_bytes),
        "total_time": float(res.total_time),
        "makespan": float(res.makespan),
        "lm_hit_rate": float(res.lm_hit_rate),
        "link_bytes": {k: float(v) for k, v in res.link_bytes.items()},
        "n_aborts": res.n_aborts, "n_retries": res.n_retries}


def phase_controller(torch, ops_mod, seen):
    """The admission controller on the card: the 8-job fleet under
    ``alma-paper`` with ``adaptive_concurrency=True``, then with
    ``horizon=True`` (trough-priced admission through the surveillance
    engine's fits), and the suite's ``node_failure`` scenario (a host dies
    mid-drain; aborts, retries, recovery). Each run's selections,
    ``scheduled_at`` and ``SimResult`` (or report) equal its CPU run's
    (floats within 1e-9), and each launches both cycle-fit kernels. The
    card runs' B1 and B2 shapes go into ``seen`` (``_capturing``).
    Returns the launches of the three runs."""
    from repro_torch.scenarios import suite
    runs = {
        "adaptive_concurrency": lambda dev: _sim_record(_fleet_run(
            "alma-paper", dev, adaptive_concurrency=True)),
        "horizon": lambda dev: _sim_record(_fleet_run(
            "alma-paper", dev, horizon=True)),
        "node_failure": lambda dev: suite.node_failure(
            policy="alma-paper", seed=SEED, device=dev),
    }
    total = {op: 0 for op in ops_mod.launch_counts()}
    for name, run in runs.items():
        ops_mod.reset_launch_counts()
        t0 = time.perf_counter()
        with _capturing(ops_mod, seen):
            got = run("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops_mod.launch_counts()
        want = run("cpu")
        if not _same_within(got, want):
            raise AssertionError(f"[fleet] {name}: the card's run differs "
                                 f"from the CPU run")
        if min(launches[op] for op in CYCLE_OPS) < 1:
            raise AssertionError(f"[fleet] {name} did not run both "
                                 f"cycle-fit kernels: {launches}")
        if name == "node_failure":
            if not (got["n_aborts"] > 0 and math.isfinite(got["rto_s"])
                    and not got["failed_jobs"]):
                raise AssertionError(f"node_failure did not fail and "
                                     f"recover: {got}")
            what = (f"{got['completed']} of {got['requested']} recovered, "
                    f"{got['n_aborts']} aborts, {got['n_retries']} retries, "
                    f"aborted {got['aborted_bytes'] / 1e9:.4f} GB, RTO "
                    f"{got['rto_s']:.4f} s, makespan "
                    f"{got['makespan_s']:.4f} s")
        else:
            what = (f"{len(got['migrations'])} migrations, "
                    f"{got['total_bytes'] / 1e9:.4f} GB, makespan "
                    f"{got['makespan']:.4f} s, lm_hit_rate "
                    f"{got['lm_hit_rate']:.4f}")
        print(f"[fleet] {name}: {what}, wall {wall:.4f} s (equal to the CPU "
              f"run); launches {launches}")
        for op, n in launches.items():
            total[op] += n
    return total


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
    largest leaf shapes (a KV ring and the stacked ``w_gate``), the edges
    and many pairs in one launch; a second launch must equal the first.
    Returns the record at the ``w_gate`` shape."""
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
    _dirty_delta_many(torch, ref, dirty_delta, g)
    return record


def _dirty_delta_many(torch, ref, dirty_delta, g):
    """B3's launch for many pairs against its plain version, bit for bit:
    MAX_LEAVES + 5 pairs (two launches) of every dtype, each of its own
    length, some read from unaligned views and some holding a NaN, at a
    block of whole 16-byte vectors and at one of none."""
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
    for block in (4096, 1001):
        news, olds = [], []
        for i in range(dirty_delta.MAX_LEAVES + 5):
            skip = int(i % 5 == 0)
            new, old = _delta_pair(torch, g, 50_000 + 7_919 * i + skip,
                                   dtypes[i % 4], block, nan=i % 9 == 0)
            news.append(new[skip:])
            olds.append(old[skip:])
        before = dirty_delta.max_abs_delta.launches
        got = dirty_delta.max_abs_delta_many(news, olds, block)
        launched = dirty_delta.max_abs_delta.launches - before
        want = torch.cat([ref.max_abs_delta_ref(n, o, block)[:, 0]
                          for n, o in zip(news, olds)])
        if launched != 2 or not _bit_equal(torch, got, want):
            raise AssertionError(f"dirty_delta on {len(news)} pairs, block "
                                 f"{block}: {launched} launches, max abs err "
                                 f"{float((got - want).abs().nan_to_num().max())}")
        if not _bit_equal(torch, got, dirty_delta.max_abs_delta_many(
                news, olds, block)):
            raise AssertionError(f"dirty_delta on many pairs, block {block}:"
                                 f" not deterministic")
        print(f"[serve] dirty_delta on {len(news)} pairs of 4 dtypes in "
              f"{launched} launches, block {block}: {got.numel()} blocks "
              f"({int((got > 0).sum())} dirty, {int(torch.isnan(got).sum())}"
              f" NaN), bit-equal to the plain version, bit-equal on a second"
              f" launch")


def _scan_launches(n_float: int) -> int:
    """B3 launches of one scan of a tree with ``n_float`` float leaves."""
    from repro_torch.kernels import dirty_delta
    return -(-n_float // dirty_delta.MAX_LEAVES)


def _scan_forms(torch, live, dest, tag: str):
    """The scan as the migration runs it (B3 once for all float leaves)
    against one B3 launch per leaf, on the same pair of trees: CUDA-event
    medians of 5, each to its counts on the host."""
    from repro_torch import tree
    from repro_torch.core import precopy
    from repro_torch.kernels import ops

    block = PCFG["block_elems"]
    pairs = list(zip(tree.leaves(live), tree.leaves(dest)))

    def per_leaf():
        masks = [ops.dirty_blocks(n.reshape(-1), o.reshape(-1), block=block)
                 for n, o in pairs]
        return torch.stack([m.sum() for m in masks]).tolist()

    one = _median_ms(lambda: precopy.dirty_scan(live, dest, block), 5)
    each = _median_ms(per_leaf, 5)
    n_float = sum(n.is_floating_point() for n, _ in pairs)
    print(f"[{tag}] scan of the whole state, CUDA events, median of 5: "
          f"{_scan_launches(n_float)} B3 launch(es) for its {n_float} float "
          f"leaves {one:.4f} ms, one launch per leaf {each:.4f} ms")
    return {"scan_one_launch_ms": one, "scan_launch_per_leaf_ms": each}


def _ring_dirty_bytes(cfg, batch: int, W: int, slot: int, block: int,
                      layers=None) -> int:
    """Bytes of the blocks that writing one ring slot of every (layer,
    sequence) dirties in the bf16 K and V rings (L, B, W, Hkv, hd), L =
    ``layers`` (default ``cfg.num_layers``), plus the one block of the int32
    ``pos`` leaf."""
    seg = cfg.num_kv_heads * cfg.head_dim
    blocks = set()
    for lb in range((layers or cfg.num_layers) * batch):
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


def _traced_round(torch, decode_once, state, dest, tag: str):
    """One more pre-copy round after a migration (decode, scan, merge)
    under ``torch.profiler``; the destination must keep up bit for bit.
    Returns (wall us, device busy us, idle share or None)."""
    from repro_torch import tree
    from repro_torch.core import precopy

    def one_round():
        decode_once()
        masks, _, _ = precopy.dirty_scan(state(), dest, PCFG["block_elems"])
        precopy.merge_dirty(state(), dest, masks, PCFG["block_elems"])

    wall_us, busy_us = _traced(torch, one_round, tag)
    idle = 1.0 - busy_us / wall_us if busy_us > 0 else None
    print(f"[{tag}] one traced pre-copy round: wall {wall_us / 1e3:.4f} ms, "
          f"device busy {busy_us / 1e3:.4f} ms, idle share {idle}")
    if not all(_same_bytes(torch, a, b) for a, b in
               zip(tree.leaves(dest), tree.leaves(state()))):
        raise AssertionError(f"{tag}: traced round left the destination "
                             f"behind")
    return wall_us, busy_us, idle


def _resume_on_destination(torch, decode, params, box, dest, tag: str,
                           steps: int = 8) -> float:
    """Decode resumes on the destination as on the live replica (the same
    tokens); then ``steps`` timed steps there. Returns s per step."""
    t_live, l_live, _ = decode(params, box["tok"], box["cache"])
    tok, l_dest, dcache = decode(dest["params"], box["tok"], dest["cache"])
    if not torch.equal(t_live, tok):
        raise AssertionError(f"{tag}: decode on the destination picks other "
                             f"tokens")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, _, dcache = decode(dest["params"], tok, dcache)
    torch.cuda.synchronize()
    t_tok = (time.perf_counter() - t0) / steps
    print(f"[{tag}] decode resumed on the destination (tokens equal, logits "
          f"max diff {float((l_live - l_dest).abs().max())}); decode "
          f"{1e3 * t_tok:.4f} ms per step of {SERVE_BATCH} tokens")
    return t_tok


def phase_serve(torch, ops_mod, ref, dirty_delta):
    """The full-width replica: prefill (24 B5 launches; the first B5
    application of the event-timed second prefill held against the
    oracle), then pre-copy while decode runs; returns the launch counts of
    the prefill and of the migration and the numbers to keep."""
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
    logits, cache, t_prefill, peak, prefill_launches = _counted_prefill(
        torch, ops_mod, prefill, params, batch)
    if logits.shape != (SERVE_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("prefill logits are not finite or misshapen")
    if prefill_launches["flash_attention"] != ATTN_LAUNCHES[ARCH]:
        raise AssertionError(f"{ARCH} prefill launched {prefill_launches}, "
                             f"want {ATTN_LAUNCHES[ARCH]} flash_attention")
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
          f"{peak:.4f} GB, launches {prefill_launches}")
    split = _timed_prefill(torch, ops_mod, prefill, params, batch, "serve")

    ops_mod.reset_launch_counts()
    dest, rep, scan_dev_ms = _migrate_scan_events(
        torch, precopy, state, decode_once, precopy.PrecopyConfig(**PCFG))
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
    if launches["dirty_blocks"] != _scan_launches(n_float) * len(
            rep.scan_seconds):
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
    print(f"[serve] scan ms per round, host clock "
          f"{[round(t, 4) for t in scan_ms]}, CUDA events "
          f"{[round(t, 4) for t in scan_dev_ms]}, against a bound of "
          f"{scan_bound:.4f} ms (bytes)")
    if max(scan_ms) > SCAN_LIMIT * scan_bound:
        raise AssertionError(f"a scan took {max(scan_ms):.4f} ms, over "
                             f"{SCAN_LIMIT} x its bound")
    scan_forms = _scan_forms(torch, state(), dest, "serve")

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

    wall_us, busy_us, idle = _traced_round(torch, decode_once, state, dest,
                                           "serve")
    t_tok = _resume_on_destination(torch, decode, params, box, dest, "serve")
    del r, params, batch, dest, live, box, cache, logits
    torch.cuda.empty_cache()
    return prefill_launches, launches, {
        "state_gb": rep.v_mem / 1e9, "prefill_s": t_prefill,
        "prefill_peak_gb": peak, "prefill_split": split,
        "decode_ms_per_step": 1e3 * t_tok, "scan_ms": scan_ms,
        "scan_event_ms": scan_dev_ms,
        "scan_bound_ms": scan_bound, **scan_forms, "rounds": out.rounds,
        "stop_reason": out.stop_reason,
        "bytes_sent_over_v_mem": out.bytes_sent / rep.v_mem,
        "migrate_wall_s": rep.wall_time, "round_traced_ms": wall_us / 1e3,
        "round_device_busy_ms": busy_us / 1e3, "round_idle_share": idle}


def _card_and_cpu(torch, cfg, batch: int = 2, prompt: int = 128,
                  steps: int = 8):
    """``cfg`` prefilled (``batch`` x ``prompt``) and decoded ``steps``
    greedy tokens on the card and on the CPU from the same weights.
    Returns ((card logits, card tokens), (CPU logits, CPU tokens))."""
    from repro_torch import tree
    from repro_torch.data import make_batch
    from repro_torch.models import lm
    from repro_torch.train import make_decode_step, make_prefill_step

    p_card = lm.init_params(cfg, SEED, device="cuda")
    runs = {}
    for dev, params in (("cuda", p_card),
                        ("cpu", tree.map(lambda t: t.cpu(), p_card))):
        b = make_batch(cfg, batch, prompt, device=dev)
        b.pop("targets")
        logits, cache = make_prefill_step(cfg, prompt + steps)(params, b)
        decode = make_decode_step(cfg)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        rows, toks = [logits.cpu()], [tok.cpu()]
        for _ in range(steps):
            tok, logits, cache = decode(params, tok, cache)
            rows.append(logits.cpu())
            toks.append(tok.cpu())
        runs[dev] = torch.stack(rows), torch.cat(toks, 1)
    return runs["cuda"], runs["cpu"]


def phase_serve_cpu_check(torch):
    """The same model 2 layers deep in f32 (batch 2, prompt 128, 8 greedy
    tokens) on the card and on the CPU, from the same weights. TF32 is
    off, so the two differ only in summation order: logits within rtol
    1e-3 / atol 1e-3, tokens equal."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH).replace(num_layers=2, param_dtype="float32")
    (lg, tg), (lc, tc) = _card_and_cpu(torch, cfg)
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


# ---------------------------------------------------------------------------
# phase 6: the SSM serving path and kernel B4
# ---------------------------------------------------------------------------
SSM_ARCH, RWKV_ARCH = "zamba2_2p7b", "rwkv6_1p6b"
# cache slots past the prompt: 8 migration steps, a traced round, a resume
# check and 8 timed steps on the destination
SSM_TOKENS = 24
RWKV_STEPS = 8
SCAN_TOL = 2e-4           # rtol and atol of tests/test_kernels.py's ssm scan
# f32 sums over thousands of tokens: atol also scales with the output's
# peak (PERF.md), as B1's does above N = 2048
SCAN_PEAK_ATOL = 1e-6
CPU_CHECK_RTOL = 1e-4     # card against CPU in f32, relative to the peak


def _distinct_bytes(t) -> int:
    """Bytes a function must read of ``t``: its distinct elements (a
    stride-0 dimension holds one), each once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _scan_flops(B: int, H: int, S: int, Dk: int, Dv: int, *,
                qk_shared: bool = False) -> float:
    """The scan's least work: the chunked form's flops at the chunk size Q
    that needs fewest (B4 itself runs Q = 32). Per (b, h): the state's
    readout and update (2 S Dk Dv each) and its decay once per chunk
    (Dk Dv); per chunk, for each causal pair, the score (2 Dk, once per b
    when every head shares q and k, then 1 for the head's decay) and its
    product with v (2 Dv). Exponentials and scalings are not counted."""
    def work(Q: int) -> float:
        n, r = divmod(S, Q)
        pairs = n * Q * (Q + 1) // 2 + r * (r + 1) // 2
        chunks = n + (r > 0)
        per_pair = 2.0 * Dk / H + 1.0 if qk_shared else 2.0 * Dk
        return B * H * (pairs * (per_pair + 2.0 * Dv) + chunks * Dk * Dv
                        + 4.0 * S * Dk * Dv)
    return min(work(Q) for Q in range(1, min(S, 256) + 1))


def _scan_case(torch, g, kind, B, H, S, Dk, Dv, *, dtype=None, ssd=True,
               decay_scale=0.3, init=False, sliced=False, scalar=False):
    """Inputs of one B4 case on the card: ((q, k, v, log_decay), bonus,
    initial state). ``mamba``: q/k broadcast over heads and the per-head
    decay over Dk (stride-0 views), v a head view of (B, S, H, Dv), decay
    -exp(U(log 1e-3, log 1.6)) as dt * A spans; ``rwkv``: head views of
    (B, S, H, D), decay -exp(U(-6, -1)) as ``decay_base`` spans, bonus u;
    ``plain``: contiguous f32 (``sliced``: every other element of rows
    twice as wide, a d stride of 2), decay -|N(0, 1)| * ``decay_scale``
    (``scalar``: one value per token, stride 0 over Dk)."""
    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dt)

    def neg_exp_u(lo, hi, *shape):
        u = torch.rand(*shape, device="cuda", generator=g)
        return -torch.exp(lo + (hi - lo) * u)

    u = None
    if kind == "mamba":
        q = rn(B, S, Dk, dt=dtype)[:, None].expand(B, H, S, Dk)
        k = rn(B, S, Dk, dt=dtype)[:, None].expand(B, H, S, Dk)
        v = rn(B, S, H, Dv, dt=dtype).permute(0, 2, 1, 3)
        lw = neg_exp_u(math.log(1e-3), math.log(1.6), B, S, H).permute(
            0, 2, 1)[..., None].expand(B, H, S, Dk)
    elif kind == "rwkv":
        q, k, v = (rn(B, S, H, D, dt=dtype).permute(0, 2, 1, 3)
                   for D in (Dk, Dk, Dv))
        lw = neg_exp_u(-6.0, -1.0, B, S, H, Dk).permute(0, 2, 1, 3)
        u = 0.5 * rn(H, Dk)
    else:
        w = 2 if sliced else 1
        q, k, v = (rn(B, H, S, w * D)[..., ::w] for D in (Dk, Dk, Dv))
        lw = -decay_scale * rn(B, H, S, w * Dk)[..., ::w].abs()
        if scalar:
            lw = lw[..., :1].expand(B, H, S, Dk)
        u = None if ssd else rn(H, Dk)
    return (q, k, v, lw), u, (rn(B, H, Dk, Dv) if init else None)


def _scan_err(torch, got, want):
    """(max abs err over y and state, the atol used); raises past
    rtol/atol SCAN_TOL with the atol raised to SCAN_PEAK_ATOL x the peak."""
    worst, atol_used = 0.0, SCAN_TOL
    for a, b in zip(got, want):
        atol = max(SCAN_TOL, SCAN_PEAK_ATOL * float(b.abs().max()))
        err = (a - b).abs()
        if not bool((err <= atol + SCAN_TOL * b.abs()).all()):
            raise AssertionError(f"max abs err {float(err.max())} over "
                                 f"atol {atol}")
        worst, atol_used = max(worst, float(err.max())), max(atol_used, atol)
    return worst, atol_used


def phase_ssm_kernel(torch, ref, gla, ssm_scan):
    """B4 against its plain version (``gla_chunked`` on the card) at
    zamba2's and rwkv6's prefill shapes, and against the step recurrence
    too on the edges; a second launch must be bit-equal. Returns the
    record at zamba2's shape."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    cases = [  # name, kind, (B, H, S, Dk, Dv), options, step oracle
        ("zamba2 prefill: SSD, stride-0 bf16 q/k, f32 decay", "mamba",
         (SERVE_BATCH, 80, SERVE_PROMPT, 64, 64), dict(dtype=bf16), False),
        ("rwkv6 prefill: RWKV + u, bf16 r/k/v", "rwkv",
         (SERVE_BATCH, 32, SERVE_PROMPT, 64, 64), dict(dtype=bf16), False),
        ("S=1 SSD f32", "plain", (2, 3, 1, 64, 64), dict(ssd=True), True),
        ("S=33 RWKV f32", "plain", (2, 3, 33, 64, 64), dict(ssd=False),
         True),
        ("S=4095 SSD f32", "plain", (2, 3, 4095, 64, 64), dict(ssd=True),
         True),
        ("S=4095 RWKV f32", "plain", (2, 3, 4095, 64, 64),
         dict(ssd=False), True),
        ("decay below the clamp, RWKV", "plain", (2, 3, 100, 64, 64),
         dict(ssd=False, decay_scale=6.0), True),
        ("initial state, SSD", "plain", (2, 3, 70, 64, 64),
         dict(ssd=True, init=True), True),
        ("initial state, RWKV", "plain", (2, 3, 70, 64, 64),
         dict(ssd=False, init=True), True),
        ("smoke dims Dk=16 Dv=32, stride-0 bf16", "mamba", (2, 8, 45, 16, 32),
         dict(dtype=bf16), True),
        ("shared q/k over H=5 heads (two a block, one left), stride-0 bf16",
         "mamba", (2, 5, 100, 64, 64), dict(dtype=bf16), True),
        ("zamba2-like in f32 (every product split), stride-0 q/k/decay",
         "mamba", (2, 8, 1000, 64, 64), dict(dtype=torch.float32), True),
        ("odd widths Dk=20 Dv=33 RWKV bf16 (element-wise loads)", "rwkv",
         (2, 3, 77, 20, 33), dict(dtype=bf16), True),
        ("SSD f32, decay stride 0 over Dk, q/k per head, initial state",
         "plain", (2, 3, 130, 64, 64), dict(ssd=True, init=True, scalar=True),
         True),
        ("d stride 2 SSD f32 (element-wise loads), initial state", "plain",
         (2, 3, 70, 64, 64), dict(ssd=True, init=True, sliced=True), True),
    ]
    record = None
    for name, kind, (B, H, S, Dk, Dv), kw, step in cases:
        ins, u, s0 = _scan_case(torch, g, kind, B, H, S, Dk, Dv, **kw)
        got = ssm_scan.ssm_scan(*ins, u, s0)
        again = ssm_scan.ssm_scan(*ins, u, s0)
        want = gla.gla_chunked(*ins, bonus=u, initial_state=s0)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssm_scan not deterministic on {name}")
        try:
            err, atol = _scan_err(torch, got, want)
            if step:
                err_ref, _ = _scan_err(torch, got, ref.ssm_scan_ref(
                    *ins, bonus=u, initial_state=s0))
        except AssertionError as e:
            raise AssertionError(f"ssm_scan disagrees on {name}: {e}")
        line = (f"[ssm] ssm_scan {name} {(B, H, S, Dk, Dv)}: max_abs_err "
                f"{err:.6g} (atol {atol:.3g}, y peak "
                f"{float(want[0].abs().max()):.4g})")
        if step:
            line += f", against the step recurrence {err_ref:.6g}"
        if kind != "plain" and not step:
            ms = _median_ms(lambda: ssm_scan.ssm_scan(*ins, u, s0))
            plain = _median_ms(lambda: gla.gla_chunked(
                *ins, bonus=u, initial_state=s0), 5)
            nbytes = (sum(_distinct_bytes(t) for t in ins)
                      + 4.0 * B * H * (S * Dv + Dk * Dv)
                      + (0 if u is None else _distinct_bytes(u)))
            shared = ins[0].stride(1) == 0 and ins[1].stride(1) == 0
            flops = _scan_flops(B, H, S, Dk, Dv, qk_shared=shared)
            # the least time on this card, whatever runs the scan: its
            # bytes, or its flops as 3xTF32 products on the tensor cores
            bound, by = _bound_ms(TF32_SPLIT_PRODUCTS * flops, nbytes,
                                  PEAK_TF32_TENSOR_FLOPS)
            f32_bound, f32_by = _bound_ms(flops, nbytes)
            line += (f"; kernel {ms:.4f} ms plain {plain:.4f} ms bound "
                     f"{bound:.6g} ms ({by}, {nbytes / 1e9:.4f} GB; at the "
                     f"f32 CUDA-core peak {f32_bound:.6g} ms, {f32_by})")
            if record is None:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=None)
        print(line + ", bit-equal on a second launch")
        del ins, u, s0, got, again, want
        torch.cuda.empty_cache()
    return record


def _plain_dirty_counts(torch, ref, live, shadow, block: int):
    """Per-leaf dirty-block counts of B3's plain version (an exact != for
    integer leaves) on the pair of trees a scan compares."""
    from repro_torch import tree
    counts = []
    for n, o in zip(tree.leaves(live), tree.leaves(shadow)):
        n, o = n.reshape(-1), o.reshape(-1)
        if n.is_floating_point():
            d = ref.max_abs_delta_ref(n, o, block)[:, 0] > 0
        else:
            d = ref.block_reduce(n != o, block, torch.any)
        counts.append(int(d.sum()))
    return counts


def _conv_dirty_blocks(conv_shape, seq_tokens, pos: int, block: int):
    """(least, most) blocks of the stacked bf16 conv state (L, B, W-1, C)
    that the decode step at position ``pos`` dirties. Layers past the
    first take the mixed residual stream, so every block there changes. A
    row of the first layer holds the projection of one token's embedding:
    a shift leaves it bit-equal where the token it now holds is the token
    it held (a repeat, common in Zipfian text) and both rows came from the
    same matmul (prefill's, or decode's); where one came from each, the two
    products may or may not round alike, so such a block counts in the
    most and not in the least. ``seq_tokens``: (B, pos + 1) token ids."""
    L, B, R, C = conv_shape
    total = -(-L * B * R * C // block)

    def row(b, p):                     # what decides a first-layer row
        return seq_tokens[b][p], p >= SERVE_PROMPT

    status = []                         # per row: dirty, clean or unknown
    for b in range(B):
        for r in range(R):
            new, old = row(b, pos - R + 1 + r), row(b, pos - R + r)
            status.append("dirty" if new[0] != old[0] else
                          "clean" if new == old else "unknown")
    first = B * R * C                   # elements of the first layer
    clean = unknown = 0
    for i in range(-(-first // block)):
        lo, hi = i * block, (i + 1) * block
        rows = set(status[lo // C: (min(hi, first) - 1) // C + 1])
        if hi > first or "dirty" in rows:
            continue
        if rows == {"clean"}:
            clean += 1
        else:
            unknown += 1
    return total - clean - unknown, total - clean


def _timed_prefill(torch, ops_mod, prefill, params, batch, tag: str,
                   parts=(), what: str = "prefill"):
    """Prefill once more with CUDA events around every layer, every B4
    launch and every B5 launch (``ops.flash_attention``: causal attention
    over the prompt), and around each call of the functions ``parts``
    names ((module, attribute, key) each); print and return ms per part
    and its share of the whole (``what`` names the call timed, a decode
    step too). The first B5 application's q, k, v and output are kept, and
    after the prefill B5 is held against ``ref.attention_ref`` on them
    (``_attn_check``): the real activations at batch 16. Launch counts and
    peak memory are not read here."""
    from repro_torch.kernels import ref
    from repro_torch.models import lm
    pending, seen = [], []

    def timed(key, fn):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            pending.append((key, a, b))
            return out
        return run

    apply_block, scan = lm.apply_block, ops_mod.ssm_scan
    attention = ops_mod.flash_attention

    def keep_first(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        if not seen:
            seen.append((q, k, v, kw.get("window", 0), out))
        return out

    lm.apply_block = lambda kind, *a, **kw: timed(
        f"{kind}_layers", apply_block)(kind, *a, **kw)
    ops_mod.ssm_scan = timed("b4_ssm_scan", scan)
    ops_mod.flash_attention = timed("b5_flash_attention", keep_first)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in parts]
    for mod, name, key in parts:
        setattr(mod, name, timed(key, getattr(mod, name)))
    try:
        out = timed("prefill", prefill)(params, batch)
        torch.cuda.synchronize()
    finally:
        lm.apply_block, ops_mod.ssm_scan = apply_block, scan
        ops_mod.flash_attention = attention
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    del out
    ms, counts = {}, {}
    for key, a, b in pending:
        ms[key] = ms.get(key, 0.0) + a.elapsed_time(b)
        counts[key] = counts.get(key, 0) + 1
    whole = ms.pop("prefill")
    counts.pop("prefill")
    parts = ", ".join(f"{k} x{counts[k]} {v:.4f} ms ({v / whole:.4f})"
                      for k, v in ms.items())
    print(f"[{tag}] event-timed {'second prefill' if what == 'prefill' else what}"
          f" {whole:.4f} ms: {parts}")
    split = {f"{what.replace(' ', '_')}_event_ms": whole,
             **{f"{k}_ms": v for k, v in ms.items()}}
    if seen:
        q, k, v, window, got = seen.pop()
        err, use = _attn_check(torch, ref, got, q, k, v, window,
                               f"{tag}'s first attention application")
        print(f"[{tag}] first attention application {tuple(q.shape)} "
              f"{str(q.dtype)[6:]} window {window}: B5 against attention_ref, "
              f"max_abs_err {err:.6g}, {use:.4f} of the limit")
        split["b5_on_path_max_abs_err"] = err
    return split


def _counted_prefill(torch, ops_mod, prefill, params, batch):
    """The counted prefill: launch counts set to 0, one prefill timed on the
    host clock, its peak memory and the counts read. Returns (logits,
    cache, s, peak GB, launches)."""
    ops_mod.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (logits, cache, secs, torch.cuda.max_memory_allocated() / 1e9,
            ops_mod.launch_counts())


def _migrate_scan_events(torch, precopy, *args, **kwargs):
    """``precopy.migrate`` with CUDA events around each scan as well
    (C-w6): returns (dest, report, device-clock ms per scan) beside the
    report's host-clock seconds."""
    scan, events = precopy.dirty_scan, []

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = scan(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    precopy.dirty_scan = timed
    try:
        dest, rep = precopy.migrate(*args, **kwargs)
    finally:
        precopy.dirty_scan = scan
    torch.cuda.synchronize()
    if len(events) != len(rep.scan_seconds):
        raise AssertionError(f"{len(events)} scans timed on the device, "
                             f"{len(rep.scan_seconds)} on the host")
    return dest, rep, [e0.elapsed_time(e1) for e0, e1 in events]


def phase_ssm_serve(torch, ops_mod, ref):
    """A full-width, full-depth zamba2-2.7b replica: prefill (45 B4 and 9
    B5 launches; the event-timed second prefill's first B5 application
    held against the oracle), then
    pre-copy with one decode step per round. Each round's
    pair of trees is also scanned by B3's plain version; its per-leaf
    counts must be every SSD-state block, the conv-state blocks the step
    changed (``_conv_dirty_blocks``), the ring blocks of the slot decode
    wrote and ``pos``, and its total the kernel's. Returns (prefill
    launches, migration launches, numbers to keep)."""
    from repro_torch import tree
    from repro_torch.core import precopy
    from repro_torch.launch.serve import build_replica
    from repro_torch.models import lm

    block = PCFG["block_elems"]
    t0 = time.perf_counter()
    r = build_replica(SSM_ARCH, SERVE_BATCH, SERVE_PROMPT, SSM_TOKENS,
                      smoke=False, seed=SEED, device="cuda")
    cfg, params, decode = r.cfg, r.params, r.decode
    n_groups, per = lm._group_shape(cfg)
    W = SERVE_PROMPT + SSM_TOKENS
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    logits, cache, t_prefill, peak, prefill_launches = _counted_prefill(
        torch, ops_mod, r.prefill, params, r.batch)
    if prefill_launches["ssm_scan"] != n_groups * per or \
            prefill_launches["flash_attention"] != ATTN_LAUNCHES[SSM_ARCH]:
        raise AssertionError(f"zamba2 prefill launched {prefill_launches}, "
                             f"want {n_groups * per} ssm_scan and "
                             f"{ATTN_LAUNCHES[SSM_ARCH]} flash_attention")
    if logits.shape != (SERVE_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("zamba2 prefill logits are not finite or "
                             "misshapen")
    split = _timed_prefill(torch, ops_mod, r.prefill, params, r.batch, "ssm")
    box = {"cache": cache, "produced": 0, "decode_s": [], "check_s": 0.0,
           "tok": logits.argmax(-1)[:, None].to(torch.int32),
           "fed": [r.batch["tokens"].cpu()]}

    def state():
        return {"params": params, "cache": box["cache"]}

    def decode_once():
        box["tok"], _, box["cache"] = decode(params, box["tok"], box["cache"])
        box["produced"] += 1

    def step_and_check():
        box["fed"].append(box["tok"].cpu())
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode_once()
        torch.cuda.synchronize()
        box["decode_s"].append(time.perf_counter() - t)
        t = time.perf_counter()
        box["plain"].append(_plain_dirty_counts(torch, ref, state(),
                                                box["shadow"], block))
        box["check_s"] += time.perf_counter() - t

    def keep_shadow(t):                  # the scan's record, as it merges
        box["shadow"], box["plain"] = t, []
        return t

    v_params = precopy.total_bytes(params)
    print(f"[ssm] {SSM_ARCH} full width and depth ({n_groups} groups of "
          f"{per} Mamba2 layers + shared attention), "
          f"{sum(t.numel() for t in tree.leaves(params))} params "
          f"({v_params / 1e9:.4f} GB), init {t_init:.4f} s; prefill "
          f"{SERVE_BATCH} x {SERVE_PROMPT} in {t_prefill:.4f} s, peak "
          f"{peak:.4f} GB, launches {prefill_launches}")

    ops_mod.reset_launch_counts()
    dest, rep, scan_dev_ms = _migrate_scan_events(
        torch, precopy, state, step_and_check, precopy.PrecopyConfig(**PCFG),
        placement=keep_shadow)
    launches = ops_mod.launch_counts()
    out = rep.outcome
    live = state()
    if not all(_same_bytes(torch, a, b) for a, b in
               zip(tree.leaves(dest), tree.leaves(live))):
        raise AssertionError("zamba2 destination differs from the live "
                             "replica")
    # what each round must find, leaf by leaf
    conv, ssd = live["cache"]["mamba"]
    kinds = {id(conv): "conv", id(ssd): "ssd", id(live["cache"]["pos"]): "pos",
             **{id(t): "ring" for t in live["cache"]["shared_attn"].values()}}
    leaves = tree.leaves(live)
    seq_tokens = torch.cat(box["fed"], dim=1).tolist()
    slots = [SERVE_PROMPT + k for k in range(box["produced"])]
    plain_bytes, conv_clean = [], []
    for slot, counts in zip(slots, box["plain"]):
        ring = (_ring_dirty_bytes(cfg, SERVE_BATCH, W, slot, block,
                                  layers=n_groups) - 4 * block) // (4 * block)
        want = {"conv": _conv_dirty_blocks(tuple(conv.shape), seq_tokens,
                                           slot, block),
                "ssd": -(-ssd.numel() // block), "pos": 1, "ring": ring}
        for t, c in zip(leaves, counts):
            kind = kinds.get(id(t), "param")
            need = want.get(kind, 0)
            least, most = need if isinstance(need, tuple) else (need, need)
            if kind == "conv":
                conv_clean.append(-(-t.numel() // block) - c)
            if not least <= c <= most:
                raise AssertionError(f"round at slot {slot}: a {kind} leaf "
                                     f"{tuple(t.shape)} has {c} dirty blocks"
                                     f", want {need}")
        plain_bytes.append(sum(c * block * t.element_size()
                               for t, c in zip(leaves, counts)))
    if rep.per_round_dirty_bytes[1:] != plain_bytes or \
            box["produced"] != out.rounds or out.stop_reason != "max_rounds":
        raise AssertionError(f"zamba2 migration: per-round bytes "
                             f"{rep.per_round_dirty_bytes} against B3's plain"
                             f" version {plain_bytes}, {out.rounds} rounds, "
                             f"stop {out.stop_reason}")
    n_float = sum(t.is_floating_point() for t in leaves)
    if launches["dirty_blocks"] != _scan_launches(n_float) * len(
            rep.scan_seconds):
        raise AssertionError(f"zamba2 migration launched {launches}")
    blocks = sum(-(-t.numel() // block) for t in leaves)
    scan_bound, _ = _bound_ms(0.0, 2.0 * rep.v_mem + 4.0 * blocks)
    scan_ms = [1e3 * s for s in rep.scan_seconds]
    wall = rep.wall_time - box["check_s"]
    print(f"[ssm] state {rep.v_mem / 1e9:.4f} GB (cache "
          f"{(rep.v_mem - v_params) / 1e9:.4f} GB: SSD {ssd.numel() * 4 / 1e9:.4f}"
          f" GB, conv {conv.numel() * conv.element_size() / 1e9:.4f} GB); "
          f"migrate {out.rounds} rounds, stop {out.stop_reason}, bytes sent "
          f"/ v_mem {out.bytes_sent / rep.v_mem:.6f} (round 1 re-sent "
          f"{plain_bytes[0] / 1e9:.4f} GB), wall "
          f"{wall:.4f} s without the plain checks ({box['check_s']:.4f} s); "
          f"per-round bytes {rep.per_round_dirty_bytes[1:]} equal B3's plain"
          f" version on each round's pair: every SSD block dirty, every conv "
          f"block but those of the first layer whose rows' tokens repeat "
          f"(clean per round {conv_clean}), ring blocks those of the slots "
          f"written; destination bit-equal; launches {launches}")
    print(f"[ssm] scan ms per round, host clock "
          f"{[round(t, 4) for t in scan_ms]}, CUDA events "
          f"{[round(t, 4) for t in scan_dev_ms]}, against a bound of "
          f"{scan_bound:.4f} ms (bytes); decode ms per "
          f"step during the migration "
          f"{[round(1e3 * t, 4) for t in box['decode_s']]}")
    if max(scan_ms) > SCAN_LIMIT * scan_bound:
        raise AssertionError(f"a zamba2 scan took {max(scan_ms):.4f} ms, "
                             f"over {SCAN_LIMIT} x its bound")
    scan_forms = _scan_forms(torch, state(), dest, "ssm")

    wall_us, busy_us, idle = _traced_round(torch, decode_once, state, dest,
                                           "ssm")
    t_tok = _resume_on_destination(torch, decode, params, box, dest, "ssm")
    del r, params, dest, live, box, cache, logits, conv, ssd, leaves
    torch.cuda.empty_cache()
    return prefill_launches, launches, {
        "state_gb": rep.v_mem / 1e9, "prefill_s": t_prefill,
        "prefill_peak_gb": peak, "decode_ms_per_step": 1e3 * t_tok,
        "scan_ms": scan_ms, "scan_event_ms": scan_dev_ms,
        "scan_bound_ms": scan_bound, **scan_forms,
        "rounds": out.rounds, "stop_reason": out.stop_reason,
        "bytes_sent_over_v_mem": out.bytes_sent / rep.v_mem,
        "round_resend_gb": plain_bytes[0] / 1e9, "migrate_wall_s": wall,
        "round_traced_ms": wall_us / 1e3,
        "round_device_busy_ms": busy_us / 1e3, "round_idle_share": idle,
        "prefill_split": split}


def phase_rwkv_serve(torch, ops_mod):
    """A full-width, full-depth rwkv6-1.6b replica served: prefill (24 B4
    launches) and RWKV_STEPS greedy decode steps."""
    from repro_torch import tree
    from repro_torch.launch.serve import build_replica

    r = build_replica(RWKV_ARCH, SERVE_BATCH, SERVE_PROMPT, RWKV_STEPS,
                      smoke=False, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = r.prefill(r.params, r.batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(RWKV_STEPS):
        tok, logits, cache = r.decode(r.params, tok, cache)
    torch.cuda.synchronize()
    t_tok = (time.perf_counter() - t0) / RWKV_STEPS
    launches = ops_mod.launch_counts()
    if launches["ssm_scan"] != r.cfg.num_layers:
        raise AssertionError(f"rwkv6 serving launched {launches}, want "
                             f"{r.cfg.num_layers} ssm_scan")
    if not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["pos"]) != SERVE_PROMPT + RWKV_STEPS:
        raise AssertionError("rwkv6 decode logits are not finite")
    split = _timed_prefill(torch, ops_mod, r.prefill, r.params, r.batch,
                           "ssm")
    n = sum(t.numel() for t in tree.leaves(r.params))
    v_cache = sum(t.numel() * t.element_size() for t in tree.leaves(cache))
    print(f"[ssm] {RWKV_ARCH} full width and depth, {n} params; prefill "
          f"{SERVE_BATCH} x {SERVE_PROMPT} in {t_prefill:.4f} s, peak "
          f"{peak:.4f} GB; state cache {v_cache / 1e9:.4f} GB; decode "
          f"{1e3 * t_tok:.4f} ms per step of {SERVE_BATCH} tokens (mean of "
          f"{RWKV_STEPS}); launches {launches}")
    del r, cache, logits
    torch.cuda.empty_cache()
    return launches, {"prefill_s": t_prefill, "prefill_peak_gb": peak,
                      "decode_ms_per_step": 1e3 * t_tok,
                      "prefill_split": split}


def phase_ssm_cpu_check(torch):
    """Both models at full width and shallow depth in f32 on the card
    against the CPU: zamba2 one group deep (5 Mamba2 layers and the shared
    block), rwkv6 2 layers. Logits within CPU_CHECK_RTOL of their peak,
    greedy tokens equal."""
    from repro_torch.configs import get_config

    errs = {}
    for arch, layers in ((SSM_ARCH, 6), (RWKV_ARCH, 2)):
        cfg = get_config(arch).replace(num_layers=layers,
                                       param_dtype="float32")
        (lg, tg), (lc, tc) = _card_and_cpu(torch, cfg)
        err, size = float((lg - lc).abs().max()), float(lc.abs().max())
        if not torch.equal(tg, tc) or err > CPU_CHECK_RTOL * size:
            raise AssertionError(f"{arch}: card and CPU differ: tokens equal "
                                 f"{torch.equal(tg, tc)}, max abs err {err} "
                                 f"on logits of size {size}")
        print(f"[ssm] {arch} full width, {layers} layers, f32: card and CPU "
              f"logits max abs err {err:.6g} (size {size:.4f}), 9 x 2 greedy "
              f"tokens equal")
        errs[arch] = err
    return errs


# ---------------------------------------------------------------------------
# phase 7: attention prefill through kernel B5, and a full-width qwen3-8b
# ---------------------------------------------------------------------------
DENSE_ARCH = "qwen3_8b"
DENSE_STEPS = 8
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}  # test_kernels.py
# bf16 outputs are held, tighter, to the rounding B5's contract allows
# against the oracle's f32 softmax: both outputs rounded to bf16 (u of
# each) and p rounded to bf16 before P.V (u of sum_k p_k |v_k|). The
# limit takes 2u on each, which leaves room for the f32 sums.
BF16_U = 2.0 ** -8
WINDOW_RATIO_LIMIT = 0.6  # windowed over causal time at S = 16,384
# B5's launches in one prefill of each replica: one per attention layer
ATTN_LAUNCHES = {ARCH: 24, SSM_ARCH: 9, DENSE_ARCH: 36}


def _attention_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs, trimmed to the window when one is set."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _attention_bound(q, k, window: int):
    """(ms, by) of the least work of attention on these inputs: 4 D flops
    per causal, window-trimmed pair and head (exponentials not counted), at
    the bf16 tensor-core peak for bf16 inputs; q, k, v read and the output
    written once."""
    B, H, S, D = q.shape
    flops = 4.0 * B * H * _attention_pairs(S, window) * D
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    peak = PEAK_BF16_TENSOR_FLOPS if q.element_size() == 2 else \
        PEAK_F32_FLOPS
    return _bound_ms(flops, nbytes, peak)


def _attn_inputs(torch, g, B, H, Hkv, S, D, dtype, layout="heads"):
    """q (B, H, S, D), k and v (B, Hkv, S, D) on the card, as ``layout``:
    "heads", head views of (B, S, heads, D) tensors as the model's prefill
    hands them to B5; "contiguous", (B, heads, S, D) tensors; "offset",
    head views whose base lies one element past a 16-byte boundary (rows of
    D + 1); "d-strided", views with a d stride of S. The last two are what
    B5's 16-byte loads cannot take."""
    def rn(heads):
        if layout == "contiguous":
            return torch.randn(B, heads, S, D, device="cuda",
                               generator=g).to(dtype)
        if layout == "offset":
            return torch.randn(B, S, heads, D + 1, device="cuda",
                               generator=g).to(dtype)[..., 1:].transpose(1, 2)
        if layout == "d-strided":
            return torch.randn(B, heads, D, S, device="cuda",
                               generator=g).to(dtype).transpose(2, 3)
        return torch.randn(B, S, heads, D, device="cuda",
                           generator=g).to(dtype).transpose(1, 2)
    return rn(H), rn(Hkv), rn(Hkv)


def _attn_check(torch, ref, got, q, k, v, window: int, name: str,
                oracle=None):
    """B5's output ``got`` held against ``ref.attention_ref`` (or
    ``oracle``, a function of the same signature) on its inputs, one batch
    element at a time (one element's f32 scores at 32 heads and S = 4,096
    take 2.1 GB). Each element must lie within ATTN_TOL of its dtype
    (rtol = atol) and, in bf16, within ``2u (|want| + sum_k p_k |v_k|)``
    as well, the second sum being the oracle on |v| in f32. Returns (max
    abs error, largest share of the limit used); raises past the limit."""
    oracle = oracle or ref.attention_ref
    tol0 = ATTN_TOL[str(q.dtype)]
    err_max = use = 0.0
    for b in range(q.shape[0]):
        one = slice(b, b + 1)
        want = oracle(q[one], k[one], v[one], window=window).float()
        tol = tol0 + tol0 * want.abs()
        if q.dtype == torch.bfloat16:
            mass = oracle(q[one].float(), k[one].float(),
                          v[one].float().abs(), window=window)
            tol = torch.minimum(tol, 2 * BF16_U * (want.abs() + mass))
        err = (got[one].float() - want).abs()
        err_max = max(err_max, float(err.max()))
        use = max(use, float((err / tol.clamp_min(1e-30)).max()))
        if bool((err > tol).any()):
            raise AssertionError(f"flash_attention disagrees with "
                                 f"attention_ref on {name}: max abs err "
                                 f"{err_max}, {use:.4f} of the limit")
    return err_max, use


def _chunked_f32_oracle(ref):
    """``ref.attention_chunked`` in f32 (its bf16 form keeps acc in bf16),
    rounded to the inputs' dtype: the oracle where ``attention_ref``'s
    S x S scores do not fit."""
    def oracle(q, k, v, *, window):
        return ref.attention_chunked(q.float(), k.float(), v.float(),
                                     window=window).to(q.dtype)
    return oracle


def phase_attention_kernel(torch, ref, fa):
    """B5 against the naive oracle (``ref.attention_ref``) at the three
    prefills' head shapes (batch 2, bf16), at the training step's (batch
    4, S 2,048, internlm2's heads, bf16) and on the edges in both dtypes
    (the bf16 ones also in layouts the 16-byte loads cannot take), each
    bit-equal on a second launch and on inputs of another layout; the
    window at full width (S = 16,384) in f32 and bf16 against the chunked
    plain version, with its time against the causal one; times of B5, the
    plain version and the library call at zamba2's, qwen3's and danube's
    prefill shapes and at the MoE prefills' (qwen3-moe's G = 8; D = 112 of
    the reference's kimi-k2, GQA standing in for Kimi-K2's MLA), those
    also bit-equal on a second launch. Returns (the record
    at zamba2's shape, the records at every prefill shape)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    edges = [  # name, (B, H, Hkv, S, D), window
        ("S=1", (2, 32, 8, 1, 128), 0),
        ("S=33", (2, 8, 2, 33, 120), 0),
        ("S=127", (2, 8, 8, 127, 80), 0),
        ("S=4095", (2, 8, 2, 4095, 128), 0),
        ("window 64", (1, 4, 2, 256, 64), 64),
        ("window 128", (1, 4, 2, 256, 64), 128),
        ("window 500", (1, 4, 2, 256, 64), 500),
        ("G=9 (starcoder2 heads)", (2, 36, 4, 300, 128), 0),
    ]
    cases = [  # name, (B, H, Hkv, S, D), dtype, window, layout
        ("zamba2 heads", (2, 32, 32, 4096, 80), bf16, 0, "heads"),
        ("danube3 heads, SWA", (2, 32, 8, 4096, 120), bf16, 4096, "heads"),
        ("qwen3 heads", (2, 32, 8, 4096, 128), bf16, 0, "heads"),
        # the training step's shape: TRAIN_BATCH x TRAIN_SEQ at internlm2's
        # heads, as its every attention layer hands them to B5
        ("internlm2 train heads", (4, 16, 8, 2048, 128), bf16, 0, "heads"),
        *((name, shape, dtype, window, "heads")
          for dtype in (f32, bf16) for name, shape, window in edges),
        ("smoke widths f32", (2, 4, 2, 48, 32), f32, 0, "heads"),
        ("smoke widths bf16, SWA 16", (2, 4, 2, 48, 32), bf16, 16, "heads"),
        ("contiguous bf16", (2, 8, 2, 1000, 120), bf16, 0, "contiguous"),
        ("base off by one bf16, SWA 300", (2, 8, 2, 1000, 120), bf16, 300,
         "offset"),
        ("d stride S bf16", (2, 8, 2, 333, 80), bf16, 0, "d-strided"),
        ("S=33 d stride S bf16", (1, 4, 4, 33, 24), bf16, 0, "d-strided"),
    ]
    for name, (B, H, Hkv, S, D), dtype, window, layout in cases:
        q, k, v = _attn_inputs(torch, g, B, H, Hkv, S, D, dtype, layout)
        got = fa.flash_attention(q, k, v, window)
        again = fa.flash_attention(q, k, v, window)
        err, use = _attn_check(torch, ref, got, q, k, v, window, name)
        # the same values in another layout: contiguous copies of head
        # views or of the unaligned views, head views of (B, S, heads, D)
        # copies of contiguous inputs
        relaid = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  if layout == "contiguous" else t.contiguous()
                  for t in (q, k, v))
        other = fa.flash_attention(*relaid, window)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype:
            raise AssertionError(f"flash_attention on {name}: {got.shape} "
                                 f"{got.dtype}")
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention not deterministic on "
                                 f"{name}")
        if not torch.equal(got, other):
            raise AssertionError(f"flash_attention: {layout} and relaid "
                                 f"inputs differ on {name}")
        print(f"[attn] flash_attention {name} {(B, H, Hkv, S, D)} "
              f"{str(dtype)[6:]} window {window}: max_abs_err {err:.6g} "
              f"against attention_ref, {use:.4f} of the limit, bit-equal on "
              f"a second launch and on "
              f"{'strided' if layout == 'contiguous' else 'contiguous'} "
              f"copies")
        del q, k, v, got, again, other
        torch.cuda.empty_cache()

    # the window at full width: danube's heads, S = 16,384, in f32 (held to
    # 2e-5 against the chunked plain version) and bf16 (held by
    # _attn_check against it in f32)
    S, window = 4 * SERVE_PROMPT, get_config(ARCH).sliding_window
    for dtype in (f32, bf16):
        q, k, v = _attn_inputs(torch, g, 1, 32, 8, S, 120, dtype)
        got = fa.flash_attention(q, k, v, window)
        if dtype == f32:
            want = ref.attention_chunked(q, k, v, window=window)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not bool(((got - want).abs()
                         <= 2e-5 + 2e-5 * want.abs()).all()):
                raise AssertionError(f"flash_attention at S={S}, window "
                                     f"{window}: max abs err {err} against "
                                     f"the chunked plain version")
            what = "against the chunked plain version"
            del want
        else:
            err, use = _attn_check(torch, ref, got, q, k, v, window,
                                   f"S={S} window {window}",
                                   oracle=_chunked_f32_oracle(ref))
            what = (f"against the chunked plain version in f32, {use:.4f} "
                    f"of the limit")
        ms_win = _median_ms(lambda: fa.flash_attention(q, k, v, window), 5)
        ms_causal = _median_ms(lambda: fa.flash_attention(q, k, v, 0), 5)
        ratio = ms_win / ms_causal
        print(f"[attn] flash_attention (1, 32, 8, {S}, 120) "
              f"{str(dtype)[6:]} window {window}: max_abs_err {err:.6g} "
              f"{what}; {ms_win:.4f} ms against {ms_causal:.4f} ms causal, "
              f"ratio {ratio:.4f} (pairs predict "
              f"{_attention_pairs(S, window) / _attention_pairs(S, 0):.4f})")
        if ratio > WINDOW_RATIO_LIMIT:
            raise AssertionError(f"windowed over causal time {ratio:.4f} > "
                                 f"{WINDOW_RATIO_LIMIT} in {dtype}: B5 does "
                                 f"not skip the tiles before the window")
        del q, k, v, got
        torch.cuda.empty_cache()

    # times at the prefills' shapes (bf16: batch 16, the MoE models' 8 and
    # 4); danube's window of 4,096 covers its whole prompt, so SDPA runs it
    # as plain causal. The MoE shapes' G = 8 and kimi-k2's D = 112 (B5's
    # D tiles zero-padded to 128) are also held bit-equal on a second
    # launch.
    record, times = None, {}
    for name, (B, H, Hkv, D), window in (
            ("zamba2", (SERVE_BATCH, 32, 32, 80), 0),
            ("qwen3", (SERVE_BATCH, 32, 8, 128), 0),
            ("danube3", (SERVE_BATCH, 32, 8, 120), 4096),
            ("qwen3-moe", (MOE_BATCH, 32, 4, 128), 0),
            ("kimi-k2", (PREFIX_BATCH, 64, 8, 112), 0)):
        q, k, v = _attn_inputs(torch, g, B, H, Hkv, SERVE_PROMPT, D, bf16)
        got = fa.flash_attention(q, k, v, window)
        if not torch.equal(got, fa.flash_attention(q, k, v, window)):
            raise AssertionError(f"flash_attention not deterministic at "
                                 f"{name}'s prefill shape")
        err, use = _attn_check(torch, ref, got, q, k, v, window,
                               f"{name}'s prefill shape")
        ms = _median_ms(lambda: fa.flash_attention(q, k, v, window))
        plain = _median_ms(lambda: ref.attention_chunked(q, k, v,
                                                         window=window), 5)
        lib = _median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        bound, by = _attention_bound(q, k, window)
        flops = 4.0 * B * H * _attention_pairs(SERVE_PROMPT, window) * D
        print(f"[attn] flash_attention {name} prefill "
              f"{(B, H, Hkv, SERVE_PROMPT, D)} bf16 window "
              f"{window}: max_abs_err {err:.6g} against attention_ref "
              f"({use:.4f} of the limit), bit-equal on a second launch; "
              f"kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.4f} of the "
              f"bound) plain {plain:.4f} ms sdpa {lib:.4f} ms (kernel / sdpa "
              f"{ms / lib:.4f}) bound {bound:.6g} ms ({by})")
        times[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib)
        if record is None:
            record = times[name]
        del q, k, v, got
        torch.cuda.empty_cache()
    return record, times


def phase_dense_serve(torch, ops_mod):
    """A full-width, full-depth qwen3-8b replica (bf16, seeded random
    weights) served: prefill SERVE_BATCH x SERVE_PROMPT (36 B5 launches,
    full causal, qk-norm, D 128, G 4), DENSE_STEPS greedy decode steps,
    then a second, event-timed prefill whose first B5 application is held
    against the oracle. No migration: phase 5 covers pre-copy of an
    attention replica."""
    from repro_torch import tree
    from repro_torch.launch.serve import build_replica

    t0 = time.perf_counter()
    r = build_replica(DENSE_ARCH, SERVE_BATCH, SERVE_PROMPT, DENSE_STEPS,
                      smoke=False, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    logits, cache, t_prefill, peak, launches = _counted_prefill(
        torch, ops_mod, r.prefill, r.params, r.batch)
    if launches["flash_attention"] != ATTN_LAUNCHES[DENSE_ARCH]:
        raise AssertionError(f"{DENSE_ARCH} prefill launched {launches}, "
                             f"want {ATTN_LAUNCHES[DENSE_ARCH]} "
                             f"flash_attention")
    if logits.shape != (SERVE_BATCH, r.cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{DENSE_ARCH} prefill logits are not finite or "
                             f"misshapen")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DENSE_STEPS):
        tok, logits, cache = r.decode(r.params, tok, cache)
    torch.cuda.synchronize()
    t_tok = (time.perf_counter() - t0) / DENSE_STEPS
    if not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["pos"]) != SERVE_PROMPT + DENSE_STEPS:
        raise AssertionError(f"{DENSE_ARCH} decode logits are not finite")
    n = sum(t.numel() for t in tree.leaves(r.params))
    v_cache = sum(t.numel() * t.element_size() for t in tree.leaves(cache))
    del cache, logits
    torch.cuda.empty_cache()
    split = _timed_prefill(torch, ops_mod, r.prefill, r.params, r.batch,
                           "dense")
    print(f"[dense] {DENSE_ARCH} full width and depth, {n} params "
          f"({n * 2 / 1e9:.4f} GB bf16), init {t_init:.4f} s; prefill "
          f"{SERVE_BATCH} x {SERVE_PROMPT} in {t_prefill:.4f} s, peak "
          f"{peak:.4f} GB; KV cache {v_cache / 1e9:.4f} GB; decode "
          f"{1e3 * t_tok:.4f} ms per step of {SERVE_BATCH} tokens (mean of "
          f"{DENSE_STEPS}); launches {launches}")
    del r
    torch.cuda.empty_cache()
    return launches, {"params": n, "init_s": t_init, "prefill_s": t_prefill,
                      "prefill_peak_gb": peak, "kv_cache_gb": v_cache / 1e9,
                      "decode_ms_per_step": 1e3 * t_tok,
                      "prefill_split": split}


def phase_dense_cpu_check(torch):
    """qwen3-8b at full width, 2 layers deep, in f32: batch 1, a prompt of
    1,024 (on the CPU the chunked online softmax over two chunks of 512)
    and DENSE_STEPS greedy tokens on the card against the CPU. Logits
    within CPU_CHECK_RTOL of their peak, tokens equal."""
    from repro_torch.configs import get_config

    cfg = get_config(DENSE_ARCH).replace(num_layers=2, param_dtype="float32")
    (lg, tg), (lc, tc) = _card_and_cpu(torch, cfg, batch=1, prompt=1024,
                                       steps=DENSE_STEPS)
    err, size = float((lg - lc).abs().max()), float(lc.abs().max())
    if not torch.equal(tg, tc) or err > CPU_CHECK_RTOL * size:
        raise AssertionError(f"{DENSE_ARCH}: card and CPU differ: tokens "
                             f"equal {torch.equal(tg, tc)}, max abs err {err} "
                             f"on logits of size {size}")
    print(f"[dense] {DENSE_ARCH} full width, 2 layers, f32, prompt 1,024: "
          f"card and CPU logits max abs err {err:.6g} (size {size:.4f}), "
          f"{DENSE_STEPS + 1} greedy tokens equal")
    return err


# ---------------------------------------------------------------------------
# phase 8: training and its live migration
# ---------------------------------------------------------------------------
TRAIN_ARCH = "internlm2_1p8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_PCFG = dict(block_elems=1 << 14, max_rounds=4, stop_dirty_blocks=0,
                  steps_per_round=1)
# card against CPU, f32, one AdamW step (``_train_errors``): the grad norm
# within 1e-4 (relative) and each leaf of the first moment (0.1 x the
# clipped gradient) within 1e-3 of its largest magnitude are what a wrong
# forward kernel or backward fails; the loss, within CPU_CHECK_RTOL, is
# ~log V at initialisation and barely reads the kernels. The update of a
# first AdamW step is lr g / (|g| + eps) + lr wd p, a sign where |g| >>
# eps: where the CPU's first moment is larger than twice the moment limit
# (so the card's has its sign) and |g| >= 100 eps, each param's update
# must agree within 1e-2 lr plus two ulps of the param (the rounding of
# master - update). That holds the optimizer's arithmetic on the card; a
# flipped sign reads 2 lr, an update scaled by 0.9 reads 0.1 lr. Where the
# sign is not settled, the update may take either sign and is not held.
TRAIN_CHECK = dict(gnorm=1e-4, moment=1e-3, update=1e-2)
# what the memory reckoning leaves free for the plain recount of a round
TRAIN_MEM_MARGIN = 0.95


def _train_batch(torch, corpus, step: int, batch: int = 0):
    """``corpus.batch_at(step)`` as tensors on the card; with ``batch``
    only its first rows (a cut batch)."""
    import numpy as np
    out = {}
    for k, v in corpus.batch_at(step).items():
        v = np.ascontiguousarray(v[:batch] if batch else v)
        out[k] = torch.from_numpy(v).to("cuda")
    return out


def _train_split(torch, step_fn, state, batch):
    """One train step with CUDA events around every B5 forward launch, the
    plain backward of attention (the saved inputs already unpacked: a
    block's recompute falls in the rest), the optimizer and the telemetry's
    B3 scan. Returns (state, ms per part and the rest)."""
    from repro_torch import optim
    from repro_torch.kernels import vjp
    from repro_torch.train import steps
    pending = []

    def timed(key, fn):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            pending.append((key, a, b))
            return out
        return run

    attention, apply, stats = vjp.Attention, optim.apply_updates, \
        steps.dirty_block_stats

    class TimedAttention(attention):
        @staticmethod
        def forward(ctx, q, k, v, window, chunk, forward):
            return attention.forward(ctx, q, k, v, window, chunk,
                                     timed("b5_forward", forward))

        @staticmethod
        def backward(ctx, grad_out):
            saved = ctx.saved_tensors
            return timed("attention_backward_plain", attention.grads)(
                ctx, *saved, grad_out)

    vjp.Attention = TimedAttention
    optim.apply_updates = timed("optimizer", apply)
    steps.dirty_block_stats = timed("telemetry_b3", stats)
    try:
        state, metrics = timed("step", step_fn)(state, batch)
        torch.cuda.synchronize()
    finally:
        vjp.Attention, optim.apply_updates = attention, apply
        steps.dirty_block_stats = stats
    ms, counts = {}, {}
    for key, a, b in pending:
        ms[key] = ms.get(key, 0.0) + a.elapsed_time(b)
        counts[key] = counts.get(key, 0) + 1
    whole = ms.pop("step")
    ms["rest_of_forward_and_backward"] = whole - sum(ms.values())
    return state, whole, ms, counts


def _scan_checked(torch, ref, box):
    """``precopy.dirty_scan`` as the train-state pre-copy runs it, timed on
    the host clock and by CUDA events, then each leaf's dirty count held
    against B3's plain version on the same pair (outside both clocks)."""
    from repro_torch import tree
    from repro_torch.core import precopy
    scan = precopy.dirty_scan

    def run(live, shadow, block):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t = time.perf_counter()
        masks, n_dirty, n_bytes = scan(live, shadow, block)
        box["scan_host_ms"].append(1e3 * (time.perf_counter() - t))
        e1.record()
        torch.cuda.synchronize()
        box["scan_event_ms"].append(e0.elapsed_time(e1))
        got = [int(m.sum()) for m in masks]
        want = _plain_dirty_counts(torch, ref, live, shadow, block)
        if got != want:
            raise AssertionError(f"train-state scan: per-leaf dirty blocks "
                                 f"{got} against B3's plain version {want}")
        box["dirty_blocks"].append(n_dirty)
        box["leaves"] = len(tree.leaves(live))
        return masks, n_dirty, n_bytes

    return scan, run


def phase_train(torch, ops_mod, ref):
    """A full-width, full-depth internlm2-1.8b trainer (bf16 params, AdamW
    with f32 moments and master, block remat), batches of TRAIN_BATCH x
    TRAIN_SEQ from ``SyntheticCorpus``: one warm-up step, TRAIN_STEPS
    steps with telemetry (B5 in every attention layer's forward, twice a
    step under remat; B3 once for the dirty profile), one event-timed
    split step; then ``elastic.rescale`` pre-copies that training state on
    the card while it keeps training, one step a round, each scan held
    against B3's plain version, the destination bit-equal at handoff, and
    the destination trains on. Returns (launches of the counted steps,
    launches of the migration, numbers to keep)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import precopy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.runtime.elastic import rescale
    from repro_torch.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    n = cfg.param_count()
    V, tokens = cfg.vocab_size, TRAIN_BATCH * TRAIN_SEQ
    props = torch.cuda.get_device_properties(0)
    print(f"[train] {TRAIN_ARCH} full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads, kv "
          f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {V}), {cfg.param_dtype}, {cfg.optimizer}, remat "
          f"{cfg.remat}: {n} params; reckoned: params {2 * n / 1e9:.4f} GB,"
          f" f32 m, v and master {12 * n / 1e9:.4f} GB, state "
          f"{14 * n / 1e9:.4f} GB (a pre-copy holds two); logits "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} x {V}: {2 * tokens * V / 1e9:.4f} GB"
          f" bf16, {4 * tokens * V / 1e9:.4f} GB f32, plus their gradient; "
          f"card {props.total_memory / 1e9:.4f} GB")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    v_mem = precopy.total_bytes(state)
    corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    step_fn = make_train_step(cfg, telemetry=True)
    t0 = time.perf_counter()
    state, m = step_fn(state, _train_batch(torch, corpus, 0))  # warm-up
    torch.cuda.synchronize()
    print(f"[train] init {t_init:.4f} s, state {v_mem / 1e9:.4f} GB; "
          f"warm-up step {time.perf_counter() - t0:.4f} s, loss "
          f"{float(m['loss']):.6f}")

    steps, total_launches = [], {}
    for _ in range(TRAIN_STEPS):
        i = int(state["step"])
        batch = _train_batch(torch, corpus, i)
        ops_mod.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step_fn(state, batch)
        b.record()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        launches = ops_mod.launch_counts()
        for k, v in launches.items():
            total_launches[k] = total_launches.get(k, 0) + v
        row = {"step": i, "host_ms": 1e3 * host,
               "event_ms": a.elapsed_time(b), "tokens_per_s": tokens / host,
               **{k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                           "dirty_fraction", "dirty_bytes")},
               "b5_launches": launches["flash_attention"],
               "b3_launches": launches["dirty_blocks"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
        steps.append(row)
        print(f"[train] step {i}: host {row['host_ms']:.4f} ms, events "
              f"{row['event_ms']:.4f} ms, {row['tokens_per_s']:.1f} tokens/s,"
              f" loss {row['loss']:.6f}, grad norm {row['grad_norm']:.6f}, "
              f"lr {row['lr']:.6g}, dirty fraction "
              f"{row['dirty_fraction']:.6f}, dirty bytes "
              f"{row['dirty_bytes']:.0f}, B5 {row['b5_launches']}, B3 "
              f"{row['b3_launches']}, peak {row['peak_gb']:.4f} GB "
              f"(reserved {row['reserved_gb']:.4f} GB)")
        if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"train step {i}: loss {row['loss']}, grad "
                                 f"norm {row['grad_norm']}")
        want_b5 = 2 * cfg.num_layers if cfg.remat in ("block", "full") \
            else cfg.num_layers
        if launches["flash_attention"] != want_b5 or \
                launches["dirty_blocks"] != _scan_launches(
                    len(tree.leaves(state["params"]))):
            raise AssertionError(f"train step {i} launched {launches}, want "
                                 f"{want_b5} flash_attention and one "
                                 f"dirty_blocks")

    state, whole, split, counts = _train_split(
        torch, step_fn, state, _train_batch(torch, corpus,
                                            int(state["step"])))
    print(f"[train] event-timed split of step {int(state['step']) - 1}: "
          f"{whole:.4f} ms: " + ", ".join(
              f"{k}{' x' + str(counts[k]) if k in counts else ''} "
              f"{v:.4f} ms ({v / whole:.4f})" for k, v in split.items()))

    # -- the pre-copy of the training state while it trains -----------------
    peak = max(r["peak_gb"] for r in steps) * 1e9
    biggest = max(t.numel() for t in tree.leaves(state))
    need = 2 * v_mem + (peak - v_mem) + 3 * 4 * biggest
    limit = TRAIN_MEM_MARGIN * props.total_memory
    mig_batch = TRAIN_BATCH
    while mig_batch > 1 and 2 * v_mem + (peak - v_mem) * mig_batch \
            / TRAIN_BATCH + 12 * biggest > limit:
        mig_batch //= 2
    print(f"[train] pre-copy reckoning: state {v_mem / 1e9:.4f} GB twice, "
          f"step transient {(peak - v_mem) / 1e9:.4f} GB, plain recount "
          f"{12 * biggest / 1e9:.4f} GB: {need / 1e9:.4f} GB against "
          f"{limit / 1e9:.4f} GB; batch of the migration's steps "
          f"{mig_batch}" + ("" if mig_batch == TRAIN_BATCH
                            else f" (cut from {TRAIN_BATCH})"))
    live = {"state": state}
    del state
    # two copies of the state leave ~31 GB for a step's 16 GB of
    # transients: without the steps' cached segments, and with segments
    # that grow in place (ALLOC_CONF, set in main), the caching allocator
    # cannot strand that room in split blocks (it did, and ran out, with
    # neither)
    gc.collect()
    torch.cuda.empty_cache()

    def step_once(s):
        s, mm = step_fn(s, _train_batch(torch, corpus, int(s["step"]),
                                        mig_batch))
        if not math.isfinite(float(mm["loss"])):
            raise AssertionError("loss not finite during the migration")
        live["state"] = s
        return s

    box = {"scan_host_ms": [], "scan_event_ms": [], "dirty_blocks": []}
    scan, checked = _scan_checked(torch, ref, box)
    start = int(live["state"]["step"])
    ops_mod.reset_launch_counts()
    precopy.dirty_scan = checked
    try:
        t0 = time.perf_counter()
        dest, rep = rescale(cfg, live["state"], step_once, "cuda",
                            pcfg=precopy.PrecopyConfig(**TRAIN_PCFG))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        precopy.dirty_scan = scan
    mig_launches = ops_mod.launch_counts()
    out = rep.precopy.outcome
    src = live.pop("state")
    if not all(_same_bytes(torch, a, b) for a, b in
               zip(tree.leaves(dest), tree.leaves(src))):
        raise AssertionError("train-state destination differs from the "
                             "source at handoff")
    n_steps = int(src["step"]) - start
    n_float = sum(t.is_floating_point() for t in tree.leaves(src))
    want_b3 = _scan_launches(n_float) * len(box["scan_host_ms"]) + n_steps * \
        _scan_launches(len(tree.leaves(src["params"])))
    if n_steps != out.rounds or mig_launches["dirty_blocks"] != want_b3:
        raise AssertionError(f"train-state pre-copy: {n_steps} steps in "
                             f"{out.rounds} rounds, launches {mig_launches} "
                             f"(want {want_b3} dirty_blocks)")
    blocks = sum(-(-t.numel() // TRAIN_PCFG["block_elems"])
                 for t in tree.leaves(src))
    scan_bound, _ = _bound_ms(0.0, 2.0 * rep.precopy.v_mem + 4.0 * blocks)
    del src
    torch.cuda.empty_cache()
    print(f"[train] pre-copy of the training state ({rep.precopy.v_mem / 1e9:.4f}"
          f" GB, {box['leaves']} leaves) on the card while training: "
          f"{out.rounds} rounds, stop {out.stop_reason}, bytes sent / v_mem "
          f"{out.bytes_sent / rep.precopy.v_mem:.6f}, per-round bytes "
          f"{rep.precopy.per_round_dirty_bytes}, dirty blocks per scan "
          f"{box['dirty_blocks']} equal B3's plain version leaf by leaf; "
          f"destination bit-equal; wall {wall:.4f} s (with the plain "
          f"recounts); launches {mig_launches}")
    print(f"[train] scan ms, host clock "
          f"{[round(t, 4) for t in box['scan_host_ms']]}, CUDA events "
          f"{[round(t, 4) for t in box['scan_event_ms']]}, against a bound "
          f"of {scan_bound:.4f} ms (bytes)")
    dest, m = step_fn(dest, _train_batch(torch, corpus, int(dest["step"]),
                                         mig_batch))
    torch.cuda.synchronize()
    if int(dest["step"]) != start + n_steps + 1 or \
            not math.isfinite(float(m["loss"])):
        raise AssertionError(f"destination step {int(dest['step'])}, loss "
                             f"{float(m['loss'])}")
    print(f"[train] the destination trains on: step {int(dest['step'])}, "
          f"loss {float(m['loss']):.6f}")
    del dest, m, live
    torch.cuda.empty_cache()
    return total_launches, mig_launches, {
        "params": n, "state_gb": v_mem / 1e9, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": steps, "split_ms": split,
        "split_step_ms": whole, "migration_batch": mig_batch,
        "rounds": out.rounds, "stop_reason": out.stop_reason,
        "bytes_sent_over_v_mem": out.bytes_sent / rep.precopy.v_mem,
        "scan_host_ms": box["scan_host_ms"],
        "scan_event_ms": box["scan_event_ms"], "scan_bound_ms": scan_bound,
        "migrate_wall_s": wall}


def _train_card_and_cpu(torch, cfg, batch: int = 2, seq: int = 128):
    """One AdamW step of ``cfg`` on the card and on the CPU from the same
    seeded state and batch. Returns per device (metrics, new state on the
    host)."""
    from repro_torch import tree
    from repro_torch.data import make_batch
    from repro_torch.train import init_train_state, make_train_step

    s_card = init_train_state(cfg, SEED, device="cuda")
    runs = {}
    for dev, state in (("cuda", s_card),
                       ("cpu", tree.map(lambda t: t.to("cpu", copy=True),
                                        s_card))):
        b = make_batch(cfg, batch, seq, device=dev)
        state, m = make_train_step(cfg)(state, b)
        runs[dev] = ({k: float(v) for k, v in m.items()},
                     tree.map(lambda t: t.to("cpu", copy=True), state))
        del state
    return runs["cuda"], runs["cpu"]


def _train_errors(torch, got, want):
    """One AdamW step's (metrics, state on the host) ``got`` held against
    ``want`` (the CPU's) within TRAIN_CHECK: returns (errors, ok). The
    update error is in units of lr, over the elements whose first moment
    settles the update's sign (``share`` of the elements)."""
    from repro_torch import tree
    (mg, sg), (mc, sc) = got, want
    lr, ulp = mc["lr"], torch.finfo(torch.float32).eps
    e_loss = abs(mg["loss"] - mc["loss"])
    e_gn = abs(mg["grad_norm"] - mc["grad_norm"])
    e_m = e_p = 0.0
    held = total = 0
    for m_g, m_c, p_g, p_c in zip(
            tree.leaves(sg["opt"]["m"]), tree.leaves(sc["opt"]["m"]),
            tree.leaves(sg["params"]), tree.leaves(sc["params"])):
        peak = max(float(m_c.abs().max()), 1e-30)
        e_m = max(e_m, float((m_g - m_c).abs().max()) / peak)
        # m = 0.1 g after one step: |g| >= 100 eps (AdamW's 1e-8) is
        # |m| >= 1e-7
        settled = m_c.abs() > max(2 * TRAIN_CHECK["moment"] * peak, 1e-7)
        slack = 2 * ulp * p_c.float().abs()
        over = ((p_g.float() - p_c.float()).abs() - slack).clamp_min(0)
        if bool(settled.any()):
            e_p = max(e_p, float(over[settled].max()) / lr)
        held += int(settled.sum())
        total += m_c.numel()
    errs = {"loss": e_loss, "grad_norm": e_gn, "moment": e_m,
            "update_lr": e_p, "share": held / max(total, 1)}
    ok = (e_loss <= CPU_CHECK_RTOL * abs(mc["loss"])
          and e_gn <= TRAIN_CHECK["gnorm"] * mc["grad_norm"]
          and e_m <= TRAIN_CHECK["moment"]
          and e_p <= TRAIN_CHECK["update"] and held > 0
          and int(sg["step"]) == int(sc["step"]) == 1)
    return errs, ok


def phase_train_cpu_check(torch, ops_mod):
    """Full width, shallow, f32, one AdamW step on the card and on the CPU:
    internlm2 2 layers, a zamba2 group (5 Mamba2 layers and the shared
    attention block) and one rwkv6 layer. Holds B5 (f32) and B4 (SSD and
    RWKV) under grad, the plain backward and the optimizer against the CPU
    path within TRAIN_CHECK (``_train_errors``). Returns (launches on the
    card, errors)."""
    from repro_torch.configs import get_config

    errs, launches = {}, {}
    for arch, layers in ((TRAIN_ARCH, 2), (SSM_ARCH, 6), (RWKV_ARCH, 1)):
        cfg = get_config(arch).replace(num_layers=layers,
                                       param_dtype="float32")
        ops_mod.reset_launch_counts()
        got, want = _train_card_and_cpu(torch, cfg)
        launches[arch] = ops_mod.launch_counts()
        e, ok = _train_errors(torch, got, want)
        (mg, _), (mc, _) = got, want
        print(f"[train] {arch} full width, {layers} layers, f32, one AdamW "
              f"step, card against CPU: loss {mg['loss']:.6f} err "
              f"{e['loss']:.6g} (limit {CPU_CHECK_RTOL} x loss), grad norm "
              f"{mg['grad_norm']:.6f} err {e['grad_norm']:.6g} (limit "
              f"{TRAIN_CHECK['gnorm']} x norm), first moment err "
              f"{e['moment']:.6g} of its leaf's peak (limit "
              f"{TRAIN_CHECK['moment']}), update err {e['update_lr']:.6g} lr"
              f" beyond 2 ulps (limit {TRAIN_CHECK['update']} lr, lr "
              f"{mc['lr']:.6g}) on the {e['share']:.4f} of the params whose"
              f" first moment settles its sign; launches {launches[arch]}")
        if not ok:
            raise AssertionError(f"{arch}: the train step on the card and on "
                                 f"the CPU differ beyond the limits")
        errs[arch] = e
        del got, want
        torch.cuda.empty_cache()
    for arch, op in ((TRAIN_ARCH, "flash_attention"), (SSM_ARCH, "ssm_scan"),
                     (SSM_ARCH, "flash_attention"), (RWKV_ARCH, "ssm_scan")):
        if launches[arch][op] < 1:
            raise AssertionError(f"{arch}'s train step launched no {op}")
    return launches, errs


def phase_train_runtime(torch, ops_mod):
    """The trainer at smoke scale on the card (checkpoint every 5 steps, a
    failure injected at step 7, restore and replay to step 12, against an
    uninterrupted run's final loss bit for bit), and an incremental
    checkpointer (a full save, then deltas after each of 4 steps) whose
    every restore is bit-exact, its B3 launches counted."""
    import tempfile

    from repro_torch import tree
    from repro_torch.checkpoint import IncrementalCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH).smoke().replace(num_layers=2)
    failed = {"done": False}

    def failure_hook(step):
        if step == 7 and not failed["done"]:
            failed["done"] = True
            return True
        return False

    with tempfile.TemporaryDirectory() as d:
        ops_mod.reset_launch_counts()
        runs = {}
        for name, hook in (("restored", failure_hook), ("uninterrupted", None)):
            tr = Trainer(cfg, TrainerConfig(ckpt_dir=f"{d}/{name}",
                                            ckpt_every=5),
                         batch=2, seq=128, failure_hook=hook, device="cuda")
            runs[name] = tr.run(12)
        trainer_launches = ops_mod.launch_counts()
        a, b = runs["restored"], runs["uninterrupted"]
        if (a["restarts"], a["final_step"], b["restarts"]) != (1, 12, 0) or \
                a["loss"] != b["loss"] or not math.isfinite(a["loss"]):
            raise AssertionError(f"trainer restore: restarts {a['restarts']}"
                                 f", final step {a['final_step']}, loss "
                                 f"{a['loss']!r} against {b['loss']!r}")
        print(f"[train] trainer at smoke scale on the card: failure at step "
              f"7, restored from step 5, final step 12, loss {a['loss']!r} "
              f"equal to the uninterrupted run's; step ms "
              f"{[round(1e3 * h['step_time'], 4) for h in b['history']]}; "
              f"launches {trainer_launches}")

        state = init_train_state(cfg, SEED, device="cuda")
        step_fn = make_train_step(cfg)
        inc = IncrementalCheckpointer(f"{d}/inc", block_elems=1 << 12,
                                      full_every=10)
        kept, stats = [], []
        ops_mod.reset_launch_counts()
        for i in range(5):
            if i:
                state, _ = step_fn(state, make_batch(cfg, 2, 128, step=i,
                                                     device="cuda"))
            stats.append(inc.save(i, state))
            kept.append(tree.map(lambda t: t.to("cpu", copy=True), state))
        inc_launches = ops_mod.launch_counts()
        like = init_train_state(cfg, SEED, device="meta")
        for i, want in enumerate(kept):
            got = inc.restore(i, like, device="cuda")
            if not all(_same_bytes(torch, x.cpu(), y) for x, y in
                       zip(tree.leaves(got), tree.leaves(want))):
                raise AssertionError(f"incremental restore of step {i} is "
                                     f"not bit-exact")
        n_float = sum(t.is_floating_point() for t in tree.leaves(state))
        if inc_launches["dirty_blocks"] != 4 * _scan_launches(n_float):
            raise AssertionError(f"incremental saves launched "
                                 f"{inc_launches}")
        print(f"[train] incremental checkpoints on the card: "
              f"{[s['kind'] for s in stats]}, bytes "
              f"{[s['bytes'] for s in stats]}, every restore bit-exact; "
              f"launches {inc_launches}")
    return trainer_launches, inc_launches


# ---------------------------------------------------------------------------
# phase 9: MoE serving: qwen3-moe at full width and depth, kimi-k2's
# prefix-dense wiring at full width
# ---------------------------------------------------------------------------
MOE_ARCH, PREFIX_ARCH = "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"
# 61.06 GB of bf16 weights leave room for 8 x 4,096 prompt tokens (KV
# 3.22 GB, ~4 GB of dispatch transients in a layer), not 16 x 4,096
MOE_BATCH, MOE_STEPS = 8, 8
# kimi-k2 at full width: its dense layer and one MoE layer of 384 experts
# (39.87 GB in bf16); three layers would take 74.0 GB. Its attention is the
# reference's GQA (64 heads, 8 KV heads, D = 112) in place of Kimi-K2's MLA
PREFIX_LAYERS, PREFIX_BATCH, PREFIX_STEPS = 2, 4, 4
ATTN_LAUNCHES.update({MOE_ARCH: 48, PREFIX_ARCH: PREFIX_LAYERS})
# card against CPU in f32: a token whose top-k margin (its K-th router
# probability less its (K+1)-th) exceeds ROUTE_MARGIN must get the same
# experts on both; the f32 router products differ by ulps, ~1e-9 in
# probability. Tokens at or below it are near ties, counted; at most
# ROUTE_TIES_MAX of a call's tokens may be, and outputs are held where
# the routing agrees.
ROUTE_MARGIN = 1e-5
ROUTE_TIES_MAX = 0.05


def _moe_parts(blocks):
    """What the event-timed MoE prefill times besides layers and B5."""
    return ((blocks, "multihead_attention", "attention"),
            (blocks, "_route", "moe_route"),
            (blocks, "_fill_buffer", "moe_dispatch"),
            (blocks, "_expert_swiglu", "moe_expert_products"),
            (blocks, "_combine", "moe_combine"))


def _moe_timed_prefill(torch, ops_mod, prefill, params, batch, cfg):
    """``_timed_prefill`` with the MoE parts, counting each MoE layer's
    (token, k) pairs dropped for capacity (a sum over the slots inside the
    combine's events). Returns (split, drops per MoE layer)."""
    from repro_torch.models import blocks
    drops, combine = [], blocks._combine

    def counted(y, slot, gate, T):
        drops.append((slot >= y.shape[0] * y.shape[1]).sum())
        return combine(y, slot, gate, T)

    blocks._combine = counted
    try:
        split = _timed_prefill(torch, ops_mod, prefill, params, batch, "moe",
                               parts=_moe_parts(blocks))
    finally:
        blocks._combine = combine
    drops = [int(d) for d in drops]
    if len(drops) != cfg.num_layers - cfg.first_k_dense:
        raise AssertionError(f"{cfg.name}: {len(drops)} MoE layers ran")
    return split, drops


BALANCE_DIRECTIONS = 16


def _balance_routers(torch, prefill, params, batch):
    """Seeded random weights send most of a layer's tokens to the same few
    experts: the router inputs share a few large directions (their mean
    over the tokens first), so every token's logits share their bias. Take
    from each MoE layer's router the BALANCE_DIRECTIONS directions of its
    input's largest second moment over the prefill (W -= U U^T W), in
    place; a second prefill refits them to the inputs the first changed.
    Returns the routers as they were."""
    from repro_torch.models import blocks
    router = params["blocks"]["moe"]["router"]          # (L, d, E) f32
    saved, route, spans = router.clone(), blocks._route, []

    def recording(p, m, xt):
        xf = xt.float()
        _, vecs = torch.linalg.eigh(xf.T @ xf)          # ascending
        spans.append(vecs[:, -BALANCE_DIRECTIONS:])
        return route(p, m, xt)

    for _ in range(2):
        spans.clear()
        blocks._route = recording
        try:
            prefill(params, batch)
        finally:
            blocks._route = route
        if len(spans) != router.shape[0]:
            raise AssertionError(f"{len(spans)} routers ran, want "
                                 f"{router.shape[0]}")
        for w, u in zip(router, spans):
            w -= u @ (u.T @ w)
    return saved


def _serve_moe(torch, ops_mod, arch, cfg, params, batch, steps,
               balanced=False):
    """Counted prefill (B5 once per layer), ``steps`` greedy decode steps,
    one more decode step and a second prefill, each event-timed by part,
    the prefill with each MoE layer's drops; with ``balanced``, the timed
    prefill once more at a routing within capacity (``_balance_routers``;
    the routers are restored after)."""
    from repro_torch import tree
    from repro_torch.models import blocks
    from repro_torch.train import make_decode_step, make_prefill_step

    B, S = batch["tokens"].shape
    C = blocks.moe_capacity(cfg.moe, B * S)
    prefill = make_prefill_step(cfg, S + steps)
    decode = make_decode_step(cfg)
    logits, cache, t_prefill, peak, launches = _counted_prefill(
        torch, ops_mod, prefill, params, batch)
    if launches["flash_attention"] != ATTN_LAUNCHES[arch]:
        raise AssertionError(f"{arch} prefill launched {launches}, want "
                             f"{ATTN_LAUNCHES[arch]} flash_attention")
    if logits.shape != (B, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{arch} prefill logits are not finite or "
                             f"misshapen")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, logits, cache = decode(params, tok, cache)
    torch.cuda.synchronize()
    t_tok = (time.perf_counter() - t0) / steps
    if not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["pos"]) != S + steps:
        raise AssertionError(f"{arch} decode logits are not finite")
    v_cache = sum(t.numel() * t.element_size() for t in tree.leaves(cache))
    decode_split = _timed_prefill(
        torch, ops_mod, lambda p, t: decode(p, t, cache), params, tok, "moe",
        parts=_moe_parts(blocks), what="decode step")
    del cache, logits
    torch.cuda.empty_cache()
    split, drops = _moe_timed_prefill(torch, ops_mod, prefill, params, batch,
                                      cfg)
    n = sum(t.numel() for t in tree.leaves(params))
    pairs = B * S * cfg.moe.top_k
    print(f"[moe] {arch}: {n} params ({n * 2 / 1e9:.4f} GB bf16), "
          f"{cfg.num_layers} layers; prefill {B} x {S} in {t_prefill:.4f} s, "
          f"peak {peak:.4f} GB; KV cache {v_cache / 1e9:.4f} GB; decode "
          f"{1e3 * t_tok:.4f} ms per step of {B} tokens (mean of {steps}); "
          f"launches {launches}")
    print(f"[moe] {arch}: (token, k) pairs dropped for capacity ({C} slots "
          f"per expert) per MoE layer, of {pairs}: {drops}")
    rec = {"params": n, "layers": cfg.num_layers, "capacity": C,
           "prefill_s": t_prefill, "prefill_peak_gb": peak,
           "kv_cache_gb": v_cache / 1e9, "decode_ms_per_step": 1e3 * t_tok,
           "dropped_pairs_per_layer": drops, "pairs_per_layer": pairs,
           "prefill_split": split, "decode_split": decode_split}
    if balanced:
        saved = _balance_routers(torch, prefill, params, batch)
        try:
            print(f"[moe] {arch}: the timed prefill again, each router "
                  f"without its input's {BALANCE_DIRECTIONS} largest "
                  f"directions")
            rec["balanced_prefill_split"], drops = _moe_timed_prefill(
                torch, ops_mod, prefill, params, batch, cfg)
        finally:
            params["blocks"]["moe"]["router"].copy_(saved)
        share = sum(drops) / (pairs * len(drops))
        print(f"[moe] {arch}: balanced routing: pairs dropped per MoE layer, "
              f"of {pairs}: {drops} (share {share:.4f})")
        rec["balanced_dropped_pairs_per_layer"] = drops
    return launches, rec


def _moe_layer_relaunch(torch, cfg, params):
    """The first MoE layer of ``params`` twice on one seeded input at the
    prefill's token count: outputs and aux bit-equal."""
    from repro_torch.models import blocks, lm
    lp = lm._unstack(params["blocks"],
                     cfg.num_layers - cfg.first_k_dense)[0]["moe"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(MOE_BATCH, SERVE_PROMPT, cfg.d_model, device="cuda",
                    generator=g).to(cfg.dtype)
    out, aux = blocks.moe_ffn(lp, cfg, x)
    again, aux2 = blocks.moe_ffn(lp, cfg, x)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(aux, aux2)):
        raise AssertionError(f"{cfg.name}: a MoE layer relaunched on the "
                             f"same input differs")
    print(f"[moe] {cfg.name}: one MoE layer on {tuple(x.shape)} "
          f"{str(x.dtype)[6:]} relaunched: output and aux bit-equal")


def phase_moe_serve(torch, ops_mod):
    """``qwen3_moe_30b_a3b`` at full width and depth in bf16 (seeded random
    weights, 61.06 GB) prefills MOE_BATCH x SERVE_PROMPT (48 B5
    launches), decodes MOE_STEPS steps (every expert's products over its C
    = 8 slots each step, as the reference runs them) and prefills again
    with CUDA events around attention, B5, routing, dispatch, the expert
    products and the combine, counting each layer's capacity drops, then
    once more at a routing within capacity (``_balance_routers``); one
    MoE layer is relaunched bit-equal. Then ``kimi_k2_1t_a32b`` at full
    width, PREFIX_LAYERS deep (the dense layer, one MoE layer of 384
    experts and a shared expert), prefills PREFIX_BATCH x SERVE_PROMPT
    (B5 at D = 112) and decodes PREFIX_STEPS steps. Returns (launches of
    the two counted prefills, numbers to keep)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.serve import build_replica
    from repro_torch.models import lm

    out, launches = {}, []
    t0 = time.perf_counter()
    r = build_replica(MOE_ARCH, MOE_BATCH, SERVE_PROMPT, MOE_STEPS,
                      smoke=False, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    counts, rec = _serve_moe(torch, ops_mod, MOE_ARCH, r.cfg, r.params,
                             r.batch, MOE_STEPS, balanced=True)
    launches.append(counts)
    rec["init_s"] = t_init
    print(f"[moe] {MOE_ARCH}: init {t_init:.4f} s")
    _moe_layer_relaunch(torch, r.cfg, r.params)
    out[MOE_ARCH] = rec
    del r
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(PREFIX_ARCH).replace(num_layers=PREFIX_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    batch = make_batch(cfg, PREFIX_BATCH, SERVE_PROMPT, device="cuda")
    batch.pop("targets")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    counts, rec = _serve_moe(torch, ops_mod, PREFIX_ARCH, cfg, params, batch,
                             PREFIX_STEPS)
    launches.append(counts)
    rec["init_s"] = t_init
    print(f"[moe] {PREFIX_ARCH} ({PREFIX_LAYERS} of 61 layers): init "
          f"{t_init:.4f} s")
    out[PREFIX_ARCH] = rec
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def _judge_routing(torch, cfg, lp_card, lp_cpu, x, out, stats, what: str):
    """One MoE call of the card's run (input ``x`` on the card, its output
    ``out``) against the same layer on the CPU on the same input, in f32.
    Raises when a token whose top-k margin exceeds ROUTE_MARGIN gets other
    experts, when a drop differs in an expert no such near-tie moved, when
    over ROUTE_TIES_MAX of the tokens are near ties, or when an output
    where the routing agrees lies beyond CPU_CHECK_RTOL of the peak."""
    from repro_torch.models import blocks
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    B, S, d = x.shape
    T = B * S
    C = blocks.moe_capacity(m, T)
    xt = x.reshape(T, d)
    _, exp_card, _, _ = blocks._route(lp_card, m, xt)
    _, slot_card = blocks._fill_buffer(xt, exp_card, E, C)
    xh = xt.cpu()
    _, exp_cpu, _, _ = blocks._route(lp_cpu, m, xh)
    _, slot_cpu = blocks._fill_buffer(xh, exp_cpu, E, C)
    probs = torch.softmax(xh.float() @ lp_cpu["router"], dim=-1)
    top = torch.topk(probs, K + 1, dim=-1).values
    tie = (top[:, K - 1] - top[:, K]) <= ROUTE_MARGIN
    exp_card = exp_card.cpu()
    oc, oh = exp_card.argsort(1), exp_cpu.argsort(1)
    set_card, set_cpu = exp_card.gather(1, oc), exp_cpu.gather(1, oh)
    same = (set_card == set_cpu).all(1)
    if bool((~same & ~tie).any()):
        bad = int((~same & ~tie).sum())
        raise AssertionError(f"{what}: {bad} tokens with a top-k margin over "
                             f"{ROUTE_MARGIN} got other experts on the card")
    if float(tie.float().mean()) > ROUTE_TIES_MAX:
        raise AssertionError(f"{what}: {int(tie.sum())} of {T} tokens are "
                             f"near ties")
    kept_card = (slot_card.cpu() < E * C).reshape(T, K).gather(1, oc)
    kept_cpu = (slot_cpu < E * C).reshape(T, K).gather(1, oh)
    moved = torch.zeros(E, dtype=torch.bool)
    moved[set_card[~same].reshape(-1)] = True
    moved[set_cpu[~same].reshape(-1)] = True
    kept_diff = same[:, None] & (kept_card != kept_cpu)
    if bool((kept_diff & ~moved[set_cpu]).any()):
        raise AssertionError(f"{what}: a drop differs in an expert that no "
                             f"near tie moved")
    agree = same & ~kept_diff.any(1)
    want, _ = blocks.moe_ffn(lp_cpu, cfg, x.cpu())
    want, got = want.reshape(T, d)[agree], out.reshape(T, d).cpu()[agree]
    err, size = float((got - want).abs().max()), float(want.abs().max())
    if err > CPU_CHECK_RTOL * size or int(agree.sum()) < T // 2:
        raise AssertionError(f"{what}: outputs where the routing agrees "
                             f"({int(agree.sum())} of {T} tokens): max abs "
                             f"err {err} on a peak of {size}")
    stats["tokens"] += T
    stats["near_ties"] += int(tie.sum())
    stats["other_experts"] += int((~same).sum())
    stats["compared"] += int(agree.sum())
    stats["dropped_pairs"] += int((slot_cpu >= E * C).sum())
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    stats["peak"] = max(stats["peak"], size)


def _moe_card_and_cpu(torch, cfg, batch: int, prompt: int, steps: int,
                      name: str):
    """``cfg`` (f32) prefilled and decoded ``steps`` greedy tokens on the
    card; every MoE call's input captured and its routing, drops and
    output judged against the CPU on that input (``_judge_routing``);
    then the whole run on the CPU, fed the card's tokens, its logits
    within CPU_CHECK_RTOL of their peak when no token took other experts.
    Returns the counts and errors."""
    from repro_torch import tree
    from repro_torch.data import make_batch
    from repro_torch.models import blocks, lm
    from repro_torch.train import make_decode_step, make_prefill_step

    p_card = lm.init_params(cfg, SEED, device="cuda")
    calls, moe_ffn = [], blocks.moe_ffn

    def capture(params, cfg_, x):
        out, aux = moe_ffn(params, cfg_, x)
        calls.append((x, out))
        return out, aux

    runs = {}
    for where, params in (("card", p_card),
                          ("cpu", tree.map(lambda t: t.cpu(), p_card))):
        dev = tree.leaves(params)[0].device
        b = make_batch(cfg, batch, prompt, device=dev)
        b.pop("targets")
        blocks.moe_ffn = capture if where == "card" else moe_ffn
        try:
            logits, cache = make_prefill_step(cfg, prompt + steps)(params, b)
            decode = make_decode_step(cfg)
            rows = [logits.cpu()]
            for i in range(steps):       # the CPU is fed the card's tokens
                tok = (logits.argmax(-1)[:, None].to(torch.int32)
                       if where == "card" else runs["card"][1][i].to(dev))
                _, logits, cache = decode(params, tok, cache)
                rows.append(logits.cpu())
        finally:
            blocks.moe_ffn = moe_ffn
        toks = [r.argmax(-1)[:, None].to(torch.int32) for r in rows[:-1]]
        runs[where] = (torch.stack(rows), toks, params)
    n_moe = cfg.num_layers - cfg.first_k_dense
    layers = {where: lm._unstack(runs[where][2]["blocks"], n_moe)
              for where in runs}
    stats = dict(calls=len(calls), tokens=0, near_ties=0, other_experts=0,
                 compared=0, dropped_pairs=0, max_abs_err=0.0, peak=0.0)
    for i, (x, out) in enumerate(calls):
        _judge_routing(torch, cfg, layers["card"][i % n_moe]["moe"],
                       layers["cpu"][i % n_moe]["moe"], x, out, stats,
                       f"{name} MoE call {i}")
    lg, lc = runs["card"][0], runs["cpu"][0]
    err, size = float((lg - lc).abs().max()), float(lc.abs().max())
    stats.update(logits_max_abs_err=err, logits_peak=size)
    if stats["other_experts"] == 0 and err > CPU_CHECK_RTOL * size:
        raise AssertionError(f"{name}: card and CPU logits differ by {err} "
                             f"on a peak of {size} with the same routing")
    held = ("held" if stats["other_experts"] == 0 else
            "not held: near ties took other experts")
    print(f"[moe] {name} f32, {batch} x {prompt} and {steps} decode steps, "
          f"card against CPU: {stats['calls']} MoE calls, "
          f"{stats['tokens']} tokens, {stats['near_ties']} near ties "
          f"(margin <= {ROUTE_MARGIN}), {stats['other_experts']} took other "
          f"experts, {stats['dropped_pairs']} pairs dropped; outputs of "
          f"{stats['compared']} tokens max abs err "
          f"{stats['max_abs_err']:.6g} (peak {stats['peak']:.4f}); logits "
          f"max abs err {err:.6g} (peak {size:.4f}, {held})")
    return stats


def phase_moe_cpu_check(torch):
    """Card against CPU in f32: ``qwen3_moe_30b_a3b`` at full width, 2
    layers (~1.87e9 params), 2 x 128 tokens and 2 decode steps; then
    ``kimi_k2_1t_a32b``'s smoke config (its dense layer and one MoE layer
    with a shared expert)."""
    from repro_torch.configs import get_config
    out = {}
    cfg = get_config(MOE_ARCH).replace(num_layers=2, param_dtype="float32")
    out[MOE_ARCH] = _moe_card_and_cpu(torch, cfg, 2, 128, 2,
                                      f"{MOE_ARCH} full width, 2 layers")
    torch.cuda.empty_cache()
    cfg = get_config(PREFIX_ARCH).smoke().replace(param_dtype="float32")
    out[PREFIX_ARCH] = _moe_card_and_cpu(torch, cfg, 2, 128, 4,
                                         f"{PREFIX_ARCH} smoke config")
    return out


def main() -> int:
    # phase 8's pre-copy holds the 26.5 GB training state twice beside a
    # step's transients, which fits the card only in segments that grow in
    # place (``runtime/elastic.rescale``); set before torch starts CUDA
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
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
    from repro_torch.kernels import flash_attention, ssm_scan
    from repro_torch.models import gla

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}, PYTORCH_CUDA_ALLOC_CONF "
          f"{os.environ['PYTORCH_CUDA_ALLOC_CONF']}")
    secs = build.build_all(verbose=True)
    print(f"[build] {secs:.4f} s")
    records = phase_kernels(torch, ops, ref, dft, autocorr)
    records["ssm_scan"] = phase_ssm_kernel(torch, ref, gla, ssm_scan)
    records["flash_attention"], attn_times = phase_attention_kernel(
        torch, ref, flash_attention)
    tick_launches, tick_times, tick_b2 = phase_tick(torch, np, ops)
    # phase 2's B2 check at each shape the tick sent (captured in phase 3)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    seen = set()
    for J, N, lags in tick_b2:
        key = (J, N, lags.numel(), int(lags[0]), int(lags[-1]))
        if key not in seen:
            seen.add(key)
            _autocorr_case(torch, ref, autocorr, g, J, N, lags,
                           back_to_back=True)
    fleet_launches, controller_launches = phase_fleet(torch, ops)
    records["dirty_delta"] = phase_dirty_delta(torch, ref, dirty_delta)
    phase_placement(torch)
    serve_prefill, serve_launches, serve_times = phase_serve(
        torch, ops, ref, dirty_delta)
    serve_times["card_vs_cpu_max_abs_err"] = phase_serve_cpu_check(torch)
    ssm_prefill, ssm_migrate, ssm_times = phase_ssm_serve(torch, ops, ref)
    rwkv_launches, ssm_times["rwkv6"] = phase_rwkv_serve(torch, ops)
    ssm_times["card_vs_cpu_max_abs_err"] = phase_ssm_cpu_check(torch)
    dense_launches, dense_times = phase_dense_serve(torch, ops)
    dense_times["card_vs_cpu_max_abs_err"] = phase_dense_cpu_check(torch)
    gc.collect()                       # every replica freed before training
    torch.cuda.empty_cache()
    train_launches, train_mig_launches, train_times = phase_train(
        torch, ops, ref)
    check_launches, train_times["card_vs_cpu"] = phase_train_cpu_check(
        torch, ops)
    trainer_launches, inc_launches = phase_train_runtime(torch, ops)
    gc.collect()                       # the trainers freed before phase 9
    torch.cuda.empty_cache()
    moe_launches, moe_times = phase_moe_serve(torch, ops)
    moe_times["card_vs_cpu"] = phase_moe_cpu_check(torch)

    sources = {"dft_power": ("src/repro_torch/kernels/csrc/dft_power.cu",
                             "src/repro/kernels/dft.py:141",
                             "power_spectrum"),
               "autocorr": ("src/repro_torch/kernels/csrc/autocorr.cu",
                            "src/repro/kernels/autocorr.py:65",
                            "autocorr_score"),
               "dirty_delta": ("src/repro_torch/kernels/csrc/dirty_delta.cu",
                               "src/repro/kernels/dirty_delta.py:56",
                               "dirty_blocks"),
               "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:90", "ssm_scan"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:82",
                   "flash_attention")}
    paths = (tick_launches, fleet_launches, controller_launches,
             serve_prefill, serve_launches,
             ssm_prefill, ssm_migrate, rwkv_launches, dense_launches,
             train_launches, train_mig_launches, *check_launches.values(),
             trainer_launches, inc_launches, *moe_launches)
    kernels = []
    for name, (src, replaces, op) in sources.items():
        launches = sum(path[op] for path in paths)
        if launches < 1:
            raise AssertionError(f"{name} never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, **records[name]))
    print("[attn] " + json.dumps(attn_times))
    print("[tick] " + json.dumps(tick_times))
    print("[serve] " + json.dumps(serve_times))
    print("[ssm] " + json.dumps(ssm_times))
    print("[dense] " + json.dumps(dense_times))
    print("[train] " + json.dumps(train_times))
    print("[moe] " + json.dumps(moe_times))
    print(_card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
