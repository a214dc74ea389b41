"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's paths, the paper's ALMA decide loop at the fleet size
its users run (also under the adaptive concurrency controller, in a
host-failure scenario and row-sharded over four ranks sharing the
card), live pre-copy of a full-width serving replica (attention and
SSM-hybrid), serving of an RWKV model, of a full-width qwen3-8b and of
the MoE models (qwen3-moe-30b-a3b at full width and depth, also through
the expert-parallel path, kimi-k2's prefix-dense wiring at full width),
training of a full-width internlm2-1.8b and the live pre-copy of its
training state, the model on a (data, model) mesh of ranks (dense, SSM
and hybrid, and attention whose heads the model axis does not divide),
the dry run of the production meshes and the examples, and
holds every hand-written kernel against its plain PyTorch version:

  1. build   — compile ``csrc/dft_power.cu``, ``csrc/autocorr.cu``,
               ``csrc/dirty_delta.cu``, ``csrc/ssm_scan.cu``,
               ``csrc/flash_attention.cu`` and ``csrc/decode_attention.cu``
               with nvcc (one process each, in parallel);
  2. kernels — each kernel against its plain version at the tick's shape,
               at FleetSim's Table 3 windows (1,440 and 2,880 samples,
               with the lag grids its refinement scores there) and at
               the window bounds 600 and 4,096, the spectrum also at N
               of 2, 3, 16,384 (its FFT route's every radix) and 7 and
               1,031 (its direct route), and against itself (a second
               launch must be bit-equal), with times of kernel, plain
               version and the PyTorch library call (``torch.fft.rfft``
               for the spectrum) beside the least time of the call
               (``_bound``: the benchmark's count of it, from
               ``portbench/counts/kernels.py``); the lag scores also at
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
               step runs per round (after one untimed scan of the state
               against itself), each scan timed by its span and with
               CUDA events (held to its bound), the destination checked bit
               for bit and each round's dirty blocks against the ring slots
               the decode wrote; then the same model, 2 layers deep in f32,
               on the card against the CPU;
  6. ssm     — first (before any replica is built) the chunked SSM-scan
               kernel against its plain version at zamba2's and rwkv6's
               prefill shapes and on the edges (S of 1, 33 and 4,095, a
               decay below the clamp, an initial state, f32 inputs, the
               smoke widths, q/k shared by an odd number of heads,
               zamba2's layout in f32, odd widths, a d stride of 2, a
               per-token decay with q/k per head), the edges against
               the step recurrence too, each bit-equal on a second
               launch; its bound is the benchmark's count of the call
               (``_bound``); after phase 5, a full-width, full-depth
               ``zamba2_2p7b`` replica (bf16) prefills 16 x 4,096
               tokens (45 B4 and 9 B5 launches) and
               pre-copies with one decode step per round, each round's
               pair of trees also scanned by the dirty-block kernel's plain
               version (every SSD- and conv-state block dirty, the ring
               slots written, totals equal); ``rwkv6_1p6b`` at full width
               and depth prefills and decodes; each model prefills once
               more with CUDA events around its layers, B4 and B5 (where
               its time goes); both models shallow in f32 on the card
               against the CPU; then ``zamba2-7b`` at its published widths
               (the benchmark's configuration file, bf16) as its benchmark
               cell serves it: 16 x 4,080 tokens prefilled in passes of 8
               (162 B4 launches a pass, one a group of each Mamba2 layer,
               and 13 B5 launches at D = 224), counted, a second prefill
               beside the first cache (peak under Z7_MEM_SHARE of the
               card), an event-timed third (its first B5 application at
               the model's scale held against the oracle) and 16 decode
               steps; B4 is also held to its plain version and timed at
               one group's launch of that pass, (8, 56, 4,080, 64, 64);
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
               danube's prefill shapes and at zamba2-7b's pass, (8, 32,
               32, 4,080, 224) at the scale 112^-0.5, B5 there held
               against the oracle too; the same at the MoE prefills' head
               shapes (qwen3-moe's
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
               memory stays the model's own). Right after B5's checks,
               decode attention (``csrc/decode_attention.cu``) alone at
               internlm2's (16, 4,096 slots, 8 KV heads, 16 query heads,
               hd 128) and zamba2-7b's (16, 4,096, 32, 32, 224) bf16
               rings, full, partly filled, wrapped and a wrapped window:
               ring bytes equal to the plain version's, a relaunch
               bit-equal, the output within the bound of
               ``tests/test_torch_decode_attention.py`` against an f64
               oracle and within 2 ulps + 6 u sqrt(sum p^2 v^2) of the
               plain version's, and scores that pick one slot (the
               window's edges, the token's own) picking it; its device
               time at the full ring (calls queued behind a sleep)
               beside its bytes bound, the plain version's (the decode
               before the kernel) and ``scaled_dot_product_attention``'s.
               The serving phases count its launches: one a KV ring a
               decode step.
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
 10. dist    — the distribution layer. (b), after phase 4 and before any
               replica: B1 and B2 on every row against the same rows in
               four blocks, each launched alone (B2's blocks plan other
               lag tiles than the whole), bit-equal; then four ranks
               spawned on the one card (``torch.multiprocessing``,
               ``spawn``; an explicitly named gloo group, since NCCL
               refuses two ranks on one card, with a FileStore in a
               temporary directory), each running the 16,384-job tick of
               phase 3 with ``shards=4``, overlap off and on, whose cold,
               steady and full-refit decisions (LM series, periods,
               profiles, RemainTime, ``scheduled_at``, confidences) must
               be bit-identical to phase 3's, and its share of one
               full-width qwen3-moe MoE layer on a (2, 2) mesh (64
               experts a ``model`` rank, ZeRO-3 over ``data``; weights
               from one seeded draw cut by ``blocks.moe_shard_params``):
               in f32 at capacity E/K within 1e-5 of the local path's
               peak (aux within 1e-6); in f32 at the config's capacity on
               tokens that share a direction (pairs drop), each rank's
               drops equal and its output within 1e-5 of the peak of the
               local path run on each ``model`` rank's own slice (C from
               that slice's tokens), aux within 1e-6; then in bf16 (4 x
               4,096 tokens, the config's capacity) timed by CUDA events
               around each part, with the pairs dropped. Each rank
               asserts that its ticks launched B1 and B2 and records the
               shapes of the row blocks it launched them on; the parent
               joins every rank, a failed one failing the run, and holds
               B1 and B2 to their plain versions at each of those shapes
               (phase 2's checks). (a), inside phase 9: the
               full-depth 8 x 4,096 prefill through the expert-parallel
               path on one NCCL rank (a (1, 1) mesh) against the local
               prefill of the same batch: logits bit-equal, or else a
               difference printed as a finding; either way 2 layers in
               f32 at full width within 1e-6 of their peak.
 11. tp      — last, after phase 9's memory is released: the model on a
               ``(data, model)`` mesh. Four gloo ranks spawned on the card
               as in phase 10(b), each holding its slices of
               ``internlm2_1p8b`` at full width (``launch/sharding``:
               heads and FFN columns over ``model``, ZeRO-3 over
               ``data``) on a (2, 2) mesh: a warm-up train step whose loss
               and grad norm must equal phase 8's first step within
               TP_TRAIN_RTOL, 2 counted steps (48 B5 launches each on
               every rank, B3 on the rank's slices), the second with
               every collective timed; a prefill of 4 x 4,096 with the cache in
               the rank's layout and 4 greedy decode steps, whose tokens
               equal the local path's wherever its top-2 margin exceeds
               TP_GREEDY_MARGIN; one f32 step 2 layers deep within
               TP_F32_TOL of the local step on the card; then
               ``elastic.rescale`` of an 8-layer state from (2, 2) to
               (1, 4) while the source trains, every destination slice
               bit-equal to the gathered source's at the stop, the same
               rounds on every rank, and a step on (1, 4). The parent holds
               B5 at every per-rank shape the ranks launched it at.
 12. ssm-tp  — after phase 11: the SSM and hybrid wirings on the mesh.
               The parent first runs the local first steps on the card
               (rwkv6 at full depth, zamba2 12 layers deep) and frees
               them; then four gloo ranks on (2, 2) in bf16 train rwkv6
               at full width and depth (a warm-up step whose loss is
               held to the local one, 2 counted steps with 48 B4
               launches each, B3 on the rank's slices, the second with
               every collective timed), prefill and decode 4 greedy
               steps of rwkv6 over 4 x 4,096 (its tokens counted against
               the local path's; ROADMAP C-11), of rwkv6 in f32 over 4 x
               1,024 and of zamba2 over 4 x 4,096 (45 B4 and 9 B5
               launches a rank), those tokens held to the local path's
               where its top-2 margin exceeds TP_GREEDY_MARGIN, train
               zamba2 12 layers deep (one step, loss and grad norm held),
               and take
               one f32 step of rwkv6 (2 layers) and of a zamba2 group,
               each held to the local step within its SSM_TP_F32 limit.
               The parent holds B4 and B5 at every per-rank shape the
               ranks launched them at.
 15. heads-tp — after phase 12 (run before 13 and 14): the attention on
               a model axis that does not divide its heads. The parent
               first runs starcoder2's local first step (4 layers, bf16)
               and frees it; then eight gloo ranks on a (1, 8) mesh, where
               neither qwen2-vl's 12 nor starcoder2's 36 query heads (nor
               their 2 and 4 KV heads) divide the model axis, so every
               rank computes every head through B5 on weights gathered
               over ``model`` (``blocks.head_split`` "replicated"): one f32
               prefill and AdamW step of each, 2 layers deep over 4 x 512,
               last logits, loss, grad norm, first moments and params
               within TP_F32_TOL of the local path on the card; one
               starcoder2 train step 4 layers deep (4 x 2,048, bf16, block
               remat, 8 B5 launches), its loss and grad norm held to the
               local step within TP_TRAIN_RTOL, every collective timed;
               qwen2-vl at full width and depth (28 layers, bf16) prefills
               4 x 4,096 (28 B5 launches a rank; the ring of 4,104 cut
               along its window) and decodes 4 greedy steps, collectives
               timed by kind, the tokens held to the local path's where
               its top-2 margin exceeds TP_GREEDY_MARGIN. The parent holds
               B5 at every shape the ranks launched it at and at
               musicgen's (4, 24, 24, 2,048, 64), its shape on the
               production mesh.
 13. dryrun  — ``launch/dryrun.py`` on this machine, every cell a process
               of its own, all at once: (a) six cells of the production
               meshes through its CLI on fake cuda tensors (internlm2
               train_4k single, rwkv6 train_4k multi, qwen3-moe
               prefill_32k single, zamba2 long_500k multi, kimi-k2
               decode_32k multi, qwen2-vl decode_32k single), each record
               ``ok`` with no kernel library loaded or launched and the
               attention's head split it should state (qwen2-vl
               "replicated"); (b) phase 12's rwkv6 train step
               on a fake group of 4, its collective calls and input bytes
               by kind equal to phase 12's rank 0 (its timed step less its
               dirty-block telemetry); (c) phase 8's internlm2 train step
               on one rank, its argument bytes equal to phase 8's state
               and batch, its predicted peak printed beside the measured.
 14. examples — each ``examples/torch_*.py`` with ``--device cuda`` in a
               process of its own (``torch_train_100m.py`` 60 steps);
               each must exit 0 with its ``OK`` line.

Every phase raises on failure. The kernels' launch counters are set to 0
before each path (phases 3, 4 and each of its controller and scenario
runs, 5's prefill and migration, 6's two prefills and its migration, 7's
prefill, 8's counted steps, its migration, its card-against-CPU steps,
its trainers and its incremental checkpoints, 9's two counted prefills,
10's sharded ticks in each rank and its one-rank prefill, 11's, 12's and
15's mesh steps, prefills, decode steps and 11's rescale in each rank) and
read after
it: each kernel of the path must have run in it. ``_recording`` records
the shape of each launch that a later hold reads; ``_spawn_ranks`` and
``_rank_main`` are the frame of every phase that spawns ranks. The last
lines are the card (``nvidia-smi``), one JSON object per kernel, and
``{"ok": true, "device": ...}``.

Run from the repository root with one CUDA device: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import types

from portbench.counts import kernels as bench_kernels
from portbench.lib.calls import distinct

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
FLEET, WINDOW, CHECK_JOBS = 16384, 512, 1024
STEADY_TICKS = 8          # one sample per job, then a tick, this many times
CYCLE_OPS = ("power_spectrum", "autocorr_score")   # the decide loop's kernels
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


def _queued_ms(fn, n: int = 20, reps: int = 7) -> float:
    """ms per call of ``n`` calls queued behind a sleeping kernel (median
    of ``reps``): the events time the device's work alone, where the host
    takes longer to enqueue a call than the card to run it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(30_000_000)          # ~17 ms: the calls queue up
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def _bound(work) -> tuple:
    """(least ms, "operations" or "bytes": the term that sets it) of a
    kernel call whose (operations, bytes) ``bench_kernels`` gave: the
    benchmark's own count and peaks, which its ``*_roofline`` metrics
    read."""
    flops, nbytes = work
    by = ("operations" if bench_kernels.seconds(flops, 0.0)
          >= bench_kernels.seconds(0.0, nbytes) else "bytes")
    return 1e3 * bench_kernels.seconds(flops, nbytes), by


def _scan_bound(leaves, block: int) -> float:
    """Least ms of one pre-copy scan of a state's ``leaves``: B3's count
    (``bench_kernels.dirty_scan``, which its bytes set) over every leaf.
    The integer leaves count too, as in ``v_mem``: the scan reads both
    copies of them for its exact ``!=``."""
    return _bound(bench_kernels.dirty_scan(
        [(t.numel(), t.element_size()) for t in leaves], block))[0]


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
        bound, by = _bound(bench_kernels.spectrum(B, N))
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
    bound, by = _bound(bench_kernels.autocorr(J, N, lags.tolist()))
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


def _tick_values(np):
    """(FLEET, WINDOW + STEADY_TICKS, F) seeded Table 3 load indexes, the
    telemetry every tick of phases 3 and 10 records."""
    from repro_torch.core.fleetsim import phase_means, table3_traces
    from repro_torch.core.telemetry import DEFAULT_FIELDS

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
    return vals


def _tick_engine(np, vals, device, n, **kw):
    """A fleet of the first ``n`` jobs with WINDOW samples recorded, and a
    ``SurveillanceEngine(device=device, **kw)`` over it."""
    from repro_torch.core.fleetsim import make_training_nb
    from repro_torch.core.surveillance import SurveillanceEngine
    from repro_torch.core.telemetry import FleetTelemetry

    fleet = FleetTelemetry(n, capacity=WINDOW, device=device)
    fleet.record_fleet_bulk(np.arange(WINDOW),
                            vals[:n, :WINDOW].transpose(1, 0, 2))
    eng = SurveillanceEngine(device=device, **kw)
    nb = make_training_nb(device=device)
    for i, view in enumerate(fleet.views()):
        eng.register(f"job{i:05d}", view, nb, window=WINDOW)
    return fleet, eng


def _tick_state(np, eng, now: int, remain) -> dict:
    """What a tick decided, in job order: RemainTime, ``scheduled_at`` (the
    step a migration asked for now is released: now + RemainTime),
    periods, profiles, LM series, fitted and origin steps, confidences."""
    import torch
    ids = sorted(eng.jobs)
    jobs = [eng.jobs[i] for i in ids]
    r = np.asarray([remain[i] for i in ids])
    width = max(len(j.model.profile_lm) for j in jobs)
    prof = np.full((len(jobs), width), -2, np.int8)
    for k, j in enumerate(jobs):
        prof[k, :len(j.model.profile_lm)] = j.model.profile_lm
    return {"remain": r, "scheduled_at": now + r,
            "period": np.asarray([j.model.period for j in jobs]),
            "profile": prof,
            "lm_series": torch.stack([j.lm_series for j in jobs]
                                     ).cpu().numpy(),
            "fitted_step": np.asarray([j.fitted_step for j in jobs]),
            "origin_step": np.asarray([j.origin_step for j in jobs]),
            "confidence": np.asarray([j.model.confidence for j in jobs])}


def _tick_run(torch, np, vals, fleet, eng, n, states=None):
    """Cold tick, then STEADY_TICKS x (record one sample, tick). Returns
    (cold remain, last remain, cold s, mean steady s, refits). With
    ``states`` (a dict), the cold tick's and the last steady tick's
    ``_tick_state`` and every steady tick's RemainTime go there, read
    outside the timed spans."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = eng.tick(WINDOW - 1)
    remain_cold = cold.remain
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    if states is not None:
        states["cold"] = _tick_state(np, eng, WINDOW - 1, remain_cold)
    refits, remains = [cold.refitted], []
    t0 = time.perf_counter()
    for s in range(WINDOW, WINDOW + STEADY_TICKS):
        fleet.record_fleet(s, vals[:n, s])
        res = eng.tick(s)
        remain = res.remain
        remains.append(remain)
        refits.append(res.refitted)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t0) / STEADY_TICKS
    if states is not None:
        ids = sorted(eng.jobs)
        states["steady_remain"] = np.asarray([[r[i] for i in ids]
                                              for r in remains])
        states["steady"] = _tick_state(np, eng, WINDOW + STEADY_TICKS - 1,
                                       remain)
    return remain_cold, remain, t_cold, t_steady, refits


def phase_tick(torch, np, ops_mod):
    """A FLEET-job surveillance fleet on Table 3 traces, one cold and one
    steady tick on the card, checked against a CPU engine. Returns the
    launches, the times, the (J, N, lags) of each B2 call on the card and
    the ticks' decisions (``_tick_state``: cold, steady, full refit)."""
    vals = _tick_values(np)
    fleet, eng = _tick_engine(np, vals, "cuda", FLEET)
    states, seen = {}, collections.defaultdict(list)
    with _recording(ops_mod, seen):
        ops_mod.reset_launch_counts()
        remain_cold, remain_steady, t_cold, t_steady, refits = _tick_run(
            torch, np, vals, fleet, eng, FLEET, states)
        launches = ops_mod.launch_counts()
        t_full, profile = _full_refit_profile(torch, eng, states)
    b2_calls = seen["autocorr"]
    print("[tick] B2 received (J, N, L, lags): " + ", ".join(
        f"({J}, {N}, {len(lags)}, {lags[0]}..{lags[-1]})"
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

    cfleet, ceng = _tick_engine(np, vals, "cpu", CHECK_JOBS)
    c_cold, c_steady, _, _, _ = _tick_run(torch, np, vals, cfleet, ceng,
                                          CHECK_JOBS)
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
                      "tick_full_s": t_full, **profile}, b2_calls, states


def _full_refit_profile(torch, eng, states=None):
    """Time a tick that refits every job (``refresh(force=True)``, the
    classify splicing the slid window), then trace one more under
    ``torch.profiler`` and print where its device time goes. With
    ``states``, the timed tick's ``_tick_state`` goes there as "full"."""
    import numpy as np
    now = WINDOW + STEADY_TICKS - 1

    def full_tick():
        eng.refresh(force=True)
        return eng.tick(now).remain

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    remain = full_tick()
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    if states is not None:
        states["full"] = _tick_state(np, eng, now, remain)
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
def _recording(ops_mod, seen, launches=None):
    """Record each launch of B1, B2, B4 and B5 made while the block runs,
    appending its shape to the list ``seen[kernel]`` (``seen`` a
    ``defaultdict(list)``):

      dft_power        (B, N), the rows the launch gets: a rank's row
                       block under ``mesh=``
      autocorr         (J, N, the lags as a tuple, read on the host after
                       the block)
      ssm_scan         (B, H, S, Dk, Dv, dtype, kind, initial state
                       given), ``kind`` "mamba" where every head shares q
                       and k (stride 0 over H), else "rwkv" with a bonus
                       or "plain"
      flash_attention  (B, H, Hkv, S, D, dtype, window)

    The wrappers go on names of ``ops`` that hold no launch counter
    (``_power`` and ``_scores``, which every launch of B1 and B2 passes,
    and the entries ``ssm_scan`` and ``flash_attention``, which the models
    call through the module), so the kernels count their launches as
    ever. With ``launches`` (a dict) the counters are set to 0 at the
    start and their counts added to it at the end."""
    grids = []

    def power(x, *a, **kw):
        seen["dft_power"].append(tuple(x.shape))
        return saved["_power"](x, *a, **kw)

    def scores(x, lags, *a, **kw):
        grids.append((*x.shape, lags))
        return saved["_scores"](x, lags, *a, **kw)

    def scan(q, k, v, log_decay, *, bonus=None, initial_state=None):
        kind = ("mamba" if q.stride(1) == 0 and k.stride(1) == 0
                else "rwkv" if bonus is not None else "plain")
        seen["ssm_scan"].append((*q.shape, v.shape[-1], str(q.dtype), kind,
                                 initial_state is not None))
        return saved["ssm_scan"](q, k, v, log_decay, bonus=bonus,
                                 initial_state=initial_state)

    def attention(q, k, v, *, window=0, **kw):
        seen["flash_attention"].append((*q.shape[:2], k.shape[1],
                                        *q.shape[2:], str(q.dtype),
                                        int(window)))
        return saved["flash_attention"](q, k, v, window=window, **kw)

    wrappers = {"_power": power, "_scores": scores, "ssm_scan": scan,
                "flash_attention": attention}
    saved = {name: getattr(ops_mod, name) for name in wrappers}
    if launches is not None:
        ops_mod.reset_launch_counts()
    for name, fn in wrappers.items():
        setattr(ops_mod, name, fn)
    try:
        yield
        if launches is not None:
            for op, n in ops_mod.launch_counts().items():
                launches[op] = launches.get(op, 0) + n
    finally:
        for name, fn in saved.items():
            setattr(ops_mod, name, fn)
        for J, N, lags in grids:
            seen["autocorr"].append((J, N, tuple(lags.tolist())))


def _hold_captured(torch, seen, tag: str = "fleet"):
    """Phase 2's B1 and B2 checks, at phase 2's tolerances, on seeded
    inputs at each distinct shape in ``seen`` (as ``_recording`` records
    them)."""
    from repro_torch.kernels import autocorr, dft, ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    spectra, grids = sorted(set(seen["dft_power"])), \
        sorted(set(seen["autocorr"]))
    worst, routes = 0.0, {}
    for B, N in spectra:
        _, err, _ = _dft_case(torch, ref, dft, g, B, N)
        worst = max(worst, float(err.max()))
        routes[dft.route(N)] = routes.get(dft.route(N), 0) + 1
    print(f"[{tag}] B1 received {len(spectra)} distinct (B, N): "
          + ", ".join(f"({B}, {N})" for B, N in spectra))
    print(f"[{tag}] B1 held at each (phase 2's tolerance, bit-equal "
          f"relaunch): routes {routes}, max_abs_err {worst:.6g}")
    print(f"[{tag}] B2 received {len(grids)} distinct "
          "(J, N, L, lags): " + ", ".join(
              f"({J}, {N}, {len(lags)}, {lags[0]}..{lags[-1]})"
              for J, N, lags in grids))
    for J, N, lags in grids:
        _autocorr_case(torch, ref, autocorr, g, J, N,
                       torch.tensor(lags, dtype=torch.int32))


def phase_fleet(torch, ops_mod):
    """The quickstart and the 8-job fleet under ``alma-paper`` and
    ``immediate`` on the card against CPU runs, then the controller's runs
    (``phase_controller``); every B1 and B2 shape the card runs sent is
    then held against its plain version. Returns the launches of both."""
    from repro_torch.core import fleetsim as fs
    from repro_torch.core.orchestrator import MigrationRequest

    seen = collections.defaultdict(list)
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    trace = fs.WorkloadTrace([("MEM", 30), ("CPU", 60), ("IDLE", 30)], 3600)
    with _recording(ops_mod, seen):
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
        with _recording(ops_mod, seen):
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
    card runs' B1 and B2 shapes go into ``seen`` (``_recording``).
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
        with _recording(ops_mod, seen):
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
        bound, by = _bound(bench_kernels.dirty_scan(
            [(n, new.element_size())], block))
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

    _warm_scan(torch, precopy, state(), PCFG["block_elems"])
    ops_mod.reset_launch_counts()
    dest, rep, scan_ms, scan_dev_ms = _migrate_scan_events(
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
    if launches["dirty_blocks"] != _scan_launches(n_float) * len(scan_ms) \
            or launches["decode_attention"] != \
            ATTN_LAUNCHES[ARCH] * box["produced"]:
        raise AssertionError(f"migration launched {launches} over "
                             f"{box['produced']} decode steps")
    scan_bound = _scan_bound(tree.leaves(live), PCFG["block_elems"])
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
    if max(scan_dev_ms) > SCAN_LIMIT * scan_bound:
        raise AssertionError(f"a scan took {max(scan_dev_ms):.4f} ms, over "
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


# zamba2-7b (Zamba2-7B-Instruct at its published widths, the benchmark's
# configuration file) served as its benchmark cell serves it: batches of 16
# prompts of 4,080 tokens, 16 decode steps
Z7_NAME = "zamba2-7b"
Z7_FILE = ROOT / "portbench" / "configs" / f"{Z7_NAME}.json"
Z7_BATCH, Z7_PROMPT, Z7_STEPS = 16, 4080, 16
# the second prefill's peak memory, beside the first batch's cache as a
# serving replica holds it, as a share of the card's memory (PERF.md: 76.3
# of 85.0 GB, 0.90, in the cell)
Z7_MEM_SHARE = 0.95


def _zamba2_7b_config():
    """The port's ``ArchConfig`` of zamba2-7b, read from the benchmark's
    configuration file as the benchmark reads it."""
    from portbench.lib import lm as lmlib
    return lmlib.arch_config(json.loads(Z7_FILE.read_text()))


def _z7_pass() -> int:
    """Sequences in one pass of zamba2-7b's prefill (``lm.PREFILL_TOKENS``)
    at the cell's prompt."""
    from repro_torch.models import lm
    return max(1, lm.PREFILL_TOKENS // Z7_PROMPT)


def _z7_scan_shape():
    """(B, H, S, Dk, Dv) of one B4 launch of zamba2-7b's prefill pass: one
    group's heads over the group's state."""
    cfg = _zamba2_7b_config()
    s = cfg.ssm
    heads = s.expand * cfg.d_model // s.head_dim
    return (_z7_pass(), heads // s.n_groups, Z7_PROMPT, s.state_dim,
            s.head_dim)


def _scan_work(ins, u, s0):
    """B4's (operations, bytes) on one launch's inputs (``_scan_case``'s
    ((q, k, v, log decay), bonus, initial state)), as the benchmark counts
    them (``bench_kernels.ssm_scan``: each input's distinct elements read
    once)."""
    q, k, v, lw = ins
    B, H, S, Dk = q.shape
    return bench_kernels.ssm_scan(
        B, H, S, Dk, v.shape[-1],
        [(distinct(t), t.element_size())
         for t in (q, k, v, lw, u, s0) if t is not None])


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
    zamba2's, rwkv6's and one group of zamba2-7b's prefill shapes, and
    against the step recurrence too on the edges; a second launch must be
    bit-equal. Returns (the record at zamba2's shape, the record at each
    timed shape)."""
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
        # one group's launch of zamba2-7b's prefill pass: its 56 heads
        # read the group's B and C as stride-0 views
        (f"{Z7_NAME} prefill, one group: SSD, stride-0 bf16 q/k, f32 decay",
         "mamba", _z7_scan_shape(), dict(dtype=bf16), False),
    ]
    record, timed = None, {}
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
            # the same launch through the custom op the model calls
            # (``kernels/ops.py``): what its dispatch adds
            op_ms = _median_ms(lambda: torch.ops.repro_torch.ssm_scan(
                *ins, u, s0))
            plain = _median_ms(lambda: gla.gla_chunked(
                *ins, bonus=u, initial_state=s0), 5)
            work = _scan_work(ins, u, s0)
            bound, by = _bound(work)
            line += (f"; kernel {ms:.4f} ms (through the custom op "
                     f"{op_ms:.4f} ms) plain {plain:.4f} ms bound "
                     f"{bound:.6g} ms ({by}, {work[1] / 1e9:.4f} GB)")
            timed[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bound, bound_by=by, library_ms=None)
            if record is None:
                record = timed[name]
        print(line + ", bit-equal on a second launch")
        del ins, u, s0, got, again, want
        torch.cuda.empty_cache()
    return record, timed


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
            seen.append((q, k, v, kw.get("window", 0),
                         kw.get("scale") or 0.0, out))
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
        q, k, v, window, scale, got = seen.pop()
        err, use = _attn_check(torch, ref, got, q, k, v, window,
                               f"{tag}'s first attention application",
                               oracle=_scaled_oracle(ref, scale))
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


def _warm_scan(torch, precopy, live, block):
    """One dirty scan of ``live`` against itself before a timed migration,
    so that no timed scan holds B3's first launch at these leaves' shapes
    and dtypes in the process or the first allocation of its masks: run
    without the phases before it, phase 5's first scan took 32-87 ms by
    CUDA events against 8-10 ms for the rest."""
    precopy.dirty_scan(live, live, block)
    torch.cuda.synchronize()


def _migrate_scan_events(torch, precopy, *args, **kwargs):
    """``precopy.migrate`` with CUDA events around each scan (C-w6) and the
    recorder on: returns (dest, report, host-clock ms of each scan, its
    ``precopy.scan`` span, device-clock ms per scan). The device is
    synchronised before each scan's first event, so the events time the
    scan alone; its span also holds what the device still had queued
    when it began (the round-0 copy, the job's step)."""
    from repro_torch.runtime import spans
    scan, events = precopy.dirty_scan, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = scan(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    precopy.dirty_scan = timed
    spans.enable()
    try:
        dest, rep = precopy.migrate(*args, **kwargs)
    finally:
        spans.disable()
        precopy.dirty_scan = scan
    torch.cuda.synchronize()
    host = [1e3 * (s.end - s.start) for s in spans.drain()[0]
            if s.name == "precopy.scan"]
    if len(events) != len(host):
        raise AssertionError(f"{len(events)} scans timed on the device, "
                             f"{len(host)} on the host")
    return dest, rep, host, [e0.elapsed_time(e1) for e0, e1 in events]


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

    _warm_scan(torch, precopy, state(), block)
    ops_mod.reset_launch_counts()
    dest, rep, scan_ms, scan_dev_ms = _migrate_scan_events(
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
    if launches["dirty_blocks"] != _scan_launches(n_float) * len(scan_ms):
        raise AssertionError(f"zamba2 migration launched {launches}")
    scan_bound = _scan_bound(leaves, block)
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
    if max(scan_dev_ms) > SCAN_LIMIT * scan_bound:
        raise AssertionError(f"a zamba2 scan took {max(scan_dev_ms):.4f} ms, "
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


def phase_zamba2_7b_serve(torch, ops_mod):
    """zamba2-7b at its published widths (bf16, seeded weights, 7.36e9
    params) served as its benchmark cell serves it: prefill Z7_BATCH x
    Z7_PROMPT in passes of ``_z7_pass()`` sequences (each pass 162 B4
    launches, one a group of each of 81 Mamba2 layers, and 13 B5 launches at
    D = 224, one a shared call), counted; a second prefill beside the first
    batch's cache, its peak memory held under Z7_MEM_SHARE of the card;
    the event-timed third prefill's first B5 application held against the
    oracle at the model's scale; then Z7_STEPS greedy decode steps, counted
    (decode attention once a shared call a step), logits finite. Returns
    (the counted prefill's launches, the decode's, numbers to keep)."""
    from repro_torch import tree
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import lm
    from repro_torch.train import make_decode_step, make_prefill_step

    cfg = _zamba2_7b_config()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    batch = make_batch(cfg, Z7_BATCH, Z7_PROMPT, device="cuda")
    batch.pop("targets")
    prefill = make_prefill_step(cfg, cache_len=Z7_PROMPT + Z7_STEPS)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    passes = -(-Z7_BATCH // _z7_pass())
    want = {"ssm_scan": passes * cfg.num_layers * cfg.ssm.n_groups,
            "flash_attention": passes * len(cfg.hybrid_layer_ids)}
    logits, cache, t_prefill, _, launches = _counted_prefill(
        torch, ops_mod, prefill, params, batch)
    if any(launches[op] != n for op, n in want.items()):
        raise AssertionError(f"{Z7_NAME} prefill launched {launches}, want "
                             f"{want}")
    if logits.shape != (Z7_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{Z7_NAME} prefill logits are not finite or "
                             "misshapen")
    # a serving replica prefills the next batch while it holds this one's
    # cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, cache2 = prefill(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    print(f"[{Z7_NAME}] {sum(t.numel() for t in tree.leaves(params))} params, "
          f"init {t_init:.4f} s; prefill {Z7_BATCH} x {Z7_PROMPT} in "
          f"{passes} passes, {t_prefill:.4f} s, launches {launches}; the "
          f"next prefill beside this cache peaks at {peak / 1e9:.4f} GB of "
          f"{card / 1e9:.4f} GB ({peak / card:.4f}, limit {Z7_MEM_SHARE})")
    if peak > Z7_MEM_SHARE * card:
        raise AssertionError(f"{Z7_NAME}: the prefill beside a cache peaks at "
                             f"{peak / card:.4f} of the card, over "
                             f"{Z7_MEM_SHARE}")
    del cache
    split = _timed_prefill(torch, ops_mod, prefill, params, batch, Z7_NAME)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(Z7_STEPS):
        tok, logits, cache2 = decode(params, tok, cache2)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decode_launches = ops_mod.launch_counts()
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{Z7_NAME} decode logits are not finite")
    want = len(cfg.hybrid_layer_ids) * Z7_STEPS
    if decode_launches["decode_attention"] != want:
        raise AssertionError(f"{Z7_NAME} decode launched {decode_launches}, "
                             f"want {want} decode_attention")
    print(f"[{Z7_NAME}] {Z7_STEPS} decode steps {t_decode:.4f} s, launches "
          f"{decode_launches}")
    del params, cache2, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches, decode_launches, dict(init_s=t_init, prefill_s=t_prefill,
                          peak_gb=peak / 1e9, peak_share=peak / card,
                          decode_s=t_decode, **split)


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


def _attn_work(q, k, window: int):
    """B5's (operations, bytes) on one launch's q (B, H, S, D) and k (B,
    Hkv, S, D), as the benchmark counts them (``bench_kernels.attention``:
    4 D a causal, window-trimmed pair and head; q, k, v read and the
    output written once)."""
    B, H, S, D = q.shape
    return bench_kernels.attention(B, H, k.shape[1], S, D,
                                   in_bytes=q.element_size(), window=window)


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


def _plain_chunk(ref, S: int) -> int:
    """The plain version's kv chunk at S: the largest divisor of S up to
    ``ref.ATTN_CHUNK`` (its default, 512, at S = 4,096; 510 at 4,080)."""
    return max(c for c in range(1, ref.ATTN_CHUNK + 1) if S % c == 0)


def _scaled_oracle(ref, scale: float):
    """``ref.attention_ref`` at the softmax scale ``scale`` (0: its
    default, ``D**-0.5``)."""
    def oracle(q, k, v, *, window):
        return ref.attention_ref(q, k, v, window=window,
                                 scale=scale or None)
    return oracle


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
        pairs = bench_kernels.causal_pairs(S, window) / \
            bench_kernels.causal_pairs(S)
        print(f"[attn] flash_attention (1, 32, 8, {S}, 120) "
              f"{str(dtype)[6:]} window {window}: max_abs_err {err:.6g} "
              f"{what}; {ms_win:.4f} ms against {ms_causal:.4f} ms causal, "
              f"ratio {ratio:.4f} (pairs predict {pairs:.4f})")
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
    # zamba2-7b's pass of its cell's prefill: 224-wide heads (64-key kv
    # tiles) at the caller's scale (attention_head_dim / 2) ** -0.5
    record, times = None, {}
    z7 = _zamba2_7b_config()
    for name, (B, H, Hkv, D), window, S, scale in (
            ("zamba2", (SERVE_BATCH, 32, 32, 80), 0, SERVE_PROMPT, 0.0),
            ("qwen3", (SERVE_BATCH, 32, 8, 128), 0, SERVE_PROMPT, 0.0),
            ("danube3", (SERVE_BATCH, 32, 8, 120), 4096, SERVE_PROMPT, 0.0),
            ("qwen3-moe", (MOE_BATCH, 32, 4, 128), 0, SERVE_PROMPT, 0.0),
            ("kimi-k2", (PREFIX_BATCH, 64, 8, 112), 0, SERVE_PROMPT, 0.0),
            (Z7_NAME, (_z7_pass(), z7.num_heads, z7.num_kv_heads,
                       z7.head_dim), 0, Z7_PROMPT, z7.attn_scale)):
        q, k, v = _attn_inputs(torch, g, B, H, Hkv, S, D, bf16)
        got = fa.flash_attention(q, k, v, window, scale)
        if not torch.equal(got, fa.flash_attention(q, k, v, window, scale)):
            raise AssertionError(f"flash_attention not deterministic at "
                                 f"{name}'s prefill shape")
        err, use = _attn_check(torch, ref, got, q, k, v, window,
                               f"{name}'s prefill shape",
                               oracle=_scaled_oracle(ref, scale))
        ms = _median_ms(lambda: fa.flash_attention(q, k, v, window, scale))
        # the same launch through the custom op the model calls
        op_ms = _median_ms(lambda: torch.ops.repro_torch.flash_attention(
            q, k, v, window, scale))
        plain = _median_ms(lambda: ref.attention_chunked(
            q, k, v, window=window, chunk=_plain_chunk(ref, S),
            scale=scale or None), 5)
        lib = _median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True, scale=scale or None))
        flops, nbytes = _attn_work(q, k, window)
        bound, by = _bound((flops, nbytes))
        print(f"[attn] flash_attention {name} prefill "
              f"{(B, H, Hkv, S, D)} bf16 window {window} scale "
              f"{scale or D ** -0.5:.6g}: max_abs_err {err:.6g} against "
              f"attention_ref "
              f"({use:.4f} of the limit), bit-equal on a second launch; "
              f"kernel {ms:.4f} ms (through the custom op {op_ms:.4f} ms) "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.4f} of the "
              f"bound) plain {plain:.4f} ms sdpa {lib:.4f} ms (kernel / sdpa "
              f"{ms / lib:.4f}) bound {bound:.6g} ms ({by})")
        times[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=lib)
        if record is None:
            record = dict(times[name])
        times[name]["op_ms"] = op_ms
        del q, k, v, got
        torch.cuda.empty_cache()
    return record, times


# decode attention's shapes: name, (B, W, ring heads, query heads, hd),
# scale
DECODE_SHAPES = (("internlm2", (16, 4096, 8, 16, 128), None),
                 (Z7_NAME, (16, 4096, 32, 32, 224), 112 ** -0.5))
# (name, pos, window) held at each shape: the full ring with the token at
# its last slot (the timed case: every slot read), a ring partly filled
# (decode-migrate's tokens sit near slot 3,500), the full ring after it
# wrapped (the valid slots run on past the token's tile) and a window ring
# whose valid slots wrap past the ring's end
DECODE_POSITIONS = (("full", 4095, 0), ("partial", 3500, 0),
                    ("wrapped", 5000, 0), ("window-wrapped", 9000, 1000))
# the kernel held to the plain path on the same inputs: the two round the
# probabilities once each (the kernel a split's, the plain path the whole
# ring's), errors of at most u that sum over the slots like a random walk
# of std sqrt(2/3) u sqrt(sum_j p_j^2 v_j^2); the limit takes DECODE_WALK
# of u sqrt(sum_j p_j^2 v_j^2) (over 7 of those std), and 2 bf16 ulps of
# |plain| for the two outputs' own rounding. A split weighted wrongly, a
# tile dropped or read twice moves the output by several times that.
DECODE_WALK = 6.0


def _decode_bound_ms(B, W, Hr, n, hd, nbytes=2):
    """Least time of one decode attention at a full ring: the ring's K and
    V read once, q, k, v and the output once (bytes; the products are
    4 hd flops a (query head, slot), ~g flops a byte), at the benchmark's
    HBM peak. Counted here until ``portbench/counts/kernels.py`` counts
    decode attention (PERF.md §7)."""
    moved = nbytes * (2 * B * W * Hr * hd + 2 * B * n * hd + 2 * B * Hr * hd)
    return 1e3 * bench_kernels.seconds(0.0, moved)


def _bf16_ulp(torch, x):
    """The spacing of bf16 values at |x| (0 where x is 0)."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0,
                       torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                   e - 8))


def _decode_oracle(torch, ref, q, rings, angles, pos, window, scale):
    """f64 decode attention of the rotated ``q`` over the written
    ``rings``, a KV head at a time: (o, the bound 2u (|o| + sum p |v|) +
    u max|s| sum p |v - o| of ``tests/test_torch_decode_attention.py``,
    sqrt(sum_j p_j^2 v_j^2)), each (B, n, hd) f64."""
    B, _, n, hd = q.shape
    W, Hr = rings[0].shape[1], rings[0].shape[2]
    G, u = n // Hr, 2.0 ** -8
    qr = ref.apply_rope(q, angles)[:, 0].double()
    valid = ref.decode_valid(window, W, pos, torch.remainder(pos, W).long(),
                             torch.arange(W, device=q.device))
    o_all, bound_all, walk_all = (
        torch.empty(B, n, hd, dtype=torch.float64, device=q.device)
        for _ in range(3))
    for h in range(Hr):
        K, V = (r[:, :, h].double() for r in rings)
        heads = slice(h * G, (h + 1) * G)
        s = torch.where(valid, torch.einsum("bgd,bkd->bgk", qr[:, heads], K)
                        * scale, -torch.inf)
        p = torch.softmax(s, dim=-1)
        o = p @ V
        top = torch.where(valid, s.abs(), 0.0).amax(-1, keepdim=True)
        spread = torch.einsum("bgk,bgkd->bgd", p,
                              (V[:, None] - o[:, :, None]).abs())
        o_all[:, heads] = o
        bound_all[:, heads] = 2 * u * (o.abs() + p @ V.abs()) + u * top * \
            spread
        walk_all[:, heads] = ((p * p) @ (V * V)).sqrt()
        del K, V, s, p, o, spread
    return o_all, bound_all, walk_all


def _decode_check(torch, ops_mod, ref, q, k, v, angles, rings, pos, window,
                  scale, what):
    """The kernel and the plain path on copies of ``rings``, and the
    kernel again on a third: the rings' bytes equal to the plain path's, the
    relaunch bit-equal (output and rings), both outputs within the f64
    oracle's bound, and the kernel within 2 ulps of |plain| + DECODE_WALK
    u sqrt(sum p^2 v^2) of the plain output. Returns (the kernel's output
    (B, n, hd), {what: largest share of its limit used})."""
    B, _, n, hd = q.shape
    copies = [[r.clone() for r in rings] for _ in range(3)]
    plain = ref.decode_attention_ref(q, k, v, angles, copies[0], pos,
                                     window=window, scale=scale)
    got, again = (ops_mod.decode_attention(q, k, v, angles, c, pos,
                                           window=window, scale=scale)
                  for c in copies[1:])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(copies[1], copies[0])):
        raise AssertionError(f"decode_attention {what}: ring bytes differ "
                             f"from the plain version's")
    if not (torch.equal(got, again) and all(
            torch.equal(a, b) for a, b in zip(copies[2], copies[1]))):
        raise AssertionError(f"decode_attention {what}: a relaunch differs")
    o, bound, walk = _decode_oracle(torch, ref, q, copies[0], angles, pos,
                                    window, scale or hd ** -0.5)
    got, plain = (t.view(B, n, hd) for t in (got, plain))
    tight = 2 * _bf16_ulp(torch, plain).double() + \
        DECODE_WALK * 2.0 ** -8 * walk
    use = {"kernel": float(((got.double() - o).abs() / bound).max()),
           "plain": float(((plain.double() - o).abs() / bound).max()),
           "kernel_vs_plain": float(((got.double() - plain.double()).abs()
                                     / tight).max())}
    if max(use.values()) > 1.0:
        raise AssertionError(f"decode_attention {what}: outside its limits "
                             f"(share used): {use}")
    del copies, plain, again, o, bound, walk, tight
    return got, use


def _decode_magnets(torch, ops_mod, ref, q, k, v, angles, rings, pos,
                    window, scale, what):
    """Scores that pick one slot (``tests/test_torch_decode_attention.py``'s
    magnets), each held by ``_decode_check``: keys that score 30 at the
    oldest valid slot and the newest invalid one, every other key zero,
    must give the oldest slot's v; a query along the token's own k must
    give the token's v, not the ring's stale row. A slot read by mistake
    or missed moves the output by about |v|. The query heads of a KV head
    are made equal, so that one key picks for all of them."""
    B, _, n, hd = q.shape
    W, Hr = rings[0].shape[1], rings[0].shape[2]
    G, p = n // Hr, int(pos)
    nv, slot = min(p + 1, W, window or W), p % W
    q = q[:, :, ::G].repeat_interleave(G, dim=2)
    qr = ref.apply_rope(q, angles).float()[:, 0, ::G]     # (B, Hr, hd)
    magnet = qr * (30 / (qr.pow(2).sum(-1, keepdim=True)
                         * (scale or hd ** -0.5)))
    edges = torch.zeros_like(rings[0])
    for j in {(slot - nv + 1) % W, (slot - nv) % W} - {slot}:
        edges[:, j] = magnet.to(edges.dtype)
    own = (3 * k.float()).repeat_interleave(G, dim=2).to(q.dtype)
    use = {}
    for name, qq, ring_k, pick in (
            ("edges", q, edges, rings[1][:, (slot - nv + 1) % W]),
            ("own", own, rings[0], v[:, 0])):
        got, use[name] = _decode_check(
            torch, ops_mod, ref, qq, k, v, angles, [ring_k, rings[1]], pos,
            window, scale, f"{what} {name}")
        err = float((got.float() - pick.float().repeat_interleave(G, dim=1)
                     ).abs().max())
        if err >= 0.05:
            raise AssertionError(f"decode_attention {what} {name}: the "
                                 f"picked slot's v missed by {err}")
        del got
    del edges
    return use


def phase_decode_attention(torch, ops_mod, ref):
    """Decode attention (``csrc/decode_attention.cu``) alone at
    internlm2's and zamba2-7b's rings, 16 x 4,096 slots, at each of
    DECODE_POSITIONS: held by ``_decode_check`` (ring bytes, relaunch, the
    f64 oracle's bound and the plain path at a tight limit) on random
    inputs and by ``_decode_magnets``; then, at the full ring, device
    times (calls queued behind a sleep, ``_queued_ms``) of the kernel, the
    plain version (rotary, the ring write and the two einsums over the
    whole ring, the decode before the kernel) and the library's
    ``scaled_dot_product_attention`` over the same ring (the attention
    alone, GQA, on the ring's (B, Hkv, W, hd) view; never called by the
    port) beside the bytes bound. Returns {name: record}."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    bf16 = torch.bfloat16
    records = {}
    for name, (B, W, Hr, n, hd), scale in DECODE_SHAPES:
        q = torch.randn(B, 1, n, hd, device="cuda", generator=g).to(bf16)
        k, v = (torch.randn(B, 1, Hr, hd, device="cuda", generator=g).to(bf16)
                for _ in range(2))
        rings = [torch.randn(B, W, Hr, hd, device="cuda",
                             generator=g).to(bf16) for _ in range(2)]
        inv = 1e4 ** (-torch.arange(hd // 2, device="cuda") / (hd // 2))
        use = {}
        for case, p, window in DECODE_POSITIONS:
            what = f"{name} {case} (pos {p}, window {window})"
            angles = (p * inv).expand(B, 1, hd // 2).contiguous()
            pos = torch.tensor(p, dtype=torch.int32, device="cuda")
            _, use[case] = _decode_check(torch, ops_mod, ref, q, k, v,
                                         angles, rings, pos, window, scale,
                                         what)
            use[case].update(_decode_magnets(torch, ops_mod, ref, q, k, v,
                                             angles, rings, pos, window,
                                             scale, what))
            print(f"[decode] decode_attention {what}: rings and relaunch "
                  f"bit-equal, magnets picked; share of each limit used "
                  f"{use[case]}")
        angles = ((W - 1) * inv).expand(B, 1, hd // 2).contiguous()
        pos = torch.tensor(W - 1, dtype=torch.int32, device="cuda")
        plain_rings = [r.clone() for r in rings]
        ms = _queued_ms(lambda: ops_mod.decode_attention(
            q, k, v, angles, rings, pos, scale=scale))
        op_ms = _median_ms(lambda: ops_mod.decode_attention(
            q, k, v, angles, rings, pos, scale=scale))
        plain_ms = _queued_ms(lambda: ref.decode_attention_ref(
            q, k, v, angles, plain_rings, pos, scale=scale), 5, 3)
        kv = [r.transpose(1, 2) for r in rings]        # (B, Hkv, W, hd)
        library_ms = _queued_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), *kv, scale=scale or hd ** -0.5,
            enable_gqa=True))
        bound_ms = _decode_bound_ms(B, W, Hr, n, hd)
        records[name] = dict(
            at=f"{(B, W, Hr, n, hd)} bf16", ms=ms, op_ms=op_ms,
            bound_ms=bound_ms, bound_by="bytes", share=bound_ms / ms,
            plain_ms=plain_ms, library_ms=library_ms,
            splits=da.plan(B * Hr, W, n // Hr), limit_use=use)
        print(f"[decode] decode_attention {name} {(B, W, Hr, n, hd)} bf16: "
              f"{ms:.4f} ms queued ({op_ms:.4f} one call), bound "
              f"{bound_ms:.4f} ms (bytes), {100 * bound_ms / ms:.2f}% of "
              f"it; plain {plain_ms:.4f} ms, scaled_dot_product_attention "
              f"{library_ms:.4f} ms; splits {records[name]['splits']}")
        del q, k, v, rings, plain_rings, kv
        torch.cuda.empty_cache()
    return records


def phase_dense_serve(torch, ops_mod):
    """A full-width, full-depth qwen3-8b replica (bf16, seeded random
    weights) served: prefill SERVE_BATCH x SERVE_PROMPT (36 B5 launches,
    full causal, qk-norm, D 128, G 4), DENSE_STEPS greedy decode steps,
    then a second, event-timed prefill whose first B5 application is held
    against the oracle. The decode steps launch decode attention 36 times
    a step. Returns (the prefill's launches, the decode's, numbers to
    keep). No migration: phase 5 covers pre-copy of an
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
    ops_mod.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(DENSE_STEPS):
        tok, logits, cache = r.decode(r.params, tok, cache)
    torch.cuda.synchronize()
    t_tok = (time.perf_counter() - t0) / DENSE_STEPS
    decode_launches = ops_mod.launch_counts()
    if not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["pos"]) != SERVE_PROMPT + DENSE_STEPS:
        raise AssertionError(f"{DENSE_ARCH} decode logits are not finite")
    if decode_launches["decode_attention"] != \
            ATTN_LAUNCHES[DENSE_ARCH] * DENSE_STEPS:
        raise AssertionError(f"{DENSE_ARCH} decode launched "
                             f"{decode_launches}, want "
                             f"{ATTN_LAUNCHES[DENSE_ARCH]} decode_attention "
                             f"a step")
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
          f"{DENSE_STEPS}); launches: prefill {launches}, decode "
          f"{decode_launches}")
    del r
    torch.cuda.empty_cache()
    return launches, decode_launches, {"params": n, "init_s": t_init, "prefill_s": t_prefill,
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
        def forward(ctx, q, k, v, window, chunk, forward, scale=None):
            return attention.forward(ctx, q, k, v, window, chunk,
                                     timed("b5_forward", forward), scale)

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
    first = {k: float(m[k]) for k in ("loss", "grad_norm")}  # phase 11's
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
               "batch_bytes": sum(t.numel() * t.element_size()
                                  for t in batch.values()),
               "peak_bytes": torch.cuda.max_memory_allocated(),
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
    scan_bound = _scan_bound(tree.leaves(src), TRAIN_PCFG["block_elems"])
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
        "params": n, "state_gb": v_mem / 1e9, "state_bytes": v_mem,
        "batch": TRAIN_BATCH,
        "first_step": first,
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
    counts, out["dist_one_rank"] = phase_dist_one_rank(
        torch, ops_mod, r.cfg, r.params, r.batch)
    launches.append(counts)
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


# ---------------------------------------------------------------------------
# phase 10: the distribution layer (``core/shard.py``, the expert-parallel
# MoE) on one NCCL rank and on four gloo ranks sharing the card
# ---------------------------------------------------------------------------
DIST_RANKS = 4
DIST_MOE_MESH = (2, 2)             # ("data", "model")
DIST_CHECK_TOKENS = (2, 1024)      # f32, capacity factor E/K: no drops,
                                   # then the config's on DIST_DROP_X tokens
# tokens that share a direction crowd a few experts, so that the config's
# capacity drops pairs: DIST_DROP_X[0] x noise + DIST_DROP_X[1] x one
# common vector, each a standard normal draw (as the CPU tests build them)
DIST_DROP_X = (0.1, 0.2)
DIST_TIMED_TOKENS = (4, 4096)      # bf16, the config's capacity factor
DIST_MOE_RTOL, DIST_AUX_ATOL = 1e-5, 1e-6
TICK_KEYS = ("remain", "scheduled_at", "period", "profile", "lm_series",
             "fitted_step", "origin_step", "confidence")
B2_BLOCK_CHECK = (8192, WINDOW, 40)    # rows, N, consecutive lags


def _blocks_bit_equal(torch, dft, autocorr):
    """B1 and B2 on every row at once against the same rows cut into
    DIST_RANKS blocks, each block launched alone (what a rank of the
    sharded tick launches): bit-equal. B2's tiles follow (J, N, L), so the
    blocks run another plan than the whole; a lag's sum must not follow
    the tile. Returns the two plans."""
    J, N, L = B2_BLOCK_CHECK
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(J, N, device="cuda", generator=g)
    xc = x - x.mean(dim=1, keepdim=True)
    lags = torch.arange(2, 2 + L, dtype=torch.int32, device="cuda")
    sms = autocorr.sm_count(x.device)
    plans = (autocorr.plan(J, N, L, sms),
             autocorr.plan(J // DIST_RANKS, N, L, sms))
    if plans[0].mt == plans[1].mt:
        raise AssertionError(f"B2 block check: the blocks plan as the whole "
                             f"({plans[0]}), nothing is checked")
    whole_s, whole_p = autocorr.autocorr_score(xc, lags), \
        dft.power_spectrum(x, True)
    parts_s = torch.cat([autocorr.autocorr_score(b.contiguous(), lags)
                         for b in xc.chunk(DIST_RANKS)])
    parts_p = torch.cat([dft.power_spectrum(b.contiguous(), True)
                         for b in x.chunk(DIST_RANKS)])
    if not (_bit_equal(torch, whole_s, parts_s)
            and _bit_equal(torch, whole_p, parts_p)):
        raise AssertionError("B1 or B2 on row blocks differs from the whole "
                             "launch")
    print(f"[dist] B2 at (J, N, L) = {B2_BLOCK_CHECK} in one launch (plan "
          f"mt {plans[0].mt}, rows {plans[0].rows}) and in {DIST_RANKS} "
          f"blocks of {J // DIST_RANKS} (plan mt {plans[1].mt}, rows "
          f"{plans[1].rows}): bit-equal; B1 (route {dft.route(N)}) too")
    return plans


def _dist_ticks(torch, np, ops_mod, workdir):
    """This rank's sharded ticks (``shards=DIST_RANKS``), overlap off and
    on: the cold, steady and full-refit decisions against phase 3's
    (``tick_states.npz``), bit for bit, with B1 and B2 launched in each
    run. Returns the times and launches of each."""
    ref = np.load(workdir / "tick_states.npz")
    vals = _tick_values(np)
    # warm-up: a small sharded tick takes this process's first use of
    # every op off the timed runs
    fleet, eng = _tick_engine(np, vals, "cuda", CHECK_JOBS,
                              shards=DIST_RANKS)
    _tick_run(torch, np, vals, fleet, eng, CHECK_JOBS)
    del fleet, eng
    out = {}
    for overlap in (False, True):
        fleet, eng = _tick_engine(np, vals, "cuda", FLEET, shards=DIST_RANKS,
                                  overlap=overlap)
        ops_mod.reset_launch_counts()
        states = {}
        _, _, t_cold, t_steady, refits = _tick_run(torch, np, vals, fleet,
                                                   eng, FLEET, states)
        now = WINDOW + STEADY_TICKS - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.refresh(force=True)
        remain = eng.tick(now).remain
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        launches = ops_mod.launch_counts()
        missing = [op for op in CYCLE_OPS if not launches[op]]
        if missing:
            raise AssertionError(f"sharded tick (overlap {overlap}): this "
                                 f"rank never launched {missing}")
        states["full"] = _tick_state(np, eng, now, remain)
        for tick in ("cold", "steady", "full"):
            for key in TICK_KEYS:
                if not np.array_equal(states[tick][key],
                                      ref[f"{tick}/{key}"]):
                    raise AssertionError(f"sharded tick (overlap "
                                         f"{overlap}) {tick}: {key} differs "
                                         f"from phase 3's")
        if not np.array_equal(states["steady_remain"], ref["steady_remain"]):
            raise AssertionError(f"sharded tick (overlap {overlap}): a "
                                 f"steady tick's RemainTime differs")
        out[f"overlap_{int(overlap)}"] = {
            "tick_cold_s": t_cold, "tick_steady_s": t_steady,
            "tick_full_s": t_full, "refits": refits,
            "launches": {op: launches[op] for op in CYCLE_OPS}}
        del fleet, eng
    return out


def _ep_timed(torch, call):
    """``call()`` once with CUDA events around each part of the
    expert-parallel layer (routing, dispatch, the two all-to-alls, the
    gathers of router, weights and outputs, the aux sums, the expert
    products, the combine). Returns (ms per part, whole ms, drops)."""
    from repro_torch.models import blocks, dist
    pending, drops, a2a = [], [], []

    def timed(name, fn, key=None):
        def run(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            pending.append((key(*args, **kwargs) if key else name, a, b))
            return out
        return run

    def gather_key(x, mesh, axis, dim):
        return ("weight_gather" if axis == "data" else
                "router_gather" if dim == 1 else "output_gather")

    def a2a_key(*_):
        a2a.append(1)
        return "a2a_dispatch" if len(a2a) % 2 else "a2a_return"

    combine_fn = blocks._combine

    def combine(y, slot, gate, T):
        drops.append((slot >= y.shape[0] * y.shape[1]).sum())
        return combine_fn(y, slot, gate, T)

    parts = ((blocks, "_route", "route"), (blocks, "_fill_buffer", "dispatch"),
             (blocks, "_expert_swiglu", "experts"),
             (dist, "all_reduce", "aux_reduce"))
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in parts] + [
        (dist, "all_gather", dist.all_gather),
        (dist, "all_to_all", dist.all_to_all), (blocks, "_combine", combine_fn)]
    for mod, n, key in parts:
        setattr(mod, n, timed(key, getattr(mod, n)))
    dist.all_gather = timed(None, dist.all_gather, gather_key)
    dist.all_to_all = timed(None, dist.all_to_all, a2a_key)
    blocks._combine = timed("combine", combine)
    try:
        out = timed("layer", call)()
        torch.cuda.synchronize()
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    del out
    ms = {}
    for key, a, b in pending:
        ms[key] = ms.get(key, 0.0) + a.elapsed_time(b)
    return ms, ms.pop("layer"), [int(d) for d in drops]


def _with_drops(call):
    """``call()`` with the pairs each ``blocks._combine`` drops counted:
    (its result, the drops of each combine it ran)."""
    from repro_torch.models import blocks
    combine, drops = blocks._combine, []

    def counted(y, slot, gate, T):
        drops.append(int((slot >= y.shape[0] * y.shape[1]).sum()))
        return combine(y, slot, gate, T)

    blocks._combine = counted
    try:
        return call(), drops
    finally:
        blocks._combine = combine


def _dist_moe_drops(torch, mesh, ctx, cfg, full, mine, g):
    """The f32 layer at the config's capacity on tokens that share a
    direction (DIST_DROP_X), so that pairs drop: in ``slice`` mode each
    ``model`` rank routes its own slice of the rank's tokens, with C from
    that slice, so its drops must equal the local path's on that slice
    and the rank's output the local path's on each slice, end to end; aux
    (taken before capacity) the local path's on every token. The parent
    requires a drop on some rank."""
    from repro_torch.launch.mesh import axis_rank, axis_size
    from repro_torch.models import blocks, dist
    d, dev = cfg.d_model, full["router"].device
    noise = torch.randn(*DIST_CHECK_TOKENS, d, device=dev, generator=g)
    common = torch.randn(d, device=dev, generator=g)
    x = DIST_DROP_X[0] * noise + DIST_DROP_X[1] * common
    xl = dist.local_tokens(ctx, x)
    with dist.use(ctx):
        (got, aux), drops = _with_drops(
            lambda: blocks.moe_ffn(mine, cfg, xl))
    tp_n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    flat = xl.reshape(-1, d)
    T_tp = flat.shape[0] // tp_n
    parts, own = [], None
    for j in range(tp_n):
        (y, _), dr = _with_drops(lambda: blocks.moe_ffn(
            full, cfg, flat[j * T_tp:(j + 1) * T_tp][None]))
        parts.append(y.reshape(T_tp, d))
        own = dr if j == r else own
    want = torch.cat(parts).reshape(xl.shape)
    _, want_aux = blocks.moe_ffn(full, cfg, x)
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    aux_err = abs(float(aux) - float(want_aux))
    if drops != own:
        raise AssertionError(f"expert-parallel MoE layer in f32 at the "
                             f"config's capacity: dropped {drops}, the local "
                             f"path on this rank's slice {own}")
    if not (err <= DIST_MOE_RTOL * peak and aux_err <= DIST_AUX_ATOL):
        raise AssertionError(f"expert-parallel MoE layer in f32 at the "
                             f"config's capacity: max abs err {err} on a "
                             f"peak of {peak}, aux err {aux_err}")
    return {"drop_max_abs_err": err, "drop_peak": peak,
            "drop_aux_err": aux_err, "drops": drops, "local_drops": own,
            "drop_pairs": T_tp * cfg.moe.top_k,
            "drop_capacity": blocks.moe_capacity(cfg.moe, T_tp)}


def _dist_moe(torch):
    """This rank's share of one full-width qwen3-moe MoE layer on a
    DIST_MOE_MESH mesh (experts over ``model``, ZeRO-3 over ``data``), the
    weights from one seeded draw cut by ``blocks.moe_shard_params``: in f32
    at a capacity that cannot drop against the local path, in f32 at the
    config's capacity where pairs drop (``_dist_moe_drops``), then in bf16
    at the config's capacity, event-timed by part."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import blocks, dist

    mesh = meshlib.make_host_mesh(*DIST_MOE_MESH)
    ctx = dist.DistContext(mesh, meshlib.batch_axes(mesh))
    base = get_config(MOE_ARCH)
    m = base.moe
    cfg = base.replace(param_dtype="float32", moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    full = blocks.moe_init(g, cfg, device="cuda")
    x = torch.randn(*DIST_CHECK_TOKENS, cfg.d_model, device="cuda",
                    generator=g)
    want, want_aux = blocks.moe_ffn(full, cfg, x)
    mine = blocks.moe_shard_params(mesh, full)
    with dist.use(ctx):
        got, aux = blocks.moe_ffn(mine, cfg, dist.local_tokens(ctx, x))
    want = dist.local_tokens(ctx, want)
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    aux_err = abs(float(aux) - float(want_aux))
    if not (err <= DIST_MOE_RTOL * peak and aux_err <= DIST_AUX_ATOL):
        raise AssertionError(f"expert-parallel MoE layer in f32: max abs err "
                             f"{err} on a peak of {peak}, aux err {aux_err}")
    out = {"f32_max_abs_err": err, "f32_peak": peak, "f32_aux_err": aux_err}
    del x, want, got
    out.update(_dist_moe_drops(torch, mesh, ctx,
                               base.replace(param_dtype="float32"), full,
                               mine, g))
    del full, mine
    torch.cuda.empty_cache()

    cfg = base
    full = blocks.moe_init(g, cfg, device="cuda")
    mine = blocks.moe_shard_params(mesh, full)
    del full
    x = torch.randn(*DIST_TIMED_TOKENS, cfg.d_model, device="cuda",
                    generator=g).to(cfg.dtype)
    xl = dist.local_tokens(ctx, x)

    def layer():
        with dist.use(ctx):
            return blocks.moe_ffn(mine, cfg, xl)

    layer()                                          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, _ = layer()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    if not bool(torch.isfinite(y.float()).all()) or y.shape != xl.shape:
        raise AssertionError("expert-parallel MoE layer in bf16: output not "
                             "finite or misshapen")
    split, whole, drops = _ep_timed(torch, layer)
    T_tp = xl.shape[0] * xl.shape[1] // meshlib.axis_size(mesh, "model")
    out.update(bf16_host_ms=host_ms, bf16_event_ms=whole,
               bf16_split_ms=split, bf16_drops=drops,
               bf16_pairs=T_tp * m.top_k,
               bf16_capacity=blocks.moe_capacity(m, T_tp),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def _rank_main(rank: int, world: int, workdir: str, body):
    """One rank of phases 10(b), 11, 12 and 15, a spawned process on the
    card shared with the others: the port on ``sys.path``, TF32 off, and a
    gloo group (NCCL refuses two ranks on one card) whose FileStore lies in
    ``workdir``; then ``body(torch, ops, rank, workdir as a path)``, a
    barrier, and its record written to ``rank<r>.json``. Any failure
    raises, and the process exits non-zero."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as tdist
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    work = pathlib.Path(workdir)
    tdist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                             rank=rank, world_size=world)
    try:
        out = body(torch, ops, rank, work)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def _spawn_ranks(torch, ops_mod, body, world: int, write):
    """``world`` ranks of ``body`` spawned on the card (``_rank_main``),
    once the parent's garbage and cached blocks are freed, in a temporary
    directory where ``write(directory)`` first puts their inputs; joined,
    a failed rank failing the run. Returns (each rank's record, their
    ``launches`` summed, the wall seconds of the ranks, spawn
    included)."""
    import tempfile
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        work = pathlib.Path(tmp)
        write(work)
        t0 = time.perf_counter()
        mp.start_processes(_rank_main, args=(world, tmp, body),
                           nprocs=world, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(world)]
    launches = {op: 0 for op in ops_mod.launch_counts()}
    for rec in ranks:
        for op, n in rec["launches"].items():
            launches[op] += n
    return ranks, launches, wall


def _dist_body(torch, ops, rank, work):
    """Phase 10(b)'s rank: the sharded ticks (``_dist_ticks``), recording
    the row blocks it launches B1 and B2 on, then the expert-parallel MoE
    layer (``_dist_moe``); its launches are the ticks'."""
    import numpy as np
    seen = collections.defaultdict(list)
    with _recording(ops, seen):
        tick = _dist_ticks(torch, np, ops, work)
    blocks = {k: sorted(set(seen[k])) for k in ("dft_power", "autocorr")}
    return {"tick": tick, "blocks": blocks, "moe": _dist_moe(torch),
            "launches": {op: sum(t["launches"][op] for t in tick.values())
                         for op in CYCLE_OPS}}


def phase_dist_ranks(torch, np, ops_mod, dft, autocorr, tick_states,
                     tick_times):
    """Phase 10(b): B1 and B2 bit-equal on row blocks (``_blocks_bit_equal``),
    then DIST_RANKS ranks spawned on the one card (``_dist_body``), each
    running the sharded tick against phase 3's decisions and its share of
    the expert-parallel MoE layer. The parent joins every rank (a failed
    rank fails the run), then holds B1 and B2 to their plain versions at
    every row-block shape the ranks launched them on (``_hold_captured``,
    phase 2's checks). Returns (the ranks' launches together, numbers to
    keep)."""
    plans = _blocks_bit_equal(torch, dft, autocorr)
    ranks, launches, wall = _spawn_ranks(
        torch, ops_mod, _dist_body, DIST_RANKS,
        lambda work: np.savez(
            work / "tick_states.npz",
            steady_remain=tick_states["steady_remain"],
            **{f"{t}/{k}": tick_states[t][k]
               for t in ("cold", "steady", "full") for k in TICK_KEYS}))
    for r, rec in enumerate(ranks):
        for o in (0, 1):
            t = rec["tick"][f"overlap_{o}"]
            print(f"[dist] rank {r} tick shards={DIST_RANKS} overlap {o}: "
                  f"cold {t['tick_cold_s']:.4f} s, steady "
                  f"{t['tick_steady_s']:.4f} s, full refit "
                  f"{t['tick_full_s']:.4f} s (phase 3 unsharded: "
                  f"{tick_times['tick_cold_s']:.4f}, "
                  f"{tick_times['tick_steady_s']:.4f}, "
                  f"{tick_times['tick_full_s']:.4f}); B1/B2 launches "
                  f"{t['launches']}; cold, steady and full decisions "
                  f"bit-identical to phase 3's")
        mo = rec["moe"]
        print(f"[dist] rank {r} MoE layer ({MOE_ARCH} full width, mesh "
              f"{DIST_MOE_MESH}): f32 at capacity E/K against the local "
              f"path max abs err {mo['f32_max_abs_err']:.6g} (peak "
              f"{mo['f32_peak']:.4f}), aux err {mo['f32_aux_err']:.3g}; f32 "
              f"at the config's capacity ({mo['drop_capacity']}) on tokens "
              f"sharing a direction: dropped {mo['drops']} of "
              f"{mo['drop_pairs']} pairs (the local path on this rank's "
              f"slice {mo['local_drops']}), max abs err "
              f"{mo['drop_max_abs_err']:.6g} (peak {mo['drop_peak']:.4f}), "
              f"aux err {mo['drop_aux_err']:.3g}; bf16 "
              f"{DIST_TIMED_TOKENS[0]} x {DIST_TIMED_TOKENS[1]} tokens "
              f"(gloo, through the host): host {mo['bf16_host_ms']:.4f} ms, "
              f"events {mo['bf16_event_ms']:.4f} ms, split "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          mo["bf16_split_ms"].items())
              + f" ms; dropped pairs {mo['bf16_drops']} of "
              f"{mo['bf16_pairs']} (capacity {mo['bf16_capacity']}); peak "
              f"{mo['peak_gb']:.4f} GB")
    print(f"[dist] {DIST_RANKS} gloo ranks on one card: {wall:.4f} s "
          f"wall, spawn included")
    if not sum(sum(rec["moe"]["drops"]) for rec in ranks):
        raise AssertionError("expert-parallel MoE layer in f32 at the "
                             "config's capacity: no rank dropped a pair, "
                             "the drop check held nothing")
    seen = {"dft_power": [tuple(b) for rec in ranks
                          for b in rec["blocks"]["dft_power"]],
            "autocorr": [(J, N, tuple(lags)) for rec in ranks
                         for J, N, lags in rec["blocks"]["autocorr"]]}
    print("[dist] the ranks' row blocks, each held to its plain version:")
    _hold_captured(torch, seen, "dist")
    return launches, {"ranks_wall_s": wall, "ranks": ranks,
                      "b2_plans": [p._asdict() for p in plans]}


def phase_dist_one_rank(torch, ops_mod, cfg, params, batch):
    """Phase 10(a): the full-depth prefill of phase 9's model and batch
    through the expert-parallel path on one NCCL rank (a (1, 1) mesh: every
    collective the identity, C as on the local path), against the local prefill
    of the same batch: logits bit-equal, else (a difference to explain)
    within 1e-6 of the peak in f32 at 2 layers, which always runs. Returns
    (the counted prefill's launches, numbers to keep)."""
    import tempfile
    import torch.distributed as tdist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import dist, lm
    from repro_torch.train import make_prefill_step

    B, S = batch["tokens"].shape
    prefill = make_prefill_step(cfg, S + MOE_STEPS)

    def timed(p, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p, b)
        torch.cuda.synchronize()
        del cache
        return logits, time.perf_counter() - t0

    local, t_local = timed(params, batch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                 rank=0, world_size=1)
        try:
            mesh = meshlib.make_host_mesh(1, 1)
            ctx = dist.DistContext(mesh, meshlib.batch_axes(mesh))
            for axis in mesh.mesh_dim_names:     # NCCL sets up lazily
                tdist.all_reduce(torch.zeros(1, device="cuda"),
                                 group=mesh.get_group(axis))
            torch.cuda.synchronize()
            ops_mod.reset_launch_counts()
            with dist.use(ctx):
                ep, t_ep = timed(params, batch)
            launches = ops_mod.launch_counts()
            torch.cuda.empty_cache()
            # f32, 2 layers at full width, prompt 1,024
            cfg32 = cfg.replace(num_layers=2, param_dtype="float32")
            p32 = lm.init_params(cfg32, SEED, device="cuda")
            b32 = {"tokens": batch["tokens"][:2, :1024]}
            pre32 = make_prefill_step(cfg32, 1024)
            want32, _ = pre32(p32, b32)
            with dist.use(ctx):
                got32, _ = pre32(p32, b32)
            del p32
        finally:
            tdist.destroy_process_group()
    equal = torch.equal(local, ep)
    err = float((local.float() - ep.float()).abs().max())
    err32 = float((got32 - want32).abs().max())
    peak32 = float(want32.abs().max())
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"expert-parallel prefill launched {launches}")
    if err32 > 1e-6 * peak32 or not bool(torch.isfinite(ep.float()).all()):
        raise AssertionError(f"expert-parallel prefill on one rank: f32 "
                             f"logits err {err32} on a peak of {peak32}")
    print(f"[dist] {cfg.name} prefill {B} x {S} through the expert-parallel "
          f"path on one NCCL rank: {t_ep:.4f} s (local path {t_local:.4f} "
          f"s); logits {'bit-equal' if equal else f'differ, max abs {err}'}"
          f"; B5 launches {launches['flash_attention']}; f32 at 2 layers, "
          f"prompt 1,024: max abs err {err32:.3g} (peak {peak32:.4f})")
    if not equal:
        print(f"[dist] finding: the one-rank expert-parallel logits differ "
              f"from the local path's by {err}; held in f32 above")
    return launches, {"prefill_local_s": t_local, "prefill_ep_s": t_ep,
                      "logits_bit_equal": equal, "logits_max_abs_err": err,
                      "f32_2layer_max_abs_err": err32,
                      "f32_2layer_peak": peak32}


# ---------------------------------------------------------------------------
# phase 11: the model on a (data, model) mesh, four gloo ranks on the card
# ---------------------------------------------------------------------------
TP_RANKS = 4
TP_MESH, TP_DST_MESH = (2, 2), (1, 4)        # ("data", "model")
TP_DEVICE = "cuda"
TP_STEPS = 2                  # counted train steps, after a warm-up
TP_PROMPT, TP_DECODE = 4096, 4                # prefill 4 x 4,096, then greedy
TP_F32_LAYERS, TP_F32_SEQ = 2, 512            # the f32 step against local
TP_ELASTIC_LAYERS = 8                         # the rescale's depth
TP_PCFG = dict(block_elems=1 << 14, max_rounds=4, stop_dirty_blocks=0,
               steps_per_round=1)
# The mesh's first bf16 step against phase 8's local one (same seed, same
# batch): the loss within 2e-3 and the grad norm within 2e-2, relative.
# The mesh sums its data ranks' bf16 gradients (each rounded once more)
# and reduces in another order; a wrong collective (a gradient counted
# twice, a vocabulary block missed) moves the norm by a factor.
TP_TRAIN_RTOL = dict(loss=2e-3, grad_norm=2e-2)
# f32, 2 layers at full width, one AdamW step, mesh against the local path
# on the card: loss and grad norm within 1e-5 (relative), each leaf of the
# first moment within 1e-5 of its largest magnitude, each param within
# 1e-5 of its leaf's largest magnitude where the local first moment
# settles the update's sign (``_train_errors``' rule: elsewhere a first
# AdamW step may take either sign).
TP_F32_TOL = 1e-5
# greedy decode against the local path (teacher-forced with the mesh's
# tokens): equal wherever the local top-2 logit margin exceeds this; a
# near tie may break either way in bf16, as ``_judge_routing`` counts
TP_GREEDY_MARGIN = 0.25


def _tp_batch(torch, corpus, step: int):
    return {k: torch.from_numpy(v.copy()).to(TP_DEVICE)
            for k, v in corpus.batch_at(step).items()}


@contextlib.contextmanager
def _collective_ms(torch, tdist, box, telemetry=None):
    """Host ms, calls and input bytes of every collective call by kind
    while the block runs, the card synchronised before and after each
    (gloo stages CUDA tensors through the host). With ``telemetry`` the
    calls made inside ``train.steps.dirty_block_stats`` also go there (they
    stay in ``box``)."""
    from repro_torch.train import steps as steps_mod
    names = ("all_reduce", "all_gather_into_tensor", "all_to_all_single")
    orig = {n: getattr(tdist, n) for n in names}
    stats = steps_mod.dirty_block_stats
    boxes = [box]

    def wrap(n):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[n](*args, **kw)
            torch.cuda.synchronize()
            t0 = args[1] if n != "all_reduce" else args[0]
            for b in boxes:
                rec = b.setdefault(n, {"ms": 0.0, "calls": 0, "bytes": 0})
                rec["ms"] += 1e3 * (time.perf_counter() - t)
                rec["calls"] += 1
                rec["bytes"] += t0.numel() * t0.element_size()
            return out
        return run

    def stats_apart(*args, **kw):
        boxes.append(telemetry)
        try:
            return stats(*args, **kw)
        finally:
            boxes.pop()

    for n in names:
        setattr(tdist, n, wrap(n))
    if telemetry is not None:
        steps_mod.dirty_block_stats = stats_apart
    try:
        yield
    finally:
        for n in names:
            setattr(tdist, n, orig[n])
        steps_mod.dirty_block_stats = stats


def _tp_state(torch, cfg, mesh):
    """This rank's slices of phase 8's seeded training state: the full
    params drawn on the card from SEED (the same draw on every rank), cut
    by ``launch/sharding``, the rest freed; the optimizer state made from
    the slices (equal to the full state's slices)."""
    from repro_torch import optim
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    full = lm.init_params(cfg, SEED, device=TP_DEVICE)
    params = sharding.param_shardings(mesh, full)
    del full
    gc.collect()
    if TP_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"params": params, "opt": optim.init_opt_state(cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=TP_DEVICE)}


def _tp_setup(cfg, mesh):
    from repro_torch.launch import sharding
    from repro_torch.models import dist
    return dist.model_context(mesh, cfg.seq_shard), dict(
        constrain=sharding.make_constrain(mesh, cfg),
        constrain_logits=sharding.make_constrain_logits(mesh))


def _kernel_layers(cfg) -> dict:
    """The layers of ``cfg`` that launch B5 (attention: the shared block
    once a group) and B4 (Mamba2, RWKV6): one launch each a forward."""
    from repro_torch.models import lm
    kinds = [kind for kind, *_ in lm._layers(
        cfg, lm.init_params(cfg, device="meta"))]
    return {"flash_attention": sum(k in lm.ATTN_KINDS for k in kinds),
            "ssm_scan": sum(k in ("mamba", "rwkv") for k in kinds)}


def _check_launches(n: dict, want: dict, what: str) -> None:
    bad = {k: (n[k], w) for k, w in want.items() if n[k] != w}
    if bad:
        raise AssertionError(f"{what}: launches (got, want) {bad}")


def _tp_train(torch, ops_mod, counted, first, rank, arch=TRAIN_ARCH,
              layers=None, steps=TP_STEPS, held=tuple(TP_TRAIN_RTOL),
              mesh_shape=TP_MESH, warmup=True):
    """The full-width trainer of phase 8 (``arch``, full depth or
    ``layers`` deep) on a ``mesh_shape`` mesh: a warm-up step whose
    ``held`` metrics are held to the local first step (``first``; the
    others are reported beside it), then ``steps`` counted steps, the last
    with every collective timed; without ``warmup`` the first counted step
    is the one held. Each step launches B5 and B4 twice a layer that runs
    them (block remat) and B3 on the rank's slices."""
    import torch.distributed as tdist
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import dist
    from repro_torch.train import make_train_step

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    mesh = meshlib.make_host_mesh(*mesh_shape, device=TP_DEVICE)
    ctx, hooks = _tp_setup(cfg, mesh)
    want = {k: 2 * n for k, n in _kernel_layers(cfg).items()}
    t0 = time.perf_counter()
    state = _tp_state(torch, cfg, mesh)
    t_init = time.perf_counter() - t0
    want["dirty_blocks"] = _scan_launches(len(tree.leaves(state["params"])))
    corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    step = make_train_step(cfg, telemetry=True, **hooks)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"init_s": t_init, "state_gb": sum(
        t.numel() * t.element_size() for t in tree.leaves(state)) / 1e9}

    def batch(i):
        return sharding.batch_shardings(mesh, _tp_batch(torch, corpus, i))

    def hold(m):
        got = {k: float(m[k]) for k in ("loss", "grad_norm")}
        out["first"] = got
        for k in held:
            tol = TP_TRAIN_RTOL[k]
            if not abs(got[k] - first[k]) <= tol * abs(first[k]):
                raise AssertionError(f"rank {rank}: the mesh's first step "
                                     f"{k} {got[k]} against the local "
                                     f"step's {first[k]}")

    with dist.use(ctx):
        out["warmup_s"] = 0.0
        if warmup:
            t0 = time.perf_counter()
            with counted():
                state, m = step(state, batch(0))
            _check_launches(ops_mod.launch_counts(), want,
                            f"rank {rank} {arch} warm-up step")
            torch.cuda.synchronize()
            out["warmup_s"] = time.perf_counter() - t0
            hold(m)
        rows, coll, telemetry = [], {}, {}
        for n_step in range(steps):
            i = int(state["step"])
            b = batch(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops_mod.reset_launch_counts()
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            # the last step times every collective (gloo moves a CUDA
            # tensor through the host, which syncs the card anyway), those
            # of its dirty-block telemetry also apart
            timer = _collective_ms(torch, tdist, coll, telemetry) \
                if n_step == steps - 1 else contextlib.nullcontext()
            with counted(), timer:
                a.record()
                state, m = step(state, b)
                e.record()
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
            n = ops_mod.launch_counts()
            row = {"step": i, "host_ms": 1e3 * host,
                   "event_ms": a.elapsed_time(e),
                   "tokens_per_s": tokens / host,
                   "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "dirty_fraction": float(m["dirty_fraction"]),
                   "b5_launches": n["flash_attention"],
                   "b4_launches": n["ssm_scan"],
                   "b3_launches": n["dirty_blocks"],
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            rows.append(row)
            _check_launches(n, want, f"rank {rank} {arch} mesh step {i}")
            if not warmup and n_step == 0:
                hold(m)
            if not math.isfinite(row["loss"]):
                raise AssertionError(f"rank {rank} {arch} mesh step {i}: "
                                     f"loss {row['loss']}")
    out.update(steps=rows, collectives=coll,
               collectives_telemetry=telemetry)
    del state
    return out


def _tp_serve(torch, ops_mod, counted, rank, arch=TRAIN_ARCH, dtype=None,
              hold=True, prompt_len=TP_PROMPT, mesh_shape=TP_MESH,
              cache_len=None, collectives=False):
    """Prefill 4 x ``prompt_len`` of ``arch`` (in ``dtype``, else the
    config's) on a ``mesh_shape`` mesh (the cache, of ``cache_len`` or
    the prompt and the decode steps, in the rank's layout; B5 and B4 once a
    layer that runs them), then TP_DECODE greedy steps; rank 0 then runs
    the local path teacher-forced with the mesh's tokens and holds every
    token whose local top-2 margin exceeds TP_GREEDY_MARGIN (without
    ``hold`` it counts the tokens that differ there instead). With
    ``collectives`` every collective of the prefill and of the decode
    steps is timed by kind (``_collective_ms``), and each part's peak
    read."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import dist, lm
    from repro_torch.train import make_decode_step, make_prefill_step

    import torch.distributed as tdist
    cfg = get_config(arch)
    if dtype:
        cfg = cfg.replace(param_dtype=dtype)
    cache_len = cache_len or prompt_len + TP_DECODE
    mesh = meshlib.make_host_mesh(*mesh_shape, device=TP_DEVICE)
    ctx, hooks = _tp_setup(cfg, mesh)
    dec_ctx = dist.model_context(mesh, False,
                                 kv_window=lm._kv_window(cfg, cache_len))
    params = _tp_state(torch, cfg, mesh)["params"]
    g = torch.Generator(device=TP_DEVICE).manual_seed(SEED + 11)
    prompt = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, prompt_len),
                           generator=g, device=TP_DEVICE, dtype=torch.int32)
    rows = sharding.batch_pspec(mesh, ("logits",), prompt[:, :1])
    mine = sharding.batch_shardings(mesh, {"tokens": prompt})
    prefill = make_prefill_step(cfg, cache_len, constrain=hooks["constrain"])
    decode = make_decode_step(cfg, constrain=hooks["constrain"])
    out, logits_all, toks = {}, [], []
    coll = {"prefill": {}, "decode": {}}

    def timer(part):
        return (_collective_ms(torch, tdist, coll[part]) if collectives
                else contextlib.nullcontext())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted(), dist.use(ctx), timer("prefill"):
        logits, cache = prefill(params, mine)
    _check_launches(ops_mod.launch_counts(), _kernel_layers(cfg),
                    f"rank {rank} {arch} prefill")
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["cache_gb"] = sum(t.numel() * t.element_size()
                          for t in tree.leaves(cache)) / 1e9
    dec_ms = []
    for s in range(TP_DECODE + 1):
        full = sharding.gather_leaf(mesh, rows, logits.float())
        logits_all.append(full)
        nxt = full.argmax(dim=-1).to(torch.int32)[:, None]
        toks.append(nxt)
        if s == TP_DECODE:
            break
        tok = sharding.batch_shardings(mesh, {"tokens": nxt})["tokens"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted(), dist.use(dec_ctx), timer("decode"):
            _, logits, cache = decode(params, tok, cache)
        torch.cuda.synchronize()
        dec_ms.append(1e3 * (time.perf_counter() - t0))
    out["decode_ms"] = dec_ms
    out["collectives"] = coll
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["tokens"] = torch.cat(toks, 1).tolist()
    del params, cache
    torch.cuda.empty_cache()
    if rank == 0:                      # the local path, alone on the card
        full_p = lm.init_params(cfg, SEED, device=TP_DEVICE)
        pre = make_prefill_step(cfg, cache_len)
        dec = make_decode_step(cfg)
        want, cache = pre(full_p, {"tokens": prompt})
        held = ties = differ = 0
        err = 0.0
        for s in range(TP_DECODE + 1):
            want = want.float()
            err = max(err, float((want - logits_all[s]).abs().max()))
            top2 = want.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            same = want.argmax(dim=-1) == toks[s][:, 0].long()
            sure = margin > TP_GREEDY_MARGIN
            if hold and bool((sure & ~same).any()):
                raise AssertionError(f"greedy step {s}: the mesh's tokens "
                                     f"{toks[s][:, 0].tolist()} against the "
                                     f"local path's {want.argmax(-1).tolist()}"
                                     f" at margins {margin.tolist()}")
            held += int(sure.sum())
            ties += int((~sure).sum())
            differ += int((sure & ~same).sum())
            if s < TP_DECODE:
                _, want, cache = dec(full_p, toks[s], cache)
        if held < 1:
            raise AssertionError("greedy decode: every position a near tie; "
                                 "the check held nothing")
        out.update(greedy_held=held, greedy_ties=ties, greedy_differ=differ,
                   logits_max_abs_err=err)
        del full_p, cache
        torch.cuda.empty_cache()
    return out


def _tp_f32(torch, counted, rank, arch=TRAIN_ARCH, layers=TP_F32_LAYERS,
            tol=TP_F32_TOL, mesh_shape=TP_MESH, logits=False):
    """One f32 AdamW step of ``arch`` at full width, ``layers`` deep, on a
    ``mesh_shape`` mesh against the local step on the card: rank 0
    compares every gathered leaf and returns the verdict, within ``tol``,
    as ``ok`` (the parent raises on it after printing). With ``logits`` a
    prefill of the step's batch first, its last logits held to the local
    prefill's within ``tol`` of their largest magnitude
    (``logits_err``)."""
    from repro_torch import optim, tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import dist, lm
    from repro_torch.train import make_prefill_step, make_train_step

    cfg = get_config(arch).replace(num_layers=layers,
                                   param_dtype="float32")
    mesh = meshlib.make_host_mesh(*mesh_shape, device=TP_DEVICE)
    ctx, hooks = _tp_setup(cfg, mesh)
    corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TP_F32_SEQ, seed=SEED)
    b = _tp_batch(torch, corpus, 0)
    full = lm.init_params(cfg, SEED, device=TP_DEVICE)
    zero = torch.zeros((), dtype=torch.int32, device=TP_DEVICE)
    params = sharding.param_shardings(mesh, full)
    mine = {"params": params, "opt": optim.init_opt_state(cfg, params),
            "step": zero}
    prompt = {k: v for k, v in b.items() if k != "targets"}
    if logits:
        rows = sharding.batch_pspec(mesh, ("logits",), b["tokens"][:, :1])
        with counted(), dist.use(ctx):
            last, _ = make_prefill_step(cfg, TP_F32_SEQ,
                                        constrain=hooks["constrain"])(
                params, sharding.batch_shardings(mesh, prompt))
        last = sharding.gather_leaf(mesh, rows, last)
    with counted(), dist.use(ctx):
        got, mg = make_train_step(cfg, **hooks)(
            mine, sharding.batch_shardings(mesh, b))
    del mine, params
    want = mw = logits_err = None
    if rank == 0:
        if logits:
            ref_last, _ = make_prefill_step(cfg, TP_F32_SEQ)(full, prompt)
            logits_err = float((last - ref_last).abs().max()) / max(
                float(ref_last.abs().max()), 1e-30)
            del ref_last
        want, mw = make_train_step(cfg)(
            {"params": full, "opt": optim.init_opt_state(cfg, full),
             "step": zero}, b)
    del full
    specs = sharding.leaf_specs(mesh, lm.init_params(cfg, device="meta"))
    errs = {"param": 0.0, "moment": 0.0, "settled": 0, "elements": 0}
    for key in ("params", "m"):
        leaves = tree.leaves(got["params"] if key == "params"
                             else got["opt"]["m"])
        if rank == 0:
            wants = tree.leaves(want["params"] if key == "params"
                                else want["opt"]["m"])
            moments = tree.leaves(want["opt"]["m"])
        for i, (leaf, spec) in enumerate(zip(leaves, specs)):
            whole = sharding.gather_leaf(mesh, spec, leaf)
            if rank != 0:
                continue
            w = wants[i]
            peak = max(float(w.abs().max()), 1e-30)
            diff = (whole.float() - w.float()).abs()
            if key == "m":
                errs["moment"] = max(errs["moment"], float(diff.max()) / peak)
                continue
            mom = moments[i]
            settled = mom.abs() > max(2 * tol * float(mom.abs().max()),
                                      1e-7)
            if bool(settled.any()):
                errs["param"] = max(errs["param"],
                                    float(diff[settled].max()) / peak)
            errs["settled"] += int(settled.sum())
            errs["elements"] += w.numel()
    out = {"loss": float(mg["loss"]), "grad_norm": float(mg["grad_norm"])}
    if rank == 0:
        out.update(errs, want_loss=float(mw["loss"]),
                   want_grad_norm=float(mw["grad_norm"]))
        bad = [k for k in ("loss", "grad_norm")
               if abs(out[k] - out["want_" + k]) > tol * abs(
                   out["want_" + k])]
        out["logits_err"] = logits_err
        out["ok"] = not (bad or errs["param"] > tol or
                         errs["moment"] > tol or errs["settled"] < 1
                         or (logits and not logits_err <= tol))
        out["tol"] = tol
    del got, want
    torch.cuda.empty_cache()
    return out


def _state_shapes(cfg):
    """The full training state's shapes (meta tensors)."""
    from repro_torch.train import init_train_state
    return init_train_state(cfg, device="meta")


def _tp_elastic(torch, tdist, ops_mod, counted, rank):
    """``elastic.rescale`` of the TP_ELASTIC_LAYERS-deep internlm2 state from
    TP_MESH to TP_DST_MESH while the source trains (one step a round, the
    dirty counts summed over the ranks): each destination slice held bit
    for bit against the slice cut from the gathered source at the stop,
    then one step on the destination mesh."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import precopy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import dist
    from repro_torch.runtime import elastic
    from repro_torch.train import make_train_step

    cfg = get_config(TRAIN_ARCH).replace(num_layers=TP_ELASTIC_LAYERS)
    src = meshlib.make_host_mesh(*TP_MESH, device=TP_DEVICE)
    dst = meshlib.make_host_mesh(*TP_DST_MESH, device=TP_DEVICE)
    (ctx, hooks), (d_ctx, d_hooks) = _tp_setup(cfg, src), _tp_setup(cfg, dst)
    corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    step = make_train_step(cfg, telemetry=True, **hooks)
    box = {"state": _tp_state(torch, cfg, src)}

    def step_once(st):
        b = sharding.batch_shardings(src, _tp_batch(torch, corpus,
                                                    int(st["step"])))
        with dist.use(ctx):
            box["state"], m = step(st, b)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError("loss not finite during the rescale")
        return box["state"]

    scans = {"host_ms": []}
    scan = precopy.dirty_scan

    def timed_scan(live, shadow, block):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = scan(live, shadow, block)
        torch.cuda.synchronize()
        scans["host_ms"].append(1e3 * (time.perf_counter() - t))
        return res

    precopy.dirty_scan = timed_scan
    try:
        t0 = time.perf_counter()
        with counted():
            got, rep = elastic.rescale(cfg, box["state"], step_once, dst,
                                       src=src,
                                       pcfg=precopy.PrecopyConfig(**TP_PCFG))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        precopy.dirty_scan = scan
    shapes = _state_shapes(cfg)
    equal = True
    for leaf, a, b, mine in zip(tree.leaves(box["state"]),
                                sharding.leaf_specs(src, shapes),
                                sharding.leaf_specs(dst, shapes),
                                tree.leaves(got)):
        want = sharding.local_slice(dst, b, sharding.gather_leaf(src, a,
                                                                 leaf))
        equal = equal and _same_bytes(torch, want, mine)
    flag = torch.tensor([int(equal)], device=TP_DEVICE)
    tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
    if not bool(flag.item()):
        raise AssertionError(f"rank {rank}: the rescaled state differs from "
                             "the source's slices at the stop")
    n_steps = int(box["state"]["step"])
    del box
    torch.cuda.empty_cache()
    b = sharding.batch_shardings(dst, _tp_batch(torch, corpus,
                                                int(got["step"])))
    with counted(), dist.use(d_ctx):
        got, m = make_train_step(cfg, telemetry=True, **d_hooks)(got, b)
    if not math.isfinite(float(m["loss"])) or int(got["step"]) != n_steps + 1:
        raise AssertionError(f"destination step {int(got['step'])}, loss "
                             f"{float(m['loss'])}")
    o = rep.precopy.outcome
    return {"rounds": o.rounds, "stop_reason": o.stop_reason,
            "per_round_bytes": rep.precopy.per_round_dirty_bytes,
            "v_mem": rep.precopy.v_mem,
            "bytes_sent_over_v_mem": o.bytes_sent / rep.precopy.v_mem,
            "source_steps": n_steps, "scan_host_ms": scans["host_ms"],
            "relayout_s": rep.relayout_seconds, "wall_s": wall,
            "devices": [rep.src_devices, rep.dst_devices],
            "dst_loss": float(m["loss"])}


def _tp_body(torch, ops, rank, work):
    """Phase 11's rank: train, serve, the f32 check and the rescale
    (``_tp_train``, ``_tp_serve``, ``_tp_f32``, ``_tp_elastic``)."""
    import torch.distributed as tdist
    first = json.loads((work / "first_step.json").read_text())
    # the mesh's own work: the local references a rank computes are left
    # out of ``seen`` and ``launches``
    seen, launches = collections.defaultdict(list), {}
    counted = functools.partial(_recording, ops, seen, launches)
    out = {"train": _tp_train(torch, ops, counted, first, rank)}
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = _tp_serve(torch, ops, counted, rank)
    out["f32"] = _tp_f32(torch, counted, rank)
    gc.collect()
    torch.cuda.empty_cache()
    out["elastic"] = _tp_elastic(torch, tdist, ops, counted, rank)
    out["launches"] = launches
    out["b5_shapes"] = sorted(set(seen["flash_attention"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _hold_attention(torch, seen, tag: str):
    """Phase 7's B5 check (``_attn_check`` against ``ref.attention_ref``)
    on seeded inputs at each distinct (B, H, Hkv, S, D, dtype, window) in
    ``seen``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for B, H, Hkv, S, D, dtype, window in sorted(seen):
        dt = getattr(torch, dtype.split(".")[-1])
        q, k, v = _attn_inputs(torch, g, B, H, Hkv, S, D, dt)
        got = fa.flash_attention(q, k, v, window)
        err, use = _attn_check(torch, ref, got, q, k, v, window,
                               f"{tag} ({B}, {H}, {Hkv}, {S}, {D}) {dtype}")
        print(f"[{tag}] B5 at a rank's shape (B {B}, H {H}, Hkv {Hkv}, S "
              f"{S}, D {D}, {dtype}, window {window}) against "
              f"attention_ref: max abs err {err:.6g}, {use:.4f} of the "
              f"limit")
        del q, k, v, got
        torch.cuda.empty_cache()


def phase_tp_ranks(torch, ops_mod, first_step):
    """Phase 11: TP_RANKS ranks spawned on the one card (gloo; NCCL refuses
    ranks that share a card), each running full-width internlm2 on a
    TP_MESH ``(data, model)`` mesh (``_tp_body``): training held to phase
    8's first step (``first_step``), a prefill and greedy decode held to
    the local path, an f32 step held to the local one, and
    ``elastic.rescale`` onto TP_DST_MESH. The parent joins every rank (a
    failed rank fails the run), requires every rank to take the same
    rescale rounds, then holds B5 at every shape the ranks launched it at.
    Returns (the ranks' launches together, numbers to keep)."""
    ranks, launches, wall = _spawn_ranks(
        torch, ops_mod, _tp_body, TP_RANKS,
        lambda work: (work / "first_step.json").write_text(
            json.dumps(first_step)))
    keys = ("rounds", "stop_reason", "per_round_bytes", "source_steps")
    if any([r["elastic"][k] for k in keys] !=
           [ranks[0]["elastic"][k] for k in keys] for r in ranks):
        raise AssertionError("the ranks took different rescale rounds: "
                             + str([[r["elastic"][k] for k in keys]
                                    for r in ranks]))
    for r, rec in enumerate(ranks):
        tr = rec["train"]
        print(f"[tp] rank {r} {TRAIN_ARCH} full width and depth on "
              f"{TP_MESH} (data, model), bf16, AdamW, block remat, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: state {tr['state_gb']:.4f}"
              f" GB a rank, init {tr['init_s']:.4f} s, warm-up "
              f"{tr['warmup_s']:.4f} s, first step loss "
              f"{tr['first']['loss']:.6f} grad norm "
              f"{tr['first']['grad_norm']:.6f} (phase 8: "
              f"{first_step['loss']:.6f}, {first_step['grad_norm']:.6f})")
        for row in tr["steps"]:
            print(f"[tp] rank {r} step {row['step']}: host "
                  f"{row['host_ms']:.4f} ms, events {row['event_ms']:.4f} ms,"
                  f" {row['tokens_per_s']:.1f} tokens/s, loss "
                  f"{row['loss']:.6f}, grad norm {row['grad_norm']:.6f}, "
                  f"dirty fraction {row['dirty_fraction']:.6f}, B5 "
                  f"{row['b5_launches']}, B3 {row['b3_launches']}, peak "
                  f"{row['peak_gb']:.4f} GB")
        print(f"[tp] rank {r} step {tr['steps'][-1]['step']}'s "
              f"collectives, each between two syncs of the card: "
              + ", ".join(
                  f"{k} {v['calls']} calls {v['ms']:.4f} ms "
                  f"{v['bytes'] / 1e9:.4f} GB"
                  for k, v in tr["collectives"].items()))
        sv = rec["serve"]
        print(f"[tp] rank {r} prefill {TRAIN_BATCH} x {TP_PROMPT}: "
              f"{sv['prefill_s']:.4f} s, cache block {sv['cache_gb']:.4f} "
              f"GB; decode ms {[round(t, 4) for t in sv['decode_ms']]}")
        el = rec["elastic"]
        print(f"[tp] rank {r} rescale ({TP_ELASTIC_LAYERS} layers) "
              f"{TP_MESH} -> {TP_DST_MESH}: {el['rounds']} rounds, stop "
              f"{el['stop_reason']}, bytes sent / v_mem "
              f"{el['bytes_sent_over_v_mem']:.6f}, per-round bytes "
              f"{el['per_round_bytes']}, scans ms "
              f"{[round(t, 4) for t in el['scan_host_ms']]}, re-layout "
              f"{el['relayout_s']:.4f} s, wall {el['wall_s']:.4f} s; "
              f"destination bit-equal, steps on: loss {el['dst_loss']:.6f};"
              f" peak {rec['peak_gb']:.4f} GB; launches {rec['launches']}")
    sv, f32 = ranks[0]["serve"], ranks[0]["f32"]
    print(f"[tp] greedy tokens {sv['tokens']}: equal to the local path's "
          f"at {sv['greedy_held']} positions whose margin exceeds "
          f"{TP_GREEDY_MARGIN} ({sv['greedy_ties']} near ties not held); "
          f"logits max abs err {sv['logits_max_abs_err']:.6g}")
    print(f"[tp] f32, {TP_F32_LAYERS} layers, {TRAIN_BATCH} x {TP_F32_SEQ}:"
          f" loss {f32['loss']:.8f} (local {f32['want_loss']:.8f}), grad "
          f"norm {f32['grad_norm']:.8f} (local {f32['want_grad_norm']:.8f}),"
          f" first moment err {f32['moment']:.6g} of its leaf's peak, "
          f"params err {f32['param']:.6g} of their leaf's peak on the "
          f"{f32['settled'] / f32['elements']:.4f} settled (limit "
          f"{TP_F32_TOL})")
    print(f"[tp] {TP_RANKS} gloo ranks on one card: {wall:.4f} s wall, spawn "
          f"included")
    if not f32["ok"]:
        raise AssertionError(f"f32 step on the mesh against the local step "
                             f"beyond {TP_F32_TOL}: {f32}")
    seen = {tuple(s) for rec in ranks for s in rec["b5_shapes"]}
    _hold_attention(torch, seen, "tp")
    return launches, {"ranks_wall_s": wall, "ranks": ranks,
                      "b5_shapes": sorted(seen)}


# ---------------------------------------------------------------------------
# phase 12: the SSM and hybrid wirings on a (data, model) mesh
# ---------------------------------------------------------------------------
SSM_TP_TRAIN_LAYERS = 12        # zamba2's train step: 2 of its 9 groups
# the f32 steps against the local ones: (arch, layers, tolerance). rwkv6's
# 2-layer f32 gradient on an H100 moves by 1.3e-3 (its grad norm) and
# 1.8e-3 of a leaf's peak when its weights take 1e-7 relative noise
# (``scripts/torch_rwkv6_conditioning.py --device cuda --layers 2
# --batch 4 --seq 512``), so two correct evaluations cannot agree within
# TP_F32_TOL there: it is held at 5e-3. zamba2's group keeps TP_F32_TOL.
SSM_TP_F32 = ((RWKV_ARCH, 2, 5e-3), (SSM_ARCH, 6, TP_F32_TOL))
SSM_TP_F32_PROMPT = 1024        # rwkv6's f32 prefill, whose tokens are held
# rwkv6 at the seeded init amplifies a perturbation through its 24 layers
# (ROADMAP C-11): in bf16 the mesh's rounding, unlike the local path's,
# moves its logits by ~2 (this phase's bf16 greedy check, on an H100),
# and its first-step gradient explodes and is chaotic (on the CPU, one
# bf16 ulp in 1% of the weights moves the grad norm from 2.5e4 to 1.1e6,
# ``scripts/torch_rwkv6_conditioning.py --dtype bfloat16 --tokens
# uniform``; on an H100 the local step reads 1.1e8 where the mesh reads
# 499). So in bf16 its first step is held by the loss and its greedy
# tokens are counted, not held; the same prefill and decode in f32 hold
# its tokens, and the f32 step 2 layers deep (SSM_TP_F32) its gradients.


def phase_ssm_tp_first(torch):
    """The local first steps phase 12's mesh steps are held to, on the card
    before the ranks start (each state freed after): rwkv6 at full depth
    and zamba2 SSM_TP_TRAIN_LAYERS deep, bf16, seeded as the ranks seed
    theirs, batch 0 of TRAIN_BATCH x TRAIN_SEQ."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.train import init_train_state, make_train_step

    first = {}
    for arch, layers in ((RWKV_ARCH, None), (SSM_ARCH, SSM_TP_TRAIN_LAYERS)):
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        state = init_train_state(cfg, SEED, device="cuda")
        corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
        state, m = make_train_step(cfg, telemetry=True)(
            state, _train_batch(torch, corpus, 0))
        first[arch] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        print(f"[ssm-tp] {arch} {cfg.num_layers} layers, the local first "
              f"step on the card: loss {first[arch]['loss']:.6f}, grad norm "
              f"{first[arch]['grad_norm']:.6f}")
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
    return first


def _ssm_tp_body(torch, ops, rank, work):
    """Phase 12's rank, as in phase 11: rwkv6 trained and served (bf16,
    then f32) at full width and depth, zamba2 served at full width and
    depth and trained SSM_TP_TRAIN_LAYERS deep, then the f32 steps of
    SSM_TP_F32 against the local ones (their verdicts the parent reads)."""
    first = json.loads((work / "first_step.json").read_text())

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    seen, launches = collections.defaultdict(list), {}
    counted = functools.partial(_recording, ops, seen, launches)
    # training first, as in phase 11: its warm-up step takes the ranks'
    # first CUDA and gloo calls
    out = {"rwkv6_train": _tp_train(torch, ops, counted, first[RWKV_ARCH],
                                    rank, RWKV_ARCH, held=("loss",))}
    freed()
    out["rwkv6_serve"] = _tp_serve(torch, ops, counted, rank, RWKV_ARCH,
                                   hold=False)
    freed()
    out["rwkv6_serve_f32"] = _tp_serve(torch, ops, counted, rank, RWKV_ARCH,
                                       dtype="float32",
                                       prompt_len=SSM_TP_F32_PROMPT)
    freed()
    out["zamba2_serve"] = _tp_serve(torch, ops, counted, rank, SSM_ARCH)
    freed()
    out["zamba2_train"] = _tp_train(torch, ops, counted, first[SSM_ARCH],
                                    rank, SSM_ARCH,
                                    layers=SSM_TP_TRAIN_LAYERS, steps=0)
    freed()
    for arch, layers, tol in SSM_TP_F32:
        out[f"{arch}_f32"] = _tp_f32(torch, counted, rank, arch, layers,
                                     tol=tol)
        freed()
    out["launches"] = launches
    out["b5_shapes"] = sorted(set(seen["flash_attention"]))
    out["b4_shapes"] = sorted(set(seen["ssm_scan"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _hold_scans(torch, seen, tag: str):
    """Phase 6's B4 check on seeded inputs (``_scan_case``, its q/k shared
    over heads for "mamba", a bonus for "rwkv") at each distinct (B, H, S,
    Dk, Dv, dtype, kind, initial state) in ``seen``: against
    ``gla.gla_chunked`` within ``_scan_err``'s tolerances, bit-equal on a
    second launch."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import gla
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for B, H, S, Dk, Dv, dtype, kind, init in sorted(seen):
        dt = getattr(torch, dtype.split(".")[-1])
        ins, u, s0 = _scan_case(torch, g, kind, B, H, S, Dk, Dv, dtype=dt,
                                ssd=kind != "rwkv", init=init)
        got = ssm_scan.ssm_scan(*ins, u, s0)
        again = ssm_scan.ssm_scan(*ins, u, s0)
        want = gla.gla_chunked(*ins, bonus=u, initial_state=s0)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"[{tag}] ssm_scan not deterministic at "
                                 f"{(B, H, S, Dk, Dv)}")
        try:
            err, atol = _scan_err(torch, got, want)
        except AssertionError as e:
            raise AssertionError(f"[{tag}] ssm_scan disagrees at a rank's "
                                 f"shape {(B, H, S, Dk, Dv)} {kind}: {e}")
        print(f"[{tag}] B4 at a rank's shape (B {B}, H {H}, S {S}, Dk {Dk}, "
              f"Dv {Dv}, {dtype}, {kind}) against gla_chunked: max abs err "
              f"{err:.6g} (atol {atol:.3g}), bit-equal on a second launch")
        del ins, u, s0, got, again, want
        torch.cuda.empty_cache()


def phase_ssm_tp_ranks(torch, ops_mod):
    """Phase 12: the local first steps (``phase_ssm_tp_first``), then
    TP_RANKS ranks spawned on the card as in phase 11 (``_ssm_tp_body``).
    The parent joins every rank (a failed rank fails the run), requires
    every f32 step within its limit (SSM_TP_F32), then holds B4 and B5 at
    every shape the ranks launched them at. Returns (the ranks' launches
    together, numbers to keep)."""
    gc.collect()
    torch.cuda.empty_cache()
    first = phase_ssm_tp_first(torch)
    ranks, launches, wall = _spawn_ranks(
        torch, ops_mod, _ssm_tp_body, TP_RANKS,
        lambda work: (work / "first_step.json").write_text(json.dumps(first)))
    for r, rec in enumerate(ranks):
        for arch, key, dt, n in (
                (SSM_ARCH, "zamba2_serve", "bf16", TP_PROMPT),
                (RWKV_ARCH, "rwkv6_serve", "bf16", TP_PROMPT),
                (RWKV_ARCH, "rwkv6_serve_f32", "f32", SSM_TP_F32_PROMPT)):
            sv = rec[key]
            print(f"[ssm-tp] rank {r} {arch} full width and depth on "
                  f"{TP_MESH} (data, model), {dt}: prefill {TRAIN_BATCH} x "
                  f"{n} {sv['prefill_s']:.4f} s, cache block "
                  f"{sv['cache_gb']:.4f} GB; decode ms "
                  f"{[round(t, 4) for t in sv['decode_ms']]}")
        for key, what in (("rwkv6_train", f"{RWKV_ARCH} full depth"),
                          ("zamba2_train", f"{SSM_ARCH} "
                           f"{SSM_TP_TRAIN_LAYERS} layers")):
            tr = rec[key]
            arch = RWKV_ARCH if key == "rwkv6_train" else SSM_ARCH
            print(f"[ssm-tp] rank {r} {what} on {TP_MESH}, bf16, AdamW, "
                  f"block remat, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: state "
                  f"{tr['state_gb']:.4f} GB a rank, init {tr['init_s']:.4f} "
                  f"s, warm-up {tr['warmup_s']:.4f} s, first step loss "
                  f"{tr['first']['loss']:.6f} grad norm "
                  f"{tr['first']['grad_norm']:.6f} (local: "
                  f"{first[arch]['loss']:.6f}, {first[arch]['grad_norm']:.6f})")
            for row in tr["steps"]:
                print(f"[ssm-tp] rank {r} {arch} step {row['step']}: host "
                      f"{row['host_ms']:.4f} ms, events "
                      f"{row['event_ms']:.4f} ms, "
                      f"{row['tokens_per_s']:.1f} tokens/s, loss "
                      f"{row['loss']:.6f}, grad norm {row['grad_norm']:.6f},"
                      f" dirty fraction {row['dirty_fraction']:.6f}, B4 "
                      f"{row['b4_launches']}, B5 {row['b5_launches']}, B3 "
                      f"{row['b3_launches']}, peak {row['peak_gb']:.4f} GB")
            if tr["steps"]:
                print(f"[ssm-tp] rank {r} {arch} step "
                      f"{tr['steps'][-1]['step']}'s collectives, each between"
                      f" two syncs of the card: " + ", ".join(
                          f"{k} {v['calls']} calls {v['ms']:.4f} ms "
                          f"{v['bytes'] / 1e9:.4f} GB"
                          for k, v in tr["collectives"].items()))
        print(f"[ssm-tp] rank {r}: peak {rec['peak_gb']:.4f} GB, launches "
              f"{rec['launches']}")
    bad = []
    for arch, key, what in ((SSM_ARCH, "zamba2_serve", "bf16, held"),
                            (RWKV_ARCH, "rwkv6_serve", "bf16, counted"),
                            (RWKV_ARCH, "rwkv6_serve_f32", "f32, held")):
        sv = ranks[0][key]
        print(f"[ssm-tp] {arch} ({what}) greedy tokens {sv['tokens']}: "
              f"{sv['greedy_held'] - sv['greedy_differ']} of "
              f"{sv['greedy_held']} positions whose margin exceeds "
              f"{TP_GREEDY_MARGIN} equal to the local path's "
              f"({sv['greedy_ties']} near ties not held); logits max abs "
              f"err {sv['logits_max_abs_err']:.6g}")
    for arch, layers, _ in SSM_TP_F32:
        f32 = ranks[0][f"{arch}_f32"]
        print(f"[ssm-tp] {arch} f32, {layers} layers, {TRAIN_BATCH} x "
              f"{TP_F32_SEQ}: loss {f32['loss']:.8f} (local "
              f"{f32['want_loss']:.8f}), grad norm {f32['grad_norm']:.8f} "
              f"(local {f32['want_grad_norm']:.8f}), first moment err "
              f"{f32['moment']:.6g} of its leaf's peak, params err "
              f"{f32['param']:.6g} of their leaf's peak on the "
              f"{f32['settled'] / f32['elements']:.4f} settled (limit "
              f"{f32['tol']})")
        if not f32["ok"]:
            bad.append(arch)
    print(f"[ssm-tp] {TP_RANKS} gloo ranks on one card: {wall:.4f} s wall, "
          f"spawn included")
    if bad:
        raise AssertionError(f"f32 steps on the mesh against the local "
                             f"steps beyond their limits: {bad}")
    seen = {tuple(s) for rec in ranks for s in rec["b5_shapes"]}
    scans = {tuple(s) for rec in ranks for s in rec["b4_shapes"]}
    _hold_scans(torch, scans, "ssm-tp")
    _hold_attention(torch, seen, "ssm-tp")
    return launches, {"ranks_wall_s": wall, "first": first, "ranks": ranks,
                      "b4_shapes": sorted(scans), "b5_shapes": sorted(seen)}


# ---------------------------------------------------------------------------
# phase 15: the attention on a model axis that does not divide its heads
# ---------------------------------------------------------------------------
HEADS_RANKS = 8
HEADS_MESH = (1, 8)                  # ("data", "model")
HEADS_SERVE_ARCH = "qwen2_vl_2b"     # 12 query heads, 2 KV heads
HEADS_TRAIN_ARCH = "starcoder2_7b"   # 36 query heads, 4 KV heads
HEADS_TRAIN_LAYERS = 4
# the serving cache: the prompt, the decode steps and 4 slots more, so
# that the model axis cuts the ring (2 KV heads) along its window
HEADS_CACHE = TP_PROMPT + 8
# musicgen's 24 heads on the production mesh's 16-wide model axis (every
# rank all of them): its B5 shape, held on the card here; the (1, 8) mesh
# divides its heads, so its wiring on a mesh is held by the CPU tests
HEADS_MHA_SHAPE = (TRAIN_BATCH, 24, 24, TRAIN_SEQ, 64, "torch.bfloat16", 0)


def phase_heads_first(torch):
    """The local first step phase 15's mesh step is held to: starcoder2
    HEADS_TRAIN_LAYERS deep, bf16, seeded as the ranks seed theirs, batch
    0 of TRAIN_BATCH x TRAIN_SEQ, on the card before the ranks start (its
    state freed after)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config(HEADS_TRAIN_ARCH).replace(num_layers=HEADS_TRAIN_LAYERS)
    state = init_train_state(cfg, SEED, device="cuda")
    corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    state, m = make_train_step(cfg, telemetry=True)(
        state, _train_batch(torch, corpus, 0))
    first = {k: float(m[k]) for k in ("loss", "grad_norm")}
    print(f"[heads-tp] {HEADS_TRAIN_ARCH} {HEADS_TRAIN_LAYERS} layers, the "
          f"local first step on the card: loss {first['loss']:.6f}, grad "
          f"norm {first['grad_norm']:.6f}")
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return first


def _heads_body(torch, ops, rank, work):
    """Phase 15's rank, as in phase 11, on a HEADS_MESH mesh where neither
    model's heads divide the model axis (``blocks.head_split``
    "replicated"): the f32 checks of both at TP_F32_LAYERS (logits, the
    step's loss, grad norm, first moments and params against the local
    path; their verdicts the parent reads), then one starcoder2 train step
    HEADS_TRAIN_LAYERS deep (bf16) held to the local first step, then
    qwen2-vl served at full width and depth (bf16, its ring cut along the
    window) with its collectives timed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import kv_split
    from repro_torch.models import blocks, lm

    first = json.loads((work / "first_step.json").read_text())
    tp = HEADS_MESH[1]
    for arch in (HEADS_SERVE_ARCH, HEADS_TRAIN_ARCH):
        if blocks.head_split(get_config(arch), tp) != "replicated":
            raise AssertionError(f"{arch}: heads cut on a model axis of {tp}")
    serve = get_config(HEADS_SERVE_ARCH)
    if kv_split(types.SimpleNamespace(shape={"model": tp}),
                serve.num_kv_heads,
                lm._kv_window(serve, HEADS_CACHE)) != "window":
        raise AssertionError("phase 15's ring is not cut along its window")

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    seen, launches = collections.defaultdict(list), {}
    counted = functools.partial(_recording, ops, seen, launches)
    # the f32 checks first: they take each rank's first CUDA and gloo
    # calls, which the timed step and prefill after them do not pay
    out = {}
    for arch in (HEADS_SERVE_ARCH, HEADS_TRAIN_ARCH):
        out[f"{arch}_f32"] = _tp_f32(torch, counted, rank, arch,
                                     mesh_shape=HEADS_MESH, logits=True)
        freed()
    out["train"] = _tp_train(torch, ops, counted, first, rank,
                             HEADS_TRAIN_ARCH, layers=HEADS_TRAIN_LAYERS,
                             steps=1, mesh_shape=HEADS_MESH, warmup=False)
    freed()
    out["serve"] = _tp_serve(torch, ops, counted, rank, HEADS_SERVE_ARCH,
                             mesh_shape=HEADS_MESH, cache_len=HEADS_CACHE,
                             collectives=True)
    out["launches"] = launches
    out["b5_shapes"] = sorted(set(seen["flash_attention"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _coll_line(coll: dict) -> str:
    return ", ".join(f"{k} {v['calls']} calls {v['ms']:.4f} ms "
                     f"{v['bytes'] / 1e9:.4f} GB" for k, v in coll.items())


def phase_heads_tp(torch, ops_mod):
    """Phase 15: the local first step (``phase_heads_first``), then
    HEADS_RANKS ranks spawned on the one card (``_heads_body``) on a
    HEADS_MESH mesh whose model axis divides neither qwen2-vl's 12 nor
    starcoder2's 36 query heads, nor their 2 and 4 KV heads: every rank
    computes every head through B5. The parent joins every rank (a failed
    rank fails the run), requires the f32 checks within TP_F32_TOL, then
    holds B5 at every shape the ranks launched it at and at musicgen's
    production shape (HEADS_MHA_SHAPE). Returns (the ranks' launches
    together, numbers to keep)."""
    gc.collect()
    torch.cuda.empty_cache()
    t_first = time.perf_counter()
    first = phase_heads_first(torch)
    t_first = time.perf_counter() - t_first
    ranks, launches, wall = _spawn_ranks(
        torch, ops_mod, _heads_body, HEADS_RANKS,
        lambda work: (work / "first_step.json").write_text(json.dumps(first)))
    for r, rec in enumerate(ranks):
        tr, sv = rec["train"], rec["serve"]
        row = tr["steps"][0]
        print(f"[heads-tp] rank {r} {HEADS_TRAIN_ARCH} {HEADS_TRAIN_LAYERS} "
              f"layers on {HEADS_MESH} (data, model), attention replicated, "
              f"bf16, AdamW, block remat, {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens: state {tr['state_gb']:.4f} GB a rank, init "
              f"{tr['init_s']:.4f} s; its one step: host "
              f"{row['host_ms']:.4f} ms, events {row['event_ms']:.4f} ms, "
              f"{row['tokens_per_s']:.1f} tokens/s, loss {row['loss']:.6f} "
              f"grad norm {row['grad_norm']:.6f} (local: "
              f"{first['loss']:.6f}, {first['grad_norm']:.6f}), B5 "
              f"{row['b5_launches']}, B3 {row['b3_launches']}, peak "
              f"{row['peak_gb']:.4f} GB; collectives "
              + _coll_line(tr["collectives"]))
        print(f"[heads-tp] rank {r} {HEADS_SERVE_ARCH} full width and depth "
              f"on {HEADS_MESH}, attention replicated, bf16: prefill "
              f"{TRAIN_BATCH} x {TP_PROMPT} {sv['prefill_s']:.4f} s (peak "
              f"{sv['prefill_peak_gb']:.4f} GB), cache block "
              f"{sv['cache_gb']:.4f} GB (ring of {HEADS_CACHE} cut along "
              f"its window); decode ms "
              f"{[round(t, 4) for t in sv['decode_ms']]}; peak "
              f"{sv['peak_gb']:.4f} GB; prefill collectives "
              + _coll_line(sv["collectives"]["prefill"])
              + "; decode collectives "
              + _coll_line(sv["collectives"]["decode"]))
        print(f"[heads-tp] rank {r}: peak {rec['peak_gb']:.4f} GB, launches "
              f"{rec['launches']}, B5 shapes {rec['b5_shapes']}")
    sv = ranks[0]["serve"]
    print(f"[heads-tp] {HEADS_SERVE_ARCH} greedy tokens {sv['tokens']}: "
          f"equal to the local path's at {sv['greedy_held']} positions whose"
          f" margin exceeds {TP_GREEDY_MARGIN} ({sv['greedy_ties']} near "
          f"ties not held); logits max abs err "
          f"{sv['logits_max_abs_err']:.6g}")
    bad = []
    for arch in (HEADS_SERVE_ARCH, HEADS_TRAIN_ARCH):
        f32 = ranks[0][f"{arch}_f32"]
        print(f"[heads-tp] {arch} f32, {TP_F32_LAYERS} layers, "
              f"{TRAIN_BATCH} x {TP_F32_SEQ}: last logits err "
              f"{f32['logits_err']:.6g} of their peak, loss "
              f"{f32['loss']:.8f} (local {f32['want_loss']:.8f}), grad norm "
              f"{f32['grad_norm']:.8f} (local {f32['want_grad_norm']:.8f}), "
              f"first moment err {f32['moment']:.6g} of its leaf's peak, "
              f"params err {f32['param']:.6g} of their leaf's peak on the "
              f"{f32['settled'] / f32['elements']:.4f} settled (limit "
              f"{f32['tol']})")
        if not f32["ok"]:
            bad.append(arch)
    print(f"[heads-tp] {HEADS_RANKS} gloo ranks on one card: {wall:.4f} s "
          f"wall, spawn included; the local first step {t_first:.4f} s")
    if bad:
        raise AssertionError(f"f32 checks on the mesh against the local "
                             f"path beyond {TP_F32_TOL}: {bad}")
    seen = {tuple(s) for rec in ranks for s in rec["b5_shapes"]}
    _hold_attention(torch, seen | {HEADS_MHA_SHAPE}, "heads-tp")
    return launches, {"ranks_wall_s": wall, "first": first, "ranks": ranks,
                      "b5_shapes": sorted(seen)}


# ---------------------------------------------------------------------------
# phase 13: the dry run on the card's machine; phase 14: the examples
# ---------------------------------------------------------------------------
#: (arch, shape, mesh) cells of ``launch/dryrun.py`` traced on fake cuda
DRYRUN_CELLS = (("internlm2_1p8b", "train_4k", "single"),
                ("rwkv6_1p6b", "train_4k", "multi"),
                ("qwen3_moe_30b_a3b", "prefill_32k", "single"),
                ("zamba2_2p7b", "long_500k", "multi"),
                ("kimi_k2_1t_a32b", "decode_32k", "multi"),
                ("qwen2_vl_2b", "decode_32k", "single"))
#: the cells whose attention the model axis replicates (``blocks.head_split``)
DRYRUN_REPLICATED = {"qwen2_vl_2b"}
DRYRUN_TIMEOUT = 600
#: the functions phase 12 wraps -> the dry run's collective kinds
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "all_reduce": "all-reduce",
                    "all_to_all_single": "all-to-all"}
#: one cell of any shape (``dryrun.run_custom``) in a process of its own:
#: argv[1] the source root, argv[2] JSON (arch, name, seq, batch, mode,
#: mesh, the ``(data, model)`` shape or null for one rank)
_CUSTOM_CELL = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
a = json.loads(sys.argv[2])
rec = dryrun.run_custom(get_config(a["arch"]), ShapeConfig(
    a["name"], a["seq"], a["batch"], a["mode"]), a["mesh"], "cuda")
print("DRYRUN " + json.dumps(rec))
"""


def _children(cmds: dict, timeout: float, cwd) -> dict:
    """Run every command of ``cmds`` at once with ``src`` on the path, each
    one's output into a file in ``cwd``; returns key -> (output, exit
    code, its wall seconds). Raises when ``timeout`` passes with one still
    running, and kills what is left on the way out."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, t0 = {}, time.perf_counter()
    for i, (key, cmd) in enumerate(cmds.items()):
        log = pathlib.Path(cwd) / f"child{i}.log"
        with open(log, "w") as f:
            procs[key] = (subprocess.Popen(cmd, stdout=f,
                                           stderr=subprocess.STDOUT,
                                           env=env, cwd=str(cwd)), log)
    walls = {}
    try:
        while len(walls) < len(procs):
            for key, (p, _) in procs.items():
                if key not in walls and p.poll() is not None:
                    walls[key] = time.perf_counter() - t0
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"still running after {timeout} s: "
                                     f"{[k for k in procs if k not in walls]}")
            time.sleep(0.1)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {key: (log.read_text(), p.returncode, walls[key])
            for key, (p, log) in procs.items()}


def _dryrun_line(what: str, rec: dict) -> str:
    mem = rec["memory"]
    return (f"[dryrun] {what}: flops {rec['flops']:.6e} hbm_bytes "
            f"{rec['hbm_bytes']:.6e} coll_total "
            f"{rec['collectives'].get('total', 0.0):.6e} temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.4f} GB args "
            f"{mem['argument_size_in_bytes'] / 1e9:.4f} GB alias "
            f"{mem['alias_size_in_bytes'] / 1e9:.4f} GB ops {rec['ops']} "
            f"trace_s {rec['trace_s']:.4f}")


def phase_dryrun(train_times: dict, ssm_tp_times: dict) -> dict:
    """Phase 13: ``launch/dryrun.py`` on this machine, every cell a process
    of its own (the fake process group never meets this process's or the
    gloo ranks' groups), all at once. (a) DRYRUN_CELLS through the CLI on
    fake cuda tensors: each record ``ok``, no kernel library loaded or
    launched in its process. (b) Phase 12's rwkv6 train step (full depth,
    bf16, TRAIN_BATCH x TRAIN_SEQ, TP_MESH) on a fake group of 4: its
    collective calls and raw input bytes by kind equal rank 0's record of
    its timed step in phase 12, less that step's dirty-block telemetry
    (which the dry run does not trace). (c) Phase 8's internlm2 train step
    on one rank: its argument bytes equal phase 8's state plus batch, byte
    for byte; its predicted peak (arguments + temp) is printed beside the
    step's measured ``max_memory_allocated`` (a finding, not a gate)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        cmds = {cell: [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", cell[0], "--shape", cell[1], "--mesh",
                       cell[2], "--device", "cuda", "--out", tmp]
                for cell in DRYRUN_CELLS}
        custom = {
            "collectives": dict(arch=RWKV_ARCH, name="phase12_train",
                                seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                                mode="train", mesh=list(TP_MESH)),
            "memory": dict(arch=TRAIN_ARCH, name="phase8_train",
                           seq=TRAIN_SEQ, batch=TRAIN_BATCH, mode="train",
                           mesh=None)}
        for key, spec in custom.items():
            cmds[key] = [sys.executable, "-c", _CUSTOM_CELL,
                         str(ROOT / "src"), json.dumps(spec)]
        t0 = time.perf_counter()
        runs = _children(cmds, DRYRUN_TIMEOUT, tmp)
        wall = time.perf_counter() - t0
        failed = {str(k): text[-3000:] for k, (text, code, _) in runs.items()
                  if code}
        if failed:
            raise AssertionError(f"dry-run processes failed: {failed}")
        records = {}
        for cell in DRYRUN_CELLS:
            rec = json.loads((pathlib.Path(tmp) / f"{'_'.join(cell)}.json")
                             .read_text())
            split = ("replicated" if cell[0] in DRYRUN_REPLICATED
                     else None if cell[0] == RWKV_ARCH else "heads")
            if not rec["ok"] or rec["device"] != "cuda" or \
                    rec["kernels_loaded"] or rec["attention"] != split:
                raise AssertionError(f"dry-run cell {cell}: {rec}")
            records[" ".join(cell)] = rec
            print(_dryrun_line(f"{' '.join(cell)} ({rec['devices']} ranks,"
                               f" rank 0, fake cuda, {rec['mode']}, "
                               f"attention {rec['attention']})", rec)
                  + f", process {runs[cell][2]:.4f} s")
    for key in custom:
        line = [ln for ln in runs[key][0].splitlines()
                if ln.startswith("DRYRUN ")][-1]
        records[key] = json.loads(line[len("DRYRUN "):])
        if records[key]["kernels_loaded"]:
            raise AssertionError(f"dry run {key} loaded a kernel library")

    # (b) collectives against phase 12's rank 0
    got = records["collectives"]
    print(_dryrun_line(f"{RWKV_ARCH} train {TRAIN_BATCH} x {TRAIN_SEQ} on "
                       f"{TP_MESH} (a fake group of {TP_RANKS})", got))
    tr = ssm_tp_times["ranks"][0]["rwkv6_train"]
    real = {}
    for name, rec in tr["collectives"].items():
        tele = tr["collectives_telemetry"].get(name, {"calls": 0,
                                                      "bytes": 0})
        real[COLLECTIVE_KINDS[name]] = (rec["calls"] - tele["calls"],
                                        rec["bytes"] - tele["bytes"])
    fake = {k: (got["collective_calls"][k], got["collective_input_bytes"][k])
            for k in got["collective_calls"]}
    print(f"[dryrun] {RWKV_ARCH} train step's collectives (calls, input "
          f"bytes): dry run {fake}; phase 12's rank 0 {real} (its timed "
          f"step less the telemetry's "
          f"{ {k: v['calls'] for k, v in tr['collectives_telemetry'].items()} }"
          f" calls)")
    if fake != real:
        raise AssertionError(f"the dry run's collectives {fake} differ from "
                             f"phase 12's rank 0 {real}")

    # (c) memory against phase 8's step
    got = records["memory"]
    mem = got["memory"]
    print(_dryrun_line(f"{TRAIN_ARCH} train {TRAIN_BATCH} x {TRAIN_SEQ} on "
                       f"one rank", got))
    rows = train_times["steps"]
    want = train_times["state_bytes"] + rows[0]["batch_bytes"]
    if mem["argument_size_in_bytes"] != want:
        raise AssertionError(f"dry run's argument bytes "
                             f"{mem['argument_size_in_bytes']} against phase "
                             f"8's state and batch {want}")
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = max(r["peak_bytes"] for r in rows)
    print(f"[dryrun] {TRAIN_ARCH} train step: arguments "
          f"{mem['argument_size_in_bytes']} bytes equal phase 8's state "
          f"{train_times['state_bytes']} + batch {rows[0]['batch_bytes']}; "
          f"predicted peak (arguments + temp) {predicted / 1e9:.4f} GB "
          f"against phase 8's max_memory_allocated {measured / 1e9:.4f} GB "
          f"(with telemetry), ratio {predicted / measured:.4f}")
    print(f"[dryrun] phase 13: {len(cmds)} processes at once, "
          f"{wall:.4f} s wall")
    return {"wall_s": wall, "cells": records,
            "phase12_collectives": {k: list(v) for k, v in real.items()},
            "predicted_peak_bytes": predicted,
            "measured_peak_bytes": measured,
            "peak_ratio": predicted / measured}


#: (file, extra arguments, its OK line); train_100m 30 steps: the failure
#: at step 15 comes before its first checkpoint (25), so it restarts from
#: step 0 and saves one checkpoint (a 60-step run spends ~2 minutes
#: compressing and restoring its 0.9 GB states)
EXAMPLES = (("torch_quickstart.py", (), "quickstart OK"),
            ("torch_serve_migration.py", (),
             "serving migration OK (replica exact, decode resumed)"),
            ("torch_train_100m.py", ("--steps", "30"), "train_100m OK"),
            ("torch_elastic_rescale.py", (), "elastic rescale OK"))


def phase_examples() -> dict:
    """Phase 14: each ``examples/torch_*.py`` with ``--device cuda``, a
    process each, all at once on the card; each must exit 0 with its
    ``OK`` line. Returns each one's wall seconds."""
    import tempfile
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        cmds = {}
        for name, extra, _ in EXAMPLES:
            args = list(extra)
            if name == "torch_train_100m.py":
                args += ["--ckpt", str(pathlib.Path(tmp) / "ckpt")]
            cmds[name] = [sys.executable, str(ROOT / "examples" / name),
                          "--device", "cuda", *args]
        runs = _children(cmds, 900, tmp)
        for name, extra, ok in EXAMPLES:
            text, code, wall = runs[name]
            lines = [ln.strip() for ln in text.splitlines()]
            if code or ok not in lines:
                raise AssertionError(f"example {name} exited {code}:\n"
                                     f"{text[-3000:]}")
            walls[name] = wall
            print(f"[examples] {name} --device cuda {' '.join(extra)}: "
                  f"{wall:.4f} s, '{ok}'")
            for ln in lines:
                if any(w in ln for w in ("period=", "rounds", "params:",
                                         "loss ", "restarts", "resumed")):
                    print(f"[examples]   {ln.strip()}")
    print(f"[examples] phase 14: {len(EXAMPLES)} processes at once, "
          f"{max(walls.values()):.4f} s wall")
    return walls


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
    records["ssm_scan"], scan_times = phase_ssm_kernel(torch, ref, gla,
                                                       ssm_scan)
    records["flash_attention"], attn_times = phase_attention_kernel(
        torch, ref, flash_attention)
    decode_times = phase_decode_attention(torch, ops, ref)
    records["decode_attention"] = decode_times["internlm2"]
    tick_launches, tick_times, tick_b2, tick_states = phase_tick(
        torch, np, ops)
    # phase 2's B2 check at each shape the tick sent (captured in phase 3)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    seen = set()
    for J, N, lags in tick_b2:
        key = (J, N, len(lags), lags[0], lags[-1])
        if key not in seen:
            seen.add(key)
            _autocorr_case(torch, ref, autocorr, g, J, N,
                           torch.tensor(lags, dtype=torch.int32),
                           back_to_back=True)
    fleet_launches, controller_launches = phase_fleet(torch, ops)
    # phase 10(b) before any replica: four ranks' contexts beside this one
    dist_launches, dist_times = phase_dist_ranks(
        torch, np, ops, dft, autocorr, tick_states, tick_times)
    del tick_states
    records["dirty_delta"] = phase_dirty_delta(torch, ref, dirty_delta)
    phase_placement(torch)
    serve_prefill, serve_launches, serve_times = phase_serve(
        torch, ops, ref, dirty_delta)
    serve_times["card_vs_cpu_max_abs_err"] = phase_serve_cpu_check(torch)
    ssm_prefill, ssm_migrate, ssm_times = phase_ssm_serve(torch, ops, ref)
    rwkv_launches, ssm_times["rwkv6"] = phase_rwkv_serve(torch, ops)
    ssm_times["card_vs_cpu_max_abs_err"] = phase_ssm_cpu_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    z7_launches, z7_decode, ssm_times[Z7_NAME] = phase_zamba2_7b_serve(
        torch, ops)
    dense_launches, dense_decode, dense_times = phase_dense_serve(torch, ops)
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
    dist_times["one_rank"] = moe_times.pop("dist_one_rank")
    gc.collect()                       # phase 9's model freed before phase 11
    torch.cuda.empty_cache()
    tp_launches, tp_times = phase_tp_ranks(torch, ops,
                                           train_times["first_step"])
    ssm_tp_launches, ssm_tp_times = phase_ssm_tp_ranks(torch, ops)
    gc.collect()
    torch.cuda.empty_cache()
    heads_launches, heads_times = phase_heads_tp(torch, ops)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_times = phase_dryrun(train_times, ssm_tp_times)
    example_walls = phase_examples()

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
                   "flash_attention"),
               "decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "none (the JAX package decodes outside any Pallas "
                   "kernel)", "decode_attention")}
    paths = (tick_launches, fleet_launches, controller_launches,
             serve_prefill, serve_launches,
             ssm_prefill, ssm_migrate, rwkv_launches, z7_launches,
             z7_decode, dense_launches, dense_decode,
             train_launches, train_mig_launches, *check_launches.values(),
             trainer_launches, inc_launches, *moe_launches, dist_launches,
             tp_launches, ssm_tp_launches, heads_launches)
    kernels = []
    for name, (src, replaces, op) in sources.items():
        launches = sum(path[op] for path in paths)
        if launches < 1:
            raise AssertionError(f"{name} never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, **records[name]))
    # zamba2-7b's shapes: B5 at D = 224 and the model's scale, B4 on one
    # group's heads, decode attention at its ring; the launches of its
    # counted prefill (B4, B5) and decode steps (decode attention)
    z7 = _zamba2_7b_config()
    attn_at = (_z7_pass(), z7.num_heads, z7.num_kv_heads, Z7_PROMPT,
               z7.head_dim)
    for name, at, record in (
            ("flash_attention", f"{Z7_NAME} {attn_at} scale "
             f"{z7.attn_scale:.6g}", attn_times[Z7_NAME]),
            ("ssm_scan", f"{Z7_NAME} one group {_z7_scan_shape()}",
             next(v for k, v in scan_times.items()
                  if k.startswith(Z7_NAME))),
            ("decode_attention", f"{Z7_NAME} {decode_times[Z7_NAME]['at']}",
             decode_times[Z7_NAME])):
        src, replaces, op = sources[name]
        path = z7_decode if name == "decode_attention" else z7_launches
        kernels.append(dict(name=name, at=at, route="cuda", source=src,
                            replaces=replaces, launches=path[op],
                            **{k: v for k, v in record.items()
                               if k not in ("op_ms", "at")}))
    print("[attn] " + json.dumps(attn_times))
    print("[decode] " + json.dumps(decode_times))
    print("[tick] " + json.dumps(tick_times))
    print("[serve] " + json.dumps(serve_times))
    print("[ssm] " + json.dumps(ssm_times))
    print("[dense] " + json.dumps(dense_times))
    print("[train] " + json.dumps(train_times))
    print("[moe] " + json.dumps(moe_times))
    print("[dist] " + json.dumps(dist_times))
    print("[tp] " + json.dumps(tp_times))
    print("[ssm-tp] " + json.dumps(ssm_tp_times))
    print("[heads-tp] " + json.dumps(heads_times))
    print("[dryrun] " + json.dumps({k: v for k, v in dryrun_times.items()
                                    if k != "cells"}))
    print("[examples] " + json.dumps(example_walls))
    print(_card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
