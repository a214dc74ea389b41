"""Time the port's spectrum (B1), lag-score (B2) and SSM-scan (B4) kernels
of two checkouts on one card, each in its own process, in the order A, B,
B, A.

B1 at the tick's shape (16,384 rows of 512, centered); B2 at the main
path's case (16,384 rows of 512, lags 2..256), at the shape the tick sent
(12,288 rows, lags 112..230) and at each other lag grid
``chip_smoke.phase_kernels`` checks: one launch per CUDA-event window, 50
launches
back to back, and the kernel's mean device time over those 50 under
``torch.profiler`` (at small shapes the windows measure the host's
launch); B4 at zamba2's and rwkv6's prefill shapes
(``chip_smoke._scan_case``). With ``--tick`` it times the 16,384-job
surveillance tick instead (``chip_smoke.phase_tick``: cold, steady and
full-refit seconds, and the traced refit's device time). With
``--prefill`` it times serving instead: each of the four full-width
replicas ``chip_smoke.py`` serves (danube3, zamba2, rwkv6, qwen3)
prefills 16 x 4,096 tokens three times on the host clock (the first
also CUDA-event timed, and its peak memory read), then decodes 8 steps.
With ``--train`` it times training instead: ``chip_smoke.phase_train``'s
full-width internlm2-1.8b on 4 x 2,048 tokens, a warm-up and 6 steps with
telemetry, each on the host clock and by CUDA events, with its peak
allocated and reserved memory. ``--alloc-b CONF`` runs b's processes with
``PYTORCH_CUDA_ALLOC_CONF=CONF`` and a's without it (the same checkout on
both sides compares two allocator settings). Each checkout builds its own
kernels into its own ``build/``. Run from a checkout on a machine with
one CUDA device:

    python3 scripts/torch_kernel_ab.py --a PATH_TO_OTHER_CHECKOUT [--b .]
        [--tick | --prefill | --train] [--alloc-b CONF]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

CHILD = r'''
import json, pathlib, sys
tree = pathlib.Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree), str(tree / "src")]
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels import autocorr, dft, ssm_scan
g = torch.Generator(device="cuda").manual_seed(cs.SEED)
out = {}
x = torch.randn(16384, 512, device="cuda", generator=g) + 3.0
spectrum = lambda: dft.power_spectrum(x, center=True)
spectrum()
torch.cuda.synchronize()
out["b1_ms"] = cs._median_ms(spectrum)
def many():
    for _ in range(50):
        spectrum()
out["b1_back_to_back_ms"] = cs._median_ms(many, 5) / 50
g2 = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
lag_sets = {
    "main": (16384, 512, torch.arange(2, 257)),
    # the shape B2 received in chip_smoke.phase_tick (its print)
    "tick": (12288, 512, torch.arange(112, 231)),
    "random": (1024, 4096, torch.randint(0, 4096, (64,), generator=g2,
                                         device="cuda")),
    "scattered": (37, 600, torch.tensor([0, 1, 2, 5, 59, 120, 300, 598, 599,
                                         600, 601, 900, -4])),
    "fleet1440": (8, 1440, cs._fleet_lags(torch, 1440)),
    "fleet2880": (8, 2880, cs._fleet_lags(torch, 2880)),
    "n16384": (64, 16384, torch.arange(1, 8193)),
    "n1031": (37, 1031, torch.arange(2, 516)),
    # a first tile of 105 consecutive lags, then scattered ones
    "mixed": (37, 1031, torch.cat([
        torch.arange(2, 107, device="cuda"),
        torch.randint(-3, 1041, (95,), generator=g2, device="cuda")])),
    "negatives": (37, 600, torch.arange(-20, 280)),
}
for name, (J, N, lags) in lag_sets.items():
    xa = torch.randn(J, N, device="cuda", generator=g2)
    xa = xa - xa.mean(dim=1, keepdim=True)
    lags = lags.to(device="cuda", dtype=torch.int32)
    score = lambda: autocorr.autocorr_score(xa, lags)
    score()
    torch.cuda.synchronize()
    out[f"b2_{name}_ms"] = cs._median_ms(score)
    def many():
        for _ in range(50):
            score()
    out[f"b2_{name}_back_to_back_ms"] = cs._median_ms(many, 5) / 50
    # the kernel's own device time, which small shapes' windows hide
    # behind the host's launch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        many()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "autocorr_kernel" in e.key]
    us = sum(getattr(e, "self_device_time_total", 0.0)
             or getattr(e, "self_cuda_time_total", 0.0) for e in ev)
    out[f"b2_{name}_device_ms"] = us / 1e3 / max(1, sum(e.count for e in ev))
for name, kind, H in (("zamba2", "mamba", 80), ("rwkv6", "rwkv", 32)):
    ins, u, s0 = cs._scan_case(torch, g, kind, 16, H, 4096, 64, 64,
                               dtype=torch.bfloat16)
    scan = lambda: ssm_scan.ssm_scan(*ins, u, s0)
    scan()
    torch.cuda.synchronize()
    out[f"b4_{name}_ms"] = cs._median_ms(scan)
    del ins
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''

TICK_CHILD = r'''
import json, pathlib, sys
tree = pathlib.Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree), str(tree / "src")]
import numpy as np, torch
import chip_smoke as cs
from repro_torch.kernels import build, ops
build.build_all(["dft_power", "autocorr"])     # not inside the cold tick
print("RESULT " + json.dumps(cs.phase_tick(torch, np, ops)[1]))
'''

PREFILL_CHILD = r'''
import json, pathlib, sys, time
tree = pathlib.Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree), str(tree / "src")]
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.launch.serve import build_replica
build.build_all(["flash_attention", "ssm_scan"])
out = {}
for arch in (cs.ARCH, cs.SSM_ARCH, cs.RWKV_ARCH, cs.DENSE_ARCH):
    r = build_replica(arch, cs.SERVE_BATCH, cs.SERVE_PROMPT, 8, smoke=False,
                      seed=cs.SEED, device="cuda")
    host = []
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        logits, cache = r.prefill(r.params, r.batch)
        b.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t)
        if i == 0:
            out[f"{arch}_prefill_event_ms"] = a.elapsed_time(b)
            out[f"{arch}_prefill_peak_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
    out[f"{arch}_prefill_s"] = host
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(8):
        tok, logits, cache = r.decode(r.params, tok, cache)
    torch.cuda.synchronize()
    out[f"{arch}_decode_ms"] = 1e3 * (time.perf_counter() - t) / 8
    del r, logits, cache, tok
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''

TRAIN_CHILD = r'''
import json, pathlib, sys, time
tree = pathlib.Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree), str(tree / "src")]
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.kernels import build
from repro_torch.train import init_train_state, make_train_step
build.build_all(["flash_attention", "dirty_delta"])
cfg = get_config(cs.TRAIN_ARCH)
state = init_train_state(cfg, cs.SEED, device="cuda")
corpus = SyntheticCorpus(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=cs.SEED)
step = make_train_step(cfg, telemetry=True)
out = {k: [] for k in ("host_ms", "event_ms", "peak_gb", "reserved_gb")}
for i in range(7):
    batch = cs._train_batch(torch, corpus, i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    a.record()
    state, m = step(state, batch)
    b.record()
    torch.cuda.synchronize()
    out["host_ms"].append(1e3 * (time.perf_counter() - t))
    out["event_ms"].append(a.elapsed_time(b))
    out["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
    out["reserved_gb"].append(torch.cuda.max_memory_reserved() / 1e9)
out["loss"] = float(m["loss"])
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the checkout timed first")
    ap.add_argument("--b", default=".", help="the other checkout")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tick", action="store_true",
                      help="time the surveillance tick, not the kernels")
    mode.add_argument("--prefill", action="store_true",
                      help="time the replicas' prefill and decode")
    mode.add_argument("--train", action="store_true",
                      help="time full-width internlm2 train steps")
    ap.add_argument("--alloc-b", default=None, metavar="CONF",
                    help="PYTORCH_CUDA_ALLOC_CONF of b's processes (a's "
                         "run without it)")
    args = ap.parse_args()
    child = (TICK_CHILD if args.tick else PREFILL_CHILD if args.prefill
             else TRAIN_CHILD if args.train else CHILD)
    envs = {"a": {k: v for k, v in os.environ.items()
                  if k != "PYTORCH_CUDA_ALLOC_CONF"}, "b": dict(os.environ)}
    if args.alloc_b is not None:
        envs["b"]["PYTORCH_CUDA_ALLOC_CONF"] = args.alloc_b
    else:
        envs["a"] = envs["b"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    for label, tree in (("a", args.a), ("b", args.b), ("b", args.b),
                        ("a", args.a)):
        run = subprocess.run([sys.executable, "-c", child, tree],
                             capture_output=True, text=True, timeout=900,
                             env=envs[label])
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode or not lines:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        print(label, pathlib.Path(tree).resolve().name,
              envs[label].get("PYTORCH_CUDA_ALLOC_CONF", "-"),
              json.dumps(json.loads(lines[0][7:])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
