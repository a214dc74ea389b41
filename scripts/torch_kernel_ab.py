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
full-refit seconds, and the traced refit's device time). Each checkout
builds its own kernels into its own ``build/``. Run from a checkout on a
machine with one CUDA device:

    python3 scripts/torch_kernel_ab.py --a PATH_TO_OTHER_CHECKOUT [--b .]
        [--tick]
"""
from __future__ import annotations

import argparse
import json
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the checkout timed first")
    ap.add_argument("--b", default=".", help="the other checkout")
    ap.add_argument("--tick", action="store_true",
                    help="time the surveillance tick, not the kernels")
    args = ap.parse_args()
    child = TICK_CHILD if args.tick else CHILD
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    for label, tree in (("a", args.a), ("b", args.b), ("b", args.b),
                        ("a", args.a)):
        run = subprocess.run([sys.executable, "-c", child, tree],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode or not lines:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        print(label, pathlib.Path(tree).resolve().name,
              json.dumps(json.loads(lines[0][7:])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
