"""Time the port's spectrum (B1) and SSM-scan (B4) kernels of two
checkouts on one card, each in its own process, in the order A, B, B, A.

B1 at the tick's shape (16,384 rows of 512, centered): one launch per
CUDA-event window, and 50 launches back to back (the device's time
without the host's launch in the window); B4 at zamba2's and rwkv6's
prefill shapes (``chip_smoke._scan_case``). Each checkout builds its own
kernels into its own ``build/``. Run from a checkout on a machine with
one CUDA device:

    python3 scripts/torch_kernel_ab.py --a PATH_TO_OTHER_CHECKOUT [--b .]
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
import chip_smoke as cs
from repro_torch.kernels import dft, ssm_scan
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the checkout timed first")
    ap.add_argument("--b", default=".", help="the other checkout")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    for label, tree in (("a", args.a), ("b", args.b), ("b", args.b),
                        ("a", args.a)):
        run = subprocess.run([sys.executable, "-c", CHILD, tree],
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
