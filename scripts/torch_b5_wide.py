"""B5 (``flash_attention.cu``) at zamba2-7b's shared attention, and its
narrower widths against another checkout, on one card.

1. Bits: in this checkout and, with ``--a``, in another one (each in its
   own process, order a, b), B5 at the D <= 128 shapes the port's cells
   and training send, each output's SHA-256; the two must be equal where
   the other checkout's kernel is the parent's.
2. Zamba2-7b's prefill call (16, 32, 32, 4,080, 224) bf16 at scale
   (224 / 2)^-0.5 in this checkout: held to ``ref.attention_ref`` on its
   first batch element, then timed by CUDA events (median of 20 launches
   after a warm-up) beside ``scaled_dot_product_attention`` at the same
   scale and the bound (``portbench/counts/kernels.attention``).

    python3 scripts/torch_b5_wide.py [--a OTHER_CHECKOUT] [--out FILE]

Prints JSON lines, the last the summary; exits 1 where the bits differ or
the check fails, 3 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (B, H, Hkv, S, D, dtype) B5 runs at D <= 128: internlm2's prefill and
#: training, zamba2-2.7b's prefill, musicgen's, a ragged f32 case
NARROW = [(16, 16, 8, 4080, 128, "bfloat16"), (4, 16, 8, 2048, 128, "bfloat16"),
          (2, 32, 32, 4096, 80, "bfloat16"), (4, 24, 24, 2048, 64, "bfloat16"),
          (1, 4, 2, 700, 128, "float32")]

CHILD = r'''
import hashlib, json, pathlib, sys
tree = pathlib.Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree / "src")]
import torch
from repro_torch.kernels import build, ops
build.build_all(["flash_attention"])
out = []
for B, H, Hkv, S, D, dt in json.loads(sys.argv[2]):
    g = torch.Generator(device="cuda").manual_seed(B * 1000003 + S * 7 + D)
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    o = ops.flash_attention(q, k, v).contiguous()
    torch.cuda.synchronize()
    out.append(hashlib.sha256(o.view(torch.uint8).cpu().numpy().tobytes())
               .hexdigest())
print(json.dumps(out))
'''


def _bits(tree: pathlib.Path) -> list:
    got = subprocess.run([sys.executable, "-c", CHILD, str(tree),
                          json.dumps(NARROW)], capture_output=True, text=True)
    if got.returncode:
        raise RuntimeError(f"{tree}: {got.stderr[-3000:]}")
    return json.loads(got.stdout.strip().splitlines()[-1])


def _median_ms(torch, fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n // 2]


def _wide(torch) -> dict:
    from portbench.counts import kernels as K
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F
    B, H, S, D = 16, 32, 4080, 224
    scale = (D / 2) ** -0.5
    g = torch.Generator(device="cuda").manual_seed(224)
    q, k, v = (torch.randn((B, H, S, D), device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v, scale=scale)
    want = ref.attention_ref(q[:1], k[:1], v[:1], scale=scale).float()
    mass = ref.attention_ref(q[:1].float(), k[:1].float(),
                             v[:1].float().abs(), scale=scale)
    use = float(((got[:1].float() - want).abs()
                 / (2 * 2.0 ** -8 * (want.abs() + mass)).clamp_min(1e-30))
                .max())
    del want, mass
    b5 = _median_ms(torch, lambda: ops.flash_attention(q, k, v, scale=scale))
    sdpa = _median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    bound = 1e3 * K.seconds(*K.attention(B, H, H, S, D, in_bytes=2))
    return {"shape": [B, H, H, S, D], "check_share_of_bound": use,
            "b5_ms": b5, "sdpa_ms": sdpa, "bound_ms": bound,
            "roofline_pct": 100.0 * bound / b5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="another checkout to compare bits with")
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("torch_b5_wide: no card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = [{"card": card}]
    ok = True
    if args.a:
        a, b = _bits(pathlib.Path(args.a)), _bits(ROOT)
        same = [x == y for x, y in zip(a, b)]
        ok &= all(same)
        lines.append({"bits_equal": dict(zip(map(str, NARROW), same))})
    wide = _wide(torch)
    ok &= wide["check_share_of_bound"] <= 1.0
    lines.append({"wide": wide, "ok": ok})
    for line in lines:
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
