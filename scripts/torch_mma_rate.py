"""Measure the card's ``mma.sync`` TF32 rate, the ceiling of the lag-score
kernel's (B2's) and the SSM scan's (B4's) tensor-core products.

Each warp issues 8 independent chains of ``mma.sync.m16n8k8`` or
``m16n8k4`` TF32 products on register operands (no memory traffic), at 1,
4 and 8 warps a scheduler (4, 16 and 32 warps an SM), and the script
prints the rate in TFLOP/s (2 flops a multiply-add) beside the card. The
kernel is built with nvcc into ``build/mma_rate/``. Run from a checkout
on a machine with one CUDA device:

    python3 scripts/torch_mma_rate.py
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int CHAINS = 8;

template <int K>
__global__ void rate(float* out, int iters, uint32_t seed) {
  uint32_t a[CHAINS][4], b[2] = {seed ^ 4u, seed ^ 5u};
  for (int k = 0; k < CHAINS; ++k)
    for (int e = 0; e < 4; ++e) a[k][e] = seed * (k + 3) + e;
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      if (K == 8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a[k][0]), "r"(a[k][1]), "r"(a[k][2]), "r"(a[k][3]),
              "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a[k][0]), "r"(a[k][1]), "r"(b[0]));
    }
  }
  float s = 0.f;
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 12345.f) out[threadIdx.x] = s;   // keeps the products live
}

extern "C" int run(int k, int blocks, int iters, float* out) {
  if (k == 8) rate<8><<<blocks, 128>>>(out, iters, 7u);
  else rate<4><<<blocks, 128>>>(out, iters, 7u);
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("torch_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rate.cu").write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out_dir / "librate.so"),
                    str(out_dir / "rate.cu")], check=True)
    lib = ctypes.CDLL(str(out_dir / "librate.so"))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(1024, device="cuda")
    iters = 4096
    for k in (8, 4):
        for warps_per_sm in (4, 16, 32):
            blocks = sms * warps_per_sm // 4
            if lib.run(k, blocks, 16, buf.data_ptr()):
                raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            lib.run(k, blocks, iters, buf.data_ptr())
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            flops = 2.0 * 16 * 8 * k * blocks * 4 * iters * 8
            print(f"mma.sync m16n8k{k} tf32, {warps_per_sm} warps an SM, 8 "
                  f"chains a warp: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
