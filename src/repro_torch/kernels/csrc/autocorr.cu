// Candidate-lag autocorrelation scores of a batch of rows, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/autocorr.py
// (autocorr_score / _kernel), which kept a tile of rows resident in VMEM
// and walked a tile of lags with dynamic-slice multiplies:
//
//   R[j, l] = sum_{t < N - lag_l} x[j, t] * x[j, t + lag_l],
//   lag_l clamped to [0, N] (lag N scores 0).
//
// This direct method is bound by its operations, J * sum_l (N - lag_l)
// MACs. The function itself needs less (Wiener-Khinchin scores every lag in
// O(N log N) per row), so its least time on the card is set by its
// (J*N + L + J*L) * 4 bytes of traffic.
//
// Design: one block per (row, tile of 64 lags). The block stages its row
// once in shared memory (N <= 16384 floats); each warp scores one lag at a
// time with a lane-strided sum, reduced by warp shuffles in a fixed order.
// There are no atomics, so the result is deterministic run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LT = 64;        // lags per block

__global__ void __launch_bounds__(THREADS)
autocorr_kernel(const float* __restrict__ x, const int* __restrict__ lags,
                float* __restrict__ out, int J, int N, int L) {
  extern __shared__ float row[];
  const int j = blockIdx.x;
  const int l0 = blockIdx.y * LT;
  const float* src = x + (size_t)j * N;
  for (int t = threadIdx.x; t < N; t += THREADS) row[t] = src[t];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = l0 + warp; l < min(l0 + LT, L); l += WARPS) {
    const int lag = min(max(lags[l], 0), N);
    float acc = 0.f;
    for (int t = lane; t < N - lag; t += 32) acc = fmaf(row[t], row[t + lag], acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[(size_t)j * L + l] = acc;
  }
}

}  // namespace

extern "C" size_t autocorr_smem_bytes(int N) { return sizeof(float) * (size_t)N; }

// x: (J, N) f32 contiguous; lags: (L,) int32; out: (J, L) f32 contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int autocorr_launch(const float* x, const int* lags, float* out,
                               int J, int N, int L, void* stream) {
  const size_t smem = autocorr_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      autocorr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(J, (L + LT - 1) / LT);
  autocorr_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, lags, out, J, N, L);
  return (int)cudaGetLastError();
}
