// One-sided DFT power spectrum of a batch of real rows, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dft.py (dft_power /
// _kernel), which fed the MXU two N x N matmuls against cos/sin weight
// matrices. On Hopper an f32 product on the tensor cores runs in TF32 and
// breaks the spectrum tolerance, so this kernel stays on the CUDA cores:
//
//   P[b, f] = (sum_t xc[b,t] cos(2 pi t f / N))^2
//           + (sum_t xc[b,t] sin(2 pi t f / N))^2,   f in [0, N/2]
//
// with xc the row minus its mean when center != 0 (mean taken in f64 in
// the prologue). This direct method is bound by its operations,
// B * (N/2+1) * N complex MACs. The function itself needs far less (an FFT
// is O(N log N) per row), so its least time on the card is set by its
// (B*N + B*(N/2+1)) * 4 bytes of traffic.
//
// Design: an SGEMM-shaped tile. A block of 256 threads owns 64 rows x 64
// frequencies; each thread keeps a 4 x 4 register tile of (re, im)
// accumulators. Time runs in chunks of 32: the chunk of rows is staged
// transposed in shared memory, and the matching 32 x 64 cos/sin tile is
// gathered from a length-N table that the block builds once in shared
// memory (computed in f64, stored f32). The phase index (t * f) mod N is
// exact integer arithmetic, so no N x N weight matrix exists anywhere.
// Any N >= 2 works while the table fits in shared memory (N <= 16384).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows per block
constexpr int FT = 64;        // frequencies per block
constexpr int TK = 32;        // time steps per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int XS_STRIDE = BT + 4;  // padded, keeps float4 alignment

__global__ void __launch_bounds__(THREADS)
dft_power_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int B, int N, int F, int center) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // fixed-size tiles first so every float4 read stays 16-byte aligned
  float* xs = smem;                      // TK x XS_STRIDE
  float* cs = xs + TK * XS_STRIDE;       // TK x FT
  float* ss = cs + TK * FT;              // TK x FT
  float* cos_tab = ss + TK * FT;         // N
  float* sin_tab = cos_tab + N;          // N
  __shared__ float mean_s[BT];

  const int tid = threadIdx.x;
  const int tx = tid % 16;               // frequency group
  const int ty = tid / 16;               // row group
  const int b0 = blockIdx.x * BT;
  const int f0 = blockIdx.y * FT;
  // this thread's column of the twiddle tile: one frequency, every 4th
  // time step of the chunk; the phase index steps by 4f mod N
  const int ff = tid % FT, tt_first = tid / FT;
  const unsigned fq = (unsigned)(f0 + ff);
  const unsigned step = (4u * fq) % (unsigned)N;

  for (int k = tid; k < N; k += THREADS) {
    double s, c;
    sincospi(2.0 * (double)k / (double)N, &s, &c);
    cos_tab[k] = (float)c;
    sin_tab[k] = (float)s;
  }
  // row means in f64: warp w sums rows w, w + 8, ...
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    double acc = 0.0;
    const int b = b0 + r;
    if (center && b < B) {
      const float* row = x + (size_t)b * N;
      for (int t = lane; t < N; t += 32) acc += (double)row[t];
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) mean_s[r] = (float)(acc / (double)N);
  }
  __syncthreads();

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { re[i][j] = 0.f; im[i][j] = 0.f; }

  for (int t0 = 0; t0 < N; t0 += TK) {
    // stage x chunk transposed: xs[tt][r] = x[b0 + r, t0 + tt] - mean
    for (int e = tid; e < BT * TK; e += THREADS) {
      const int r = e / TK, tt = e % TK;
      const int b = b0 + r, t = t0 + tt;
      float v = 0.f;
      if (b < B && t < N) v = x[(size_t)b * N + t] - mean_s[r];
      xs[tt * XS_STRIDE + r] = v;
    }
    // twiddle tile from the table: exact integer phase index
    unsigned idx = ((unsigned)(t0 + tt_first) * fq) % (unsigned)N;
    for (int tt = tt_first; tt < TK; tt += THREADS / FT) {
      cs[tt * FT + ff] = cos_tab[idx];
      ss[tt * FT + ff] = sin_tab[idx];
      idx += step;
      if (idx >= (unsigned)N) idx -= (unsigned)N;
    }
    __syncthreads();
#pragma unroll 8
    for (int tt = 0; tt < TK; ++tt) {
      const float4 xv = *reinterpret_cast<const float4*>(
          &xs[tt * XS_STRIDE + ty * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&cs[tt * FT + tx * 4]);
      const float4 sv = *reinterpret_cast<const float4*>(&ss[tt * FT + tx * 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(xr[i], cr[j], re[i][j]);
          im[i][j] = fmaf(xr[i], sr[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) out[(size_t)b * F + f] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  }
}

}  // namespace

extern "C" size_t dft_power_smem_bytes(int N) {
  return sizeof(float) * (2 * (size_t)N + TK * XS_STRIDE + 2 * TK * FT);
}

// x: (B, N) f32 contiguous; out: (B, N/2+1) f32 contiguous. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dft_power_launch(const float* x, float* out, int B, int N,
                                int center, void* stream) {
  const int F = N / 2 + 1;
  const size_t smem = dft_power_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      dft_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + BT - 1) / BT, (F + FT - 1) / FT);
  dft_power_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, out, B, N, F, center);
  return (int)cudaGetLastError();
}
