// Candidate-lag autocorrelation scores of a batch of rows, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/autocorr.py
// (autocorr_score / _kernel), which kept a tile of rows resident in VMEM
// and walked a tile of lags with dynamic-slice multiplies:
//
//   R[j, l] = sum_{t < N - lag_l} x[j, t] * x[j, t + lag_l],
//   lag_l clamped to [0, N] (lag N scores 0).
//
// Bound: the direct sums are J * sum_l (N - lag_l) multiply-adds; the
// function itself needs less (Wiener-Khinchin scores every lag in
// O(N log N) a row), so its least time on the card is set by its
// (J*N + L + J*L) * 4 bytes. Direct sums on the CUDA cores are bound by
// their shared-memory loads (two a multiply-add); this kernel puts them on
// the tensor cores wherever the lag grid allows it.
//
// The lags are cut into tiles of LT = 16 MT - 7 (MT <= 8, chosen by the
// launcher from J, L and the SM count: the largest tiles that come out
// even, smaller until every warp has one). Each block picks each tile's
// route on the device from the lags it reads:
//
// - TENSOR, a tile whose clamped lags are consecutive (a0, a0 + 1, ...:
//   every grid the cycle fit sends). With t = 8b + i (i < 8) and the row
//   staged once with zeros past N, the tile's scores are the diagonal sums
//   of one Hankel product:
//
//     G[w, i] = sum_b x[8b + a0 + w] x[8b + i]        (w < 16 MT)
//     R[a0 + d] = sum_{i < 8} G[d + i, i]             (d < LT)
//
//   M is w, N is i, K is the time blocks b with 8b < N - a0 (rounded up to
//   the mma's 4), run as mma.sync m16n8k4 TF32 in 3xTF32 (each f32 operand
//   split hi + lo, both TF32, and lo*hi + hi*lo + hi*hi summed in f32): a
//   plain TF32 product keeps ~11 bits and misses the 2e-4 tolerance. A
//   lane's A fragments of all MT tiles at one k-step are the pairs
//   (y[s], y[s + 1]) of one strided sequence y[s] = x[a0 + g + 8r + 8s],
//   and the next k-step shares all but 4 of the values, each in the same
//   pair; so each k-step loads and splits 4 new values (and 1 for B) for
//   3 MT products, and the window lives in a ring of registers, 5 k-steps
//   unrolled, read in place by the products with no moves. (With k8 each
//   value sat in two m-tiles' fragments in different places, and the
//   copies cost more than the products.) The products issue term by term
//   over the m-tiles, dependent ones MT apart. The tensor cores add into
//   their accumulator with truncation, an error biased by its size:
//   chunks of 20 k-steps are summed into G in f32 with rounding, which
//   keeps it small at N = 16,384. The diagonal sums read G from shared
//   memory (stride 9: conflict-free) in the order i = 0..7.
// - CUDA, any other tile (scattered lags, or lags that clamp to one value:
//   negatives, N and above): a warp scores 4 lags of one row at once (5
//   for a tile's last 5: tiles are 4k + 1 lags) with a lane-strided sum,
//   one load of x[t] for the products, each lag's terms in the order of a
//   one-lag sum and reduced by warp shuffles, so each score equals the
//   one-lag kernel's bit for bit.
//
// Design: 4 warps a block (128 registers a thread, 4 blocks an SM), one
// block per RB rows and TG tiles (the launcher's choice: several rows a
// block when J fills the card, smaller tiles when it does not, so every
// warp has work). The block stages its rows once (asynchronous 16-byte
// copies where the rows allow, all in flight while it reads the tiles'
// lags and picks their routes), then takes its units in (row, tile) order,
// round robin over the warps: a tensor tile is one unit, a CUDA tile one
// unit per 4 lags (the last up to 5). A warp writes each unit's scores
// itself, so the block has one barrier. No atomics and fixed orders
// throughout, so a second launch is bit-equal to the first. Rows must be
// finite: a tensor tile's products take the zeros past N, and 0 * inf is
// NaN, so a non-finite value reaches every lag of its tile, not only the
// lags whose sums hold it.
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int T = 8;                  // time block: the mma's n side
constexpr int KSTEP = 4 * T;          // samples of one k-step (4 blocks)
constexpr int PAD = 256;              // zeros staged past N (the furthest read)
constexpr int GS = T + 1;             // row stride of the G scratch
constexpr int RING = 20;              // 5 k-steps of 4 new window values
constexpr int CHUNK = 4;              // 5-k-step rounds an accumulator takes
constexpr int MAX_MT = 8;
constexpr int MAX_RB = WARPS;
constexpr int MAX_TG = 64;            // tiles a block
constexpr int CC = 4;                 // lags a CUDA-route unit takes
constexpr int CMAX = CC + 1;          // ... its tile's last, at most
constexpr int INFO = 2;               // ints a tile: a0, k-steps (-1: CUDA)

__host__ __device__ constexpr int lag_tile(int mt) { return 16 * mt - (T - 1); }
__host__ __device__ constexpr int row_stride(int n) {
  return (n + PAD + 3) / 4 * 4;
}

size_t smem_bytes(int mt, int n, int rb, int tg) {
  return sizeof(float) * ((size_t)rb * row_stride(n) +
                          (size_t)WARPS * 16 * mt * GS) +
         sizeof(int) * (size_t)INFO * tg;
}

// --- tensor route ------------------------------------------------------------
// volatile: the products issue in the order written
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Lane (g = lane / 4, r = lane % 4) reads y[s] = x[a0 + g + 8r + 8s]
// (yb = row + a0 + g + 8r). At k-step ks its A fragment of m-tile mt is
// A[16mt + g (+8)][4ks + r] = (y[4ks + 2mt], y[4ks + 2mt + 1]): the window
// y[4ks .. 4ks + 2 MT - 1], held in ring slots (4P + j) % RING at phase
// P = ks % 5, every pair in an even slot and the next. Its B fragment is
// B[4ks + r][g] = x[32ks + 8r + g] (bb = row + g + 8r), held in slot P of a
// ring of 5. Each k-step loads and splits the next one's new window values
// and B.
template <int MT, int P>
__device__ __forceinline__ void kstep(const float* yb, const float* bb,
                                      int ks, uint32_t (&yh)[RING],
                                      uint32_t (&yl)[RING], uint32_t (&bh)[5],
                                      uint32_t (&bl)[5], float (&acc)[MT][4]) {
  constexpr int WS = 2 * MT;
  constexpr int J0 = WS > 4 ? WS : 4;
  constexpr int Q = (P + 1) % 5;
  const float* yk = yb + KSTEP * ks;
#pragma unroll
  for (int jn = J0; jn < WS + 4; ++jn)
    split_tf32(yk[8 * jn], yh[(4 * P + jn) % RING], yl[(4 * P + jn) % RING]);
  split_tf32(bb[KSTEP * (ks + 1)], bh[Q], bl[Q]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    mma_tf32(acc[mt], yl[(4 * P + 2 * mt) % RING],
             yl[(4 * P + 2 * mt + 1) % RING], bh[P]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    mma_tf32(acc[mt], yh[(4 * P + 2 * mt) % RING],
             yh[(4 * P + 2 * mt + 1) % RING], bl[P]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    mma_tf32(acc[mt], yh[(4 * P + 2 * mt) % RING],
             yh[(4 * P + 2 * mt + 1) % RING], bh[P]);
}

// G (+)= acc in the C fragments' places of G in the warp's scratch (row
// stride GS), acc = 0. Each lane touches its own entries only.
template <int MT>
__device__ __forceinline__ void flush(float* gs, int lane,
                                      float (&acc)[MT][4], bool first) {
  const int g = lane >> 2, r = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float* p = gs + (16 * mt + g) * GS + 2 * r;
    float* q[4] = {p, p + 1, p + 8 * GS, p + 8 * GS + 1};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *q[e] = first ? acc[mt][e] : *q[e] + acc[mt][e];
      acc[mt][e] = 0.f;
    }
  }
}

// G of one staged row over the nk > 0 k-steps of the tile at a0, into the
// warp's scratch gs
template <int MT>
__device__ __forceinline__ void hankel(const float* row, int a0, int nk,
                                       int lane, float* gs) {
  constexpr int WS = 2 * MT;
  const int g = lane >> 2, r = lane & 3;
  const float* yb = row + a0 + g + 8 * r;
  const float* bb = row + g + 8 * r;
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  uint32_t yh[RING], yl[RING], bh[5], bl[5];
#pragma unroll
  for (int j = 0; j < WS; ++j) split_tf32(yb[8 * j], yh[j], yl[j]);
  split_tf32(bb[0], bh[0], bl[0]);
  bool first = true;
  int rounds = 0;
  int ks = 0;
  for (; ks + 5 <= nk; ks += 5) {
    kstep<MT, 0>(yb, bb, ks, yh, yl, bh, bl, acc);
    kstep<MT, 1>(yb, bb, ks + 1, yh, yl, bh, bl, acc);
    kstep<MT, 2>(yb, bb, ks + 2, yh, yl, bh, bl, acc);
    kstep<MT, 3>(yb, bb, ks + 3, yh, yl, bh, bl, acc);
    kstep<MT, 4>(yb, bb, ks + 4, yh, yl, bh, bl, acc);
    if (++rounds == CHUNK) {
      flush<MT>(gs, lane, acc, first);
      first = false;
      rounds = 0;
    }
  }
  const int rem = nk - ks;
  if (rem > 0) {
    kstep<MT, 0>(yb, bb, ks, yh, yl, bh, bl, acc);
    if (rem > 1) kstep<MT, 1>(yb, bb, ks + 1, yh, yl, bh, bl, acc);
    if (rem > 2) kstep<MT, 2>(yb, bb, ks + 2, yh, yl, bh, bl, acc);
    if (rem > 3) kstep<MT, 3>(yb, bb, ks + 3, yh, yl, bh, bl, acc);
    rounds = 1;
  }
  if (rounds) flush<MT>(gs, lane, acc, first);
}

// dst[d] = sum_{i < 8} G[d + i, i] for d < n, from the warp's scratch
__device__ __forceinline__ void diagonals(const float* gs, int lane, int n,
                                          float* dst) {
  __syncwarp();
  for (int d = lane; d < n; d += 32) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) s += gs[(d + i) * GS + i];
    dst[d] = s;
  }
  __syncwarp();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ int clamp_lag(int lag, int n) {
  return min(max(lag, 0), n);
}

// CUDA-route units of a tile of n lags: CC lags each, the last up to CC + 1
__device__ __forceinline__ int cuda_units(int n) {
  return max(1, (n + 2) / CC);
}

// --- CUDA route: lags l .. l + cnt - 1 (cnt <= CMAX) of one staged row -------
__device__ __forceinline__ void direct(const float* row, const int* lags,
                                       int l, int cnt, int N, int lane,
                                       float* dst) {
  int lg[CMAX], at[CMAX];
#pragma unroll
  for (int k = 0; k < CMAX; ++k) {
    lg[k] = k < cnt ? clamp_lag(__ldg(lags + l + k), N) : N;
    at[k] = k;
  }
  // sort by lag (a fixed network), so the sum runs in ranges of t where
  // 5, 4, 3, 2, then 1 lags still have terms
#pragma unroll
  for (int i = 0; i < CMAX - 1; ++i)
#pragma unroll
    for (int k = 0; k < CMAX - 1 - i; ++k)
      if (lg[k] > lg[k + 1]) {
        const int a = lg[k], b = at[k];
        lg[k] = lg[k + 1];
        at[k] = at[k + 1];
        lg[k + 1] = a;
        at[k + 1] = b;
      }
  float acc[CMAX] = {};
  int t = lane;
#pragma unroll
  for (int live = CMAX; live > 0; --live) {
    // lags 0 .. live - 1 (the smallest) have terms while t < N - lg[live-1]
#pragma unroll 4
    for (; t < N - lg[live - 1]; t += 32) {
      const float a = row[t];
#pragma unroll
      for (int k = 0; k < live; ++k) acc[k] = fmaf(a, row[t + lg[k]], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < CMAX; ++k) {
    float v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && at[k] < cnt) dst[at[k]] = v;
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 4)
autocorr_kernel(const float* __restrict__ x, const int* __restrict__ lags,
                float* __restrict__ out, int J, int N, int L, int RB, int TG,
                int vec) {
  constexpr int LT = lag_tile(MT);
  extern __shared__ __align__(16) float smem[];
  const int NS = row_stride(N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rows = smem;
  float* gs = rows + (size_t)RB * NS + warp * 16 * MT * GS;
  int* info = reinterpret_cast<int*>(rows + (size_t)RB * NS +
                                     WARPS * 16 * MT * GS);

  const int j0 = blockIdx.x * RB, nrows = min(RB, J - j0);
  const int ntiles = (L + LT - 1) / LT;
  const int tile0 = blockIdx.y * TG, nt = min(TG, ntiles - tile0);

  // 1. stage the rows (asynchronous copies, all in flight at once), zeros
  // past N
  for (int rr = 0; rr < nrows; ++rr) {
    const float* src = x + (size_t)(j0 + rr) * N;
    float* dst = rows + (size_t)rr * NS;
    if (vec) {
      for (int i = threadIdx.x; i < N / 4; i += THREADS)
        cp_async16(dst + 4 * i, src + 4 * i);
    } else {
      for (int i = threadIdx.x; i < N; i += THREADS)
        cp_async4(dst + i, src + i);
    }
    for (int i = N + threadIdx.x; i < NS; i += THREADS) dst[i] = 0.f;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // 2. each tile's route: consecutive clamped lags take the tensor route
  for (int t = warp; t < nt; t += WARPS) {
    const int l0 = (tile0 + t) * LT, n = min(LT, L - l0);
    const int a0 = clamp_lag(__ldg(lags + l0), N);
    bool ok = true;
    for (int k = lane; k < n; k += 32)
      ok = ok && clamp_lag(__ldg(lags + l0 + k), N) == a0 + k;
    ok = __all_sync(0xffffffffu, ok);
    if (lane == 0) {
      info[INFO * t] = a0;
      info[INFO * t + 1] = ok ? (N - a0 + KSTEP - 1) / KSTEP : -1;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. the units in (row, tile) order, round robin over the warps: a tensor
  // tile whole (lag N, with no k-steps, scores 0), a CUDA tile in units of
  // CC lags, the last up to CC + 1
  int u = 0;
  for (int rr = 0; rr < nrows; ++rr) {
    const float* row = rows + (size_t)rr * NS;
    for (int t = 0; t < nt; ++t) {
      const int l0 = (tile0 + t) * LT, n = min(LT, L - l0);
      const int nk = info[INFO * t + 1];
      float* o = out + (size_t)(j0 + rr) * L + l0;
      if (nk >= 0) {
        if (u++ % WARPS != warp) continue;
        if (nk == 0) {
          for (int d = lane; d < n; d += 32) o[d] = 0.f;
        } else {
          hankel<MT>(row, info[INFO * t], nk, lane, gs);
          diagonals(gs, lane, n, o);
        }
      } else {
        const int nu = cuda_units(n);
        for (int c = 0; c < nu; ++c)
          if (u++ % WARPS == warp)
            direct(row, lags, l0 + CC * c,
                   c + 1 < nu ? CC : n - CC * c, N, lane, o + CC * c);
      }
    }
  }
}

template <int MT>
int launch(const float* x, const int* lags, float* out, int J, int N, int L,
           int RB, int TG, cudaStream_t stream) {
  // the shared-memory ceiling is raised once per device, to the largest
  // size launched so far
  static size_t configured[64] = {};
  const size_t smem = smem_bytes(MT, N, RB, TG);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || configured[dev] < smem) {
    err = cudaFuncSetAttribute(autocorr_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured[dev] = smem;
  }
  const int ntiles = (L + lag_tile(MT) - 1) / lag_tile(MT);
  const int vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  dim3 grid((J + RB - 1) / RB, (ntiles + TG - 1) / TG);
  autocorr_kernel<MT><<<grid, THREADS, smem, stream>>>(x, lags, out, J, N, L,
                                                       RB, TG, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The constants kernels/autocorr.py plans with: T, PAD, MAX_MT, MAX_TG,
// WARPS, written to out[0..4]. Returns how many.
extern "C" int autocorr_constants(int* out) {
  const int c[] = {T, PAD, MAX_MT, MAX_TG, WARPS};
  for (int i = 0; i < 5; ++i) out[i] = c[i];
  return 5;
}

// x: (J, N) f32 contiguous; lags: (L,) int32; out: (J, L) f32 contiguous.
// MT: 16-row tiles of the tensor route's product (lag tiles of 16 MT - 7);
// RB rows and TG lag tiles a block (kernels/autocorr.py's plan). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int autocorr_launch(const float* x, const int* lags, float* out,
                               int J, int N, int L, int MT, int RB, int TG,
                               void* stream) {
  if (J < 1 || L < 1 || N < 1 || N > 16384 || MT < 1 || MT > MAX_MT ||
      RB < 1 || RB > MAX_RB || TG < 1 || TG > MAX_TG ||
      smem_bytes(MT, N, RB, TG) > 232448)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (MT) {
    case 1: return launch<1>(x, lags, out, J, N, L, RB, TG, s);
    case 2: return launch<2>(x, lags, out, J, N, L, RB, TG, s);
    case 3: return launch<3>(x, lags, out, J, N, L, RB, TG, s);
    case 4: return launch<4>(x, lags, out, J, N, L, RB, TG, s);
    case 5: return launch<5>(x, lags, out, J, N, L, RB, TG, s);
    case 6: return launch<6>(x, lags, out, J, N, L, RB, TG, s);
    case 7: return launch<7>(x, lags, out, J, N, L, RB, TG, s);
    default: return launch<8>(x, lags, out, J, N, L, RB, TG, s);
  }
}
