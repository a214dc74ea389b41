// One-sided DFT power spectrum of a batch of real rows, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dft.py (dft_power /
// _kernel), which fed the MXU two N x N matmuls against cos/sin weight
// matrices:
//
//   P[b, f] = |sum_t xc[b,t] exp(-2 pi i t f / N)|^2,   f in [0, N/2]
//
// with xc the row minus its mean when center != 0 (mean taken in f64 in
// the prologue). The function's least time on the card is set by its
// (B*N + B*(N/2+1)) * 4 bytes of traffic; an FFT needs O(N log N) flops a
// row, far below that line. On Hopper an f32 product on the tensor cores
// runs in TF32 and breaks the spectrum tolerance, so both routes here stay
// on the CUDA cores. The wrapper (kernels/dft.py) picks the route by N:
//
// FFT route (dft_power_fft_launch), every 5-smooth N (2^a 3^b 5^c): a
// Stockham (self-sorting) mixed-radix FFT of each row. A block takes G
// rows (2,048 points of 128 threads up to N = 2048, one row of N / 8
// threads above), takes each row's mean in f64, then runs one pass per
// radix of the plan (8s, then a 4 or 2, then 5s, then 3s; the wrapper
// passes it). A pass reads each butterfly's R inputs, multiplies them by
// the twiddles (none in the first pass), runs the radix-R DFT in registers
// and writes the R outputs. The first pass reads the rows from device
// memory (x minus its mean, as (x, 0)) and the last writes |Z|^2 of bins
// 0..N/2 to device memory, so the data crosses shared memory only between
// passes: into a second buffer up to N = 8192 (one pad point every 16
// points against bank conflicts), in place above it (all reads before a
// barrier, all writes after), so that N = 16384 fits its 128 KB. Twiddles come from one length-N f32 table in device memory
// (built once per N in f64 by the wrapper), indexed by the exact integer
// k * r * N / (Ns * R) < N. Each row is transformed on its own, not
// packed two to a complex row: a packed pair leaks one row's rounding into
// the other, so a constant row would no longer give P = 0 exactly, and the
// cycle fit's degenerate-window clamp reads exactly that.
//
// Direct route (dft_power_launch), N with a prime factor above 5: an
// SGEMM-shaped tile. A block of 256 threads owns 64 rows x 64
// frequencies; each thread keeps a 4 x 4 register tile of (re, im)
// accumulators. Time runs in chunks of 32: the chunk of rows is staged
// transposed in shared memory, and the matching 32 x 64 cos/sin tile is
// gathered from a length-N table that the block builds once in shared
// memory (computed in f64, stored f32). The phase index (t * f) mod N is
// exact integer arithmetic, so no N x N weight matrix exists anywhere.
//
// Both take any N from 2 to 16384 on their route, have a fixed order of
// operations and no atomics, so a relaunch is bit-equal.
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

// ---------------------------------------------------------------------------
// FFT route
// ---------------------------------------------------------------------------
constexpr int FFT_MAX_PASSES = 16;   // 3^8 = 6561 needs 8
constexpr int FFT_MAX_THREADS = 1024;


__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// n / d by a multiply-high, exact for every n < 2^17 and every divisor the
// FFT route divides by (checked against integer division for all of them)
struct FastDiv {
  uint32_t d, m;
  __device__ explicit FastDiv(uint32_t d_) : d(d_), m(0xffffffffu / d_ + 1u) {}
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1u ? n : __umulhi(n, m);
  }
};

// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// Forward DFTs of size R in registers: a[q] <- sum_r a[r] W_R^(r q),
// W_R = exp(-2 pi i / R).
template <int R> __device__ __forceinline__ void dft_small(float2 (&a)[R]);

template <> __device__ __forceinline__ void dft_small<2>(float2 (&a)[2]) {
  const float2 s = cadd(a[0], a[1]), d = csub(a[0], a[1]);
  a[0] = s;
  a[1] = d;
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = mul_mi(csub(a1, a3));
  a0 = cadd(s02, s13);
  a2 = csub(s02, s13);
  a1 = cadd(d02, d13);
  a3 = csub(d02, d13);
}

template <> __device__ __forceinline__ void dft_small<4>(float2 (&a)[4]) {
  dft4(a[0], a[1], a[2], a[3]);
}

template <> __device__ __forceinline__ void dft_small<8>(float2 (&a)[8]) {
  constexpr float H = 0.707106781186547524401f;   // sqrt(1/2)
  dft4(a[0], a[2], a[4], a[6]);                   // even samples: E_k
  dft4(a[1], a[3], a[5], a[7]);                   // odd samples: O_k
  const float2 o0 = a[1];
  const float2 o1 = make_float2(H * (a[3].x + a[3].y), H * (a[3].y - a[3].x));
  const float2 o2 = mul_mi(a[5]);
  const float2 o3 = make_float2(H * (a[7].y - a[7].x),
                                -H * (a[7].x + a[7].y));
  const float2 e0 = a[0], e1 = a[2], e2 = a[4], e3 = a[6];
  a[0] = cadd(e0, o0);
  a[4] = csub(e0, o0);
  a[1] = cadd(e1, o1);
  a[5] = csub(e1, o1);
  a[2] = cadd(e2, o2);
  a[6] = csub(e2, o2);
  a[3] = cadd(e3, o3);
  a[7] = csub(e3, o3);
}

template <> __device__ __forceinline__ void dft_small<3>(float2 (&a)[3]) {
  constexpr float S3 = 0.866025403784438646764f;  // sin(2 pi / 3)
  const float2 t = cadd(a[1], a[2]), d = csub(a[1], a[2]);
  const float2 m = make_float2(a[0].x - 0.5f * t.x, a[0].y - 0.5f * t.y);
  const float2 r = make_float2(S3 * d.y, -S3 * d.x);   // -i sin(2pi/3) d
  a[0] = cadd(a[0], t);
  a[1] = cadd(m, r);
  a[2] = csub(m, r);
}

template <> __device__ __forceinline__ void dft_small<5>(float2 (&a)[5]) {
  constexpr float C1 = 0.309016994374947424102f;   // cos(2 pi / 5)
  constexpr float C2 = -0.809016994374947424102f;  // cos(4 pi / 5)
  constexpr float S1 = 0.951056516295153572116f;   // sin(2 pi / 5)
  constexpr float S2 = 0.587785252292473129169f;   // sin(4 pi / 5)
  const float2 t1 = cadd(a[1], a[4]), d1 = csub(a[1], a[4]);
  const float2 t2 = cadd(a[2], a[3]), d2 = csub(a[2], a[3]);
  const float2 m1 = make_float2(a[0].x + C1 * t1.x + C2 * t2.x,
                                a[0].y + C1 * t1.y + C2 * t2.y);
  const float2 m2 = make_float2(a[0].x + C2 * t1.x + C1 * t2.x,
                                a[0].y + C2 * t1.y + C1 * t2.y);
  // -i (S1 d1 + S2 d2) and -i (S2 d1 - S1 d2)
  const float2 r1 = mul_mi(make_float2(S1 * d1.x + S2 * d2.x,
                                       S1 * d1.y + S2 * d2.y));
  const float2 r2 = mul_mi(make_float2(S2 * d1.x - S1 * d2.x,
                                       S2 * d1.y - S1 * d2.y));
  a[0] = cadd(a[0], cadd(t1, t2));
  a[1] = cadd(m1, r1);
  a[4] = csub(m1, r1);
  a[2] = cadd(m2, r2);
  a[3] = csub(m2, r2);
}

// Where a pass reads and writes. The first pass reads the rows from device
// memory (x minus the row's mean, as (x, 0)); the last one writes the
// power of its outputs f <= N/2 to device memory (in the last pass
// Ns = N / R, so butterfly j's output q is bin j + q Ns); the others read
// and write shared memory.
struct PassIO {
  const float* xb;       // the block's first row
  const float* mean;     // per row, or nullptr (no centering)
  float* ob;             // the block's first output row
  int rows;              // rows of the block below B
};

// Butterfly u = (row g, j) of a radix-R pass: inputs j + r N/R, twiddle r
// W_N^(k r N/(Ns R)) with k = j mod Ns (all 1 when Ns = 1), outputs to
// (j - k) R + k + q Ns.
// Point i of the two-buffer passes lies at i + i / 16: one pad point
// every 16 spreads the strided writes of the early passes over all banks
// (without it the first pass's writes of 8 points a butterfly conflict
// 8-way). The in-place passes keep i.
template <bool PAD>
__device__ __forceinline__ int at(int i) {
  return PAD ? i + (i >> 4) : i;
}

template <int R, bool FIRST, bool PAD>
__device__ __forceinline__ void butterfly(float2 (&v)[R], const float2* in,
                                          const PassIO& io,
                                          const float2* __restrict__ tw,
                                          int N, int M, int Ns, int g, int j,
                                          int k) {
  if (FIRST) {
    const float m = io.mean != nullptr && g < io.rows ? io.mean[g] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = make_float2(g < io.rows ? io.xb[g * N + j + r * M] - m : 0.f,
                         0.f);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[at<PAD>(g * N + j + r * M)];
  }
  if (Ns > 1)
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[k * r * (N / (Ns * R))]);
  dft_small<R>(v);
}

template <int R, bool LAST, bool PAD>
__device__ __forceinline__ void store_butterfly(const float2 (&v)[R],
                                                float2* out, const PassIO& io,
                                                int N, int Ns, int g, int j,
                                                int k) {
  if (LAST) {
    const int F = N / 2 + 1;
    if (g < io.rows)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j + r * Ns < F)
          io.ob[g * F + j + r * Ns] = v[r].x * v[r].x + v[r].y * v[r].y;
    return;
  }
  const int dst = g * N + (j - k) * R + k;
  if (!PAD && R % 2 == 0 && Ns == 1) {
    float4* o = reinterpret_cast<float4*>(out + dst);
#pragma unroll
    for (int r = 0; r < R; r += 2)
      o[r / 2] = make_float4(v[r].x, v[r].y, v[r + 1].x, v[r + 1].y);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) out[at<PAD>(dst + r * Ns)] = v[r];
  }
}

// One Stockham pass of radix R from one buffer into another: each
// butterfly is read, transformed and written in one go.
template <int R, bool FIRST, bool LAST>
__device__ __forceinline__ void fft_pass_pp(const float2* in, float2* out,
                                            const PassIO& io,
                                            const float2* __restrict__ tw,
                                            int N, int G, int Ns) {
  const int M = N / R, total = G * M;
  const FastDiv by_m(M), by_ns(Ns);
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int g = by_m.div(u), j = u - g * M;
    const int k = j - by_ns.div(j) * Ns;
    float2 v[R];
    butterfly<R, FIRST, true>(v, in, io, tw, N, M, Ns, g, j, k);
    store_butterfly<R, LAST, true>(v, out, io, N, Ns, g, j, k);
  }
  __syncthreads();
}

// The same pass in place: every thread reads all of its (at most PTS / R)
// butterflies before a barrier and writes them after it.
template <int R, bool FIRST, bool LAST, int PTS>
__device__ __forceinline__ void fft_pass_ip(float2* buf, const PassIO& io,
                                            const float2* __restrict__ tw,
                                            int N, int G, int Ns) {
  constexpr int MB = (PTS + R - 1) / R;
  const int M = N / R, total = G * M;
  const FastDiv by_m(M), by_ns(Ns);
  float2 v[MB][R];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    if (u < total) {
      const int g = by_m.div(u), j = u - g * M;
      butterfly<R, FIRST, false>(v[i], buf, io, tw, N, M, Ns, g, j,
                                 j - by_ns.div(j) * Ns);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int u = threadIdx.x + i * blockDim.x;
    if (u < total) {
      const int g = by_m.div(u), j = u - g * M;
      store_butterfly<R, LAST, false>(v[i], buf, io, N, Ns, g, j,
                                      j - by_ns.div(j) * Ns);
    }
  }
  __syncthreads();
}

template <bool FIRST, bool LAST, bool INPLACE, int PTS>
__device__ __forceinline__ void fft_pass(int R, const float2* in,
                                         float2* out, const PassIO& io,
                                         const float2* __restrict__ tw,
                                         int N, int G, int Ns) {
  if (INPLACE) {
    switch (R) {
      case 8: fft_pass_ip<8, FIRST, LAST, PTS>(out, io, tw, N, G, Ns); break;
      case 4: fft_pass_ip<4, FIRST, LAST, PTS>(out, io, tw, N, G, Ns); break;
      case 2: fft_pass_ip<2, FIRST, LAST, PTS>(out, io, tw, N, G, Ns); break;
      case 5: fft_pass_ip<5, FIRST, LAST, PTS>(out, io, tw, N, G, Ns); break;
      default: fft_pass_ip<3, FIRST, LAST, PTS>(out, io, tw, N, G, Ns);
    }
  } else {
    switch (R) {
      case 8: fft_pass_pp<8, FIRST, LAST>(in, out, io, tw, N, G, Ns); break;
      case 4: fft_pass_pp<4, FIRST, LAST>(in, out, io, tw, N, G, Ns); break;
      case 2: fft_pass_pp<2, FIRST, LAST>(in, out, io, tw, N, G, Ns); break;
      case 5: fft_pass_pp<5, FIRST, LAST>(in, out, io, tw, N, G, Ns); break;
      default: fft_pass_pp<3, FIRST, LAST>(in, out, io, tw, N, G, Ns);
    }
  }
}

// PTS: complex points a thread holds at most in place (G * N <= PTS *
// blockDim.x); MAXT: the most threads a block; INPLACE: one buffer (N =
// 16384 needs it), else two that the passes alternate between. The plan:
// radix of pass p in bits 4p..4p+3 of `codes`.
template <int PTS, int MAXT, bool INPLACE>
__global__ void __launch_bounds__(MAXT, 1)
fft_power_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float2* __restrict__ tw, int B, int N, int G,
                 int center, double inv_n, unsigned long long codes,
                 int n_pass) {
  // G * N points in place, or twice G * N * 17 / 16 (padded, `at`)
  extern __shared__ float2 buf[];
  const int span = INPLACE ? G * N : G * N + (G * N >> 4);
  float2* alt = INPLACE ? buf : buf + span;
  double* part = reinterpret_cast<double*>(alt + span);  // 32
  float* mean = reinterpret_cast<float*>(part + 32);   // G
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, W = T >> 5;
  const long long b0 = (long long)blockIdx.x * G;
  const int rows = (int)min((long long)G, (long long)B - b0);
  const PassIO io{x + b0 * N, center ? mean : nullptr,
                  out + b0 * (N / 2 + 1), rows};

  // row g's f64 sum over the points (16-byte loads where aligned) i0,
  // i0 + step, ..., in a fixed order
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto row_sum = [&](int g, int i0, int step) {
    double acc = 0.0;
    if (g >= rows) return acc;
    const float* row = io.xb + (size_t)g * N;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int t = i0; t < N / 4; t += step) {
        const float4 v = row4[t];
        acc += (double)v.x;
        acc += (double)v.y;
        acc += (double)v.z;
        acc += (double)v.w;
      }
    } else {
      for (int t = i0; t < N; t += step) acc += (double)row[t];
    }
    return acc;
  };
  if (center) {
    // row means in f64 from device memory, each summed in a fixed order
    // (the first pass reads the rows again, from the cache)
    if (G >= W) {
      for (int g = warp; g < G; g += W) {
        double acc = row_sum(g, lane, 32);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) mean[g] = (float)(acc * inv_n);
      }
    } else {
      const int wpr = W / G;                  // warps per row
      const int g = warp / wpr, sub = warp - g * wpr;
      double acc = g < G ? row_sum(g, sub * 32 + lane, wpr * 32) : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) part[warp] = acc;
      __syncthreads();
      if (tid < G) {
        double s = 0.0;
        for (int w = 0; w < wpr; ++w) s += part[tid * wpr + w];
        mean[tid] = (float)(s * inv_n);
      }
    }
    __syncthreads();
  }

  int Ns = 1;
  float2 *src = alt, *dst = buf;
  for (int p = 0; p < n_pass; ++p) {
    const int R = (int)((codes >> (4 * p)) & 15u);
    const bool first = p == 0, last = p == n_pass - 1;
    if (first && last)
      fft_pass<true, true, INPLACE, PTS>(R, src, dst, io, tw, N, G, Ns);
    else if (first)
      fft_pass<true, false, INPLACE, PTS>(R, src, dst, io, tw, N, G, Ns);
    else if (last)
      fft_pass<false, true, INPLACE, PTS>(R, src, dst, io, tw, N, G, Ns);
    else
      fft_pass<false, false, INPLACE, PTS>(R, src, dst, io, tw, N, G, Ns);
    float2* t = src;
    src = dst;
    dst = t;
    Ns *= R;
  }
}

}  // namespace

extern "C" size_t dft_power_smem_bytes(int N) {
  return sizeof(float) * (2 * (size_t)N + TK * XS_STRIDE + 2 * TK * FT);
}

// Direct route. x: (B, N) f32 contiguous; out: (B, N/2+1) f32 contiguous.
// Returns the cudaError_t of the launch (0 on success).
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

// FFT route. x, out as above; tw: (N,) complex f32 W_N^m = exp(-2 pi i m /
// N); radix: the n_pass radices (each 2, 3, 4, 5 or 8) whose product is N.
extern "C" int dft_power_fft_launch(const float* x, float* out,
                                    const void* tw, int B, int N, int center,
                                    const int* radix, int n_pass,
                                    void* stream) {
  if (N < 2 || N > 16384 || n_pass < 1 || n_pass > FFT_MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  unsigned long long codes = 0;
  long long prod = 1;
  for (int p = 0; p < n_pass; ++p) {
    const int r = radix[p];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8)
      return (int)cudaErrorInvalidValue;
    codes |= (unsigned long long)r << (4 * p);
    prod *= r;
  }
  if (prod != N) return (int)cudaErrorInvalidValue;
  // G rows of N points a block: 16 points a thread up to N = 2048 (128
  // threads, measured faster than 256 with 8), 8 up to N = 8192, 16 above
  int G = 1, T;
  if (N <= 2048) {
    G = 2048 / N;
    T = 128;
  } else {
    T = ((N / 8 + 31) / 32) * 32;
    if (T > FFT_MAX_THREADS) T = FFT_MAX_THREADS;
  }
  // two buffers up to N = 8192 (128 KB), one in place above it
  const bool inplace = N > 8192;
  const size_t span = inplace ? (size_t)G * N : (size_t)G * N + G * N / 16;
  const size_t smem = sizeof(float2) * span * (inplace ? 1 : 2)
                      + 32 * sizeof(double) + sizeof(float) * G;
  auto kernel = N <= 2048 ? fft_power_kernel<16, 128, false>
              : N <= 8192 ? fft_power_kernel<8, FFT_MAX_THREADS, false>
                          : fft_power_kernel<16, FFT_MAX_THREADS, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + G - 1) / G);
  kernel<<<blocks, T, smem, (cudaStream_t)stream>>>(
      x, out, static_cast<const float2*>(tw), B, N, G, center,
      1.0 / (double)N, codes, n_pass);
  return (int)cudaGetLastError();
}
