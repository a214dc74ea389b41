// Causal GQA flash attention, forward, with an optional sliding window, for
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel) and, on the path, the function the JAX
// package's attention prefill runs in its place,
// src/repro/models/blocks.py:121 _chunked_causal_attention (its XLA-path
// equivalent). For q (B, H, S, D) and k, v (B, Hkv, S, D), query head h
// reads kv head h / (H / Hkv), and
//
//   o[q] = sum_k softmax_k(q . k * D^-0.5, masked) v[k]
//   masked: k > q, or window > 0 and q - k >= window (filled with -1e30)
//
// by an online softmax over kv tiles with a running (m, l, acc) in f32, as
// the TPU kernel keeps it: m starts at -1e30, p = exp(s - m_new) is rounded
// to v's dtype before P.V (p.astype(v_ref.dtype)), l sums the unrounded p,
// and the output is acc / max(l, 1e-30) in q's dtype.
//
// What differs from the TPU kernel: its grid walked the kv tiles as the
// innermost, sequential axis with (m, l, acc) in VMEM scratch; here one
// thread block per (b, h, 64-query tile) walks its kv tiles of 64 in a loop
// with (m, l, acc) in registers. It skips every kv tile wholly after its
// last query row, as the TPU kernel does, and also every tile wholly before
// its first row's window, as _chunked_causal_attention trims its kv range.
// It takes what the model's prefill sends and the TPU kernel did not: any
// S >= 1 (the ragged last tile is masked in the loads, never padded), any
// D <= 128, any G = H / Hkv, inputs of any strides in f32 or bf16, and it
// writes the output in (B, S, H, D) memory order, so the caller's
// (B, S, H * D) view before the output projection copies nothing.
//
// Bound: 4 D flops per causal (query, key) pair against 4 D input and
// output elements per query row, so at S = 4,096 it is bound by its
// operations. Every product is an f32 FMA on the CUDA cores, for both
// dtypes: TF32 tensor cores keep ~1e-3 and would miss the 2e-5 f32
// tolerance (a bf16 p times a bf16 v is exact in f32, so bf16 inputs lose
// nothing here). For bf16 inputs, bf16 mma.sync or wgmma with f32
// accumulation would compute the same exact products with f32 sums; this
// version does not use them, and is slower than the plain version it
// replaced at D = 120 and 128. Each sum has a fixed order and there are no
// atomics, so a second launch is bit-equal to the first.
//
// Design (first version, simple): 256 threads as 16 x 16; a thread owns
// 4 query rows (ty + 16 i) and, per kv tile, 4 score columns (tx + 16 j)
// and NJ = ceil(D / 16) output columns (tx + 16 j), so each score and each
// output element is summed by one thread. The 16 threads of a row are one
// half-warp and reduce the row's max and sum with shuffles. Q, K and V
// tiles sit in dynamic shared memory widened to f32 (rows of Q and K padded
// to an odd stride, so column reads hit distinct banks); P reuses K's tile
// once the scores are in registers: 98,816 bytes at D = 128, two blocks per
// SM. The heaviest query tiles (the last ones) are scheduled first. Left
// for a later PR, first: bf16 tensor-core products for bf16 inputs (the
// f32 path stays on the CUDA cores, or takes a split that keeps 2e-5);
// then TMA loads and a warp-specialised pipeline that overlaps the next
// tile's loads with this tile's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int BK = 64;                // keys per kv tile
constexpr int THREADS = 256;
constexpr int DMAX = 128;             // largest head dim
constexpr int PP = BK + 1;            // padded row stride of P
constexpr float NEG = -1e30f;         // the TPU kernel's NEG_INF

static_assert(THREADS == 16 * 16, "16 x 16 thread tile");
static_assert(BQ == 4 * 16 && BK == 4 * 16, "4 rows and 4 columns a thread");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                           // (B, S, H, D), q's dtype
  long long sq[4], sk[4], sv[4];     // strides (elements): b, h, s, d
  long long S;
  float scale;                       // D^-0.5, rounded once to f32
  int B, H, G, D, window, nq;
};

template <bool BF16>
__device__ __forceinline__ float load(const void* p, long long off) {
  if (BF16)
    return __uint_as_float(
        (uint32_t)static_cast<const uint16_t*>(p)[off] << 16);
  return static_cast<const float*>(p)[off];
}

template <bool BF16>
__device__ __forceinline__ float to_dtype(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Floats of dynamic shared memory: Q, then K (or P), then V.
__host__ __device__ inline int q_stride(int D) { return D | 1; }
__host__ __device__ inline int kp_floats(int D) {
  return BK * q_stride(D) > BQ * PP ? BK * q_stride(D) : BQ * PP;
}
__host__ __device__ inline int smem_floats(int D, int nj) {
  return BQ * q_stride(D) + kp_floats(D) + BK * 16 * nj;
}

template <int NJ, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const Args a) {
  extern __shared__ float sm[];
  const int D = a.D, DP = q_stride(D), DV = 16 * NJ;
  float* Qs = sm;                     // BQ x DP
  float* Ks = Qs + BQ * DP;           // BK x DP; then P, BQ x PP
  float* Vs = Ks + kp_floats(D);      // BK x DV, columns >= D zero

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long BH = (long long)a.B * a.H;
  const long long qt = a.nq - 1 - (long long)blockIdx.x / BH;
  const long long bh = (long long)blockIdx.x % BH;
  const long long b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const long long q0 = qt * BQ;
  const long long q_last = (q0 + BQ - 1 < a.S ? q0 + BQ - 1 : a.S - 1);
  const long long oq = b * a.sq[0] + h * a.sq[1];
  const long long ok = b * a.sk[0] + hk * a.sk[1];
  const long long ov = b * a.sv[0] + hk * a.sv[1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const long long s = q0 + r;
    Qs[r * DP + d] = s < a.S ? load<BF16>(a.q, oq + s * a.sq[2] + d * a.sq[3])
                             : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // kv tiles [lo, hi]: none wholly after the last row, none wholly before
  // the first row's window
  const long long hi = q_last / BK;
  long long lo = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) lo = (q0 - a.window + 1) / BK;

  for (long long kt = lo; kt <= hi; ++kt) {
    const long long k0 = kt * BK;
    __syncthreads();                  // the last tile's P and V are read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const long long s = k0 + r;
      Ks[r * DP + d] = s < a.S
          ? load<BF16>(a.k, ok + s * a.sk[2] + d * a.sk[3]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, d = i % DV;
      const long long s = k0 + r;
      Vs[i] = (s < a.S && d < D)
          ? load<BF16>(a.v, ov + s * a.sv[2] + d * a.sv[3]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j, summed over d in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long col = k0 + tx + 16 * j;
        const bool keep = col <= row && col < a.S &&
                          (a.window <= 0 || row - col < a.window);
        s[i][j] = keep ? s[i][j] * a.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                  // every thread is done with K
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = to_dtype<BF16>(s[i][j]);
    __syncthreads();

    // acc += P . V, summed over the tile's keys in order
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long base = ((b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d >= D) continue;
      const float y = acc[i][j] / denom;
      if (BF16)
        static_cast<__nv_bfloat16*>(a.o)[base + d] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(a.o)[base + d] = y;
    }
  }
}

template <int NJ, bool BF16>
int launch(const Args& a, unsigned blocks, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.D, NJ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NJ, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<NJ, BF16><<<blocks, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_nj(const Args& a, unsigned blocks, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
    case 1: return launch<1, BF16>(a, blocks, stream);
    case 2: return launch<2, BF16>(a, blocks, stream);
    case 3: return launch<3, BF16>(a, blocks, stream);
    case 4: return launch<4, BF16>(a, blocks, stream);
    case 5: return launch<5, BF16>(a, blocks, stream);
    case 6: return launch<6, BF16>(a, blocks, stream);
    case 7: return launch<7, BF16>(a, blocks, stream);
    default: return launch<8, BF16>(a, blocks, stream);
  }
}

}  // namespace

// q: (B, H, S, D); k, v: (B, Hkv, S, D), each read through its four strides
// (in elements: b, h, s, d), all three of one dtype (0 f32, 1 bf16). o:
// (B, S, H, D) contiguous, of that dtype. shape = {B, H, Hkv, S, D};
// strides = {q, k, v} x {b, h, s, d}; window 0 is plain causal. Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* shape,
                                      const long long* strides, int dtype,
                                      int window, void* stream) {
  const long long B = shape[0], H = shape[1], Hkv = shape[2], S = shape[3];
  const long long D = shape[4];
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || D < 1 ||
      D > DMAX || window < 0 || (dtype != 0 && dtype != 1) ||
      B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long nq = (S + BQ - 1) / BQ;
  if (nq * B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 4; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[4 + i];
    a.sv[i] = strides[8 + i];
  }
  a.S = S;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.B = (int)B;
  a.H = (int)H;
  a.G = (int)(H / Hkv);
  a.D = (int)D;
  a.window = window;
  a.nq = (int)nq;
  const unsigned blocks = (unsigned)(nq * B * H);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch_nj<true>(a, blocks, st)
                    : launch_nj<false>(a, blocks, st);
}
