// Causal GQA flash attention, forward, with an optional sliding window, for
// sm_90a: bf16 on the tensor cores, f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel) and, on the path, the function the JAX
// package's attention prefill runs in its place,
// src/repro/models/blocks.py:121 _chunked_causal_attention (its XLA-path
// equivalent). For q (B, H, S, D) and k, v (B, Hkv, S, D), query head h
// reads kv head h / (H / Hkv), and
//
//   o[q] = sum_k softmax_k(q . k * scale, masked) v[k]
//   masked: k > q, or window > 0 and q - k >= window (filled with -1e30)
//
// by an online softmax over kv tiles with a running (m, l, acc) in f32, as
// the TPU kernel keeps it: m starts at -1e30, p = exp(s - m_new) is rounded
// to v's dtype before P.V (p.astype(v_ref.dtype)), l sums the unrounded p,
// and the output is acc / max(l, 1e-30) in q's dtype. The scale is the
// caller's (Zamba2's shared attention takes (D / 2)^-0.5) or D^-0.5,
// rounded once to f32.
//
// What differs from the TPU kernel: its grid walked the kv tiles as the
// innermost, sequential axis with (m, l, acc) in VMEM scratch; here one
// thread block per (b, h, query tile) walks its kv tiles of 64 in a loop
// with (m, l, acc) in registers. It skips every kv tile wholly after its
// last query row, as the TPU kernel does, and also every tile wholly before
// its first row's window, as _chunked_causal_attention trims its kv range.
// It takes what the model's prefill sends and the TPU kernel did not: any
// S >= 1 (the ragged last tile is masked, never padded in memory), any
// D <= 128 (bf16 also 128 < D <= 224), any G = H / Hkv, inputs of any
// strides, and it writes the
// output in (B, S, H, D) memory order, so the caller's (B, S, H * D) view
// before the output projection copies nothing. Each sum has a fixed order
// and there are no atomics and no split of a row across blocks, so a
// second launch is bit-equal to the first.
//
// Bound: 4 D flops per causal (query, key) pair against 4 D input and
// output elements per query row, so at S = 4,096 both paths are bound by
// their operations.
//
// bf16 inputs (attn_wg): the products run on the tensor cores, wgmma
// bf16 x bf16 -> f32. A bf16 product is exact in f32 and the sums are
// f32, the TPU kernel's arithmetic; p is rounded to bf16 for P.V as the
// contract says. A block of 384 threads takes 128 query rows and walks kv
// tiles of 128 keys (64 past D = 128, see kv_tile): two consumer
// warpgroups of 64 rows, and a producer warpgroup whose first warp loads
// the Q tile once and the K and V tiles into a 3-stage ring (2 past D =
// 128), by TMA boxes of 64 columns with the 128-byte
// swizzle, each stage handed over by a pair of mbarriers (full: the bytes
// have landed; empty: both consumers are done with it). The producer
// warpgroup drops to 40 registers a thread (setmaxnreg) so that each
// consumer thread can hold 232: its S (64), O (DP / 2) and P (32)
// fragments. One rank-4 (d, s, head, batch) tensor map per input, built
// on the host with the caller's strides, fills the ragged S tail and the
// columns past D with zeros, so D is padded to DP = 16 ceil(D / 16) for
// free (120 -> 128; past 128, to 224): the zero columns add nothing to
// q . k, and the P.V columns past D are not stored. A consumer computes
// S = Q K^T with m64n128k16 (m64n64k16 on 64-key tiles; Q and K K-major
// in shared memory), masks and takes the
// online softmax on the accumulator fragments (row max and sum over the 4
// threads of a quad), repacks P to bf16 A fragments in registers and adds
// P.V with m64nDPk16 (V MN-major in shared memory). The softmax is
// overlapped with the tensor cores twice over, as FlashAttention-3 does:
// a consumer issues tile t's scores together with tile t - 1's P.V and
// takes t's softmax while P.V runs (o is rescaled once P.V has landed: the
// same arithmetic in the same order as one tile after another), and the
// two consumers take turns to issue their products (named barriers 1 and
// 2), so one's softmax runs while the other's products do. Both consumers
// walk every tile of the block; a tile a consumer's rows cannot see adds
// p = 0 and corr = 1, the same bits as skipping it. exp is 2^x by the SFU
// (ex2.approx.ftz: relative error <= 2^-22, below 2^-126 flushed to 0) of
// fma(s, log2 e, -m log2 e); a row with nothing unmasked yet keeps
// m = -1e30 and gets p = 0. A warp masks only the tiles on its diagonal,
// its window's edge or S's ragged end. Inputs TMA cannot take (a base or
// a b, h, s stride that is not a multiple of 16 bytes, or a d stride !=
// 1) take the same kernel with VEC = false: the producer warp writes the
// same swizzled tiles element by element, so both layouts give the same
// bits. Bound: the tensor cores' bf16 rate.
//
// f32 inputs (attn_f32): every product is an f32 FMA on the CUDA cores;
// TF32 tensor cores keep ~1e-3 and would miss the 2e-5 f32 tolerance. 256
// threads as 16 x 16; a thread owns 4 query rows (ty + 16 i) and, per kv
// tile, 4 score columns (tx + 16 j) and NJ = ceil(D / 16) output columns
// (tx + 16 j), so each score and each output element is summed by one
// thread. The 16 threads of a row are one half-warp and reduce the row's
// max and sum with shuffles. Q, K and V tiles sit in dynamic shared memory
// (rows of Q and K padded to an odd stride, so column reads hit distinct
// banks); P reuses K's tile once the scores are in registers: 98,816 bytes
// at D = 128, two blocks per SM. The heaviest query tiles (the last ones)
// are scheduled first on both paths. Bound: shared-memory loads per FMA
// (0.5 in the scores, 0.375 in P.V) cap it near half the f32 rate; it runs
// in the shallow card-against-CPU checks only.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 128;             // largest head dim in f32
constexpr int WG_DMAX = 224;          // largest head dim in bf16
constexpr float NEG = -1e30f;         // the TPU kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                           // (B, S, H, D), q's dtype
  long long sq[4], sk[4], sv[4];     // strides (elements): b, h, s, d
  long long S;
  float scale;                       // the caller's, or D^-0.5; rounded
                                     // once to f32
  int B, H, G, D, window, nq;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;                // query rows per block
constexpr int BK = 64;                // keys per kv tile
constexpr int THREADS = 256;
constexpr int PP = BK + 1;            // padded row stride of P

static_assert(THREADS == 16 * 16, "16 x 16 thread tile");
static_assert(BQ == 4 * 16 && BK == 4 * 16, "4 rows and 4 columns a thread");

// Floats of dynamic shared memory: Q, then K (or P), then V.
__host__ __device__ inline int q_stride(int D) { return D | 1; }
__host__ __device__ inline int kp_floats(int D) {
  return BK * q_stride(D) > BQ * PP ? BK * q_stride(D) : BQ * PP;
}
__host__ __device__ inline int smem_floats(int D, int nj) {
  return BQ * q_stride(D) + kp_floats(D) + BK * 16 * nj;
}

template <int NJ>
__global__ void __launch_bounds__(THREADS, 2)
attn_f32(const Args a) {
  extern __shared__ float sm[];
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
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
    Qs[r * DP + d] = s < a.S ? q[oq + s * a.sq[2] + d * a.sq[3]] : 0.f;
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
      Ks[r * DP + d] = s < a.S ? k[ok + s * a.sk[2] + d * a.sk[3]] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, d = i % DV;
      const long long s = k0 + r;
      Vs[i] = (s < a.S && d < D) ? v[ov + s * a.sv[2] + d * a.sv[3]] : 0.f;
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
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
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
      static_cast<float*>(a.o)[base + d] = acc[i][j] / denom;
    }
  }
}

template <int NJ>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.D, NJ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_f32<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)a.nq * a.B * a.H);
  attn_f32<NJ><<<blocks, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_any(const Args& a, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 3: return launch<3>(a, stream);
    case 4: return launch<4>(a, stream);
    case 5: return launch<5>(a, stream);
    case 6: return launch<6>(a, stream);
    case 7: return launch<7>(a, stream);
    default: return launch<8>(a, stream);
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma with TMA loads (Hopper)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 128;               // query rows per block
constexpr int CONSUMER_WARPS = 8;     // two warpgroups of 64 rows
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // + a producer one
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65,536 (a
// block of 12 warps starts at 168)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW = 128;              // bytes of a swizzled row: 64 bf16

// Keys per kv tile and stages of the K/V ring, by the padded head dim DP:
// 128 keys in 3 stages up to DP = 128. Past it a 128-key ring would not
// fit shared memory beside the Q tile (at DP = 224, Q alone is 64 KB and
// one stage of 128-key K and V tiles 128 KB), so 64 keys in 2 stages:
// 64 KB of Q and 2 x 64 KB of K and V. A consumer thread then holds O
// (DP / 2 = 112), S (32) and P (16) fragments, as at DP = 128 (64, 64,
// 32).
__host__ __device__ constexpr int kv_tile(int dp) {
  return dp > 128 ? 64 : 128;
}
__host__ __device__ constexpr int stages(int dp) { return dp > 128 ? 2 : 3; }
// the head dim as the bf16 kernel pads it: to 16 up to 128, else to 224
__host__ __device__ constexpr int padded(int D) {
  return D > 128 ? 224 : 16 * ((D + 15) / 16);
}
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two f32 rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Dynamic shared memory from a 1024-byte aligned base: Q as NC column
// blocks of BQ rows, then K[STAGES] and V[STAGES] as NC blocks of BK rows
// each; a block holds 64 columns (zeros past D) in rows of 128 bytes with
// the 128-byte swizzle that TMA writes and wgmma reads (16-byte chunk c of
// row r at chunk c ^ (r % 8)). Then the mbarriers.
template <int NC, int BK, int STAGES>
struct Smem {
  static constexpr int QB = BQ * ROW, KB = BK * ROW;
  static constexpr int Q = 0;
  static constexpr int K = Q + NC * QB;
  static constexpr int V = K + STAGES * NC * KB;
  static constexpr int BAR = V + STAGES * NC * KB;  // full, empty, q
  static constexpr int BYTES = 1024 + BAR + 8 * (2 * STAGES + 1);
};

// O += P V for 64 rows and N columns, depth 16: P's A fragments in
// registers, V MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc);

// S += Q K^T for 64 rows and N keys, depth 16: Q and K K-major in shared
// memory
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<224>(float (&d)[112],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins registers in program order around the asynchronous wgmma: their
// writes before it, their reads after its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4 * N; ++i)
    asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
}

// a shared-memory matrix descriptor with the 128-byte swizzle; byte
// offsets: lbo between 64-column blocks (MN-major only), sbo between
// 8-row groups
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// waits for the phase of this parity to complete; traps after ~2^33
// cycles (seconds), so a fault ends the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// 2^x by the SFU (relative error <= 2^-22, results below 2^-126 flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax in place on the m64n128 accumulator fragments
// `s` (keys k0 .. k0 + BK - 1): scale, mask (only on the warp's diagonal,
// its window's edge or S's end), row max over the quad, m updated, s
// replaced by p = 2^fma(s, log2 e, -m log2 e) and p summed into this
// thread's part of l; corr is each row's factor for the running output (1
// where m did not move).
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float& m0, float& m1, float& l0, float& l1,
    float& corr0, float& corr1, const Args& a, long long k0,
    long long r_first, long long row0, long long row1, int c0) {
  const bool whole = k0 + BK - 1 <= r_first && k0 + BK - 1 < a.S &&
                     (a.window <= 0 || r_first + 15 - k0 < a.window);
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * a.scale;
      if (!whole) {
        const long long col = k0 + 8 * j + c0 + (e & 1);
        const long long row = e < 2 ? row0 : row1;
        const bool keep = col <= row && col < a.S &&
                          (a.window <= 0 || row - col < a.window);
        x = keep ? x : NEG;
      }
      s[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // a row with nothing unmasked yet keeps m = -1e30 and gets p = 0
  const float ml0 = mn0 == NEG ? 0.f : mn0 * LOG2E;
  const float ml1 = mn1 == NEG ? 0.f : mn1 * LOG2E;
  corr0 = m0 == mn0 ? 1.f : ex2(fmaf(m0, LOG2E, -ml0));
  corr1 = m1 == mn1 ? 1.f : ex2(fmaf(m1, LOG2E, -ml1));
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], LOG2E, -ml0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], LOG2E, -ml0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], LOG2E, -ml1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], LOG2E, -ml1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// P rounded to bf16 A fragments of the k16 steps of P.V (the m64nNk16
// layout of the accumulator is the A layout of 16 rows by 16 keys)
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// one box of a rank-4 (d, s, head, batch) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d, int s, int h, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s),
         "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// rows [r0, r0 + ROWS) of a (S, D) slice, row stride ss and d stride sd,
// element by element into NC swizzled column blocks, zeros past S and D:
// the tiles TMA would write. The producer warp's 32 lanes share the work.
template <int ROWS, int NC>
__device__ __forceinline__ void fill(uint32_t dst, const uint16_t* src,
                                     long long ss, long long sd, long long r0,
                                     long long S, int D, int lane) {
  for (int i = lane; i < ROWS * NC * 64; i += 32) {
    const int r = i / (NC * 64), c = i % (NC * 64);
    const long long s = r0 + r;
    const uint16_t x = (s < S && c < D) ? src[s * ss + c * sd] : 0;
    const uint32_t at = dst + (c >> 6) * ROWS * ROW + r * ROW +
                        ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
    asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(at), "h"(x) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
attn_wg(const __grid_constant__ Args a,
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv) {
  constexpr int NC = (DP + 63) / 64;          // 64-column blocks
  constexpr int NKD = DP / 16;                // k-steps of q . k
  constexpr int BK = kv_tile(DP), STAGES = stages(DP);
  using L = Smem<NC, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long BH = (long long)a.B * a.H;
  const long long qt = a.nq - 1 - (long long)blockIdx.x / BH;
  const long long bh = (long long)blockIdx.x % BH;
  const long long b = bh / a.H, h = bh % a.H, hk = h / a.G;
  const long long q0 = qt * BQ;
  const long long q_last = (q0 + BQ - 1 < a.S ? q0 + BQ - 1 : a.S - 1);
  // kv tiles [lo, hi]: none wholly after the last row, none wholly before
  // the first row's window
  const long long hi = q_last / BK;
  long long lo = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) lo = (q0 - a.window + 1) / BK;
  const int nt = (int)(hi - lo + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // producer: one warp loads Q once, then the kv tiles through the ring;
    // the warpgroup hands most of its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (warp != CONSUMER_WARPS) return;
    const uint16_t* q = static_cast<const uint16_t*>(a.q) + b * a.sq[0] +
                        h * a.sq[1];
    const uint16_t* k = static_cast<const uint16_t*>(a.k) + b * a.sk[0] +
                        hk * a.sk[1];
    const uint16_t* v = static_cast<const uint16_t*>(a.v) + b * a.sv[0] +
                        hk * a.sv[1];
    if (VEC) {
      if (lane == 0) {
        mbar_expect(qbar, NC * L::QB);
        for (int c = 0; c < NC; ++c)
          tma_load(base + L::Q + c * L::QB, &tq, 64 * c, (int)q0, (int)h,
                   (int)b, qbar);
      }
    } else {
      fill<BQ, NC>(base + L::Q, q, a.sq[2], a.sq[3], q0, a.S, a.D, lane);
      if (lane == 0) mbar_arrive(qbar);
    }
    for (int t = 0; t < nt; ++t) {
      const int st = t % STAGES;
      const int k0 = (int)((lo + t) * BK);
      if (t >= STAGES) mbar_wait(empty + 8 * st, ((t / STAGES) + 1) & 1);
      const uint32_t kd = base + L::K + st * NC * L::KB;
      const uint32_t vd = base + L::V + st * NC * L::KB;
      if (VEC) {
        if (lane == 0) {
          mbar_expect(full + 8 * st, 2 * NC * L::KB);
          for (int c = 0; c < NC; ++c) {
            tma_load(kd + c * L::KB, &tk, 64 * c, k0, (int)hk, (int)b,
                     full + 8 * st);
            tma_load(vd + c * L::KB, &tv, 64 * c, k0, (int)hk, (int)b,
                     full + 8 * st);
          }
        }
      } else {
        fill<BK, NC>(kd, k, a.sk[2], a.sk[3], k0, a.S, a.D, lane);
        fill<BK, NC>(vd, v, a.sv[2], a.sv[3], k0, a.S, a.D, lane);
        if (lane == 0) mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  // consumers: warpgroup g owns rows q0 + 64 g .. + 63, warp w of it 16 of
  // them; this thread rows row0 = .. + lane / 4 and row0 + 8, columns
  // 2 (lane % 4) and the next in every 8-wide tile (the m64nNk16 layout)
  const int g = warp >> 2, w = warp & 3;
  const long long g_first = q0 + 64 * g, g_last = g_first + 63;
  const long long r_first = g_first + 16 * w;
  const long long row0 = r_first + (lane >> 2), row1 = row0 + 8;
  const int c0 = 2 * (lane & 3);
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's part
  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;


  // the two warpgroups take turns to issue their products (named barriers
  // 1 and 2), so one's softmax runs while the other's products do; both
  // walk every tile of the block (a tile a warpgroup's rows cannot see
  // adds p = 0), so their turns pair up
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + g) : "memory");
  };
  auto your_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - g) : "memory");
  };
  auto arrived = [&](int t) {
    mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
    __syncwarp();
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
  };
  // S = Q K_t^T, issued (Q and K K-major)
  const uint32_t qa = base + L::Q + g * 64 * ROW;
  auto scores = [&](int t, float (&sc)[BK / 2]) {
    const uint32_t kt = base + L::K + (t % STAGES) * NC * L::KB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_qk<BK>(sc, desc(qa + (kk >> 2) * L::QB + off, 16, 1024),
               desc(kt + (kk >> 2) * L::KB + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_t, issued (V, keys x d with d contiguous, MN-major)
  auto values = [&](int t, uint32_t (&p)[BK / 16][4]) {
    const uint32_t vt = base + L::V + (t % STAGES) * NC * L::KB;
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(o, p[kk], desc(vt + kk * 16 * ROW, L::KB, 1024), 1);
    wgmma_commit();
  };

  mbar_wait(qbar, 0);
  if (g == 1) your_turn();                     // warpgroup 0 goes first
  float corr0, corr1;
  uint32_t pa[BK / 16][4];
  {
    float s[BK / 2];
    arrived(0);
    my_turn();
    scores(0, s);
    your_turn();
    wgmma_wait<0>();
    pin(s);
    softmax_tile<BK>(s, m0, m1, l0, l1, corr0, corr1, a, lo * BK, r_first,
                     row0, row1, c0);
    pack_p<BK>(s, pa);
  }
  // S of tile t and P.V of tile t - 1 in flight together, then t's softmax
  // while P.V runs; o is rescaled and P of t packed once P.V of t - 1 has
  // landed (as FlashAttention-3 overlaps them)
  for (int t = 1; t < nt; ++t) {
    float s[BK / 2];
    arrived(t);
    my_turn();
    scores(t, s);
    values(t - 1, pa);
    your_turn();
    wgmma_wait<1>();
    pin(s);
    softmax_tile<BK>(s, m0, m1, l0, l1, corr0, corr1, a, (lo + t) * BK,
                     r_first, row0, row1, c0);
    wgmma_wait<0>();
    pin(o);
    pin(pa);
    release(t - 1);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    pack_p<BK>(s, pa);
  }
  my_turn();
  values(nt - 1, pa);
  your_turn();
  wgmma_wait<0>();
  pin(o);
  pin(pa);
  release(nt - 1);
  if (g == 0) my_turn();                       // the last turn handed over

  // l over the quad; out = acc / max(l, 1e-30), columns < D, rows < S
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  const int D = a.D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = half ? row1 : row0;
    if (row >= a.S) continue;
    const float den = half ? den1 : den0;
    __nv_bfloat16* orow = out + ((b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c0;
      const float y0 = o[4 * j + 2 * half] / den;
      const float y1 = o[4 * j + 2 * half + 1] / den;
      if (col + 1 < D && !(D & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < D) orow[col] = __float2bfloat16_rn(y0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

template <int DP, bool VEC>
int launch(const Args& a, const CUtensorMap* maps, cudaStream_t stream) {
  constexpr int bytes =
      Smem<(DP + 63) / 64, kv_tile(DP), stages(DP)>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_wg<DP, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)a.nq * a.B * a.H);
  attn_wg<DP, VEC><<<blocks, THREADS, bytes, stream>>>(a, maps[0], maps[1],
                                                       maps[2]);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_dp(const Args& a, const CUtensorMap* maps, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
    case 1: return launch<16, VEC>(a, maps, stream);
    case 2: return launch<32, VEC>(a, maps, stream);
    case 3: return launch<48, VEC>(a, maps, stream);
    case 4: return launch<64, VEC>(a, maps, stream);
    case 5: return launch<80, VEC>(a, maps, stream);
    case 6: return launch<96, VEC>(a, maps, stream);
    case 7: return launch<112, VEC>(a, maps, stream);
    case 8: return launch<128, VEC>(a, maps, stream);
    default: return launch<224, VEC>(a, maps, stream);
  }
}

// TMA needs a 16-byte aligned base, d stride 1 and the other strides in
// multiples of 8 elements (a stride of a size-1 dim is unused)
bool vec_ok(const void* p, const long long* st, long long n_b, long long n_h,
            long long S, long long D) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (st[3] == 1 || D == 1) && (st[2] % 8 == 0 || S == 1) &&
         (st[1] % 8 == 0 || n_h == 1) && (st[0] % 8 == 0 || n_b == 1);
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (no -lcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the rank-4 (d, s, head, batch) map of one input with the caller's
// strides, boxes of 64 columns x `rows` rows, the 128-byte swizzle, zeros
// out of bounds; a size-1 dim's stride, never used, is set to a packed one
bool make_map(CUtensorMap* map, const void* p, const long long* st,
              long long B, long long heads, long long S, long long D,
              int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const long long ss = S > 1 ? st[2] : (D + 7) / 8 * 8;
  const long long sh = heads > 1 ? st[1] : ss * S;
  const long long sb = B > 1 ? st[0] : sh * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(p), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

}  // namespace

// q: (B, H, S, D); k, v: (B, Hkv, S, D), each read through its four strides
// (in elements: b, h, s, d), all three of one dtype (0 f32, 1 bf16). o:
// (B, S, H, D) contiguous, of that dtype. shape = {B, H, Hkv, S, D};
// strides = {q, k, v} x {b, h, s, d}; window 0 is plain causal; scale > 0
// multiplies q . k (rounded once to f32), else D^-0.5 does. D <= 128 in
// f32, D <= 224 in bf16. Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* shape,
                                      const long long* strides, int dtype,
                                      int window, double scale,
                                      void* stream) {
  const long long B = shape[0], H = shape[1], Hkv = shape[2], S = shape[3];
  const long long D = shape[4];
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || D < 1 ||
      D > (dtype == 1 ? WG_DMAX : DMAX) || window < 0 ||
      (dtype != 0 && dtype != 1) || B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int bq = dtype == 1 ? wg::BQ : f32::BQ;
  const long long nq = (S + bq - 1) / bq;
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
  a.scale = scale > 0 ? (float)scale : (float)(1.0 / sqrt((double)D));
  a.B = (int)B;
  a.H = (int)H;
  a.G = (int)(H / Hkv);
  a.D = (int)D;
  a.window = window;
  a.nq = (int)nq;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return f32::launch_any(a, st);
  const bool vec = wg::vec_ok(q, a.sq, B, H, S, D) &&
                   wg::vec_ok(k, a.sk, B, Hkv, S, D) &&
                   wg::vec_ok(v, a.sv, B, Hkv, S, D);
  CUtensorMap maps[3] = {};
  const int bk = wg::kv_tile(wg::padded((int)D));
  const bool tma = vec &&
      wg::make_map(&maps[0], q, a.sq, B, H, S, D, wg::BQ) &&
      wg::make_map(&maps[1], k, a.sk, B, Hkv, S, D, bk) &&
      wg::make_map(&maps[2], v, a.sv, B, Hkv, S, D, bk);
  return tma ? wg::launch_dp<true>(a, maps, st)
             : wg::launch_dp<false>(a, maps, st);
}
