// Chunked gated-linear-attention scan (Mamba2 SSD / RWKV6 WKV), f32, for
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan /
// _kernel), and with it the function the JAX package's SSM layers call under
// another name, src/repro/models/gla.py gla_chunked (Mamba2 prefill,
// mamba2.py:109; RWKV6 prefill, rwkv6.py:149). Per (batch, head) it runs the
// linear recurrence over an f32 (Dk, Dv) state
//
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//   SSD  (u == NULL): y_t = q_t S_t
//   RWKV (u != NULL): y_t = q_t S_{t-1} + (q_t . u . k_t) v_t
//
// chunk-parallel, as gla_chunked does: chunks of Q = 32 tokens, the log
// decay clamped to [-4, 0] and cumulated inside the chunk, the pairwise
// term factored around the mid-chunk cumulative decay (so both factors stay
// inside f32 range), a masked Q x Q score tile, and the state carried from
// chunk to chunk. y is written in f32 (gla_chunked's type; the TPU kernel
// cast to v's), and the final state in f32.
//
// What differs from the TPU kernel: it walked the chunks as the innermost,
// sequential grid axis with the state in VMEM scratch; here one thread
// block per (b, h) walks them in a loop with the state in shared memory.
// It also takes what gla_chunked takes and the TPU kernel did not: an
// optional initial state, any S >= 1 (the ragged last chunk is masked in
// the loads, which is gla_chunked's zero padding without a padded copy),
// and inputs of any strides, stride 0 included (Mamba2 broadcasts B and C
// over heads and the per-head decay over the state dimension), read as
// f32 or bf16 and widened to f32 in registers.
//
// Bound: per chunk 2 Q^2 Dk (scores) + 2 Q^2 Dv (intra-chunk readout)
// + 2 Q Dk Dv (state readout) + 2 Q Dk Dv (state update) flops against
// Q (2 Dk + Dv + Dk) input elements: about 200 flops per byte at Dk = Dv
// = 64, so it is bound by its operations. The products run as f32 FMAs on
// the CUDA cores, not TF32 tensor cores, whose ~1e-3 relative error misses
// the 2e-4 tolerance. Every sum has a fixed order and there are no atomics,
// so a second launch is bit-equal to the first.
//
// Design (first version, simple): 256 threads, ~62 KB of dynamic shared
// memory (q, k, cumulative decay, scratch and v tiles of Q x 64, the
// 64 x 64 state, the Q x Q scores), rows padded to 65 floats so that
// column reads hit distinct banks. Each matmul gives a thread a small
// register tile (4 x 1 scores, 4 x 2 outputs, 8 x 2 state entries).
// Dk and Dv up to 64; smaller ones are zero-padded in shared memory,
// which adds nothing to any sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;                 // chunk, as gla.CHUNK
constexpr int DMAX = 64;              // largest Dk and Dv
constexpr int DP = DMAX + 1;          // padded row stride of the tiles
constexpr int QP = Q + 1;             // padded row stride of the scores
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float CLAMP = 4.0f;         // gla.LOG_DECAY_CLAMP
constexpr int SMEM_FLOATS = 5 * Q * DP + DMAX * DP + Q * QP + 3 * DMAX + Q;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

static_assert(THREADS == 4 * DMAX, "tile maps assume 256 threads, D <= 64");
static_assert(WARPS * 4 == Q, "score and output tiles: 4 rows per warp");
static_assert(WARPS * 8 == DMAX, "state tile: 8 rows per warp");

// A (B, H, S, D) input read through its strides (in elements), f32 (0)
// or bf16 (1).
struct In {
  const void* p;
  long long sb, sh, st, sd;
  int dtype;
};

struct Args {
  In q, k, v, lw;
  const float* u;       // (H, Dk) bonus; NULL selects SSD
  const float* s0;      // (B, H, Dk, Dv) initial state or NULL
  float* y;             // (B, H, S, Dv)
  float* state;         // (B, H, Dk, Dv)
  long long S;
  int H, Dk, Dv;
};

__device__ __forceinline__ float load(const In& x, long long off) {
  if (x.dtype == 0) return static_cast<const float*>(x.p)[off];
  // bf16 is the high half of the f32 with the same value
  return __uint_as_float((uint32_t)static_cast<const uint16_t*>(x.p)[off]
                         << 16);
}

// jnp.clip(x, -CLAMP, 0): NaN stays NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clamp_log_decay(float x) {
  return x < -CLAMP ? -CLAMP : (x > 0.f ? 0.f : x);
}

__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const Args a) {
  extern __shared__ float sm[];
  float* qs = sm;                  // q; then q * exp(Lq)        (readout)
  float* ks = qs + Q * DP;         // k; then k * exp(Ltot - L)  (update)
  float* Ls = ks + Q * DP;         // log decay; cumsum L; then k * exp(shift - L)
  float* Xs = Ls + Q * DP;         // RWKV's Lq = L - lw; then q * exp(Lq - shift)
  float* vs = Xs + Q * DP;         // v
  float* St = vs + Q * DP;         // state (Dk x Dv)
  float* sc = St + DMAX * DP;      // masked scores (Q x Q)
  float* shift = sc + Q * QP;      // L at mid-chunk
  float* ltot = shift + DMAX;      // L at chunk end
  float* us = ltot + DMAX;         // bonus u of this head
  float* diag = us + DMAX;         // q_t . u . k_t

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x;
  const long long b = bh / a.H, h = bh % a.H;
  const bool ssd = a.u == nullptr;
  const long long oq = b * a.q.sb + h * a.q.sh, ok = b * a.k.sb + h * a.k.sh;
  const long long ov = b * a.v.sb + h * a.v.sh, ol = b * a.lw.sb + h * a.lw.sh;

  for (int i = tid; i < DMAX * DMAX; i += THREADS) {
    const int d = i / DMAX, e = i % DMAX;
    St[d * DP + e] = (a.s0 != nullptr && d < a.Dk && e < a.Dv)
        ? a.s0[(bh * a.Dk + d) * a.Dv + e] : 0.f;
  }
  if (tid < DMAX)
    us[tid] = (!ssd && tid < a.Dk) ? a.u[h * a.Dk + tid] : 0.f;

  const long long nc = (a.S + Q - 1) / Q;
  for (long long c = 0; c < nc; ++c) {
    const long long t0 = c * Q;
    // 1. load the chunk, zeros past S or past Dk / Dv (exact padding)
    for (int i = tid; i < Q * DMAX; i += THREADS) {
      const int t = i / DMAX, d = i % DMAX;
      const long long s = t0 + t;
      float qv = 0.f, kv = 0.f, lv = 0.f, vv = 0.f;
      if (s < a.S && d < a.Dk) {
        qv = load(a.q, oq + s * a.q.st + d * a.q.sd);
        kv = load(a.k, ok + s * a.k.st + d * a.k.sd);
        lv = clamp_log_decay(load(a.lw, ol + s * a.lw.st + d * a.lw.sd));
      }
      if (s < a.S && d < a.Dv) vv = load(a.v, ov + s * a.v.st + d * a.v.sd);
      qs[t * DP + d] = qv;
      ks[t * DP + d] = kv;
      Ls[t * DP + d] = lv;
      vs[t * DP + d] = vv;
    }
    __syncthreads();

    // 2. inclusive cumsum of the log decay (one thread per channel, in
    //    order) and, for RWKV, the diagonal bonus (one warp per row)
    if (tid < DMAX) {
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float lw = Ls[t * DP + tid];
        run += lw;
        Ls[t * DP + tid] = run;
        if (!ssd) Xs[t * DP + tid] = run - lw;
      }
      shift[tid] = Ls[(Q / 2) * DP + tid];
      ltot[tid] = run;
    }
    if (!ssd) {
      for (int t = warp; t < Q; t += WARPS) {
        float p = 0.f;
        for (int d = lane; d < DMAX; d += 32)
          p += qs[t * DP + d] * us[d] * ks[t * DP + d];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (lane == 0) diag[t] = p;
      }
    }
    __syncthreads();

    // 3. the decay factors, in place (each element by one thread)
    for (int i = tid; i < Q * DMAX; i += THREADS) {
      const int t = i / DMAX, d = i % DMAX, o = t * DP + d;
      const float L = Ls[o], Lq = ssd ? L : Xs[o];
      const float q = qs[o], k = ks[o];
      Xs[o] = q * expf(Lq - shift[d]);
      qs[o] = q * expf(Lq);
      Ls[o] = k * expf(shift[d] - L);
      ks[o] = k * expf(ltot[d] - L);
    }
    __syncthreads();

    // 4. scores[t][s] = q_in[t] . k_in[s], masked (s <= t SSD, s < t RWKV),
    //    plus the bonus on the diagonal; thread: rows warp*4.., column lane
    {
      const int s = lane;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < DMAX; ++d) {
        const float kk = Ls[s * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += Xs[(warp * 4 + i) * DP + d] * kk;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = warp * 4 + i;
        float v = (ssd ? s <= t : s < t) ? acc[i] : 0.f;
        if (!ssd && s == t) v += diag[t];
        sc[t * QP + s] = v;
      }
    }
    __syncthreads();

    // 5. y = scores @ v + (q * exp(Lq)) @ S; thread: rows warp*4..,
    //    columns lane and lane + 32
    {
      float yi[4][2] = {}, ye[4][2] = {};
      for (int s = 0; s < Q; ++s) {
        const float v0 = vs[s * DP + lane], v1 = vs[s * DP + lane + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sc[(warp * 4 + i) * QP + s];
          yi[i][0] += p * v0;
          yi[i][1] += p * v1;
        }
      }
      for (int d = 0; d < DMAX; ++d) {
        const float s0 = St[d * DP + lane], s1 = St[d * DP + lane + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qq = qs[(warp * 4 + i) * DP + d];
          ye[i][0] += qq * s0;
          ye[i][1] += qq * s1;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long s = t0 + warp * 4 + i;
        if (s >= a.S) continue;
        float* row = a.y + (bh * a.S + s) * a.Dv;
        if (lane < a.Dv) row[lane] = yi[i][0] + ye[i][0];
        if (lane + 32 < a.Dv) row[lane + 32] = yi[i][1] + ye[i][1];
      }
    }
    __syncthreads();

    // 6. S = diag(exp(Ltot)) S + (k * exp(Ltot - L))^T v; thread: state
    //    rows warp*8.., columns lane and lane + 32
    {
      float acc[8][2] = {};
      for (int s = 0; s < Q; ++s) {
        const float v0 = vs[s * DP + lane], v1 = vs[s * DP + lane + 32];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float kk = ks[s * DP + warp * 8 + i];
          acc[i][0] += kk * v0;
          acc[i][1] += kk * v1;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = warp * 8 + i;
        const float w = expf(ltot[d]);
        St[d * DP + lane] = w * St[d * DP + lane] + acc[i][0];
        St[d * DP + lane + 32] = w * St[d * DP + lane + 32] + acc[i][1];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < a.Dk * a.Dv; i += THREADS) {
    const int d = i / a.Dv, e = i % a.Dv;
    a.state[bh * a.Dk * a.Dv + i] = St[d * DP + e];
  }
}

bool valid_dtype(int code) { return code == 0 || code == 1; }

}  // namespace

// q, k, lw: (B, H, S, Dk); v: (B, H, S, Dv); each read through its four
// strides (in elements, 0 allowed) with its dtype code (0 f32, 1 bf16). u: (H, Dk) f32 contiguous, NULL for SSD mode. s0: (B, H, Dk, Dv)
// f32 contiguous, or NULL for a zero initial state. y: (B, H, S, Dv) f32
// and state: (B, H, Dk, Dv) f32, both contiguous.
// shape = {B, H, S, Dk, Dv}; strides = {q, k, v, lw} x {b, h, s, d};
// dtypes = {q, k, v, lw}. Returns the cudaError_t of the launch.
extern "C" int ssm_scan_launch(const void* q, const void* k, const void* v,
                               const void* lw, const float* u,
                               const float* s0, float* y, float* state,
                               const long long* shape,
                               const long long* strides, const int* dtypes,
                               void* stream) {
  const long long B = shape[0], H = shape[1], S = shape[2];
  const long long Dk = shape[3], Dv = shape[4];
  if (B < 1 || H < 1 || S < 1 || Dk < 1 || Dk > DMAX || Dv < 1 || Dv > DMAX
      || B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (!valid_dtype(dtypes[i])) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, lw};
  In ins[4];
  for (int i = 0; i < 4; ++i)
    ins[i] = In{ptrs[i], strides[4 * i], strides[4 * i + 1],
                strides[4 * i + 2], strides[4 * i + 3], dtypes[i]};
  const Args a{ins[0], ins[1], ins[2], ins[3], u, s0, y, state, S, (int)H,
               (int)Dk, (int)Dv};
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_kernel<<<(unsigned)(B * H), THREADS, SMEM_BYTES,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
