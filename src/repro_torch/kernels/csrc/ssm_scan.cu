// Chunked gated-linear-attention scan (Mamba2 SSD / RWKV6 WKV), f32 state
// and output, products on the tensor cores, for sm_90a.
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
// decay clamped to [-4, 0] and cumulated inside the chunk, a masked Q x Q
// score tile, and the state carried from chunk to chunk. y is written in
// f32 (gla_chunked's type), and the final state in f32. It takes an
// optional initial state, any S >= 1 (the ragged last chunk is masked in
// the loads: gla_chunked's zero padding without a padded copy), and inputs
// of any strides, stride 0 included, read as f32 or bf16.
//
// Bound: the four products of a chunk (scores, scores x v, the state's
// readout and its update) are ~200 flops per input byte at Dk = Dv = 64,
// so the scan is bound by its operations on the CUDA cores and close to
// its bytes on the tensor cores. The products run as mma.sync m16n8k8 TF32
// with each f32 operand split as hi + lo (both TF32) and hi*hi + hi*lo +
// lo*hi summed in f32 (3xTF32): one plain TF32 product keeps ~11 bits and
// misses the 2e-4 tolerance, the split keeps ~21. An operand that is
// exactly TF32 (raw bf16 inputs) has lo = 0, and its extra product is
// skipped.
//
// Two forms, chosen by the launcher:
//
// - SCALAR (SSD with a decay broadcast over Dk, Mamba2's): the scores are
//   (q k^T)[t, s] * exp(L_t - L_s) for s <= t, with q k^T from the raw
//   inputs and one exp per token pair; the readout is exp(L_t) (q_t S) and
//   the update S = exp(L_end) S + k^T (v * exp(L_end - L_s)). Every
//   exponent is <= 0, so nothing can overflow. When q and k are shared by
//   every head (stride 0 over H), a block takes HB = 2 heads of one batch
//   row, loads q and k once and forms q k^T once for both.
// - GENERAL (per-channel decay: RWKV with its bonus, or SSD): the factored
//   form of gla_chunked around the mid-chunk cumulative decay (4 x 16
//   tokens = 64 < 88 keeps both factors inside f32 range).
//
// Design: 4 warps a head. Warp w keeps rows 16w..16w+15 of the head's
// state in mma accumulators for the whole scan, and a copy in shared
// memory for the next chunk's readout (stride 72, so the column reads of
// a B fragment hit distinct banks). A chunk's inputs land in one of two
// staging buffers while the chunk before computes: one TMA box a tile (on
// one mbarrier) where TMA takes the layout, else element by element; in
// bf16 when q, k and v are bf16 (the models' case), else in f32; and the
// products read them there as they are. A chunk: the cumulated decay (SCALAR: one warp's shuffles a head;
// GENERAL: a thread per channel and half chunk, then two exps an
// element), the score tiles (the two above the diagonal skipped), then
// each warp forms a 16 x 32 block of y (readout then scores x v) and its
// 16 state rows; three barriers a chunk (five in the GENERAL form). Fixed
// orders and no atomics, so a second launch is bit-equal to the first.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32.cuh"

namespace {

constexpr int Q = 32;                 // chunk, as gla.CHUNK
constexpr int DMAX = 64;              // largest Dk and Dv
constexpr int QS = DMAX + 4;          // stride of f32 tiles (= 4 mod 32)
constexpr int VS = DMAX + 8;          // stride of the state (= 8 mod 32)
constexpr int PS = Q + 4;             // stride of the scores
constexpr int GROUP = 128;            // threads a head
constexpr float CLAMP = 4.0f;         // gla.LOG_DECAY_CLAMP

// A (B, H, S, D) input read through its strides (in elements), f32 (0)
// or bf16 (1); tma: its tiles arrive by TMA through the tensor map the
// launcher built (16-byte aligned rows, d stride 1).
struct In {
  const void* p;
  long long sb, sh, st, sd;
  int dtype, tma;
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

__host__ __device__ constexpr int esize(int dtype) { return dtype == 0 ? 4 : 2; }

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

// --- staging -----------------------------------------------------------------
// Each chunk's inputs land in one of two staging buffers, in their own
// type when it is the kernel's (bf16 raw bits when q, k and v are bf16,
// else f32), rows padded so that fragment reads hit distinct banks
// (144-byte bf16 rows, 272-byte f32 rows). A tile whose layout TMA takes
// arrives as one box of 32 rows (cp.async.bulk.tensor, on one mbarrier),
// the pad columns, the columns past D and the rows past S zero-filled by
// TMA itself. Other layouts are read element by element into the same
// tiles. The products read the staged tiles as they are: nothing is
// widened in between.
template <bool BF16> struct Stg;
template <> struct Stg<true> {
  using T = uint16_t;
  static constexpr int S = DMAX + 8;
};
template <> struct Stg<false> {
  using T = float;
  static constexpr int S = DMAX + 4;
};

__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}
__device__ __forceinline__ float widen(float f) { return f; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
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

// one box of a rank-4 (d, s, head, batch) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int s, int h, int b, uint32_t bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(s),
         "r"(h), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the bytes of one staged tile of T (a TMA box: every row, pad included)
template <typename T>
__host__ __device__ constexpr uint32_t box_bytes() {
  return (uint32_t)(Q * Stg<sizeof(T) == 2>::S * sizeof(T));
}

// x's rows t0.. into the staged tile dst (row stride SE): one TMA box from
// the issuing thread, or element by element over `nthr` threads, zeros
// past S and past D. A head that does not exist keeps the zeros the
// kernel started with.
template <typename T, int SE>
__device__ void stage_tile(const In& x, const CUtensorMap* map,
                           long long base, long long t0, long long S, int D,
                           int h, int b, T* dst, uint32_t bar, bool issuer,
                           int tid, int nthr) {
  if (x.tma) {
    if (issuer)
      tma_load(smem_addr(dst), map, (int)t0, x.sh ? h : 0, x.sb ? b : 0,
               bar);
    return;
  }
  for (int i = tid; i < Q * DMAX; i += nthr) {
    const int t = i / DMAX, d = i % DMAX;
    const long long s = t0 + t;
    T val = T(0);
    if (s < S && d < D) {
      const long long off = base + s * x.st + d * x.sd;
      if constexpr (sizeof(T) == 2)
        val = static_cast<const uint16_t*>(x.p)[off];       // bf16 bits
      else
        val = load(x, off);
    }
    dst[t * SE + d] = val;
  }
}

// --- tensor-core helpers ---------------------------------------------------
// x = hi + lo, both TF32 (tf32.cuh). An EXACT operand (raw bf16) is its
// own hi, and lo = 0.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split_tf32(x, hi, lo);
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the small terms first, a term whose lo part is 0
// left out
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!AX) mma_tf32(c, al, bh);
  if (!BX) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Fragments of m16n8k8 (g = lane / 4, r = lane % 4), read from a tile of
// element type E and row stride S through the thread's own base pointer.
// A (16 x 8) from a row-major tile t[row][col] at (r0, c0): pass
// t + g * S + r.
template <bool EXACT, int S, typename E>
__device__ __forceinline__ void frag_a(const E* t, int r0, int c0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split<EXACT>(widen(t[r0 * S + c0]), hi[0], lo[0]);
  split<EXACT>(widen(t[(r0 + 8) * S + c0]), hi[1], lo[1]);
  split<EXACT>(widen(t[r0 * S + c0 + 4]), hi[2], lo[2]);
  split<EXACT>(widen(t[(r0 + 8) * S + c0 + 4]), hi[3], lo[3]);
}

// A (16 x 8) = t^T: A[m][k] = t[c0 + k][r0 + m]: pass t + r * S + g.
template <bool EXACT, int S, typename E>
__device__ __forceinline__ void frag_a_t(const E* t, int r0, int c0,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split<EXACT>(widen(t[c0 * S + r0]), hi[0], lo[0]);
  split<EXACT>(widen(t[c0 * S + r0 + 8]), hi[1], lo[1]);
  split<EXACT>(widen(t[(c0 + 4) * S + r0]), hi[2], lo[2]);
  split<EXACT>(widen(t[(c0 + 4) * S + r0 + 8]), hi[3], lo[3]);
}

// B (8 x 8) with B[k][n] = t[n0 + n][k0 + k]: pass t + g * S + r.
template <bool EXACT, int S, typename E>
__device__ __forceinline__ void frag_b_n(const E* t, int k0, int n0,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split<EXACT>(widen(t[n0 * S + k0]), hi[0], lo[0]);
  split<EXACT>(widen(t[n0 * S + k0 + 4]), hi[1], lo[1]);
}

// B (8 x 8) with B[k][n] = t[k0 + k][n0 + n] * w_k (w0, w1: the scales of
// rows r and r + 4): pass t + r * S + g.
template <bool EXACT, int S, typename E>
__device__ __forceinline__ void frag_b_k(const E* t, int k0, int n0,
                                         float w0, float w1,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split<EXACT>(widen(t[k0 * S + n0]) * w0, hi[0], lo[0]);
  split<EXACT>(widen(t[(k0 + 4) * S + n0]) * w1, hi[1], lo[1]);
}

// Shared-memory layout. Floats first: GENERAL's four f32 tiles (q then
// q exp(Lq), k then k exp(Ltot - L), X = q exp(Lq - shift), the cumsum then
// k exp(shift - L)); per head the state, the scores and the decay's
// scratch (SCALAR: the chunk's cumulated log decay, Q; GENERAL: the total
// per channel, the bonus, the cumsum's half totals and q_t . u . k_t,
// 5 DMAX + Q). Then the mbarrier (16 bytes) and two staging buffers, each
// q, k, HB v tiles and the log decay (SCALAR: Q f32 a head; GENERAL: an
// f32 tile).
template <bool SCALAR, int HB, bool BF16>
struct Layout {
  using T = typename Stg<BF16>::T;
  static constexpr int SE = Stg<BF16>::S;
  static constexpr int shared = SCALAR ? 0 : 4 * Q * QS;
  static constexpr int head =
      DMAX * VS + Q * PS + (SCALAR ? Q : 5 * DMAX + Q);
  static constexpr int floats = shared + HB * head;
  static constexpr int tile = Q * SE * (int)sizeof(T);       // bytes
  static constexpr int lw_tile = SCALAR ? HB * Q * 4 : Q * QS * 4;
  static constexpr int buffer = (2 + HB) * tile + lw_tile;   // bytes
  static constexpr int bar = floats * 4;
  // the staging buffers start at the next 128-byte boundary (TMA's
  // alignment), found at run time: room for it is allocated
  static constexpr size_t bytes = (size_t)bar + 16 + 127 + 2 * buffer;
  static_assert(floats % 4 == 0 && tile % 128 == 0 && buffer % 128 == 0,
                "128-byte alignment of the staged tiles");
};

template <bool SCALAR, int HB, bool BF16>
__global__ void __launch_bounds__(GROUP * HB, 2)
ssm_scan_kernel(const __grid_constant__ Args a,
                const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tl) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  using LY = Layout<SCALAR, HB, BF16>;
  using T = typename LY::T;
  constexpr int SE = LY::SE;
  constexpr int NT = GROUP * HB;
  constexpr bool QX = SCALAR && BF16;   // raw q and k read as they are
  constexpr bool VX = BF16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = tid / GROUP, htid = tid % GROUP, wq = warp & 3;
  const int g = lane >> 2, r4 = lane & 3;
  const bool ssd = a.u == nullptr;

  const int groups = (a.H + HB - 1) / HB;
  const long long b = blockIdx.x / groups;
  const int h0 = (int)(blockIdx.x % groups) * HB;
  const int h = h0 + hg;
  const bool valid = h < a.H;
  const long long bh = b * a.H + h;

  float* qs = sm;                       // GENERAL: q exp(Lq)
  float* ks = qs + Q * QS;              // GENERAL: k exp(Ltot - L)
  float* Xs = ks + Q * QS;              // GENERAL: q exp(Lq - shift)
  float* Ls = Xs + Q * QS;              // GENERAL: cumsum, k exp(shift - L)
  float* St = sm + LY::shared + hg * LY::head;   // state entering the chunk
  float* Ps = St + DMAX * VS;           // masked scores
  float* Lh = Ps + Q * PS;              // SCALAR: cumulated log decay (Q)
  float* ltot = Lh;                     // GENERAL: total log decay (DMAX)
  float* us = ltot + DMAX;              // GENERAL: bonus (DMAX)
  float* part = us + DMAX;              // GENERAL: the halves' totals and
                                        // the second half's first (3 DMAX)
  float* diag = part + 3 * DMAX;        // GENERAL: q_t . u . k_t (Q)
  char* smc = reinterpret_cast<char*>(sm);
  const uint32_t bar = smem_addr(smc + LY::bar);
  char* stage = smc + (((smem_addr(smc) + LY::bar + 16 + 127) & ~127u) -
                       smem_addr(smc));
  // staged tiles of buffer c & 1
  auto q_at = [&](long long c) {
    return reinterpret_cast<T*>(stage + (c & 1) * LY::buffer);
  };
  auto k_at = [&](long long c) { return q_at(c) + Q * SE; };
  auto v_at = [&](long long c, int hh) { return q_at(c) + (2 + hh) * Q * SE; };
  auto lw_at = [&](long long c) {
    return reinterpret_cast<float*>(stage + (c & 1) * LY::buffer +
                                    (2 + HB) * LY::tile);
  };

  const long long oq = b * a.q.sb + (long long)(SCALAR ? h0 : h) * a.q.sh;
  const long long ok = b * a.k.sb + (long long)(SCALAR ? h0 : h) * a.k.sh;
  const long long ol = b * a.lw.sb + (long long)h * a.lw.sh;

  // the state: rows 16 wq + g (+ 8) and columns 8 n + 2 r4 (+ 1) in
  // accumulators, 8 n-tiles
  float Sacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * wq + g + (e >> 1) * 8, c = 8 * n + 2 * r4 + (e & 1);
      Sacc[n][e] = (a.s0 != nullptr && valid && d < a.Dk && c < a.Dv)
          ? a.s0[(bh * a.Dk + d) * a.Dv + c] : 0.f;
    }
  if (!SCALAR && htid < DMAX)
    us[htid] = (!ssd && valid && htid < a.Dk) ? a.u[h * a.Dk + htid] : 0.f;

  auto store_state = [&]() {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int row = 16 * wq + g, c = 8 * n + 2 * r4;
      *reinterpret_cast<float2*>(&St[row * VS + c]) =
          make_float2(Sacc[n][0], Sacc[n][1]);
      *reinterpret_cast<float2*>(&St[(row + 8) * VS + c]) =
          make_float2(Sacc[n][2], Sacc[n][3]);
    }
  };

  // chunk c's rows t0.. into buffer c & 1: TMA boxes issued by lane 0 of
  // warp 0 (q), 1 (k), 2 of each head (its v) and 3 (GENERAL's log
  // decay), thread 0 arming the mbarrier with their bytes; other layouts
  // element by element. SCALAR's per-token log decay: cp.async, 4 bytes a
  // lane of each head's first warp (f32), else loaded.
  auto issue_chunk = [&](long long c) {
    const long long t0 = c * Q;
    if (tid == 0) {
      uint32_t bytes = (a.q.tma + a.k.tma) * box_bytes<T>();
      for (int hh = 0; hh < HB; ++hh)
        if (h0 + hh < a.H) bytes += a.v.tma * box_bytes<T>();
      if (!SCALAR) bytes += a.lw.tma * box_bytes<float>();
      mbar_expect(bar, bytes);
    }
    stage_tile<T, SE>(a.q, &tq, oq, t0, a.S, a.Dk, h0, (int)b, q_at(c), bar,
                      tid == 0, tid, NT);
    stage_tile<T, SE>(a.k, &tk, ok, t0, a.S, a.Dk, h0, (int)b, k_at(c), bar,
                      tid == 32, tid, NT);
    if (valid)
      stage_tile<T, SE>(a.v, &tv, b * a.v.sb + (long long)h * a.v.sh, t0,
                        a.S, a.Dv, h, (int)b, v_at(c, hg), bar,
                        htid == 64, htid, GROUP);
    if (SCALAR) {
      if (wq == 0) {
        const long long s = t0 + lane;
        const bool full = valid && s < a.S;
        float* dst = lw_at(c) + hg * Q + lane;
        if (a.lw.dtype == 0) {
          const float* p = static_cast<const float*>(a.lw.p);
          cp_async4(dst, full ? p + ol + s * a.lw.st : p, full);
          cp_async_commit();
        } else {
          *dst = full ? load(a.lw, ol + s * a.lw.st) : 0.f;
        }
      }
    } else {
      stage_tile<float, QS>(a.lw, &tl, ol, t0, a.S, a.Dk, h, (int)b,
                            lw_at(c), bar, tid == 96, tid, NT);
    }
  };

  // after the copies of chunk c have landed: the state entering it and,
  // SCALAR, the cumulated log decay (one warp's shuffles a head)
  auto wait_and_prepare = [&](long long c) {
    mbar_wait(bar, (uint32_t)(c & 1));
    if (SCALAR && wq == 0) cp_async_wait_all();
    __syncthreads();
    store_state();
    if (SCALAR && wq == 0) {
      float L = clamp_log_decay(lw_at(c)[hg * Q + lane]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, L, o);
        if (lane >= o) L += n;
      }
      Lh[lane] = L;
    }
    __syncthreads();
  };

  // zero both staging buffers (an absent head's v tiles stay so), then
  // hand them to TMA
  for (int i = tid; i < 2 * LY::buffer / 16; i += NT)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue_chunk(0);
  wait_and_prepare(0);

  const long long nc = (a.S + Q - 1) / Q;
  for (long long c = 0; c < nc; ++c) {
    const long long t0 = c * Q;
    if (c + 1 < nc) issue_chunk(c + 1);       // lands during this chunk
    const T* qst = q_at(c);
    const T* kst = k_at(c);
    const T* vst = v_at(c, hg);

    if (!SCALAR) {
      // thread (channel d, half): its 16 tokens in order, the cumsum in two
      // halves; then the factored tiles, two exps an element
      const float* lwst = lw_at(c);
      const int d = tid & (DMAX - 1), half = tid / DMAX, tb = 16 * half;
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        run += clamp_log_decay(lwst[(tb + i) * QS + d]);
        Ls[(tb + i) * QS + d] = run;
      }
      part[half * DMAX + d] = run;            // each half's total
      if (half == 1) part[2 * DMAX + d] = Ls[16 * QS + d];
      if (!ssd) {
        // the bonus q_t . u . k_t from the raw tiles, 8 tokens a warp
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = 8 * wq + i;
          p[i] = widen(qst[t * SE + lane]) * us[lane] *
                     widen(kst[t * SE + lane]) +
                 widen(qst[t * SE + lane + 32]) * us[lane + 32] *
                     widen(kst[t * SE + lane + 32]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            p[i] += __shfl_xor_sync(0xffffffffu, p[i], o);
        if (lane < 8) {
          float v = p[0];
#pragma unroll
          for (int i = 1; i < 8; ++i) if (lane == i) v = p[i];
          diag[8 * wq + lane] = v;
        }
      }
      __syncthreads();
      const float off = half ? part[d] : 0.f;
      const float shift = part[d] + part[2 * DMAX + d];     // L at Q/2
      const float tot = part[d] + part[DMAX + d];
      const float e_shift = expf(shift), e_rest = expf(tot - shift);
      float prev = 0.f;                     // the local cumsum before t
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int o = (tb + i) * QS + d;
        const float loc = Ls[o], L = loc + off;
        const float Lq = ssd ? L : prev + off;
        prev = loc;
        const float x = widen(qst[(tb + i) * SE + d]) * expf(Lq - shift);
        const float kin = widen(kst[(tb + i) * SE + d]) * expf(shift - L);
        Xs[o] = x;                          // q exp(Lq - shift)
        qs[o] = x * e_shift;                // q exp(Lq)
        Ls[o] = kin;                        // k exp(shift - L)
        ks[o] = kin * e_rest;               // k exp(tot - L)
      }
      if (half == 0) ltot[d] = tot;
      __syncthreads();
    }

    // scores: 8 tiles of 16 x 8 over the block's warps; the two above the
    // diagonal are zero
    for (int tile = warp; tile < 8; tile += NT / 32) {
      const int mt = tile >> 2, nt = tile & 3;
      const int r0 = 16 * mt, s0 = 8 * nt;
      // two accumulators (even and odd k-steps) halve the chain of
      // dependent products
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};
      if (s0 <= r0 + 15) {
#pragma unroll
        for (int kk = 0; kk < DMAX; kk += 16) {
          uint32_t ah[4], al[4], bhi[2], blo[2], ah2[4], al2[4], bh2[2],
              bl2[2];
          if constexpr (SCALAR) {
            frag_a<QX, SE>(qst + g * SE + r4, r0, kk, ah, al);
            frag_b_n<QX, SE>(kst + g * SE + r4, kk, s0, bhi, blo);
            frag_a<QX, SE>(qst + g * SE + r4, r0, kk + 8, ah2, al2);
            frag_b_n<QX, SE>(kst + g * SE + r4, kk + 8, s0, bh2, bl2);
          } else {
            frag_a<false, QS>(Xs + g * QS + r4, r0, kk, ah, al);
            frag_b_n<false, QS>(Ls + g * QS + r4, kk, s0, bhi, blo);
            frag_a<false, QS>(Xs + g * QS + r4, r0, kk + 8, ah2, al2);
            frag_b_n<false, QS>(Ls + g * QS + r4, kk + 8, s0, bh2, bl2);
          }
          mma3<QX, QX>(acc, ah, al, bhi, blo);
          mma3<QX, QX>(acc2, ah2, al2, bh2, bl2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += acc2[e];
      }
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        float* P = sm + LY::shared + hh * LY::head + DMAX * VS;
        const float* Lx = P + Q * PS;
        const float* dg = Lx + 5 * DMAX;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + g + (e >> 1) * 8, s = s0 + 2 * r4 + (e & 1);
          float val = 0.f;
          if (SCALAR) {
            if (s <= t) val = acc[e] * expf(Lx[t] - Lx[s]);
          } else {
            if (ssd ? s <= t : s < t) val = acc[e];
            if (!ssd && s == t) val += dg[t];
          }
          P[t * PS + s] = val;
        }
      }
    }
    __syncthreads();

    // y: warp wq forms rows 16 (wq & 1).. and columns 32 (wq >> 1)..:
    // the readout of the state entering the chunk, then scores x v
    {
      const int mt = wq & 1, nb = (wq >> 1) * 4, r0 = 16 * mt;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const float* tS = St + r4 * VS + g;
#pragma unroll
      for (int kk = 0; kk < DMAX; kk += 8) {
        uint32_t ah[4], al[4];
        if constexpr (SCALAR) frag_a<QX, SE>(qst + g * SE + r4, r0, kk, ah, al);
        else frag_a<false, QS>(qs + g * QS + r4, r0, kk, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          frag_b_k<false, VS>(tS, kk, 8 * (nb + j), 1.f, 1.f, bhi, blo);
          mma3<QX, false>(acc[j], ah, al, bhi, blo);
        }
      }
      if (SCALAR) {
        const float e0 = expf(Lh[r0 + g]), e1 = expf(Lh[r0 + g + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] *= e0; acc[j][1] *= e0;
          acc[j][2] *= e1; acc[j][3] *= e1;
        }
      }
      const float* tP = Ps + g * PS + r4;
      const T* tv = vst + r4 * SE + g;
#pragma unroll
      for (int kk = 0; kk < Q; kk += 8) {
        if (mt == 0 && kk >= Q / 2) break;       // rows < 16 see s < 16
        uint32_t ah[4], al[4];
        frag_a<false, PS>(tP, r0, kk, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bhi[2], blo[2];
          frag_b_k<VX, SE>(tv, kk, 8 * (nb + j), 1.f, 1.f, bhi, blo);
          mma3<false, VX>(acc[j], ah, al, bhi, blo);
        }
      }
      if (valid) {
        const bool even = (a.Dv & 1) == 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long t = t0 + r0 + g + 8 * half;
          if (t >= a.S) continue;
          float* row = a.y + (bh * a.S + t) * a.Dv;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 8 * (nb + j) + 2 * r4;
            const float y0 = acc[j][2 * half], y1 = acc[j][2 * half + 1];
            if (even && col + 1 < a.Dv) {
              *reinterpret_cast<float2*>(row + col) = make_float2(y0, y1);
            } else {
              if (col < a.Dv) row[col] = y0;
              if (col + 1 < a.Dv) row[col + 1] = y1;
            }
          }
        }
      }
    }

    // the state: S = decay * S + k'^T v' over the chunk's tokens; warp wq
    // owns rows 16 wq..
    {
      const int d0 = 16 * wq;
      const float tot = SCALAR ? Lh[Q - 1] : 0.f;
      const float dec0 = expf(SCALAR ? tot : ltot[d0 + g]);
      const float dec1 = expf(SCALAR ? tot : ltot[d0 + g + 8]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        Sacc[n][0] *= dec0; Sacc[n][1] *= dec0;
        Sacc[n][2] *= dec1; Sacc[n][3] *= dec1;
      }
      // GENERAL reads v as it is (exact when bf16); SCALAR scales it
      constexpr bool UX = !SCALAR && VX;
      const T* tv = vst + r4 * SE + g;
#pragma unroll
      for (int kk = 0; kk < Q; kk += 8) {
        uint32_t ah[4], al[4];
        if constexpr (SCALAR) frag_a_t<QX, SE>(kst + r4 * SE + g, d0, kk, ah, al);
        else frag_a_t<false, QS>(ks + r4 * QS + g, d0, kk, ah, al);
        const float w0 = SCALAR ? expf(tot - Lh[kk + r4]) : 1.f;
        const float w1 = SCALAR ? expf(tot - Lh[kk + r4 + 4]) : 1.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_k<UX, SE>(tv, kk, 8 * n, w0, w1, bhi, blo);
          mma3<QX, UX>(Sacc[n], ah, al, bhi, blo);
        }
      }
    }
    if (c + 1 < nc) wait_and_prepare(c + 1);
  }

  if (valid) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * wq + g + (e >> 1) * 8;
        const int col = 8 * n + 2 * r4 + (e & 1);
        if (d < a.Dk && col < a.Dv)
          a.state[(bh * a.Dk + d) * a.Dv + col] = Sacc[n][e];
      }
  }
}

bool valid_dtype(int code) { return code == 0 || code == 1; }

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

// The rank-4 (d, s, head, batch) map of x with its strides, boxes of the
// staged row width (`se` elements, past D zero-filled) by 32 rows, zeros
// out of bounds; a dim of stride 0 (q, k shared by every head) or of size
// 1 is mapped as size 1. False where TMA cannot take the layout (a base or
// a row, head or batch stride not a multiple of 16 bytes, a d stride != 1)
// or the driver has no encoder: x is then read element by element.
bool make_map(CUtensorMap* map, const In& x, long long B, long long H,
              long long S, long long D, int se) {
  const long long es = esize(x.dtype);
  const long long nh = x.sh ? H : 1, nb = x.sb ? B : 1;
  const long long ss = S > 1 ? x.st : (D + 7) / 8 * 8;
  const long long sh = nh > 1 ? x.sh : ss * S;
  const long long sb = nb > 1 ? x.sb : sh * nh;
  if ((x.sd != 1 && D > 1) || reinterpret_cast<uintptr_t>(x.p) % 16 ||
      (ss * es) % 16 || (sh * es) % 16 || (sb * es) % 16)
    return false;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)nh,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * es), (cuuint64_t)(sh * es),
                                 (cuuint64_t)(sb * es)};
  const cuuint32_t box[4] = {(cuuint32_t)se, (cuuint32_t)Q, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, x.dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(x.p), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SCALAR, int HB, bool BF16>
cudaError_t launch(Args a, long long B, void* stream) {
  using LY = Layout<SCALAR, HB, BF16>;
  // TMA takes an input staged in its own type: q, k, v when they are the
  // kernel's type, GENERAL's log decay when f32
  CUtensorMap maps[4] = {};
  In* ins[4] = {&a.q, &a.k, &a.v, &a.lw};
  const long long dims[4] = {a.Dk, a.Dk, a.Dv, a.Dk};
  for (int i = 0; i < 4; ++i) {
    const bool typed = i < 3 ? (ins[i]->dtype == 1) == BF16
                             : !SCALAR && ins[i]->dtype == 0;
    ins[i]->tma = typed && make_map(&maps[i], *ins[i], B, a.H, a.S, dims[i],
                                    i < 3 ? LY::SE : QS);
  }
  const size_t smem = LY::bytes;
  auto kernel = ssm_scan_kernel<SCALAR, HB, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = B * ((a.H + HB - 1) / HB);
  kernel<<<(unsigned)blocks, GROUP * HB, smem, (cudaStream_t)stream>>>(
      a, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

template <bool SCALAR, int HB>
cudaError_t launch_typed(const Args& a, bool bf16, long long B,
                         void* stream) {
  return bf16 ? launch<SCALAR, HB, true>(a, B, stream)
              : launch<SCALAR, HB, false>(a, B, stream);
}

}  // namespace

// q, k, lw: (B, H, S, Dk); v: (B, H, S, Dv); each read through its four
// strides (in elements, 0 allowed) with its dtype code (0 f32, 1 bf16).
// u: (H, Dk) f32 contiguous, NULL for SSD mode. s0: (B, H, Dk, Dv) f32
// contiguous, or NULL for a zero initial state. y: (B, H, S, Dv) f32 and
// state: (B, H, Dk, Dv) f32, both contiguous.
// shape = {B, H, S, Dk, Dv}; strides = {q, k, v, lw} x {b, h, s, d};
// dtypes = {q, k, v, lw}. The form: SCALAR for SSD with a log decay of
// stride 0 over Dk, two heads a block when q and k also have stride 0
// over H; GENERAL otherwise. Staged in bf16 when q, k and v are all bf16,
// else in f32. Returns the cudaError_t of the launch.
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
                strides[4 * i + 2], strides[4 * i + 3], dtypes[i], 0};
  const Args a{ins[0], ins[1], ins[2], ins[3], u, s0, y, state, S, (int)H,
               (int)Dk, (int)Dv};
  const bool bf16 = dtypes[0] == 1 && dtypes[1] == 1 && dtypes[2] == 1;
  const bool scalar = u == nullptr && ins[3].sd == 0;
  const bool shared_qk = ins[0].sh == 0 && ins[1].sh == 0;
  cudaError_t err;
  if (scalar && shared_qk) err = launch_typed<true, 2>(a, bf16, B, stream);
  else if (scalar) err = launch_typed<true, 1>(a, bf16, B, stream);
  else err = launch_typed<false, 1>(a, bf16, B, stream);
  return (int)err;
}
