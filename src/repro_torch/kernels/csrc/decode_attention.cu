// Decode attention of one token against a KV ring, in place, for sm_90a:
// rotary on q and k, the ring write of the token's k and v, and a split-K
// pass over the ring's valid slots, in one launch (and, past one split, a
// second, small launch that merges the splits).
//
// Replaces no TPU kernel: the JAX package decodes outside any Pallas
// kernel (src/repro/models/blocks.py, multihead_attention's decode branch:
// apply_rope, dynamic_update_slice into the ring, two einsums over the
// whole ring). The port ran the same composition in plain PyTorch
// (kernels/ref.py decode_attention_ref, still its CPU path), where each
// einsum over the (B, W, Hkv, hd) ring first copied the permuted ring
// whole: two ring-sized copies a layer and a step. This kernel reads each
// valid K and V slot once, where it lies.
//
// For q (B, 1, n, hd) and k, v (B, 1, Hr, hd) before rotary, angles
// (B, 1, hd/2) f32, the layer's rings (B, W, Hr, hd) and the position pos
// (a 0-dim int32 on the card), with slot = pos % W:
//
//   k', q' = rope(k), rope(q)       cos, sin rounded to the dtype, each
//                                   product and sum rounded (apply_rope)
//   ring_k[:, slot], ring_v[:, slot] = k', v          (every ring head)
//   o[b, h g + i] = sum_j softmax_j(round(q'[h g + i] . K[j]) scale) V[j]
//
// over ring heads h in [kv0, kv1) (g = n / (kv1 - kv0) query heads each),
// where slot j is valid when its distance back from the token, (slot - j)
// mod W, is below nv = min(pos + 1, W, window or W): the mask of
// kernels/ref.py decode_valid for the full and the sliding-window ring.
// The dot is rounded to the dtype before the f32 scale, as the reference's
// einsum in the activation dtype is; the softmax is f32; the probabilities
// are rounded to the dtype before P.V and summed in f32; the output is in
// q's dtype. The ring's bytes after the launch equal the plain path's bit for
// bit (the rotary is the same sequence of rounded operations, with
// __fmul_rn and friends so that nothing contracts into an FMA).
//
// Bound: bytes. Each valid slot's K and V rows are read once (2 nv Hkv hd
// elements a batch row); the products are 4 hd flops a (query head, slot),
// some g flops a byte, far below the card's ~295 a byte. What the design
// does about it:
// - grid (split, ring head, batch row): a block takes one (b, h) pair and
//   one split of the ring's slots; the split count comes from the shapes
//   (kernels/decode_attention.plan: B Hkv pairs, W, g), never from pos, so
//   nothing waits on the host. pos is read on the card: a block whose split
//   holds no valid slot exits at once, and a block loads only the tiles
//   that hold a valid slot, and of those only the valid rows (cp.async with
//   a zero source size fills the rest with zeros, reading nothing).
// - each block streams its tiles of 32 slots by 16-byte cp.async into a
//   3-stage ring in shared memory: first its K tiles, then its V tiles, so
//   the first V tiles load while the last K tiles are scored.
// - within a block the split's scores stay in shared memory: all K tiles
//   first, then the split's max and sum, then the probabilities, rounded,
//   then P.V over the V tiles. Within one split that is the reference's
//   arithmetic (normalised probabilities rounded before P.V).
// - the token's own slot is never read from the ring: the block whose
//   split holds it puts the rotated k and the v into its tiles' rows and
//   writes both to the ring at its end; for ring heads outside [kv0, kv1)
//   the split-0 block only writes them.
// - past one split each block writes its (max, sum, normalised P.V) in
//   f32, and merge_kernel combines the splits in split order, weights
//   l_i exp(m_i - M): a fixed order and no atomics, so a second launch is
//   bit-equal to the first.
// Head dims: one instantiation each of 32, 64, 80, 112, 120, 128 and 224
// (every head the port decodes on the card), f32 and bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads a block: 4 warps
constexpr int TILE = 32;    // ring slots a tile
constexpr int NSTAGE = 3;   // tiles in flight a block
constexpr int MERGE_NT = 128;
constexpr size_t MAX_SMEM = 232448;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* angles;
  void* ck;
  void* cv;
  const void* pos;
  void* out;
  float* part;
  long long sq[3], sk[3], sv[3];   // (b, head, d) strides, elements
  long long sck[3], scv[3];        // (b, slot, head) strides of the rings
  long long sa[2];                 // (b, i) strides of the angles
  int B, W, Hr, kv0, kv1, G, HD, window, n_splits, split_len;
  float scale;
};

template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <>
struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 to(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float from(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// x rounded to T and read back as f32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Elt<T>::from(Elt<T>::to(x));
}

template <typename T>
__device__ __forceinline__ void put(T* p, float x) {
  *p = Elt<T>::to(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// 16 bytes of T from shared memory as f32
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// apply_rope on one head of hd: out[i] = x1 c - x2 s, out[i + hd/2] =
// x2 c + x1 s, each product and sum rounded to T in PyTorch's order
template <typename T, typename O>
__device__ __forceinline__ void rope(const T* x, long long sd,
                                     const float* ang, long long sa, int hd,
                                     O* out) {
  const int half = hd / 2;
  for (int i = threadIdx.x; i < half; i += NT) {
    const float t = ang[i * sa];
    const float c = rnd<T>(cosf(t)), s = rnd<T>(sinf(t));
    const float x1 = Elt<T>::from(x[i * sd]);
    const float x2 = Elt<T>::from(x[(i + half) * sd]);
    put(out + i, rnd<T>(__fsub_rn(rnd<T>(__fmul_rn(x1, c)),
                                  rnd<T>(__fmul_rn(x2, s)))));
    put(out + i + half, rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x2, c)),
                                         rnd<T>(__fmul_rn(x1, s)))));
  }
}

// slot j holds a token the new one attends to
__device__ __forceinline__ bool valid_slot(int j, int slot, int W,
                                           long long nv) {
  int d = slot - j;
  if (d < 0) d += W;
  return d < nv;
}

// the split's tiles [t0, t1) that meet the slots [x0, x1]
__device__ __forceinline__ void tile_run(int x0, int x1, int s0, int s1,
                                         int& t0, int& t1) {
  const int c0 = max(x0, s0), c1 = min(x1, s1 - 1);
  if (c0 > c1) {
    t0 = t1 = 0;
    return;
  }
  t0 = (c0 - s0) / TILE;
  t1 = (c1 - s0) / TILE + 1;
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_kernel(const Args a) {
  constexpr int VEC = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  constexpr int NC = HD / VEC;                 // chunks a row
  constexpr int SG = pow2_at_least(NC) < 32 ? pow2_at_least(NC) : 32;
  constexpr int RPW = 32 / SG;                 // rows a warp scores at once
  static_assert(HD % VEC == 0 && TILE % (4 * RPW) == 0, "tile shape");

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, W = a.W;
  const long long pos = *static_cast<const int*>(a.pos);
  int slot = (int)(pos % W);
  if (slot < 0) slot += W;
  const bool used = h >= a.kv0 && h < a.kv1;
  const int s0 = split * a.split_len;
  const int s1 = min(s0 + a.split_len, W);
  // this block writes the token's k and v into ring head h
  const bool mine = used ? (slot >= s0 && slot < s1) : split == 0;
  if (!used && !mine) return;

  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);       // NSTAGE x TILE x HD
  T* knew = tiles + NSTAGE * TILE * HD;        // the rotated k
  T* vnew = knew + HD;                         // the v
  float* qs = reinterpret_cast<float*>(vnew + HD);   // G x HD rotated q
  float* acc = qs + G * HD;                    // G x HD P.V
  float* sc = acc + G * HD;                    // split_len x G scores, then p
  float* mls = sc + a.split_len * G;           // G x (max, sum)

  const T* kin = static_cast<const T*>(a.k);
  const T* vin = static_cast<const T*>(a.v);
  const float* ang = a.angles + b * a.sa[0];
  T* ring_k = static_cast<T*>(a.ck) + b * a.sck[0] + h * a.sck[2];
  T* ring_v = static_cast<T*>(a.cv) + b * a.scv[0] + h * a.scv[2];
  if (mine) {
    rope(kin + b * a.sk[0] + h * a.sk[1], a.sk[2], ang, a.sa[1], HD, knew);
    for (int i = tid; i < HD; i += NT)
      vnew[i] = vin[b * a.sv[0] + h * a.sv[1] + i * a.sv[2]];
  }
  if (!used) {                                  // a head no query reads
    __syncthreads();
    for (int i = tid; i < HD; i += NT) {
      ring_k[slot * a.sck[1] + i] = knew[i];
      ring_v[slot * a.scv[1] + i] = vnew[i];
    }
    return;
  }

  const int n = G * (a.kv1 - a.kv0);           // query heads of q
  const int qh0 = (h - a.kv0) * G;
  const long long cap = a.window > 0 ? (long long)a.window : (long long)W;
  const long long nv = min(min(pos + 1, (long long)W), cap);
  const int lo = slot - (int)nv + 1;           // valid: [lo, slot] mod W
  int ta0, ta1, tb0 = 0, tb1 = 0;
  tile_run(max(lo, 0), slot, s0, s1, ta0, ta1);
  if (lo < 0) tile_run(lo + W, W - 1, s0, s1, tb0, tb1);
  tb0 = max(tb0, ta1);                         // a tile the runs share
  tb1 = max(tb1, tb0);                         // is taken once
  const int na = ta1 - ta0, nact = na + tb1 - tb0;
  if (nact == 0) {                              // no valid slot here
    if (a.n_splits > 1) {
      float* pml = a.part + (long long)a.n_splits * a.B * n * HD +
                   (((long long)split * a.B + b) * n + qh0) * 2;
      for (int e = tid; e < G; e += NT) {
        pml[2 * e] = -INFINITY;
        pml[2 * e + 1] = 0.f;
      }
    }
    return;
  }

  const T* qin = static_cast<const T*>(a.q);
  for (int i = 0; i < G; ++i)
    rope(qin + b * a.sq[0] + (qh0 + i) * a.sq[1], a.sq[2], ang, a.sa[1], HD,
         qs + i * HD);
  for (int e = tid; e < G * HD; e += NT) acc[e] = 0.f;
  for (int e = tid; e < a.split_len * G; e += NT) sc[e] = -INFINITY;

  const int njobs = 2 * nact;                  // K tiles, then V tiles
  auto tile_start = [&](int j) {
    const int i = j < nact ? j : j - nact;
    return s0 + (i < na ? ta0 + i : tb0 + i - na) * TILE;
  };
  auto fetch = [&](int j, int stage) {
    const bool isv = j >= nact;
    const int t0 = tile_start(j);
    const T* base = isv ? ring_v : ring_k;
    const long long sw = isv ? a.scv[1] : a.sck[1];
    T* dst = tiles + stage * TILE * HD;
    for (int e = tid; e < TILE * NC; e += NT) {
      const int r = e / NC, c = e - r * NC;
      const int j2 = t0 + r;
      const bool ok =
          j2 < s1 && j2 != slot && valid_slot(j2, slot, W, nv);
      cp_async16(dst + r * HD + c * VEC, ok ? base + j2 * sw + c * VEC : base,
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < njobs) fetch(s, s);
    cp_commit();
  }
  for (int j = 0; j < njobs; ++j) {
    if (j + NSTAGE - 1 < njobs)
      fetch(j + NSTAGE - 1, (j + NSTAGE - 1) % NSTAGE);
    cp_commit();
    cp_wait<NSTAGE - 1>();
    __syncthreads();
    const bool isv = j >= nact;
    const int t0 = tile_start(j);
    const int nrow = min(TILE, s1 - t0);
    T* buf = tiles + (j % NSTAGE) * TILE * HD;
    if (mine && slot >= t0 && slot < t0 + TILE) {   // the token's own row
      const T* fresh = isv ? vnew : knew;
      for (int i = tid; i < HD; i += NT) buf[(slot - t0) * HD + i] = fresh[i];
      __syncthreads();
    }
    if (!isv) {
      // scores: a subgroup of SG lanes a row, the row's chunks over its
      // lanes, summed by a butterfly
      const int sub = lane / SG, lin = lane % SG;
      for (int r0 = 0; r0 < TILE; r0 += 4 * RPW) {
        const int r = r0 + warp * RPW + sub;
        const int j2 = t0 + r;
        const bool ok = r < nrow && valid_slot(j2, slot, W, nv);
        const T* row = buf + r * HD;
        for (int i = 0; i < G; ++i) {
          const float* qg = qs + i * HD;
          float part = 0.f;
#pragma unroll
          for (int c = lin; c < NC; c += SG) {
            float x[VEC], y[VEC];
            load16(row + c * VEC, x);
#pragma unroll
            for (int e = 0; e < VEC; e += 4) load16(qg + c * VEC + e, y + e);
#pragma unroll
            for (int e = 0; e < VEC; ++e) part = fmaf(y[e], x[e], part);
          }
#pragma unroll
          for (int o = SG / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          if (lin == 0 && r < nrow)
            sc[(j2 - s0) * G + i] = ok ? rnd<T>(part) * a.scale : -INFINITY;
        }
      }
      if (j == nact - 1) {
        // the split's softmax, a warp a query head: max, sum, then the
        // probabilities rounded to T
        __syncthreads();
        const int ns = s1 - s0;
        for (int i = warp; i < G; i += NT / 32) {
          float m = -INFINITY;
          for (int e = lane; e < ns; e += 32) m = fmaxf(m, sc[e * G + i]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          float l = 0.f;
          for (int e = lane; e < ns; e += 32) l += expf(sc[e * G + i] - m);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            l += __shfl_xor_sync(0xffffffffu, l, o);
          for (int e = lane; e < ns; e += 32)
            sc[e * G + i] = rnd<T>(expf(sc[e * G + i] - m) / l);
          if (lane == 0) {
            mls[2 * i] = m;
            mls[2 * i + 1] = l;
          }
        }
      }
    } else {
      // P.V: a thread owns two adjacent output columns of a query head
      const float* P = sc + (t0 - s0) * G;
      for (int o = tid; o < G * (HD / 2); o += NT) {
        const int i = o / (HD / 2), d = 2 * (o - i * (HD / 2));
        float a0 = 0.f, a1 = 0.f;
        for (int r = 0; r < nrow; ++r) {
          const float p = P[r * G + i];
          const float2 x = load2(buf + r * HD + d);
          a0 = fmaf(p, x.x, a0);
          a1 = fmaf(p, x.y, a1);
        }
        acc[i * HD + d] += a0;
        acc[i * HD + d + 1] += a1;
      }
    }
    __syncthreads();
  }

  if (a.n_splits == 1) {
    T* o = static_cast<T*>(a.out) + ((long long)b * n + qh0) * HD;
    for (int e = tid; e < G * HD; e += NT) o[e] = Elt<T>::to(acc[e]);
  } else {
    const long long row = ((long long)split * a.B + b) * n + qh0;
    float* pa = a.part + row * HD;
    for (int e = tid; e < G * HD; e += NT) pa[e] = acc[e];
    float* pml = a.part + (long long)a.n_splits * a.B * n * HD + row * 2;
    for (int e = tid; e < 2 * G; e += NT) pml[e] = mls[e];
  }
  if (mine) {
    for (int i = tid; i < HD; i += NT) {
      ring_k[slot * a.sck[1] + i] = knew[i];
      ring_v[slot * a.scv[1] + i] = vnew[i];
    }
  }
}

// the splits of each (batch row, query head) combined in split order:
// o = sum_i w_i acc_i / sum_i w_i, w_i = l_i exp(m_i - M)
template <typename T>
__global__ void __launch_bounds__(MERGE_NT)
    merge_kernel(const float* part, T* out, int ns, int bn, int hd) {
  const long long bq = blockIdx.x;
  const float* ml = part + (long long)ns * bn * hd;
  float M = -INFINITY;
  for (int i = 0; i < ns; ++i) {
    const float* s = ml + ((long long)i * bn + bq) * 2;
    if (s[1] > 0.f) M = fmaxf(M, s[0]);
  }
  float L = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float* s = ml + ((long long)i * bn + bq) * 2;
    if (s[1] > 0.f) L += s[1] * expf(s[0] - M);
  }
  for (int d = threadIdx.x; d < hd; d += MERGE_NT) {
    float acc = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float* s = ml + ((long long)i * bn + bq) * 2;
      if (s[1] > 0.f)
        acc = fmaf(s[1] * expf(s[0] - M),
                   part[((long long)i * bn + bq) * hd + d], acc);
    }
    out[bq * hd + d] = Elt<T>::to(acc / L);
  }
}

template <typename T, int HD>
size_t smem_bytes(const Args& a) {
  return (size_t)(NSTAGE * TILE + 2) * HD * sizeof(T) +
         sizeof(float) * ((size_t)2 * a.G * HD +
                          (size_t)a.split_len * a.G + 2 * a.G);
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t st) {
  const size_t smem = smem_bytes<T, HD>(a);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_splits, a.Hr, a.B);
  decode_kernel<T, HD><<<grid, NT, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return (int)e;
  const int bn = a.B * a.G * (a.kv1 - a.kv0);
  merge_kernel<T><<<bn, MERGE_NT, 0, st>>>(a.part, static_cast<T*>(a.out),
                                           a.n_splits, bn, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(const Args& a, cudaStream_t st) {
  switch (a.HD) {
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 80: return launch<T, 80>(a, st);
    case 112: return launch<T, 112>(a, st);
    case 120: return launch<T, 120>(a, st);
    case 128: return launch<T, 128>(a, st);
    case 224: return launch<T, 224>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, W, Hr, kv0, kv1, G, hd, window, n_splits, split_len, dtype
// (0 f32, 1 bf16); pos an int32; strides: q, k, v (b, head, d),
// the k and v rings (b, slot, head), the angles (b, i), in elements.
// part: n_splits > 1 only, n_splits B n (hd + 2) f32.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* angles,
                                       void* ck, void* cv, const void* pos,
                                       void* out, void* part,
                                       const long long* dims,
                                       const long long* strides,
                                       double scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.angles = static_cast<const float*>(angles);
  a.ck = ck;
  a.cv = cv;
  a.pos = pos;
  a.out = out;
  a.part = static_cast<float*>(part);
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sck[i] = strides[9 + i];
    a.scv[i] = strides[12 + i];
  }
  a.sa[0] = strides[15];
  a.sa[1] = strides[16];
  a.B = (int)dims[0];
  a.W = (int)dims[1];
  a.Hr = (int)dims[2];
  a.kv0 = (int)dims[3];
  a.kv1 = (int)dims[4];
  a.G = (int)dims[5];
  a.HD = (int)dims[6];
  a.window = (int)dims[7];
  a.n_splits = (int)dims[8];
  a.split_len = (int)dims[9];
  a.scale = (float)scale;
  const int dtype = (int)dims[10];
  if (a.B < 1 || a.B > 65535 || a.W < 1 || a.Hr < 1 || a.Hr > 65535 ||
      a.kv0 < 0 || a.kv1 > a.Hr || a.kv0 >= a.kv1 || a.G < 1 ||
      a.window < 0 || a.n_splits < 1 || a.split_len < 1 ||
      (long long)a.n_splits * a.split_len < a.W ||
      (a.n_splits > 1 && part == nullptr) || !(scale > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float>(a, st);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
