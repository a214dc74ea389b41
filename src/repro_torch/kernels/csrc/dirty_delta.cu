// Per-block max |new - old| of pairs of flat tensors, f32 out, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dirty_delta.py
// (max_abs_delta / _kernel), the inner loop of pre-copy live migration: the
// live state and its shadow (the copy already sent) are cut into blocks
// ("pages") of `blk` elements, and a block is dirty when some element
// changed. The TPU kernel took (n_blocks, block) tiles of 8 x 2048, padded
// both inputs with zeros to whole tiles and carried a row accumulator in
// VMEM across the column sweep.
//
//   out[p] = max(0, max_{i in block p} |f32(new[i]) - f32(old[i])|),
//   NaN when any difference in the block is NaN (as jnp.maximum).
//
// The function reads 2 * n * itemsize bytes and writes 4 per block, with one
// subtraction and one compare per element: it is bound by its bytes.
//
// One launch scans up to MAX_LEAVES pairs ("leaves" of a state tree), each
// of its own length and dtype: a scan of a whole replica is one grid, with
// no gap between leaves and no partly filled last wave per leaf. The
// leaves' addresses, lengths and dtypes travel in the launch's parameters
// (__grid_constant__, read in place); their blocks are numbered in leaf
// order and out[] holds them in that order.
//
// Design: one warp per block, eight warps per thread block. A warp finds
// its leaf by a binary search over the leaves' first block numbers (the
// same for every lane). Lanes stream 16-byte vectors of both inputs
// (UNROLL of them in flight per input) when the leaf starts 16-byte aligned
// and a block is a whole number of vectors, else single elements; the
// block's last vector-less elements and the ragged tail block (n not a
// multiple of blk) are read element by element, so nothing is padded or
// copied. |d| >= 0, so its f32 order is the unsigned order of its bits,
// with every NaN above +inf: each lane keeps the running max as bits (one
// integer max per element, NaN kept, as jnp.maximum keeps it), and the warp
// reduces them with __reduce_max_sync. No atomics, so the result is the
// same on every run, and since a max of f32 differences does not depend on
// order, it equals the plain version bit for bit (NaN payloads aside).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int MAX_LEAVES = 64;   // keeps the parameters under 4 KB

// the bits of |a - b|, in f32
__device__ __forceinline__ unsigned abs_diff_bits(float a, float b) {
  return __float_as_uint(a - b) & 0x7fffffffu;
}

// Each element type: its f32 value, and the VEC values of a 16-byte vector.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static float f32(float v) { return v; }
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};

// bfloat16, carried as its 16 bits: the f32 with the same high half
template <> struct Elem<uint16_t> {
  static constexpr int VEC = 8;
  __device__ static float f32(uint16_t v) {
    return __uint_as_float((uint32_t)v << 16);
  }
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // little endian: low half first
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Elem<__half> {
  static constexpr int VEC = 8;
  __device__ static float f32(__half v) { return __half2float(v); }
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};

// float64 is rounded to f32 before the difference, as astype(float32) does
template <> struct Elem<double> {
  static constexpr int VEC = 2;
  __device__ static float f32(double v) { return __double2float_rn(v); }
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __double2float_rn(__hiloint2double((int)r.y, (int)r.x));
    f[1] = __double2float_rn(__hiloint2double((int)r.w, (int)r.z));
  }
};

template <typename T>
__device__ __forceinline__ unsigned vec_max(const uint4& ra, const uint4& rb,
                                            unsigned m) {
  constexpr int V = Elem<T>::VEC;
  float fa[V], fb[V];
  Elem<T>::unpack(ra, fa);
  Elem<T>::unpack(rb, fb);
#pragma unroll
  for (int k = 0; k < V; ++k) m = max(m, abs_diff_bits(fa[k], fb[k]));
  return m;
}

// the bits of max |new - old| over the elements of one block that a lane
// reads, before the warp's reduction
template <typename T, bool VECTOR>
__device__ __forceinline__ unsigned block_max(const T* __restrict__ pa,
                                           const T* __restrict__ pb,
                                           long long len, int lane) {
  unsigned m = 0u;                       // +0.0f
  long long done = 0;
  if (VECTOR) {
    constexpr int V = Elem<T>::VEC;
    const long long nvec = len / V;
    const uint4* va = reinterpret_cast<const uint4*>(pa);
    const uint4* vb = reinterpret_cast<const uint4*>(pb);
    long long i = lane;
    for (; i + 32 * (UNROLL - 1) < nvec; i += 32 * UNROLL) {
      uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ra[u] = __ldcs(va + i + 32 * u);
        rb[u] = __ldcs(vb + i + 32 * u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) m = vec_max<T>(ra[u], rb[u], m);
    }
    for (; i < nvec; i += 32) m = vec_max<T>(__ldcs(va + i), __ldcs(vb + i), m);
    done = nvec * V;
  }
  for (long long i = done + lane; i < len; i += 32)
    m = max(m, abs_diff_bits(Elem<T>::f32(pa[i]), Elem<T>::f32(pb[i])));
  return m;
}

template <typename T>
__device__ __forceinline__ unsigned leaf_block_max(const void* a, const void* b,
                                                long long start, long long len,
                                                bool vector, int lane) {
  const T* pa = static_cast<const T*>(a) + start;
  const T* pb = static_cast<const T*>(b) + start;
  return vector ? block_max<T, true>(pa, pb, len, lane)
                : block_max<T, false>(pa, pb, len, lane);
}

// the leaves of one launch; first[i] is leaf i's first block, first[n_leaves]
// the launch's block count
struct Leaves {
  long long first[MAX_LEAVES + 1];
  long long n[MAX_LEAVES];
  const void* a[MAX_LEAVES];
  const void* b[MAX_LEAVES];
  int dtype[MAX_LEAVES];       // 0 f32, 1 bf16, 2 f16, 3 f64
  int vector[MAX_LEAVES];      // 16-byte vectors on both inputs
  int n_leaves;
};

__global__ void __launch_bounds__(THREADS)
dirty_delta_kernel(const __grid_constant__ Leaves t, float* __restrict__ out,
                   long long blk) {
  const long long page = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (page >= t.first[t.n_leaves]) return;
  int lo = 0, hi = t.n_leaves - 1;     // the last leaf with first <= page
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first[mid] <= page) lo = mid; else hi = mid - 1;
  }
  const long long start = (page - t.first[lo]) * blk;
  const long long len = (t.n[lo] - start < blk) ? t.n[lo] - start : blk;
  const bool vec = t.vector[lo] != 0;
  unsigned m;
  switch (t.dtype[lo]) {
    case 0: m = leaf_block_max<float>(t.a[lo], t.b[lo], start, len, vec, lane); break;
    case 1: m = leaf_block_max<uint16_t>(t.a[lo], t.b[lo], start, len, vec, lane); break;
    case 2: m = leaf_block_max<__half>(t.a[lo], t.b[lo], start, len, vec, lane); break;
    default: m = leaf_block_max<double>(t.a[lo], t.b[lo], start, len, vec, lane); break;
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) out[page] = __uint_as_float(m);
}

}  // namespace

// table: n_leaves rows of 4 int64 on the host, {new, old, n, dtype}: two
// addresses of n >= 1 contiguous elements of one dtype on the card (0 f32,
// 1 bf16, 2 f16, 3 f64); 1 <= n_leaves <= MAX_LEAVES. out: the leaves'
// ceil(n / blk) f32 each, one per block, in leaf order. blk >= 1.
// One launch; returns its cudaError_t (0 on success).
extern "C" int dirty_delta_launch(const long long* table, int n_leaves,
                                  float* out, long long blk, void* stream) {
  static const int SIZE[4] = {4, 2, 2, 8};
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || blk < 1)
    return (int)cudaErrorInvalidValue;
  Leaves t;
  t.n_leaves = n_leaves;
  t.first[0] = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* row = table + 4 * i;
    const int dtype = (int)row[3];
    if (row[2] < 1 || dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
    t.a[i] = (const void*)row[0];
    t.b[i] = (const void*)row[1];
    t.n[i] = row[2];
    t.dtype[i] = dtype;
    t.vector[i] = (row[0] | row[1]) % 16 == 0 && (blk * SIZE[dtype]) % 16 == 0;
    t.first[i + 1] = t.first[i] + (row[2] + blk - 1) / blk;
  }
  const long long nb = t.first[n_leaves];
  const dim3 grid((unsigned)((nb + WARPS - 1) / WARPS));
  dirty_delta_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(t, out, blk);
  return (int)cudaGetLastError();
}
