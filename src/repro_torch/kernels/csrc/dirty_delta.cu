// Per-block max |new - old| of two flat tensors, f32 out, for sm_90a.
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
// Design: one warp per block, eight warps per thread block. Lanes stream
// 16-byte vectors of both inputs (UNROLL of them in flight per input) when
// the block starts 16-byte aligned, else single elements; the block's last
// vector-less elements and the ragged tail block (n not a multiple of blk)
// are read element by element, so nothing is padded or copied. Each lane
// keeps a running max; the warp reduces it with a fixed xor butterfly of
// shuffles. No atomics, so the result is the same on every run, and since
// a max of exact f32 differences does not depend on order, it equals the
// plain version bit for bit. CUDA's fmaxf drops NaN; nan_max keeps it.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;

// NaN if either argument is NaN, else the larger (jnp.maximum's rule)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
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
__device__ __forceinline__ float vec_max(const uint4& ra, const uint4& rb,
                                         float m) {
  constexpr int V = Elem<T>::VEC;
  float fa[V], fb[V];
  Elem<T>::unpack(ra, fa);
  Elem<T>::unpack(rb, fb);
#pragma unroll
  for (int k = 0; k < V; ++k) m = nan_max(m, fabsf(fa[k] - fb[k]));
  return m;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS)
dirty_delta_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ out, long long n, long long blk,
                   long long nb) {
  const long long page = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (page >= nb) return;
  const long long start = page * blk;
  const long long len = (n - start < blk) ? n - start : blk;
  const T* pa = a + start;
  const T* pb = b + start;
  float m = 0.f;
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
    m = nan_max(m, fabsf(Elem<T>::f32(pa[i]) - Elem<T>::f32(pb[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) out[page] = m;
}

template <typename T>
int launch(const void* a, const void* b, float* out, long long n,
           long long blk, cudaStream_t stream) {
  const long long nb = (n + blk - 1) / blk;
  const dim3 grid((unsigned)((nb + WARPS - 1) / WARPS));
  const bool aligned = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                       (blk * (long long)sizeof(T)) % 16 == 0;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (aligned)
    dirty_delta_kernel<T, true><<<grid, THREADS, 0, stream>>>(ta, tb, out, n, blk, nb);
  else
    dirty_delta_kernel<T, false><<<grid, THREADS, 0, stream>>>(ta, tb, out, n, blk, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// new, old: n contiguous elements of one dtype (0 f32, 1 bf16, 2 f16,
// 3 f64); out: ceil(n / blk) f32, one per block. n >= 1, blk >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dirty_delta_launch(const void* new_, const void* old,
                                  float* out, long long n, long long blk,
                                  int dtype, void* stream) {
  if (n < 1 || blk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(new_, old, out, n, blk, s);
    case 1: return launch<uint16_t>(new_, old, out, n, blk, s);
    case 2: return launch<__half>(new_, old, out, n, blk, s);
    case 3: return launch<double>(new_, old, out, n, blk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
