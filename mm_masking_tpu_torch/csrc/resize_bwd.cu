// Backward of one axis of the UNet's bilinear upsample with align_corners
// (models/unet.py::upsample_bilinear_align_corners), in gather form, with no
// atomics: two runs give the same bits.
//
// Beside the TPU kernels: the JAX package has no pallas_call here. Its
// upsample (mm_masking_tpu/models/unet.py:30) is two jnp.take gathers and a
// blend, whose VJP XLA derives and fuses. In PyTorch the VJP of index_select
// is index_add, which sums with float atomics on the card, in an order that
// changes from run to run.
//
// The forward of one axis, with i0 monotone and w0 = 1 - t, w1 = t in x's
// type (the weights it applied), is y[i] = x[i0[i]] * w0[i] + x[i0[i] + 1] *
// w1[i] along the axis. Its backward gives input row j
//   dx[j] = sum over i with i0[i] + 1 = j of dy[i] * w1[i]
//         + sum over i with i0[i] = j     of dy[i] * w0[i],
// that is, the i in ascending order, since i0 is monotone. The host passes
// off[j] = #{i : i0[i] < j} (n_in + 1 entries), so the first sum runs over
// i in [off[j - 1], off[j]) and the second over [off[j], off[j + 1]). The
// repeat of an axis of size 1 is the case i0 = 0, w0 = 1, off = {0, n_out}.
//
// What bounds it on this card: bytes. Each output element reads about
// n_out / n_in (2 in the UNet) elements of dy and writes one of dx; the
// weights and offsets are a few KB, read through the cache. Design: a
// thread per four consecutive dx elements along the innermost dimension
// (16- or 8-byte loads and stores), or per one to four rows j when the axis
// is innermost, so that the reads of dy coalesce.
// Products are rounded to float32 and summed in float32 (__fmul_rn /
// __fadd_rn: no contraction into FMAs, so the sum is the plain sequential
// one), and each result is rounded once to dx's type. bfloat16 products are
// exact in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int THREADS = 256;

// VEC consecutive elements of a row, widened to float32: one 16-byte
// (float32) or 8-byte (bfloat16) load for VEC = 4.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
                        static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[1])))
                            << 16;
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2])) |
                        static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[3])))
                            << 16;
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// acc += the products of input row j's two runs, in ascending order: dy
// rows [off[j - 1], off[j]) by w1, then [off[j], off[j + 1]) by w0. col
// points at dy row 0 of this (outer, innermost position); a row is
// VEC elements wide and `stride` apart.
template <int VEC, typename T>
__device__ __forceinline__ void add_runs(float (&acc)[VEC], const T* col, size_t stride,
                                         const T* __restrict__ w0, const T* __restrict__ w1,
                                         const int* __restrict__ off, int j) {
  const int mid = __ldg(off + j), end = __ldg(off + j + 1);
  float v[VEC];
  for (int i = j > 0 ? __ldg(off + j - 1) : mid; i < mid; ++i) {
    load_vec<VEC>(col + i * stride, v);
    const float w = to_f(__ldg(w1 + i));
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(v[u], w));
  }
  for (int i = mid; i < end; ++i) {
    load_vec<VEC>(col + i * stride, v);
    const float w = to_f(__ldg(w0 + i));
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(v[u], w));
  }
}

// dy (outer, n_out, inner) and dx (outer, n_in, inner), contiguous; w0, w1
// (n_out) in T; off (n_in + 1) int32. A thread computes VEC consecutive dx
// elements: VEC positions along the innermost dimension of one row j
// (inner > 1, a multiple of VEC), or VEC consecutive rows j (inner = 1, n_in
// a multiple of VEC); each element's sum is the same either way.
// groups = outer * n_in * inner / VEC < 2^30.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
resize_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ w0, const T* __restrict__ w1,
                  const int* __restrict__ off, T* __restrict__ dx, int groups, int n_in,
                  int n_out, int inner) {
  for (int q = blockIdx.x * THREADS + threadIdx.x; q < groups; q += gridDim.x * THREADS) {
    const int e = q * VEC;
    const int r = e / inner;
    const int k = e - r * inner;
    const int o = r / n_in;
    const int j = r - o * n_in;
    float acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
    if (inner > 1) {
      add_runs<VEC>(acc, dy + static_cast<size_t>(o) * n_out * inner + k,
                    static_cast<size_t>(inner), w0, w1, off, j);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        float one[1] = {0.f};
        add_runs<1>(one, dy + static_cast<size_t>(o) * n_out, 1, w0, w1, off, j + u);
        acc[u] = one[0];
      }
    }
    store_vec<VEC>(dx + e, acc);
  }
}

template <typename T, int VEC>
int launch_vec(const void* dy, const void* w0, const void* w1, const void* off, void* dx,
               long long total, int n_in, int n_out, int inner, cudaStream_t stream) {
  const long long groups = total / VEC;
  const int blocks = static_cast<int>(
      (groups + THREADS - 1) / THREADS < 132 * 64 ? (groups + THREADS - 1) / THREADS : 132 * 64);
  resize_bwd_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w0), static_cast<const T*>(w1),
      static_cast<const int*>(off), static_cast<T*>(dx), static_cast<int>(groups), n_in, n_out,
      inner);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dy, const void* w0, const void* w1, const void* off, void* dx, int outer,
           int n_in, int n_out, int inner, void* stream) {
  const long long total = static_cast<long long>(outer) * n_in * inner;
  if (outer < 1 || n_in < 1 || n_out < 1 || inner < 1 || total >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  // Four elements a thread where they share a row (16- or 8-byte aligned,
  // as torch allocates), or a column of bfloat16 rows; else one. (For
  // float32 rows of an innermost axis, four outputs a thread read 32-byte
  // segments 32 bytes apart across a warp and ran slower than one on the
  // H100.)
  const bool vec = inner > 1 ? inner % 4 == 0 : sizeof(T) == 2 && n_in % 4 == 0;
  return vec ? launch_vec<T, 4>(dy, w0, w1, off, dx, total, n_in, n_out, inner, st)
             : launch_vec<T, 1>(dy, w0, w1, off, dx, total, n_in, n_out, inner, st);
}

}  // namespace

extern "C" int mm_resize_bwd_f32(const void* dy, const void* w0, const void* w1,
                                 const void* off, void* dx, int outer, int n_in, int n_out,
                                 int inner, void* stream) {
  return launch<float>(dy, w0, w1, off, dx, outer, n_in, n_out, inner, stream);
}

extern "C" int mm_resize_bwd_bf16(const void* dy, const void* w0, const void* w1,
                                  const void* off, void* dx, int outer, int n_in, int n_out,
                                  int inner, void* stream) {
  return launch<__nv_bfloat16>(dy, w0, w1, off, dx, outer, n_in, n_out, inner, stream);
}
