// The 3x3 conv backward's ReLU mask and bias gradient in one pass over dy
// (ops/kernels/conv2d.py::_Conv3x3.backward), with no float atomics: two
// runs give the same bits.
//
// Beside the TPU kernels: it replaces no pallas_call. The JAX package's conv
// VJP (mm_masking_tpu/ops/pallas/conv2d.py::_conv_bwd) writes dy * (y > 0)
// and the bias sum in jnp, and XLA fuses them. In PyTorch the two
// expressions are five passes over every conv's dy: a compare, a cast of the
// mask, a multiply, a float32 copy and a reduction.
//
// For y (B, C, H, W) contiguous and dy of the same shape whose planes are
// contiguous, at any batch stride (a channel slice of a cat's cotangent is
// read in place), it writes
//   dy_m[b, c] = dy[b, c] * (y[b, c] > 0 ? 1 : 0)   in dy's type, with relu,
//   db[c] = sum over b, h, w of dy_m[b, c, h, w]     in float32,
// where dy_m is dy itself without relu. The mask is a multiply, as the plain
// version's, so signed zeros and non-finite values come out as they do
// there; the product is exact.
//
// What bounds it on this card: bytes. It reads y and dy once each and writes
// dy_m once (6 bytes an element in bfloat16, 12 in float32); without relu it
// reads dy alone. Design: each channel's B * H * W elements, its B planes one
// after the other, are cut into equal slabs, one block a slab, so that the
// smallest stage fills the 132 SMs too. The loads and stores are 16 bytes
// wide where the planes of y, dy and dy_m share their alignment, with a
// scalar head and tail in each plane (a polar plane of 25 x 210 floats is no
// multiple of 16 bytes). Each thread sums its elements in order, the block
// in a fixed tree, into one float32 partial a slab; a second kernel adds
// each channel's partials in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // 16-byte vectors of y and dy in flight a thread
// Slabs: enough blocks to fill the card a few times over, each at least
// MIN_SLAB elements; a slab's length is a multiple of 8 elements.
constexpr long long TARGET_BLOCKS = 132 * 16;
constexpr long long MIN_SLAB = 4096;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

// d * m, as the plain version's multiply: opaque to the compiler, which
// would otherwise turn d * (p ? 1 : 0) into p ? d : d * 0 and keep a NaN's
// payload that the multiply replaces.
__device__ __forceinline__ float mul(float d, float m) {
  float r;
  asm("mul.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(d), "f"(m));
  return r;
}

// One element: dy_m into *o (with relu), its value added to acc.
template <typename T, bool RELU>
__device__ __forceinline__ void one(const T* y, const T* d, T* o, float& acc) {
  float v = to_f(*d);
  if constexpr (RELU) {
    v = mul(v, to_f(*y) > 0.f ? 1.f : 0.f);
    from_f(v, o);
  }
  acc += v;
}

// 16 bytes: 4 floats or 8 bfloat16 values, widened to float32 and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[N]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  __device__ __forceinline__ static Raw pack(const float (&v)[N]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static Raw pack(const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
                 << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Elements [0, n) of one plane's run: y, d and o point at its first element.
// With VEC, the head up to d's next 16-byte boundary and the tail are
// scalar, the rest 16-byte vectors; y and o share d's alignment.
template <typename T, bool RELU, bool VEC>
__device__ __forceinline__ void run(const T* __restrict__ y, const T* __restrict__ d,
                                    T* __restrict__ o, int n, float& acc) {
  using V = Vec<T>;
  constexpr int N = V::N;
  if constexpr (!VEC) {
    for (int i = threadIdx.x; i < n; i += THREADS) one<T, RELU>(y + i, d + i, o + i, acc);
    return;
  }
  const int mis = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15);
  const int head = min(n, mis / static_cast<int>(sizeof(T)));
  const int nv = (n - head) / N;
  if (static_cast<int>(threadIdx.x) < head)
    one<T, RELU>(y + threadIdx.x, d + threadIdx.x, o + threadIdx.x, acc);
  const auto* yv = reinterpret_cast<const typename V::Raw*>(y + head);
  const auto* dv = reinterpret_cast<const typename V::Raw*>(d + head);
  auto* ov = reinterpret_cast<typename V::Raw*>(o + head);
  int k = threadIdx.x;
  for (; k + (UNROLL - 1) * THREADS < nv; k += UNROLL * THREADS) {
    typename V::Raw dr[UNROLL], yr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      dr[u] = __ldg(dv + k + u * THREADS);
      if constexpr (RELU) yr[u] = __ldg(yv + k + u * THREADS);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dd[N], yy[N];
      V::unpack(dr[u], dd);
      if constexpr (RELU) {
        V::unpack(yr[u], yy);
#pragma unroll
        for (int j = 0; j < N; ++j) dd[j] = mul(dd[j], yy[j] > 0.f ? 1.f : 0.f);
        ov[k + u * THREADS] = V::pack(dd);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) acc += dd[j];
    }
  }
  for (; k < nv; k += THREADS) {
    float dd[N], yy[N];
    V::unpack(__ldg(dv + k), dd);
    if constexpr (RELU) {
      V::unpack(__ldg(yv + k), yy);
#pragma unroll
      for (int j = 0; j < N; ++j) dd[j] = mul(dd[j], yy[j] > 0.f ? 1.f : 0.f);
      ov[k] = V::pack(dd);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) acc += dd[j];
  }
  const int done = head + nv * N;
  if (static_cast<int>(threadIdx.x) < n - done)
    one<T, RELU>(y + done + threadIdx.x, d + done + threadIdx.x, o + done + threadIdx.x, acc);
}

// Block (slab s, channel c): elements [s * slab, (s + 1) * slab) of channel
// c's B * HW, plane by plane; its sum → partial[c * n_slabs + s] (0 for a
// slab past the end). y and o are contiguous (B, C, HW); dy's planes are
// contiguous, dy_bstride apart in the batch and HW apart in the channel.
template <typename T, bool RELU, bool VEC>
__global__ void __launch_bounds__(THREADS)
relu_bias_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy, T* __restrict__ o,
                     float* __restrict__ partial, int C, int HW, long long dy_bstride,
                     long long per_channel, long long slab) {
  const int s = blockIdx.x, c = blockIdx.y;
  const long long k1 = min(per_channel, (s + 1) * slab);
  float acc = 0.f;
  for (long long k = s * slab; k < k1;) {
    const int b = static_cast<int>(k / HW);
    const int i0 = static_cast<int>(k - static_cast<long long>(b) * HW);
    const int i1 =
        static_cast<int>(min(static_cast<long long>(HW), k1 - static_cast<long long>(b) * HW));
    const size_t plane = (static_cast<size_t>(b) * C + c) * HW;
    const T* d = dy + b * dy_bstride + static_cast<size_t>(c) * HW;
    run<T, RELU, VEC>(y + plane + i0, d + i0, o + plane + i0, i1 - i0, acc);
    k = static_cast<long long>(b) * HW + i1;
  }
  // Fixed tree: each warp by shuffles, then the first warp over the warps.
  __shared__ float warp_sum[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < THREADS / 32 ? warp_sum[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partial[static_cast<size_t>(c) * gridDim.x + s] = acc;
  }
}

// db[c] = channel c's n_slabs partials, one warp a channel: lane l adds
// partials l, l + 32, ... in order, then the lanes in a fixed tree.
__global__ void __launch_bounds__(THREADS)
relu_bias_bwd_sum(const float* __restrict__ partial, float* __restrict__ db, int C, int n_slabs) {
  const int c = (blockIdx.x * THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (c >= C) return;  // whole warps
  float acc = 0.f;
  for (int j = lane; j < n_slabs; j += 32) acc += partial[static_cast<size_t>(c) * n_slabs + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) db[c] = acc;
}

long long slab_length(long long per_channel, int n_slabs) {
  return ((per_channel + n_slabs - 1) / n_slabs + 7) / 8 * 8;
}

bool co_aligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) - reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <typename T, bool RELU, bool VEC>
void launch_one(const void* y, const void* dy, void* o, float* partial, int B, int C, int HW,
                long long dy_bstride, int n_slabs, cudaStream_t st) {
  const long long per_channel = static_cast<long long>(B) * HW;
  relu_bias_bwd_kernel<T, RELU, VEC><<<dim3(n_slabs, C), THREADS, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy), static_cast<T*>(o), partial, C, HW,
      dy_bstride, per_channel, slab_length(per_channel, n_slabs));
}

template <typename T>
int launch(const void* y, const void* dy, void* o, void* partial, void* db, int B, int C, int HW,
           long long dy_bstride, int n_slabs, int relu, void* stream) {
  if (B < 1 || C < 1 || C > 65535 || HW < 1 || n_slabs < 1 || (relu && !o))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(partial);
  if (relu) {
    // 16-byte vectors where every plane of y, dy and dy_m shares its
    // alignment: y and dy_m are contiguous alike, dy's planes move against
    // y's by (dy_bstride - C * HW) elements from one batch item to the next.
    const long long drift = (dy_bstride - static_cast<long long>(C) * HW) * sizeof(T);
    const bool vec = co_aligned(y, dy) && co_aligned(o, dy) && (B == 1 || drift % 16 == 0);
    if (vec)
      launch_one<T, true, true>(y, dy, o, p, B, C, HW, dy_bstride, n_slabs, st);
    else
      launch_one<T, true, false>(y, dy, o, p, B, C, HW, dy_bstride, n_slabs, st);
  } else {
    // y and dy_m are not read or written: dy stands in for both.
    launch_one<T, false, true>(dy, dy, const_cast<void*>(dy), p, B, C, HW, dy_bstride, n_slabs,
                               st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relu_bias_bwd_sum<<<(C * 32 + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      p, static_cast<float*>(db), C, n_slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Slabs a channel: the scratch the wrapper allocates, (C, n_slabs) float32.
extern "C" int mm_relu_bias_bwd_slabs(int B, int C, int HW) {
  const long long per_channel = static_cast<long long>(B) * HW;
  const long long want = (TARGET_BLOCKS + C - 1) / C;
  const long long most = per_channel / MIN_SLAB > 1 ? per_channel / MIN_SLAB : 1;
  return static_cast<int>(want < most ? want : most);
}

extern "C" int mm_relu_bias_bwd_f32(const void* y, const void* dy, void* dy_m, void* partial,
                                    void* db, int B, int C, int HW, long long dy_bstride,
                                    int n_slabs, int relu, void* stream) {
  return launch<float>(y, dy, dy_m, partial, db, B, C, HW, dy_bstride, n_slabs, relu, stream);
}

extern "C" int mm_relu_bias_bwd_bf16(const void* y, const void* dy, void* dy_m, void* partial,
                                     void* db, int B, int C, int HW, long long dy_bstride,
                                     int n_slabs, int relu, void* stream) {
  return launch<__nv_bfloat16>(y, dy, dy_m, partial, db, B, C, HW, dy_bstride, n_slabs, relu,
                               stream);
}
