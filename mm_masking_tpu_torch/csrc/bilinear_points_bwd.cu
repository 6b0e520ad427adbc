// Gradient, with respect to the image, of the per-point bilinear lookup
// (ops/grid_sample.py::grid_sample_points, zero padding), in gather form,
// with no atomics: two runs give the same bits.
//
// Beside the TPU kernels: the JAX package has no pallas_call here. Its lookup
// (mm_masking_tpu/ops/grid_sample.py:80) is four take_along_axis gathers,
// whose VJP XLA derives. In PyTorch the lookup is F.grid_sample, whose CUDA
// backward (grid_sampler_2d_backward) adds each point's four taps into the
// image with float atomics, in an order that changes from run to run.
//
// The forward samples image n at P points, point p at pixel coordinates
// (x, y) = unnormalize(coords[n, p]) with the four taps (floor(x) + a,
// floor(y) + b), a, b in {0, 1}, each weighted by wx_a * wy_b: wx_0 =
// (floor(x) + 1) - x, wx_1 = x - floor(x), and likewise in y (the weights and
// rounding of ATen's grid_sampler_2d in float32, which the forward runs for
// bfloat16 images too). A tap outside the image contributes
// nothing. The gradient of pixel (r, c) is the sum over the points p, in
// ascending order, of (wx_a * wy_b) * dout[n, p] for the tap of p that lands
// on it (a point has at most one). Pad points routed to (-100, -100) have
// every tap outside the image.
//
// What bounds it on this card: bytes, the gradient image written in full
// (N * H * W elements; the points are a few hundred KB). Design: the image is
// cut into tiles of 64 rows x 128 columns, one block each, accumulated in
// float32 in shared memory. The block reads its image's points in chunks of 1024 (L2
// serves them to the other tiles), keeps in order those whose taps can reach
// its tile (ballots and a prefix count), and one warp adds them in that
// order, 8 points a round, four lanes for the four taps of a point (which
// land on four distinct pixels); lanes of a round that land on one pixel are
// added by the first of them in lane order. So each pixel's sum runs over
// ascending p. Bucketing by tile was chosen over sorting (pixel,
// contribution) pairs: it needs no scratch, no sort and no second pass, and
// the tile is written once, in full, with coalesced stores. Products and
// sums are rounded to float32 as written (no contraction into FMAs), each
// result once to the image's type.
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

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int TW = 128, TH = 64;      // a block's tile: columns, rows
constexpr int PER = 4;                // points a thread reads a pass
constexpr int CHUNK = PER * THREADS;  // points read a pass

// A point's (x, y), widened to float32: one 8-byte or 4-byte load.
__device__ __forceinline__ float2 load_xy(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_xy(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ATen's grid_sampler_unnormalize: normalised [-1, 1] to pixel coordinates.
__device__ __forceinline__ float unnormalize(float coord, int size, bool align) {
  return align ? __fmul_rn(__fmul_rn(__fadd_rn(coord, 1.f), 0.5f), static_cast<float>(size - 1))
               : __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(coord, 1.f), static_cast<float>(size)),
                                     -1.f),
                           0.5f);
}

// dout (N, P), coords (N, P, 2) (x, y) and dimg (N, H, W), all T, contiguous.
// grid = (ceil(W / TW), ceil(H / TH), N).
template <typename T>
__global__ void __launch_bounds__(THREADS)
bilinear_points_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ coords,
                           T* __restrict__ dimg, int P, int H, int W, int align) {
  __shared__ float tile[TH * TW];
  __shared__ float hx[CHUNK], hy[CHUNK], hg[CHUNK];
  __shared__ int counts[PER * WARPS];
  __shared__ float contrib[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH, n = blockIdx.z;
  const T* g = dout + static_cast<size_t>(n) * P;
  const T* xy = coords + static_cast<size_t>(n) * P * 2;
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) tile[i] = 0.f;

  for (int base = 0; base < P; base += CHUNK) {
    // Keep, in order, the chunk's points with a tap in the tile: point
    // base + j * THREADS + threadIdx.x is this thread's j-th, so the order
    // of (j, warp, lane) is the points' order.
    float x[PER], y[PER], gv[PER];
    bool hit[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = base + j * THREADS + threadIdx.x;
      hit[j] = p < P;
      const float2 c = hit[j] ? load_xy(xy + 2 * p) : make_float2(0.f, 0.f);
      x[j] = c.x;
      y[j] = c.y;
      gv[j] = hit[j] ? to_f(g[p]) : 0.f;
    }
    unsigned mask[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      x[j] = unnormalize(x[j], W, align != 0);
      y[j] = unnormalize(y[j], H, align != 0);
      const float fx = floorf(x[j]), fy = floorf(y[j]);
      hit[j] = hit[j] && fx >= c0 - 1 && fx < c0 + TW && fy >= r0 - 1 && fy < r0 + TH;
      mask[j] = __ballot_sync(0xffffffffu, hit[j]);
      if (lane == 0) counts[j * WARPS + warp] = __popc(mask[j]);
    }
    __syncthreads();  // counts in place; the previous chunk's list is read
    int total = 0;
#pragma unroll
    for (int q = 0; q < PER * WARPS; ++q) total += counts[q];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (hit[j]) {
        int s = __popc(mask[j] & ((1u << lane) - 1u));
        for (int q = 0; q < j * WARPS + warp; ++q) s += counts[q];
        hx[s] = x[j];
        hy[s] = y[j];
        hg[s] = gv[j];
      }
    }
    __syncthreads();
    // Add them in order, 8 points a round: lane 4 k + 2 b + a takes tap
    // (a, b) of the round's point k. The lanes that land on one pixel (two
    // points' taps may) are added by the first of them, in lane order, so
    // that every pixel's sum runs over ascending points.
    if (warp == 0) {
      const int a = lane & 1, b = lane >> 1 & 1, k = lane >> 2;
      for (int e0 = 0; e0 < total; e0 += 8) {
        const int e = e0 + k;
        int key = -1 - lane;  // no pixel: a key of its own
        float v = 0.f;
        if (e < total) {
          const float px = hx[e], py = hy[e];
          const float fx = floorf(px), fy = floorf(py);
          const float wx = a ? __fadd_rn(px, -fx) : __fadd_rn(__fadd_rn(fx, 1.f), -px);
          const float wy = b ? __fadd_rn(py, -fy) : __fadd_rn(__fadd_rn(fy, 1.f), -py);
          // fx, fy lie within a tile's width of the tile: the casts are exact.
          const int c = static_cast<int>(fx) + a, r = static_cast<int>(fy) + b;
          if (c >= 0 && c < W && r >= 0 && r < H && c >= c0 && c < c0 + TW && r >= r0 &&
              r < r0 + TH) {
            key = (r - r0) * TW + (c - c0);
            v = __fmul_rn(__fmul_rn(wx, wy), hg[e]);
          }
        }
        const unsigned same = __match_any_sync(0xffffffffu, key);
        contrib[lane] = v;
        __syncwarp();
        if (key >= 0 && (same & ((1u << lane) - 1u)) == 0) {
          float acc = tile[key];
          for (unsigned m = same; m != 0; m &= m - 1) acc = __fadd_rn(acc, contrib[__ffs(m) - 1]);
          tile[key] = acc;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  T* out = dimg + static_cast<size_t>(n) * H * W;
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int r = r0 + i / TW, c = c0 + i % TW;
    if (r < H && c < W) out[static_cast<size_t>(r) * W + c] = from_f<T>(tile[i]);
  }
}

template <typename T>
int launch(const void* dout, const void* coords, void* dimg, int N, int P, int H, int W,
           int align, void* stream) {
  if (N < 1 || P < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  bilinear_points_bwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dout), static_cast<const T*>(coords), static_cast<T*>(dimg), P, H,
      W, align);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mm_bilinear_points_bwd_f32(const void* dout, const void* coords, void* dimg,
                                          int N, int P, int H, int W, int align,
                                          void* stream) {
  return launch<float>(dout, coords, dimg, N, P, H, W, align, stream);
}

extern "C" int mm_bilinear_points_bwd_bf16(const void* dout, const void* coords, void* dimg,
                                           int N, int P, int H, int W, int align,
                                           void* stream) {
  return launch<__nv_bfloat16>(dout, coords, dimg, N, P, H, W, align, stream);
}
