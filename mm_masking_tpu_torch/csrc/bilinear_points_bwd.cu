// Gradient, with respect to the image, of the per-point bilinear lookup
// (ops/grid_sample.py::grid_sample_points, zero padding), in gather form,
// with no float atomics: two runs give the same bits.
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
// on it (a point has at most one), starting from +0; products and sums are
// rounded to float32 as written (no contraction into FMAs), the result once
// to the image's type. Pad points routed to (-100, -100) have every tap
// outside the image. ops/kernels/resample.py::bilinear_points_bwd_ordered is
// the same sums in plain PyTorch.
//
// What bounds it on this card: bytes, the gradient image written once in
// full (N * H * W elements; the points are a few hundred KB).
//
// Design: two launches, so that each point is read and tested once.
//  1. bilinear_points_bwd_bin. The image is cut into bins of RW rows x TW
//     columns, the points into chunks of CH; one block a (chunk, image).
//     Each point enters the list of every bin that one of its taps reaches:
//     one bin, or two or four on a bin's edge. A block writes its chunk's
//     lists one bin after another, each bin's entries in ascending p, and
//     where each bin's entries start. An entry carries what the second pass
//     needs of the point, its pixel coordinates and dout, so that it
//     gathers nothing. The order is decided by integer counts alone: each
//     warp takes 32 consecutive points, 8 a round and a lane a tap, ranks a
//     round's entries of one bin by lane (__match_any_sync), counts them per
//     warp, and the warps' counts are summed in warp order. No atomics.
//  2. bilinear_points_bwd_tiles. One block a tile of TH = 8 RW rows x TW
//     columns, accumulated in float32 in shared memory; each warp owns one
//     bin of it, RW rows, and reads only that bin's list: its chunks' lists
//     one after another, so ascending in p. The warp loads the list 32
//     entries at a time, a lane each (the next 32 in flight while these are
//     added), and adds them 8 a round, four lanes for the four taps of a
//     point (which land on four distinct pixels); lanes of a round that land
//     on one pixel are added by the first of them in lane order. So every
//     pixel's sum runs over ascending p, as in one sequential loop. The warp
//     then writes its rows once, zeros included, in 16-byte stores. The
//     warps need no barrier, and bins of 10 rows share a dense tile's points
//     out evenly among them. 80 x 128-pixel tiles keep a 640 x 640 batch of
//     16 at 640 blocks of 43 KB, five to an SM: one wave on 132 SMs. The
//     pass is launched as a programmatic dependent of the binning pass, so
//     that it zeroes its tile while that pass ends.
// The lists (4 * CH entries a chunk: at most four taps a point) and the
// starts come from the caller, who allocates them on the stream's pool.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_opt_in.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int TW = 128, RW = 10;  // a bin: RW rows x TW columns
constexpr int TILE_WARPS = 8, TH = RW * TILE_WARPS;  // a tile: a bin a warp
constexpr int TILE_THREADS = 32 * TILE_WARPS;
constexpr int BIN_WARPS = 8, BIN_THREADS = 32 * BIN_WARPS;
constexpr int CH = 256;                 // points a bin block
constexpr int PER_WARP = CH / BIN_WARPS;  // consecutive points a bin warp takes
constexpr int ROUNDS = PER_WARP / 8;      // 8 points (32 taps) a round

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

template <typename T>
__device__ __forceinline__ float2 pixel_xy(const T* xy, int p, int H, int W, bool align) {
  const float2 c = load_xy(xy + 2 * static_cast<size_t>(p));
  return make_float2(unnormalize(c.x, W, align), unnormalize(c.y, H, align));
}

// Programmatic dependent launch (sm_90): the tile pass is launched to
// overlap the binning pass's tail and waits for its results before reading
// them; the binning pass lets it start at once.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Exclusive prefix sums of v over the lanes of a warp, and their total.
__device__ __forceinline__ int warp_exclusive(int v, int lane, int& total) {
  int s = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, s, d);
    if (lane >= d) s += u;
  }
  total = __shfl_sync(0xffffffffu, s, 31);
  return s - v;
}

// dout (N, P) and coords (N, P, 2) T. lists (N, G, 4 CH) float4: chunk g's
// entries, the points g CH .. g CH + CH - 1 that reach each bin, bin after
// bin, each bin's in ascending p; an entry is the point's pixel coordinates,
// its dout widened to float32, and p (its bits). starts (N, nbins + 1, G)
// int32: where bin t's entries begin in chunk g's list (t = nbins, the
// number of bins: where the list ends).
// grid = (G, N); dynamic shared memory (BIN_WARPS + 1) * nbins + 1 ints.
template <typename T>
__global__ void __launch_bounds__(BIN_THREADS)
bilinear_points_bwd_bin(const T* __restrict__ dout, const T* __restrict__ coords,
                        float4* __restrict__ lists, int* __restrict__ starts, int P, int H, int W,
                        int align, int ntx, int nbins) {
  extern __shared__ int bsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x, n = blockIdx.y, G = gridDim.x;
  int* mine = bsm + warp * nbins;  // this warp's entries per bin, then their offsets
  int* start = bsm + BIN_WARPS * nbins;    // [nbins + 1]
  const T* xy = coords + static_cast<size_t>(n) * P * 2;
  griddep_launch_dependents();  // the tile pass may start its prologue

  // Lane 4 k + 2 b + a of round r takes tap (a, b) of the warp's point
  // 8 r + k. A point's taps in one bin make one entry, the first of them.
  const int a = lane & 1, b = lane >> 1 & 1;
  const unsigned below = (1u << lane) - 1u, group = 0xfu << (lane & ~3);
  const int first = g * CH + warp * PER_WARP;
  int key[ROUNDS];
  unsigned same[ROUNDS];
  float4 entry[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int p = first + 8 * r + lane / 4;
    int t = -1;
    entry[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < P) {
      const float2 q = pixel_xy(xy, p, H, W, align != 0);
      entry[r] = make_float4(q.x, q.y, to_f(dout[static_cast<size_t>(n) * P + p]),
                             __int_as_float(p));
      const float c = floorf(q.x) + a, rr = floorf(q.y) + b;
      if (c >= 0.f && c < W && rr >= 0.f && rr < H)
        t = static_cast<int>(rr) / RW * ntx + static_cast<int>(c) / TW;
    }
    const unsigned m = __match_any_sync(0xffffffffu, t);
    const bool keep = t >= 0 && (m & group & below) == 0u;
    key[r] = keep ? t : -1;
    same[r] = m & __ballot_sync(0xffffffffu, keep);  // the round's entries of this bin
  }
  for (int i = threadIdx.x; i < BIN_WARPS * nbins; i += BIN_THREADS) bsm[i] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (key[r] >= 0 && (same[r] & below) == 0u) mine[key[r]] += __popc(same[r]);
    __syncwarp();
  }
  __syncthreads();
  // A bin's entries go warp after warp; the bins one after another.
  for (int t = threadIdx.x; t < nbins; t += BIN_THREADS) {
    int s = 0;
    for (int w = 0; w < BIN_WARPS; ++w) {
      const int c = bsm[w * nbins + t];
      bsm[w * nbins + t] = s;
      s += c;
    }
    start[t] = s;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int t0 = 0; t0 < nbins; t0 += 32) {
      const int t = t0 + lane;
      const int c = t < nbins ? start[t] : 0;
      int total;
      const int s = warp_exclusive(c, lane, total);
      if (t < nbins) start[t] = carry + s;
      carry += total;
    }
    if (lane == 0) start[nbins] = carry;
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= nbins; t += BIN_THREADS)
    starts[(static_cast<size_t>(n) * (nbins + 1) + t) * G + g] = start[t];
  float4* list = lists + (static_cast<size_t>(n) * G + g) * 4 * CH;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int t = key[r];
    if (t >= 0) list[start[t] + mine[t] + __popc(same[r] & below)] = entry[r];
    __syncwarp();
    if (t >= 0 && (same[r] & below) == 0u) mine[t] += __popc(same[r]);
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* src);
template <>
__device__ __forceinline__ void store16<float>(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst, const float* src) {
  const float4 u = *reinterpret_cast<const float4*>(src);
  const float4 v = *reinterpret_cast<const float4*>(src + 4);
  const auto bits = [](float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  };
  *reinterpret_cast<uint4*>(dst) = make_uint4(bits(u.x, u.y), bits(u.z, u.w), bits(v.x, v.y),
                                              bits(v.z, v.w));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t tile_smem_bytes(int G) {
  return (static_cast<size_t>(TH) * TW + 32 * TILE_WARPS +
          TILE_WARPS * (2 * static_cast<size_t>(G) + 1)) * 4;
}

// dimg (N, H, W) T, contiguous; lists and starts from
// bilinear_points_bwd_bin. grid = (ntx, ceil(H / TH), N); dynamic shared
// memory tile_smem_bytes(G). Warp w of block (x, y) takes bin (y TILE_WARPS
// + w, x): its RW rows of the tile. With vec (W a multiple of 16 bytes'
// elements) the rows leave in 16-byte stores.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 5)
bilinear_points_bwd_tiles(const float4* __restrict__ lists, const int* __restrict__ starts,
                          T* __restrict__ dimg, int H, int W, int G, int vec) {
  extern __shared__ __align__(16) float tsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* rows = tsm + warp * RW * TW;     // this warp's rows of the tile
  float* con = tsm + TH * TW + 32 * warp;  // its round's contributions
  int* base = reinterpret_cast<int*>(tsm + TH * TW + 32 * TILE_WARPS) + warp * (2 * G + 1);
  int* from = base + G + 1;  // its list: chunk g's entries from[g] .. at base[g] ..
  const int ntx = gridDim.x, nbins = ntx * ((H + RW - 1) / RW), n = blockIdx.z;
  const int by = blockIdx.y * TILE_WARPS + warp, bin = by * ntx + blockIdx.x;
  const int c0 = blockIdx.x * TW, lo = by * RW;  // the warp's rows: lo .. lo + RW - 1
  for (int i = lane; i < RW * TW / 4; i += 32)
    reinterpret_cast<float4*>(rows)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lo >= H) return;
  griddep_wait();  // the binning pass's lists and starts are complete
  const int* s = starts + (static_cast<size_t>(n) * (nbins + 1) + bin) * G;
  int carry = 0;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    const int f = g < G ? s[g] : 0, c = g < G ? s[G + g] - f : 0;
    int total;
    const int e = warp_exclusive(c, lane, total);
    if (g < G) {
      from[g] = f;
      base[g] = carry + e;
    }
    carry += total;
  }
  const int M = carry;
  __syncwarp();
  const float4* ln = lists + static_cast<size_t>(n) * G * 4 * CH;
  const int a = lane & 1, b = lane >> 1 & 1, k = lane / 4;
  const unsigned below = (1u << lane) - 1u;
  // Entry e of the list: in chunk g, the last that starts at or before e.
  auto entry = [&](int e) {
    int g = 0, hi = G - 1;
    while (g < hi) {
      const int mid = (g + hi + 1) / 2;
      if (base[mid] <= e) g = mid; else hi = mid - 1;
    }
    return ln[static_cast<size_t>(g) * 4 * CH + from[g] + e - base[g]];
  };
  // The list 32 entries at a time, a lane each (the next 32 loading while
  // these are added), and they 8 a round: lanes 4 k .. 4 k + 3 take entry
  // r0 + k.
  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < M) next = entry(lane);
  for (int e0 = 0; e0 < M; e0 += 32) {
    const float4 cur = next;
    if (e0 + 32 + lane < M) next = entry(e0 + 32 + lane);
    const int m = min(32, M - e0);
    for (int r0 = 0; r0 < m; r0 += 8) {
      const int src = r0 + k;
      const float px = __shfl_sync(0xffffffffu, cur.x, src),
                  py = __shfl_sync(0xffffffffu, cur.y, src),
                  pg = __shfl_sync(0xffffffffu, cur.z, src);
      int key = -1;  // no pixel of this warp
      float v = 0.f;
      if (src < m) {
        const float fx = floorf(px), fy = floorf(py);
        const float c = fx + a, r = fy + b;
        if (c >= c0 && c < c0 + TW && c < W && r >= lo && r < lo + RW && r < H) {
          const float wx = a ? __fadd_rn(px, -fx) : __fadd_rn(__fadd_rn(fx, 1.f), -px);
          const float wy = b ? __fadd_rn(py, -fy) : __fadd_rn(__fadd_rn(fy, 1.f), -py);
          key = (static_cast<int>(r) - lo) * TW + static_cast<int>(c) - c0;
          v = __fmul_rn(__fmul_rn(wx, wy), pg);
        }
      }
      const unsigned same = __match_any_sync(0xffffffffu, key);
      con[lane] = v;
      __syncwarp();
      if (key >= 0 && (same & below) == 0u) {
        float acc = rows[key];
        for (unsigned mm = same; mm != 0u; mm &= mm - 1u) acc = __fadd_rn(acc, con[__ffs(mm) - 1]);
        rows[key] = acc;
      }
      __syncwarp();
    }
  }
  // The warp's rows leave once, zeros included.
  T* out = dimg + static_cast<size_t>(n) * H * W;
  if (vec) {
    constexpr int V = 16 / sizeof(T), PER_ROW = TW / V;  // 16-byte stores a row: 32 or 16
    for (int i = lane; i < RW * PER_ROW; i += 32) {
      const int rr = i / PER_ROW, c = c0 + i % PER_ROW * V;
      if (lo + rr < H && c < W) store16(out + static_cast<size_t>(lo + rr) * W + c,
                                        rows + rr * TW + (c - c0));
    }
  } else {
    for (int i = lane; i < RW * TW; i += 32) {
      const int rr = i / TW, c = c0 + i % TW;
      if (lo + rr < H && c < W) out[static_cast<size_t>(lo + rr) * W + c] = from_f<T>(rows[i]);
    }
  }
}

template <typename T>
int launch(const void* dout, const void* coords, void* dimg, void* lists, void* starts, int N,
           int P, int H, int W, int align, void* stream) {
  if (N < 1 || P < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ntx = (W + TW - 1) / TW, nby = (H + RW - 1) / RW, G = (P + CH - 1) / CH;
  const size_t bin_bytes = (static_cast<size_t>(BIN_WARPS + 1) * ntx * nby + 1) * 4;
  const size_t tile_bytes = tile_smem_bytes(G);
  int status = mm::opt_in_smem(reinterpret_cast<const void*>(bilinear_points_bwd_bin<T>),
                               static_cast<int>(bin_bytes));
  if (status == 0)
    status = mm::opt_in_smem(reinterpret_cast<const void*>(bilinear_points_bwd_tiles<T>),
                             static_cast<int>(tile_bytes));
  if (status != 0) return status;
  bilinear_points_bwd_bin<T><<<dim3(G, N), BIN_THREADS, bin_bytes, st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(coords), static_cast<float4*>(lists),
      static_cast<int*>(starts), P, H, W, align, ntx, ntx * nby);
  status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  const int vec = W % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<uintptr_t>(dimg) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntx, (H + TH - 1) / TH, N);
  cfg.blockDim = dim3(TILE_THREADS);
  cfg.dynamicSmemBytes = tile_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  status = static_cast<int>(cudaLaunchKernelEx(
      &cfg, bilinear_points_bwd_tiles<T>, static_cast<const float4*>(lists),
      static_cast<const int*>(starts), static_cast<T*>(dimg), H, W, G, vec));
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The layout the caller allocates and bilinear_points_bwd_bin fills: {RW, TW,
// CH} (bin rows and columns, points a chunk). lists: N * ceil(P / CH) * 4 *
// CH float4; starts: N * (ceil(H / RW) * ceil(W / TW) + 1) * ceil(P / CH)
// int32.
extern "C" void mm_bilinear_points_layout(int* out) {
  out[0] = RW;
  out[1] = TW;
  out[2] = CH;
}

extern "C" int mm_bilinear_points_bwd_f32(const void* dout, const void* coords, void* dimg,
                                          void* lists, void* starts, int N, int P, int H, int W,
                                          int align, void* stream) {
  return launch<float>(dout, coords, dimg, lists, starts, N, P, H, W, align, stream);
}

extern "C" int mm_bilinear_points_bwd_bf16(const void* dout, const void* coords, void* dimg,
                                           void* lists, void* starts, int N, int P, int H, int W,
                                           int align, void* stream) {
  return launch<__nv_bfloat16>(dout, coords, dimg, lists, starts, N, P, H, W, align, stream);
}
