// Conv probe P4: the 3x3 SAME conv (no bias, optional ReLU) on the flat
// lanes of an NCHW image: each channel's H x W plane is one row of H * W
// lanes, the di taps are offsets of -W, 0, +W lanes and the dj taps of
// -1, 0, +1 lanes under the row-edge mask.
//
// Replaces: benchmarks/probe_pallas_conv4.py::conv3x3_flat (body _kernel,
// pallas_call at :104), which staged a (Ci, (TH + 2) W) slab per TH-row tile
// and contracted it in one (Co, 9 Ci) @ (9 Ci, TH W) dot (ndot = 1) or in
// three K = 3 Ci dots summed in di order (ndot = 3, :62-69).
//
// What bounds it on this card: as P1 (conv_probe_nhcw.cu), operations on the
// f32 CUDA cores and the shared-memory reads of the contraction (640^2,
// 16 -> 16, B = 16: 30.2 GFLOP, 0.45 ms at 67 TFLOP/s); the bytes alone
// would allow 0.125 ms in bf16. The staged slab also holds 2 W lanes of halo
// per chunk, read again by the neighbouring chunks (from L2).
//
// Design: one block takes one (b, TH-row tile, chunk of Lc lanes of the
// tile's TH * W). It stages, per input channel, the chunk plus the W lanes
// before and after it plus one lane on each side, with 16-byte cp.async
// copies; at the tile's first and last row those W lanes are the halo rows
// above and below the tile, and zeros beyond the image. The taps are read
// straight from that slab (no x9): lane f's (di, dj) tap is slab lane
// f + (di - 1) W + dj - 1, zero when dj = 0 and f % W == 0 or dj = 2 and
// f % W == W - 1, with f the global lane, as the iota mask at
// probe_pallas_conv4.py:44-46. Each thread owns one lane and 8 output
// channels. The host picks Lc from (Ci, Co, W, dtype) by
// mm_probe_flat_smem_bytes, so that the slab fits in shared memory.
#include "conv_probe.cuh"

namespace {

using namespace probe;

size_t smem_bytes(int Ci, int Co, int W, int Lc, int elem) {
  const int S = Lc + 2 * W + 2 * (16 / elem);
  return static_cast<size_t>(9 * Ci) * round_up(Co, COB) * 4 +
         static_cast<size_t>(Ci) * S * elem;
}

// x (B, Ci, H, W); kmat (Co, 9 Ci) f32; y (B, Co, H, W).
// grid = (ceil(TH * W / Lc), H / TH, B).
template <typename T, int NDOT>
__global__ void __launch_bounds__(THREADS)
probe_flat_kernel(const T* __restrict__ x, const float* __restrict__ kmat, T* __restrict__ y,
                  int Ci, int Co, int H, int W, int TH, int Lc, int relu, int vec) {
  constexpr int V = vec_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 9 * Ci;
  const int cop = (Co + COB - 1) / COB * COB;
  const int S = Lc + 2 * W + 2 * V;
  float* ks = reinterpret_cast<float*>(smem);
  T* slab = reinterpret_cast<T*>(ks + K * cop);

  const int HW = H * W;
  const int c0 = blockIdx.x * Lc;
  const int f0 = blockIdx.y * TH * W + c0;  // global lane of the chunk's first output
  const int n_out = min(Lc, TH * W - c0);
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * Ci * HW;
  T* yb = y + static_cast<size_t>(b) * Co * HW;

  // slab[ci * S + V + j] = x[b, ci, lane f0 - W + j], j in [-1, Lc + 2 W].
  stage_rows(slab, Ci, S, f0 - W, Lc + 2 * W, HW, vec != 0,
             [&](int r) -> const T* { return xb + static_cast<size_t>(r) * HW; });
  cp_async_commit();
  stage_weights(kmat, ks, Co, K, cop);
  cp_async_wait<0>();
  __syncthreads();

  const int ncog = cop / COB;
  for (int it = threadIdx.x; it < Lc * ncog; it += blockDim.x) {
    const int l = it % Lc;
    const int co0 = (it / Lc) * COB;
    if (l >= n_out) continue;
    const int col = (f0 + l) % W;
    const bool left = col != 0;
    const bool right = col != W - 1;
    float acc[COB] = {};
    for (int di = 0; di < 3; ++di) {
      float part[COB] = {};
      float* sum = NDOT == 1 ? acc : part;  // ndot = 3: one K = 3 Ci sum per di
      for (int dj = 0; dj < 3; ++dj) {
        const bool live = dj == 1 || (dj == 0 ? left : right);
        const T* xs = slab + V + l + di * W + dj - 1;
        const float* kc = ks + (di * 3 + dj) * Ci * cop + co0;
#pragma unroll 4
        for (int ci = 0; ci < Ci; ++ci) {
          fma_cob(sum, kc + ci * cop, live ? to_f(xs[static_cast<size_t>(ci) * S]) : 0.f);
        }
      }
      if (NDOT == 3) {
#pragma unroll
        for (int c = 0; c < COB; ++c) acc[c] += part[c];
      }
    }
    store_cob(yb + f0 + l, acc, co0, Co, HW, relu != 0);
  }
}

template <typename T, int NDOT>
int launch_ndot(const T* x, const float* kmat, T* y, int B, int Ci, int Co, int H, int W,
                int TH, int Lc, int relu, int vec, cudaStream_t stream) {
  const size_t bytes = smem_bytes(Ci, Co, W, Lc, sizeof(T));
  const int status = smem_opt_in(probe_flat_kernel<T, NDOT>, bytes);
  if (status != 0) return status;
  const dim3 grid((TH * W + Lc - 1) / Lc, H / TH, B);
  probe_flat_kernel<T, NDOT><<<grid, THREADS, bytes, stream>>>(x, kmat, y, Ci, Co, H, W, TH,
                                                               Lc, relu, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* kmat, T* y, int B, int Ci, int Co, int H, int W, int TH,
           int Lc, int ndot, int relu, int vec, cudaStream_t stream) {
  if (ndot == 1) {
    return launch_ndot<T, 1>(x, kmat, y, B, Ci, Co, H, W, TH, Lc, relu, vec, stream);
  }
  if (ndot == 3) {
    return launch_ndot<T, 3>(x, kmat, y, B, Ci, Co, H, W, TH, Lc, relu, vec, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared bytes of one block: the host picks Lc by it.
extern "C" size_t mm_probe_flat_smem_bytes(int Ci, int Co, int W, int Lc, int elem) {
  return smem_bytes(Ci, Co, W, Lc, elem);
}

extern "C" int mm_probe_flat_f32(const void* x, const void* kmat, void* y, int B, int Ci,
                                 int Co, int H, int W, int TH, int Lc, int ndot, int relu,
                                 int vec, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(kmat),
                static_cast<float*>(y), B, Ci, Co, H, W, TH, Lc, ndot, relu, vec,
                static_cast<cudaStream_t>(stream));
}

extern "C" int mm_probe_flat_bf16(const void* x, const void* kmat, void* y, int B, int Ci,
                                  int Co, int H, int W, int TH, int Lc, int ndot, int relu,
                                  int vec, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(kmat),
                static_cast<__nv_bfloat16*>(y), B, Ci, Co, H, W, TH, Lc, ndot, relu, vec,
                static_cast<cudaStream_t>(stream));
}
