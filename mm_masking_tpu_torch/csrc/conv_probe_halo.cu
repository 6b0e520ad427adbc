// Conv probe P3: the 3x3 SAME conv (no bias, optional ReLU) of P1 in the
// NHCW layout (B, H, C, W), with the halo of the next row tile prefetched
// while the current one is contracted.
//
// Replaces: benchmarks/probe_pallas_conv3.py::conv3x3_nhcw_v2 (body _kernel,
// pallas_call at :80). The TPU kernel fed the halo as three BlockSpec inputs
// (the previous, current and next TH-row blocks of an x padded by TH zero
// rows at each end, probe_pallas_conv3.py:72), so that Mosaic's grid
// pipeline double-buffered them.
//
// What bounds it on this card: as P1 (conv_probe_nhcw.cu), operations on the
// f32 CUDA cores and the shared-memory reads of the contraction; the bytes
// alone would allow 0.125 ms at 640^2, 16 -> 16, B = 16, bf16.
//
// Design: the Hopper counterpart of that grid pipeline. One block walks G
// consecutive row tiles of one (b, W tile of Wt columns) through a two-stage
// cp.async ring: it commits the copy of tile i + 1's (TH + 2)-row halo slab,
// waits for tile i's (cp.async.wait_group 1), and builds tile i's im2col
// stack and contracts it while the next copy is in flight. The padding rows
// existed only for the BlockSpecs: this kernel reads the unpadded x and
// writes zeros for the rows above and below the image.
#include "conv_probe.cuh"

namespace {

using namespace probe;

size_t smem_bytes(int Ci, int Co, int TH, int Wt, int elem) {
  const int K = 9 * Ci;
  const int S = Wt + 2 * (16 / elem);
  return static_cast<size_t>(K) * round_up(Co, COB) * 4 +
         2 * static_cast<size_t>(TH + 2) * Ci * S * elem +
         static_cast<size_t>(TH) * K * Wt * elem;
}

// x (B, H, Ci, W); kmat (Co, 9 Ci) f32; y (B, H, Co, W).
// grid = (ceil(W / Wt), ceil((H / TH) / G), B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
probe_halo_kernel(const T* __restrict__ x, const float* __restrict__ kmat, T* __restrict__ y,
                  int H, int Ci, int Co, int W, int TH, int Wt, int G, int relu, int vec) {
  constexpr int V = vec_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 9 * Ci;
  const int cop = (Co + COB - 1) / COB * COB;
  const int S = Wt + 2 * V;
  const size_t slab = static_cast<size_t>(TH + 2) * Ci * S;
  float* ks = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(ks + K * cop);
  T* x9 = ring + 2 * slab;

  const int w0 = blockIdx.x * Wt;
  const int b = blockIdx.z;
  const int first = blockIdx.y * G;
  const int last = min(H / TH, first + G);
  const T* xb = x + static_cast<size_t>(b) * H * Ci * W;
  T* yb = y + static_cast<size_t>(b) * H * Co * W;

  // Rows i * TH - 1 .. i * TH + TH of x into ring slot s; null (zeros)
  // above and below the image.
  auto fetch = [&](int i, int s) {
    stage_rows(ring + s * slab, (TH + 2) * Ci, S, w0, Wt, W, vec != 0,
               [&](int r) -> const T* {
                 const int h = i * TH - 1 + r / Ci;
                 return (h < 0 || h >= H) ? nullptr
                                          : xb + (static_cast<size_t>(h) * Ci + r % Ci) * W;
               });
    cp_async_commit();
  };

  fetch(first, 0);
  stage_weights(kmat, ks, Co, K, cop);
  for (int i = first; i < last; ++i) {
    const int s = (i - first) & 1;
    if (i + 1 < last) {
      fetch(i + 1, s ^ 1);  // slot s ^ 1 was last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i's slab (and, at first, the weights) is in place
    build_x9(ring + s * slab, x9, TH, Ci, S, Wt);
    __syncthreads();
    contract_x9(x9, ks, yb, i * TH, TH, K, Co, cop, W, w0, Wt, relu != 0);
    __syncthreads();  // x9 and slot s are free again
  }
}

template <typename T>
int launch(const T* x, const float* kmat, T* y, int B, int H, int Ci, int Co, int W, int TH,
           int Wt, int G, int relu, int vec, cudaStream_t stream) {
  if (THREADS % Wt != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(Ci, Co, TH, Wt, sizeof(T));
  const int status = smem_opt_in(probe_halo_kernel<T>, bytes);
  if (status != 0) return status;
  const dim3 grid((W + Wt - 1) / Wt, (H / TH + G - 1) / G, B);
  probe_halo_kernel<T><<<grid, THREADS, bytes, stream>>>(x, kmat, y, H, Ci, Co, W, TH, Wt, G,
                                                         relu, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes of one block: the host picks Wt by it.
extern "C" size_t mm_probe_halo_smem_bytes(int Ci, int Co, int TH, int Wt, int elem) {
  return smem_bytes(Ci, Co, TH, Wt, elem);
}

extern "C" int mm_probe_halo_f32(const void* x, const void* kmat, void* y, int B, int H,
                                 int Ci, int Co, int W, int TH, int Wt, int G, int relu, int vec,
                                 void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(kmat),
                static_cast<float*>(y), B, H, Ci, Co, W, TH, Wt, G, relu, vec,
                static_cast<cudaStream_t>(stream));
}

extern "C" int mm_probe_halo_bf16(const void* x, const void* kmat, void* y, int B, int H,
                                  int Ci, int Co, int W, int TH, int Wt, int G, int relu,
                                  int vec, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(kmat),
                static_cast<__nv_bfloat16*>(y), B, H, Ci, Co, W, TH, Wt, G, relu, vec,
                static_cast<cudaStream_t>(stream));
}
