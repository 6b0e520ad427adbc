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
// What bounds it on this card: bytes. At 640^2, 16 -> 16, B = 16 in bf16 the
// data needs 0.125 ms; the 15 G products need 0.03 ms of the bf16 tensor
// cores but 0.45 ms of the float32 CUDA cores.
//
// Design, common to both types: the Hopper counterpart of that grid
// pipeline. One block walks G consecutive row tiles of one (b, W tile of Wt
// columns) through a two-stage cp.async ring: it commits the copy of tile
// i + 1's (TH + 2)-row halo slab (NHCW rows, coalesced along W), waits for
// tile i's (cp.async.wait_group 1), and works on tile i while the next copy
// is in flight. The padding rows existed only for the BlockSpecs: this
// kernel reads the unpadded x and writes zeros for the rows above and below
// the image.
//
// float32 (probe_halo_kernel): a contraction on the CUDA cores over an
// im2col stack of the tile in shared memory (conv_probe.cuh).
//
// bfloat16 (probe_halo_mma_bf16): the implicit GEMM on mma.sync.m16n8k16
// of conv_probe_gemm.cuh, which P2's tap-dots and P4 share: each tile's slab
// transposed once into a channels-innermost halo, no im2col stack, each
// chunk's nine k16 steps into a fresh accumulator. With ring = 0 a block
// copies each tile's slab only when its turn comes: the variant without the
// prefetch.
#include "conv_probe_gemm.cuh"

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

int launch_f32(const float* x, const float* kmat, float* y, int B, int H, int Ci, int Co,
               int W, int TH, int Wt, int G, int relu, int vec, cudaStream_t stream) {
  if (THREADS % Wt != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(Ci, Co, TH, Wt, sizeof(float));
  const int status = smem_opt_in(probe_halo_kernel<float>, bytes);
  if (status != 0) return status;
  const dim3 grid((W + Wt - 1) / Wt, (H / TH + G - 1) / G, B);
  probe_halo_kernel<float><<<grid, THREADS, bytes, stream>>>(x, kmat, y, H, Ci, Co, W, TH, Wt,
                                                             G, relu, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bfloat16: tensor cores

// The implicit GEMM of conv_probe_gemm.cuh on NHCW, each chunk's nine taps
// into one fresh accumulator.
template <int NT, int WT>
__global__ void __launch_bounds__(THREADS, 2)
probe_halo_mma_bf16(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int H, int Ci, int Co, int W, int TH, int G,
                    int relu, int vec, int ring, int padded) {
  halo_gemm<NT, WT, NHCW, 9>(x, w, y, H, Ci, Co, W, TH, G, relu, vec, ring, padded);
}

}  // namespace

// Shared bytes of one block (float32: elem 4; bfloat16: elem 2, with the
// ring's two slab slots, SIZE_MAX for a Wt that is no multiple of 16): the
// host picks Wt by it.
extern "C" size_t mm_probe_halo_smem_bytes(int Ci, int Co, int TH, int Wt, int elem) {
  return elem == 2 ? halo_smem_bytes(Ci, Co, TH, Wt, true) : smem_bytes(Ci, Co, TH, Wt, elem);
}

extern "C" int mm_probe_halo_f32(const void* x, const void* kmat, void* y, int B, int H,
                                 int Ci, int Co, int W, int TH, int Wt, int G, int relu, int vec,
                                 void* stream) {
  return launch_f32(static_cast<const float*>(x), static_cast<const float*>(kmat),
                    static_cast<float*>(y), B, H, Ci, Co, W, TH, Wt, G, relu, vec,
                    static_cast<cudaStream_t>(stream));
}

// x, y bf16 NHCW; w bf16 packed by ops/kernels/conv2d.py::pack_weight_bf16
// with chunks of 16 input channels; ring 0 copies each tile's slab only when
// its turn comes.
extern "C" int mm_probe_halo_bf16(const void* x, const void* w, void* y, int B, int H, int Ci,
                                  int Co, int W, int TH, int Wt, int G, int relu, int vec,
                                  int ring, void* stream) {
  if (TH < 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_tile(Co, Wt, [&](auto nt, auto wt) {
    constexpr int NT = decltype(nt)::value, WT = decltype(wt)::value;
    return launch_halo_gemm<NT, WT>(probe_halo_mma_bf16<NT, WT>, x, w, y, B, H, Ci, Co, W, TH,
                                    G, relu, vec, ring, 0, static_cast<cudaStream_t>(stream));
  });
}
