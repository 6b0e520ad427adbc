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
// What bounds it on this card: bytes, on the tensor cores (640^2, 16 -> 16,
// B = 16, bf16: 419 MB, 0.125 ms at 3.35 TB/s; the 15 G products need 0.03
// ms); on the f32 CUDA cores, operations and the shared-memory reads of the
// contraction (30.2 GFLOP, 0.45 ms at 67 TFLOP/s).
//
// float32 (probe_flat_kernel): one block takes one (b, TH-row tile, chunk of
// Lc lanes of the tile's TH * W). It stages, per input channel, the chunk
// plus the W lanes before and after it plus one lane on each side, with
// 16-byte cp.async copies; at the tile's first and last row those W lanes
// are the halo rows above and below the tile, and zeros beyond the image.
// The taps are read straight from that slab (no x9): lane f's (di, dj) tap is
// slab lane f + (di - 1) W + dj - 1, zero when dj = 0 and f % W == 0 or
// dj = 2 and f % W == W - 1, with f the global lane, as the iota mask at
// probe_pallas_conv4.py:44-46. Each thread owns one lane and 8 output
// channels. The host picks Lc from (Ci, Co, W) by mm_probe_flat_smem_bytes.
//
// bfloat16 (probe_flat_mma_bf16): the implicit GEMM of conv_probe_gemm.cuh,
// which P3 and P2's tap-dots share, reading and writing NCHW. On flat lanes
// the dj taps are shifts of one 2-byte lane, which no 16-byte ldmatrix row
// can take; but a (TH + 2)-row x Wt-column tile of NCHW differs from an NHCW
// tile only in its strides, so the block stages it by W-runs (coalesced
// along W) and transposes it once into a channels-innermost halo with a zero
// column on each side of the image: the dj shifts become whole-pixel moves,
// and the row-edge mask becomes the zero column. A block owns the probe's TH
// rows and walks them in sub-tiles of fewer rows through the two-stage
// cp.async ring, so that a sub-tile's halo fits twice on an SM. ndot = 1
// sums each chunk's nine taps in one fresh accumulator; ndot = 3 each di's
// three (K = 3 Ci), added in di order. The host picks the sub-tile's rows
// and Wt by mm_probe_flat_smem_bytes.
#include "conv_probe_gemm.cuh"

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

// The implicit GEMM of conv_probe_gemm.cuh on NCHW, GT = 9 (ndot 1) or 3
// (ndot 3) taps a fresh accumulator.
template <int NT, int WT, int NDOT>
__global__ void __launch_bounds__(THREADS, 2)
probe_flat_mma_bf16(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int H, int Ci, int Co, int W, int TH, int G,
                    int relu, int vec, int ring, int padded) {
  halo_gemm<NT, WT, NCHW, NDOT == 1 ? 9 : 3>(x, w, y, H, Ci, Co, W, TH, G, relu, vec, ring,
                                            padded);
}

}  // namespace

// Shared bytes of one block: float32 with chunks of `tile` lanes (rows
// unused); bfloat16 with sub-tiles of `rows` rows and `tile` columns and the
// ring's two slab slots (W unused; SIZE_MAX for a tile that is no whole
// number of m-tiles). The host picks the tile by it.
extern "C" size_t mm_probe_flat_smem_bytes(int Ci, int Co, int W, int rows, int tile, int elem) {
  return elem == 2 ? halo_smem_bytes(Ci, Co, rows, tile, true) : smem_bytes(Ci, Co, W, tile, elem);
}

extern "C" int mm_probe_flat_f32(const void* x, const void* kmat, void* y, int B, int Ci,
                                 int Co, int H, int W, int TH, int Lc, int ndot, int relu,
                                 int vec, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* kf = static_cast<const float*>(kmat);
  auto* yf = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ndot == 1) return launch_ndot<float, 1>(xf, kf, yf, B, Ci, Co, H, W, TH, Lc, relu, vec, st);
  if (ndot == 3) return launch_ndot<float, 3>(xf, kf, yf, B, Ci, Co, H, W, TH, Lc, relu, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (B, Ci, H, W) and y (B, Co, H, W) bf16; w bf16 packed by
// ops/kernels/conv2d.py::pack_weight_bf16 with chunks of 16 input channels.
// A block owns G sub-tiles of TH rows and Wt columns: the probe's row tile.
extern "C" int mm_probe_flat_mma_bf16(const void* x, const void* w, void* y, int B, int Ci,
                                      int Co, int H, int W, int TH, int Wt, int G, int ndot,
                                      int relu, int vec, void* stream) {
  if (TH < 1 || G < 1 || (ndot != 1 && ndot != 3)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_tile(Co, Wt, [&](auto nt, auto wt) {
    constexpr int NT = decltype(nt)::value, WT = decltype(wt)::value;
    return ndot == 1
               ? launch_halo_gemm<NT, WT>(probe_flat_mma_bf16<NT, WT, 1>, x, w, y, B, H, Ci, Co,
                                          W, TH, G, relu, vec, 1, 0, st)
               : launch_halo_gemm<NT, WT>(probe_flat_mma_bf16<NT, WT, 3>, x, w, y, B, H, Ci, Co,
                                          W, TH, G, relu, vec, 1, 0, st);
  });
}
