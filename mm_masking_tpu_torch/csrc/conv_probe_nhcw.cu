// Conv probes P1 and P2: a 3x3 SAME conv (no bias) in the NHCW layout
// (B, H, C, W), by an explicit im2col stack built from one staged halo slab.
//
// Replaces two Pallas TPU kernels:
//   * P1, benchmarks/probe_pallas_conv.py::conv3x3_nhcw_pallas (body _kernel,
//     pallas_call at :105): copy the (TH + 2)-row halo, wait, build the
//     im2col stack x9 (TH, 9 Ci, W), one (Co, 9 Ci) @ (9 Ci, W) contraction
//     per row, optional ReLU;
//   * P2, benchmarks/probe_pallas_conv2.py::run (body make(variant), at :103):
//     P1's body taken apart into five variants, a template parameter here:
//     full (P1's body), asm-only (build x9 and store its first Co rows
//     instead of contracting), dot-only (contract over scratch that was never
//     written), row2 (rows t and t + 1 in one pass that shares the weight
//     loads) and tap-dots (no x9: nine K = Ci sums straight from the slab).
// Both take x padded with one zero row above and below (B, H + 2, Ci, W).
//
// What bounds it on this card: at the probes' shapes (1..32 channels) a
// conv moves (Ci + Co) * 2 or 4 bytes per pixel and does 18 * Ci * Co
// operations, so the tensor cores would make it bound by bytes (640^2,
// 16 -> 16, B = 16, bf16: 419 MB, 0.125 ms at 3.35 TB/s). This kernel sums on
// the f32 CUDA cores, which bound it by operations (30.2 GFLOP, 0.45 ms at
// 67 TFLOP/s), and every multiply-add also reads shared memory.
//
// Design: one block takes one (b, row tile of TH rows, W tile of Wt
// columns). It stages the (TH + 2) x Ci x (Wt + 2) halo slab with 16-byte
// cp.async copies and waits for them: the counterpart of
// make_async_copy(...).start(); .wait() at probe_pallas_conv.py:49-52. Then
// it builds x9 in shared memory and contracts; each thread owns one (t, w)
// and 8 output channels in registers. The host picks Wt from (TH, Ci, Co,
// dtype) by mm_probe_nhcw_smem_bytes, so that the slab plus x9 fit in
// shared memory.
#include "conv_probe.cuh"

namespace {

using namespace probe;

enum Variant { FULL = 0, ASM_ONLY = 1, DOT_ONLY = 2, ROW2 = 3, TAP_DOTS = 4 };

size_t smem_bytes(int variant, int Ci, int Co, int TH, int Wt, int elem) {
  const int K = 9 * Ci;
  const int S = Wt + 2 * (16 / elem);
  size_t bytes = static_cast<size_t>(K) * round_up(Co, COB) * 4 +
                 static_cast<size_t>(TH + 2) * Ci * S * elem;
  if (variant != TAP_DOTS) bytes += static_cast<size_t>(TH) * K * Wt * elem;
  return bytes;
}

// xp (B, H + 2, Ci, W); kmat (Co, 9 Ci) f32; y (B, H, Co, W).
// grid = (ceil(W / Wt), H / TH, B).
template <typename T, int VARIANT>
__global__ void __launch_bounds__(THREADS)
probe_nhcw_kernel(const T* __restrict__ xp, const float* __restrict__ kmat, T* __restrict__ y,
                  int H, int Ci, int Co, int W, int TH, int Wt, int relu, int vec) {
  constexpr int V = vec_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 9 * Ci;
  const int cop = (Co + COB - 1) / COB * COB;
  const int S = Wt + 2 * V;
  float* ks = reinterpret_cast<float*>(smem);
  T* xt = reinterpret_cast<T*>(ks + K * cop);
  T* x9 = xt + static_cast<size_t>(TH + 2) * Ci * S;

  const int w0 = blockIdx.x * Wt;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const T* xb = xp + static_cast<size_t>(b) * (H + 2) * Ci * W;
  T* yb = y + static_cast<size_t>(b) * H * Co * W;

  // Rows h0 .. h0 + TH + 1 of the padded x: the tile and its halo.
  stage_rows(xt, (TH + 2) * Ci, S, w0, Wt, W, vec != 0, [&](int r) -> const T* {
    return xb + (static_cast<size_t>(h0 + r / Ci) * Ci + r % Ci) * W;
  });
  cp_async_commit();
  stage_weights(kmat, ks, Co, K, cop);
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (VARIANT == FULL || VARIANT == ASM_ONLY || VARIANT == ROW2) {
    build_x9(xt, x9, TH, Ci, S, Wt);
    __syncthreads();
  }

  if constexpr (VARIANT == FULL || VARIANT == DOT_ONLY) {
    contract_x9(x9, ks, yb, h0, TH, K, Co, cop, W, w0, Wt, relu != 0);
  } else if constexpr (VARIANT == ASM_ONLY) {
    // y[b, h0 + t, c, w] = x9[t, c, w] for c < Co (the host checks Co <= K),
    // with build_x9's thread layout.
    const int w = threadIdx.x % Wt;
    if (w0 + w < W) {
      for (int t = 0; t < TH; ++t) {
        for (int c = threadIdx.x / Wt; c < Co; c += blockDim.x / Wt) {
          yb[(static_cast<size_t>(h0 + t) * Co + c) * W + w0 + w] =
              x9[(static_cast<size_t>(t) * K + c) * Wt + w];
        }
      }
    }
  } else if constexpr (VARIANT == ROW2) {
    const int ncog = cop / COB;
    for (int it = threadIdx.x; it < (TH / 2) * ncog * Wt; it += blockDim.x) {
      const int w = it % Wt;
      const int t = 2 * ((it / Wt) % (TH / 2));
      const int co0 = (it / (Wt * (TH / 2))) * COB;
      float acc0[COB] = {};
      float acc1[COB] = {};
      const T* x0 = x9 + static_cast<size_t>(t) * K * Wt + w;
      const T* x1 = x0 + static_cast<size_t>(K) * Wt;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float* kc = ks + k * cop + co0;
        const float4 a = *reinterpret_cast<const float4*>(kc);
        const float4 c = *reinterpret_cast<const float4*>(kc + 4);
        const float wv[COB] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
        const float v0 = to_f(x0[static_cast<size_t>(k) * Wt]);
        const float v1 = to_f(x1[static_cast<size_t>(k) * Wt]);
#pragma unroll
        for (int j = 0; j < COB; ++j) {
          acc0[j] = fmaf(wv[j], v0, acc0[j]);
          acc1[j] = fmaf(wv[j], v1, acc1[j]);
        }
      }
      if (w0 + w < W) {
        T* yr = yb + static_cast<size_t>(h0 + t) * Co * W + w0 + w;
        store_cob(yr, acc0, co0, Co, W, relu != 0);
        store_cob(yr + static_cast<size_t>(Co) * W, acc1, co0, Co, W, relu != 0);
      }
    }
  } else {  // TAP_DOTS: the same k order, read from the slab
    const int ncog = cop / COB;
    for (int it = threadIdx.x; it < TH * ncog * Wt; it += blockDim.x) {
      const int w = it % Wt;
      const int t = (it / Wt) % TH;
      const int co0 = (it / (Wt * TH)) * COB;
      float acc[COB] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const T* xr = xt + static_cast<size_t>(t + tap / 3) * Ci * S + V + w + tap % 3 - 1;
        const float* kc = ks + tap * Ci * cop + co0;
#pragma unroll 4
        for (int ci = 0; ci < Ci; ++ci) {
          fma_cob(acc, kc + ci * cop, to_f(xr[static_cast<size_t>(ci) * S]));
        }
      }
      if (w0 + w < W) {
        store_cob(yb + static_cast<size_t>(h0 + t) * Co * W + w0 + w, acc, co0, Co, W,
                  relu != 0);
      }
    }
  }
}

template <typename T, int VARIANT>
int launch_variant(const T* xp, const float* kmat, T* y, int B, int H, int Ci, int Co, int W,
                   int TH, int Wt, int relu, int vec, cudaStream_t stream) {
  if (THREADS % Wt != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(VARIANT, Ci, Co, TH, Wt, sizeof(T));
  const int status = smem_opt_in(probe_nhcw_kernel<T, VARIANT>, bytes);
  if (status != 0) return status;
  const dim3 grid((W + Wt - 1) / Wt, H / TH, B);
  probe_nhcw_kernel<T, VARIANT><<<grid, THREADS, bytes, stream>>>(xp, kmat, y, H, Ci, Co, W,
                                                                  TH, Wt, relu, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* xp, const float* kmat, T* y, int B, int H, int Ci, int Co, int W, int TH,
           int Wt, int variant, int relu, int vec, cudaStream_t stream) {
  switch (variant) {
    case FULL:
      return launch_variant<T, FULL>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec, stream);
    case ASM_ONLY:
      return launch_variant<T, ASM_ONLY>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec,
                                         stream);
    case DOT_ONLY:
      return launch_variant<T, DOT_ONLY>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec,
                                         stream);
    case ROW2:
      return launch_variant<T, ROW2>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec, stream);
    case TAP_DOTS:
      return launch_variant<T, TAP_DOTS>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared bytes of one block: the host picks Wt by it.
extern "C" size_t mm_probe_nhcw_smem_bytes(int variant, int Ci, int Co, int TH, int Wt,
                                           int elem) {
  return smem_bytes(variant, Ci, Co, TH, Wt, elem);
}

extern "C" int mm_probe_nhcw_f32(const void* xp, const void* kmat, void* y, int B, int H,
                                 int Ci, int Co, int W, int TH, int Wt, int variant, int relu,
                                 int vec, void* stream) {
  return launch(static_cast<const float*>(xp), static_cast<const float*>(kmat),
                static_cast<float*>(y), B, H, Ci, Co, W, TH, Wt, variant, relu, vec,
                static_cast<cudaStream_t>(stream));
}

extern "C" int mm_probe_nhcw_bf16(const void* xp, const void* kmat, void* y, int B, int H,
                                  int Ci, int Co, int W, int TH, int Wt, int variant, int relu,
                                  int vec, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(xp), static_cast<const float*>(kmat),
                static_cast<__nv_bfloat16*>(y), B, H, Ci, Co, W, TH, Wt, variant, relu, vec,
                static_cast<cudaStream_t>(stream));
}
