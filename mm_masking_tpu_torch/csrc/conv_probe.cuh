// Shared pieces of the conv-probe kernels P1-P4 (conv_probe_nhcw.cu,
// conv_probe_halo.cu, conv_probe_flat.cu): type conversion, 16-byte cp.async
// copies into shared memory, the staging of one block's input rows and of
// the weight matrix, and the dynamic shared-memory opt-in.
//
// Every probe computes a 3x3 SAME convolution without bias as one
// contraction over K = 9 * Ci per output, with the weight matrix
// kmat (Co, 9 * Ci) f32 indexed k = (di * 3 + dj) * Ci + ci, the order of
// benchmarks/probe_pallas_conv.py:102. The float32 kernels sum on the CUDA
// cores in that k order. The bfloat16 kernels, every probe's on the
// tensor cores (conv_probe_nhcw.cu, and the implicit GEMM of
// conv_probe_gemm.cuh that P3, P2's tap-dots and P4 share), take the copies,
// the ldmatrix and mma.sync wrappers and the opt-in only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "smem_opt_in.cuh"

namespace probe {

constexpr int THREADS = 256;        // threads per block, every probe kernel
constexpr int COB = 8;              // output channels per thread
constexpr int SMEM_LIMIT = 232448;  // shared bytes a block may opt into on the H100

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements in one 16-byte copy; a staged row keeps this many elements of
// room on each side so that its interior starts 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(T)); }

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ks[k * cop + co] = kmat[co, k] for co < Co, 0 up to cop (a multiple of COB);
// kmat is read in its own order, so that the loads coalesce.
__device__ inline void stage_weights(const float* __restrict__ kmat, float* ks, int Co,
                                     int K, int cop) {
  for (int i = threadIdx.x; i < K * cop; i += blockDim.x) {
    const int co = i / K;
    const int k = i - co * K;
    ks[k * cop + co] = co < Co ? kmat[i] : 0.f;
  }
}

// Stage `rows` row segments into shared memory, row r at dst + r * S:
// dst[r * S + V + (g - g0)] = src(r)[g] for g in [g0 - 1, g0 + n], where
// src(r) is the row's first element, or null for a row that lies outside
// the image; anything outside [0, len) of a row is 0 (SAME padding).
// With vec, the interior [g0, g0 + n) goes in 16-byte cp.async copies (the
// caller then guarantees that g0, n, len and each row's address are
// multiples of V elements, so a copy lies wholly inside or outside [0, len));
// the caller commits and waits. The two edge elements, and every element
// without vec, are plain loads.
template <typename T, typename RowFn>
__device__ inline void stage_rows(T* dst, int rows, int S, int g0, int n, int len, bool vec,
                                  RowFn src) {
  constexpr int V = vec_elems<T>();
  const T zero = from_f<T>(0.f);
  if (vec) {
    const int nv = n / V;
    for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
      const int r = i / nv;
      const int g = g0 + (i % nv) * V;
      const T* row = src(r);
      T* d = dst + static_cast<size_t>(r) * S + V + (g - g0);
      if (row != nullptr && g >= 0 && g < len) {
        cp_async16(d, row + g);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = threadIdx.x; i < rows * 2; i += blockDim.x) {
      const int r = i / 2;
      const int j = (i % 2) ? V + n : V - 1;
      const int g = g0 + j - V;
      const T* row = src(r);
      dst[static_cast<size_t>(r) * S + j] = (row != nullptr && g >= 0 && g < len) ? row[g] : zero;
    }
  } else {
    const int m = n + 2;
    for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
      const int r = i / m;
      const int j = V - 1 + i % m;
      const int g = g0 + j - V;
      const T* row = src(r);
      dst[static_cast<size_t>(r) * S + j] = (row != nullptr && g >= 0 && g < len) ? row[g] : zero;
    }
  }
}

// The im2col stack of a row tile: x9[(t * K + k) * Wt + w] =
// xt[((t + di) * Ci + ci) * S + V + w + dj - 1], k = (di * 3 + dj) * Ci + ci,
// K = 9 * Ci; xt holds TH + 2 staged rows of Ci channels, stride S. Each
// thread keeps one column w and a set of channels, and walks the (t, tap)
// tiles with no index division; the nine taps of a row are independent
// copies, unrolled so that their loads overlap. Wt divides blockDim.x.
template <typename T>
__device__ inline void build_x9(const T* xt, T* x9, int TH, int Ci, int S, int Wt) {
  constexpr int V = vec_elems<T>();
  const int w = threadIdx.x % Wt;
  const int c0 = threadIdx.x / Wt;
  const int cstep = blockDim.x / Wt;
  for (int t = 0; t < TH; ++t) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* src = xt + static_cast<size_t>((t + tap / 3) * Ci) * S + V + w + tap % 3 - 1;
      T* dst = x9 + static_cast<size_t>((t * 9 + tap) * Ci) * Wt + w;
      for (int ci = c0; ci < Ci; ci += cstep) dst[ci * Wt] = src[ci * S];
    }
  }
}

// Store one thread's COB output channels at one NHCW position.
template <typename T>
__device__ __forceinline__ void store_cob(T* yrow, const float* acc, int co0, int Co, int W,
                                          bool relu) {
#pragma unroll
  for (int c = 0; c < COB; ++c) {
    if (co0 + c < Co) {
      yrow[static_cast<size_t>(co0 + c) * W] = from_f<T>(relu ? fmaxf(acc[c], 0.f) : acc[c]);
    }
  }
}

// acc[c] += ks[k * cop + c] * xv, the weights read as two broadcast float4.
__device__ __forceinline__ void fma_cob(float* acc, const float* kc, float xv) {
  const float4 a = *reinterpret_cast<const float4*>(kc);
  const float4 b = *reinterpret_cast<const float4*>(kc + 4);
  acc[0] = fmaf(a.x, xv, acc[0]);
  acc[1] = fmaf(a.y, xv, acc[1]);
  acc[2] = fmaf(a.z, xv, acc[2]);
  acc[3] = fmaf(a.w, xv, acc[3]);
  acc[4] = fmaf(b.x, xv, acc[4]);
  acc[5] = fmaf(b.y, xv, acc[5]);
  acc[6] = fmaf(b.z, xv, acc[6]);
  acc[7] = fmaf(b.w, xv, acc[7]);
}

// The TH output rows of an NHCW tile from its im2col stack, one contraction
// per row: y[b, h0 + t, co, w0 + w] = sum_k kmat[co, k] x9[t, k, w]. yb is
// y + b * H * Co * W. Each thread owns one (t, w) and COB channels; a warp
// runs along w, so it reads x9 without bank conflicts and the weights as a
// broadcast.
template <typename T>
__device__ inline void contract_x9(const T* x9, const float* ks, T* yb, int h0, int TH, int K,
                                   int Co, int cop, int W, int w0, int Wt, bool relu) {
  const int ncog = cop / COB;
  for (int it = threadIdx.x; it < TH * ncog * Wt; it += blockDim.x) {
    const int w = it % Wt;
    const int t = (it / Wt) % TH;
    const int co0 = (it / (Wt * TH)) * COB;
    float acc[COB] = {};
    const T* xc = x9 + static_cast<size_t>(t) * K * Wt + w;
    const float* kc = ks + co0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) fma_cob(acc, kc + k * cop, to_f(xc[static_cast<size_t>(k) * Wt]));
    if (w0 + w < W) {
      store_cob(yb + static_cast<size_t>(h0 + t) * Co * W + w0 + w, acc, co0, Co, W, relu);
    }
  }
}

// ------------------------------------------------- bfloat16 tensor cores

// n-tiles of 8 output channels a block takes: up to 8 (64 channels).
inline int n_tiles(int Co) { return Co <= 8 ? 1 : Co <= 16 ? 2 : Co <= 32 ? 4 : 8; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Opt the kernel into `bytes` of dynamic shared memory, once per device; an
// error code for more than a block may have, so that nothing is launched
// that would be refused.
template <typename Kernel>
int smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(SMEM_LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  return mm::opt_in_smem(reinterpret_cast<const void*>(kernel), static_cast<int>(bytes));
}

}  // namespace probe
