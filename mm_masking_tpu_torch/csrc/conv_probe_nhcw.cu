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
// operations, so the tensor cores make it bound by bytes (640^2, 16 -> 16,
// B = 16, bf16: 419 MB, 0.125 ms at 3.35 TB/s); on the float32 CUDA cores it
// is bound by operations (30.2 GFLOP, 0.45 ms at 67 TFLOP/s), and there every
// multiply-add also reads shared memory.
//
// float32 (probe_nhcw_kernel), every variant: one block takes one (b, row
// tile of TH rows, W tile of Wt columns). It stages the (TH + 2) x Ci x
// (Wt + 2) halo slab with 16-byte cp.async copies and waits for them: the
// counterpart of make_async_copy(...).start(); .wait() at
// probe_pallas_conv.py:49-52. Then it builds x9 in shared memory and
// contracts on the CUDA cores in f32; each thread owns one (t, w) and 8
// output channels in registers.
//
// bfloat16, on the tensor cores (mma.sync.m16n8k16, float32 sums); every
// variant takes a bfloat16 kmat only.
// * full, P1's body (probe_nhcw_mma_bf16), asm-only, dot-only and row2
//   (probe_nhcw_asm_bf16, _dot_bf16, _row2_bf16; stack_gemm): the same
//   staging (P1's x is read as it is, zero rows above and below the image;
//   P2's comes padded), then an explicit im2col stack a pass at a time and
//   one contraction per pass. The stack holds a row's Wt pixels, each
//   pixel's K = 9 Ci values innermost in the probe's k order
//   (di * 3 + dj) * Ci + ci, K padded as a whole to a multiple of 16 (Ci = 1
//   takes one k16 step, where a stack of taps would take nine) and pixels an
//   odd number of 16-byte units apart, so that the 8 rows of every ldmatrix
//   fall in 8 different bank groups. Each 16-byte unit of the stack is
//   gathered from the slab by a thread of a warp that runs along W, so that
//   the gathers read the slab without bank conflicts: with Ci a multiple of 8
//   a unit is 8 channels of one tap, S apart from one offset; else 8 values
//   from a table of offsets made once a block. Two stack buffers: the next
//   pass is built while this one is contracted. M is 16 pixels along W of
//   the row, N the output channels (up to 64 a block), K in k16 steps; each
//   group of 9 steps starts a fresh accumulator, added to the running sums in
//   float32 registers (the tensor cores' sums round toward zero). The
//   weights arrive in bf16 as kmat (Co, 9 Ci) padded to (Co rounded up to 8,
//   K rounded up to 16) and stay in shared memory; the outputs go through
//   shared memory and leave as 16-byte rows of 8 pixels along W. A pass is
//   one row, or for row2 two (rows t and t + 1: each k-step's weight
//   fragments are loaded once and held in registers for both rows' m-tiles,
//   and a buffer holds both rows). asm-only builds the stack as full does
//   and writes each pixel's first Co k-values through the output tile, bit
//   for bit; dot-only stages the slab, builds nothing and contracts the
//   stack buffers as they are (undefined values, as the probe's).
// * tap-dots (probe_tapdots_mma_bf16): no stack. The implicit GEMM of
//   conv_probe_gemm.cuh that P3 and P4 share, on the padded x, one row tile a
//   block without the ring: the slab transposed once into a channels-
//   innermost halo, so that a tap's shift along W moves whole 16-byte rows;
//   each tap's k-steps start a fresh accumulator, added in (di, dj) order,
//   the probe's nine K = Ci sums.
// The host picks Wt from (variant, TH, Ci, Co, dtype) by
// mm_probe_nhcw_smem_bytes.
#include "conv_probe_gemm.cuh"

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

// ------------------------------------------------- bfloat16: tensor cores

// Units of 16 bytes (8 values of k) a stack pixel or weight row spans: K
// rounded up to 16, made odd.
__host__ __device__ inline int k_units(int Ci) { return (9 * Ci + 15) / 16 * 2 + 1; }

// One block's shared memory, in bytes, with stack buffers of R rows each.
// All offsets are multiples of 16 bytes.
struct SmemMma {
  size_t weights, koff, slab, stack, out;
  __host__ __device__ SmemMma(int Ci, int NT, int TH, int Wt, int R) {
    const int ku = k_units(Ci), kp = (ku - 1) * 8;
    weights = static_cast<size_t>(NT) * 8 * ku * 16;
    koff = static_cast<size_t>(kp) * 4;
    slab = static_cast<size_t>(TH + 2) * Ci * (Wt + 2 * vec_elems<__nv_bfloat16>()) * 2;
    stack = 2 * static_cast<size_t>(R) * Wt * ku * 16;
    out = static_cast<size_t>(TH) * NT * 8 * (Wt + 8) * 2;
  }
  __host__ __device__ size_t total() const { return weights + koff + slab + stack + out; }
};

// The bf16 kernels' bytes: the stack's (full, asm-only, dot-only; row2 with
// buffers of two rows) or the halo GEMM's without the ring (tap-dots);
// SIZE_MAX for a Wt they do not take.
size_t smem_bytes_mma(int variant, int Ci, int Co, int TH, int Wt) {
  if (Wt != 16 && Wt != 32 && Wt != 64 && Wt != 128) return SIZE_MAX;  // the kernels' widths
  if (variant == TAP_DOTS) return halo_smem_bytes(Ci, Co, TH, Wt, false);
  return SmemMma(Ci, n_tiles(Co), TH, Wt, variant == ROW2 ? 2 : 1).total();
}

// P1's body and P2's full, asm-only, dot-only and row2 on the tensor cores.
// x (B, H, Ci, W), or with padded xp (B, H + 2, Ci, W) with a zero row above
// and below, and y (B, H, Co, W) bf16; w bf16 (cop, kp): kmat zero-padded to
// cop = Co rounded up to 8 and kp = 9 Ci rounded up to 16. A block takes NT
// n-tiles of output channels, WT columns and TH rows; grid = (ceil(W / WT),
// H / TH, B * co_groups). A pass takes R = 1 row (R = 2 for row2: rows t and
// t + 1, each k-step's B fragments loaded once for both rows' m-tiles);
// asm-only builds the stack and stores each pixel's first Co k-values
// instead of contracting; dot-only builds nothing and contracts the stack
// buffers as they are.
template <int NT, int WT, int VARIANT>
__device__ __forceinline__ void stack_gemm(const __nv_bfloat16* __restrict__ x,
                                           const uint16_t* __restrict__ w,
                                           __nv_bfloat16* __restrict__ y, int H, int Ci, int Co,
                                           int W, int TH, int padded, int relu, int vec) {
  constexpr int V = vec_elems<__nv_bfloat16>();
  constexpr int R = VARIANT == ROW2 ? 2 : 1;  // rows a pass contracts
  constexpr bool BUILD = VARIANT != DOT_ONLY, CONTRACT = VARIANT != ASM_ONLY;
  constexpr int CO_T = 8 * NT;
  constexpr int MT = WT / 16, S = WT + 2 * V, SO = WT + 8, NV = S / V;
  constexpr int NTB = NT > 1 ? 2 : 1;  // n-tiles of a warp's item, sharing its A fragment
  constexpr int NB = NT / NTB;
  constexpr int GROUP = 9;                      // k16 steps into one fresh accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;        // C fragment row group, column pair
  const int ku = k_units(Ci), kp = (ku - 1) * 8, ksteps = kp / 16;
  const int cop = (Co + 7) / 8 * 8;
  const int co_groups = (Co + CO_T - 1) / CO_T;
  const int b = blockIdx.z / co_groups, co0 = blockIdx.z % co_groups * CO_T;
  const int w0 = blockIdx.x * WT, h0 = blockIdx.y * TH;

  const SmemMma lay(Ci, NT, TH, WT, R);
  const int row_bytes = WT * ku * 16;  // one stack row; a buffer holds R
  unsigned char* wsm = smem;
  int* koff = reinterpret_cast<int*>(smem + lay.weights);
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + lay.weights + lay.koff);
  unsigned char* stack = smem + lay.weights + lay.koff + lay.slab;
  uint16_t* out = reinterpret_cast<uint16_t*>(stack + lay.stack);
  const int hx = padded ? H + 2 : H;  // rows of x
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * hx * Ci * W;

  // Rows h0 - 1 .. h0 + TH of the image (of xp: h0 .. h0 + TH + 1), columns
  // w0 - V .. w0 + WT + V - 1, into the slab, row (halo row, channel) S
  // elements apart; zeros outside the image. With vec (W a multiple of 8, x
  // 16-byte aligned) every 16-byte vector lies wholly inside or outside the
  // row and goes by cp.async.
  const int rows = (TH + 2) * Ci;
  const int g0 = (h0 - (padded ? 0 : 1)) * Ci;  // x's (row, channel) of slab row 0
  auto src = [&](int r) -> const __nv_bfloat16* {  // slab row r's source row, or null
    return g0 + r < 0 || g0 + r >= hx * Ci ? nullptr : xb + static_cast<size_t>(g0 + r) * W;
  };
  if (vec) {
    for (int q = threadIdx.x; q < rows * NV; q += THREADS) {
      const int r = q / NV, gw = w0 - V + q % NV * V;
      __nv_bfloat16* d = slab + r * S + q % NV * V;
      const __nv_bfloat16* row = src(r);
      if (row != nullptr && gw >= 0 && gw < W) {
        cp_async16(d, row + gw);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int q = threadIdx.x; q < rows * (WT + 2); q += THREADS) {
      const int r = q / (WT + 2), gw = w0 - 1 + q % (WT + 2);
      const __nv_bfloat16* row = src(r);
      slab[r * S + V - 1 + q % (WT + 2)] =
          row != nullptr && gw >= 0 && gw < W ? row[gw] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  // The block's weight rows, ku units apart (the last unit spare), and where
  // the stack's values are in the slab: with Ci a multiple of 8 a unit's 8
  // values are 8 channels of one tap, S apart from koff[u] = (di Ci + 8 (u %
  // cu)) S + V + dj - 1 (tap u / cu, cu = Ci / 8); else each k's own,
  // koff[k] = (di Ci + ci) S + V + dj - 1; -1 past K.
  for (int q = threadIdx.x; q < CO_T * (ku - 1); q += THREADS) {
    const int co = q / (ku - 1), u = q % (ku - 1);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (co0 + co < cop)
      v = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(co0 + co) * kp + 8 * u));
    *reinterpret_cast<uint4*>(wsm + (co * ku + u) * 16) = v;
  }
  const bool by_unit = Ci % 8 == 0;
  for (int k = threadIdx.x; k < kp; k += THREADS) {
    const int tap = by_unit ? k / (Ci / 8) : k / Ci, ci = by_unit ? k % (Ci / 8) * 8 : k % Ci;
    koff[k] = tap < 9 ? (tap / 3 * Ci + ci) * S + V + tap % 3 - 1 : -1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // Rows t .. t + R - 1's stack into buffer s: row t + rr's pixel p, unit u
  // holds k = 8 u .. 8 u + 7. A warp that contracts a pass (the first CW)
  // builds half as many of each row's units as one that does not, so that
  // they reach the pass's barrier at about the same time; units are dealt
  // out 32 at a time.
  constexpr int WARPS = THREADS / 32, CW = MT * NB < WARPS ? MT * NB : WARPS;
  const int units = WT * (ku - 1);  // of one row
  const int split = units * (WARPS - CW) * 2 / ((WARPS - CW) * 2 + CW) / 32 * 32;
  const int q0 = warp < CW ? split + warp * 32 + lane : (warp - CW) * 32 + lane;
  const int q1 = warp < CW ? units : split;
  const int qs = 32 * (warp < CW ? CW : WARPS - CW);
  auto build = [&](int t, int s) {
    unsigned char* buf = stack + s * (lay.stack / 2);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      for (int q = q0; q < q1; q += qs) {
        const int p = q % WT, u = q / WT;
        const __nv_bfloat16* row = slab + (t + rr) * Ci * S;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (by_unit) {
          const int o = koff[u];
          if (o >= 0) {
            const __nv_bfloat16* c = row + o + p;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = __bfloat16_as_ushort(c[2 * j * S]) |
                     static_cast<uint32_t>(__bfloat16_as_ushort(c[(2 * j + 1) * S])) << 16;
          }
        } else {
          const int4 o0 = *reinterpret_cast<const int4*>(koff + 8 * u);
          const int4 o1 = *reinterpret_cast<const int4*>(koff + 8 * u + 4);
          const int o[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t lo = o[2 * j] >= 0 ? __bfloat16_as_ushort(row[o[2 * j] + p]) : 0u;
            const uint32_t hi =
                o[2 * j + 1] >= 0 ? __bfloat16_as_ushort(row[o[2 * j + 1] + p]) : 0u;
            v[j] = lo | hi << 16;
          }
        }
        *reinterpret_cast<uint4*>(buf + rr * row_bytes + (p * ku + u) * 16) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  const uint32_t stack_s = static_cast<uint32_t>(__cvta_generic_to_shared(stack));
  const uint32_t w_s = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));
  // ldmatrix rows. A: lanes 8q .. 8q + 7 address matrix q: pixels 8 (q % 2)
  // .. of the m-tile, k half q / 2 of the step. B: matrix q of an x4 is
  // n-tile q / 2 of the n-block, k half q % 2 (an x2: the n-tile's halves).
  const int a_pix = lane / 8 % 2 * 8 + lane % 8, a_half = lane / 16;
  const int b_co = (NTB > 1 ? lane / 16 : 0) * 8 + lane % 8, b_half = lane / 8 % 2;

  if constexpr (BUILD) build(0, 0);
  __syncthreads();
  for (int t = 0; t < TH; t += R) {
    const int s = t / R & 1;
    if constexpr (BUILD) {
      if (t + R < TH) build(t + R, s ^ 1);
    }
    if constexpr (CONTRACT) {
      const uint32_t a_base = stack_s + s * static_cast<uint32_t>(lay.stack / 2);
      for (int item = warp; item < MT * NB; item += WARPS) {
        const int mt = item % MT, nb = item / MT;
        float acc[R][NTB][4] = {};
        for (int k0 = 0; k0 < ksteps; k0 += GROUP) {
          float d[R][NTB][4] = {};  // this group's fresh accumulator
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            const int ks = k0 + i;
            if (ks >= ksteps) break;
            uint32_t bf[NTB][2];
            const uint32_t b_addr = w_s + ((nb * NTB * 8 + b_co) * ku + 2 * ks + b_half) * 16;
            if constexpr (NTB == 1) {
              ldsm_x2(bf[0][0], bf[0][1], b_addr);
            } else {
              uint32_t r[4];
              ldsm_x4(r, b_addr);
              bf[0][0] = r[0];
              bf[0][1] = r[1];
              bf[1][0] = r[2];
              bf[1][1] = r[3];
            }
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
              uint32_t a[4];
              ldsm_x4(a, a_base + rr * row_bytes + ((mt * 16 + a_pix) * ku + 2 * ks + a_half) * 16);
#pragma unroll
              for (int n = 0; n < NTB; ++n) mma_bf16(d[rr][n], a, bf[n][0], bf[n][1]);
            }
          }
#pragma unroll
          for (int rr = 0; rr < R; ++rr)
#pragma unroll
            for (int n = 0; n < NTB; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[rr][n][e] += d[rr][n][e];
        }
        // C fragment element e: pixel g + 8 (e / 2) of the m-tile, output
        // channel 2 t4 + e % 2 of the n-tile.
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int n = 0; n < NTB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = relu ? fmaxf(acc[rr][n][e], 0.f) : acc[rr][n][e];
              out[((t + rr) * CO_T + (nb * NTB + n) * 8 + 2 * t4 + e % 2) * SO + mt * 16 + g +
                  8 * (e / 2)] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
            }
      }
    } else if (warp < CW) {  // asm-only: pixel p's k-values co0 .. into the output tile
      const unsigned char* buf = stack + s * (lay.stack / 2);
      for (int q = warp * 32 + lane; q < CO_T * WT; q += CW * 32) {
        const int p = q % WT, co = q / WT, k = co0 + co;
        out[(t * CO_T + co) * SO + p] =
            k < Co ? *reinterpret_cast<const uint16_t*>(buf + (p * ku + k / 8) * 16 + k % 8 * 2)
                   : 0;
      }
    }
    __syncthreads();  // the next pass's stack is built; buffer s is free
  }
  // The output tile leaves in 8-pixel rows along W.
  for (int q = threadIdx.x; q < TH * CO_T * (WT / 8); q += THREADS) {
    const int sg = q % (WT / 8), co = q / (WT / 8) % CO_T, row = q / (WT / 8 * CO_T);
    const int gw = w0 + 8 * sg;
    if (co0 + co >= Co || gw >= W) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(out + (row * CO_T + co) * SO + 8 * sg);
    uint16_t* dst = reinterpret_cast<uint16_t*>(y) +
                    ((static_cast<size_t>(b) * H + h0 + row) * Co + co0 + co) * W + gw;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (gw + k < W) dst[k] = static_cast<uint16_t>(vw[k / 2] >> (16 * (k % 2)));
    }
  }
}

// One kernel name a variant, so that the SASS of each can be told apart:
// full (P1's body), asm-only (contracts nothing), dot-only and row2.
#define STACK_KERNEL(NAME, VARIANT_)                                                        \
  template <int NT, int WT>                                                                 \
  __global__ void __launch_bounds__(THREADS, 2)                                             \
      NAME(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,             \
           __nv_bfloat16* __restrict__ y, int H, int Ci, int Co, int W, int TH, int padded, \
           int relu, int vec) {                                                             \
    stack_gemm<NT, WT, VARIANT_>(x, w, y, H, Ci, Co, W, TH, padded, relu, vec);             \
  }
STACK_KERNEL(probe_nhcw_mma_bf16, FULL)
STACK_KERNEL(probe_nhcw_asm_bf16, ASM_ONLY)
STACK_KERNEL(probe_nhcw_dot_bf16, DOT_ONLY)
STACK_KERNEL(probe_nhcw_row2_bf16, ROW2)
#undef STACK_KERNEL

// tap-dots: the halo GEMM of conv_probe_gemm.cuh on the padded x, each tap's
// k-steps into a fresh accumulator, added in (di, dj) order.
template <int NT, int WT>
__global__ void __launch_bounds__(THREADS, 2)
probe_tapdots_mma_bf16(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, int H, int Ci, int Co, int W, int TH,
                       int G, int relu, int vec, int ring, int padded) {
  halo_gemm<NT, WT, NHCW, 1>(x, w, y, H, Ci, Co, W, TH, G, relu, vec, ring, padded);
}

template <int NT, int WT, typename Kernel>
int launch_stack(Kernel kernel, int R, const void* x, const void* w, void* y, int B, int H,
                 int Ci, int Co, int W, int TH, int padded, int relu, int vec,
                 cudaStream_t stream) {
  const size_t bytes = SmemMma(Ci, NT, TH, WT, R).total();
  const int status = smem_opt_in(kernel, bytes);
  if (status != 0) return status;
  const dim3 grid((W + WT - 1) / WT, H / TH, B * ((Co + 8 * NT - 1) / (8 * NT)));
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                            static_cast<const uint16_t*>(w),
                                            static_cast<__nv_bfloat16*>(y), H, Ci, Co, W, TH,
                                            padded, relu, vec);
  return static_cast<int>(cudaGetLastError());
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

int launch_f32(const float* xp, const float* kmat, float* y, int B, int H, int Ci, int Co,
               int W, int TH, int Wt, int variant, int relu, int vec, cudaStream_t stream) {
  switch (variant) {
    case FULL:
      return launch_variant<float, FULL>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec, stream);
    case ASM_ONLY:
      return launch_variant<float, ASM_ONLY>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec,
                                             stream);
    case DOT_ONLY:
      return launch_variant<float, DOT_ONLY>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec,
                                             stream);
    case ROW2:
      return launch_variant<float, ROW2>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec, stream);
    case TAP_DOTS:
      return launch_variant<float, TAP_DOTS>(xp, kmat, y, B, H, Ci, Co, W, TH, Wt, relu, vec,
                                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared bytes of one block (bfloat16: the tensor-core kernel's of the
// variant, SIZE_MAX for a Wt it does not take): the host picks Wt by it.
extern "C" size_t mm_probe_nhcw_smem_bytes(int variant, int Ci, int Co, int TH, int Wt,
                                           int elem) {
  return elem == 2 ? smem_bytes_mma(variant, Ci, Co, TH, Wt)
                   : smem_bytes(variant, Ci, Co, TH, Wt, elem);
}

extern "C" int mm_probe_nhcw_f32(const void* xp, const void* kmat, void* y, int B, int H,
                                 int Ci, int Co, int W, int TH, int Wt, int variant, int relu,
                                 int vec, void* stream) {
  return launch_f32(static_cast<const float*>(xp), static_cast<const float*>(kmat),
                    static_cast<float*>(y), B, H, Ci, Co, W, TH, Wt, variant, relu, vec,
                    static_cast<cudaStream_t>(stream));
}

// P1's body and P2's variants in bfloat16 on the tensor cores: x (B, H, Ci,
// W), or with padded xp (B, H + 2, Ci, W) as P2 takes it. w: for full,
// asm-only, dot-only and row2 kmat zero-padded to (Co rounded up to 8, 9 Ci
// rounded up to 16) (conv_probes.pack_kmat_bf16); for tap-dots the chunks of
// 16 input channels of ops/kernels/conv2d.py::pack_weight_bf16.
extern "C" int mm_probe_nhcw_mma_bf16(const void* x, const void* w, void* y, int B, int H,
                                      int Ci, int Co, int W, int TH, int Wt, int variant,
                                      int padded, int relu, int vec, void* stream) {
  if (TH < 1 || (variant == ROW2 && TH % 2 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_tile(Co, Wt, [&](auto nt, auto wt) {
    constexpr int NT = decltype(nt)::value, WT = decltype(wt)::value;
    switch (variant) {
      case FULL:
        return launch_stack<NT, WT>(probe_nhcw_mma_bf16<NT, WT>, 1, x, w, y, B, H, Ci, Co, W,
                                    TH, padded, relu, vec, st);
      case ASM_ONLY:
        return launch_stack<NT, WT>(probe_nhcw_asm_bf16<NT, WT>, 1, x, w, y, B, H, Ci, Co, W,
                                    TH, padded, relu, vec, st);
      case DOT_ONLY:
        return launch_stack<NT, WT>(probe_nhcw_dot_bf16<NT, WT>, 1, x, w, y, B, H, Ci, Co, W,
                                    TH, padded, relu, vec, st);
      case ROW2:
        return launch_stack<NT, WT>(probe_nhcw_row2_bf16<NT, WT>, 2, x, w, y, B, H, Ci, Co, W,
                                    TH, padded, relu, vec, st);
      case TAP_DOTS:  // one row tile a block, no ring
        return launch_halo_gemm<NT, WT>(probe_tapdots_mma_bf16<NT, WT>, x, w, y, B, H, Ci, Co,
                                        W, TH, 1, relu, vec, 0, padded, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}
