// Weight gradient of the 3x3 SAME stride-1 convolution for float32 inputs,
// NCHW, float32 sums and result, on the tensor cores through 3xTF32.
//
// Replaces: mm_masking_tpu/ops/pallas/conv2d.py::_dk_nhcw_raw (kernel body
// _dk_kernel, pallas_call at :184) for float32 inputs; bfloat16 inputs run
// conv3x3_dk_tc.cu.
//
//   dk[co][ci][kh][kw] = sum_{b,h,w} dy[b][co][h][w] * x[b][ci][h+kh-1][w+kw-1]
//
// (x zero outside the image), as a GEMM whose reduction dimension K is the
// pixels (b, h, w): rows M are the 9 * Ci (tap, input channel) pairs, columns
// N the Co output channels.
//
// What bounds it on this card: per pixel the GEMM does 18 * Ci * Co
// operations for 4 * (Ci + Co) bytes of x and dy, 4.5 * Ci * Co / (Ci + Co)
// operations a byte, against the ~49 a byte at which float32 on the tensor
// cores (495 / 3 = 165 TFLOP/s through 3xTF32) outruns 3.35 TB/s. Every
// stage up to 16 channels (the 640^2 end of the UNet) is bound by bytes;
// every stage from 32 channels on by operations.
//
// Design: the bfloat16 kernel's GEMM (conv3x3_dk_tc.cu) on the float32
// conv's arithmetic (conv3x3_tc.cu), an implicit GEMM on mma.sync.m16n8k8
// TF32 with float32 sums.
// - M is 9 taps x CI_T input channels, tap-major (row m = tap * CI_T + ci),
//   in m-tiles of 16: CI_T = 16 fills 9 m-tiles exactly; CI_T = 8 (2..8
//   channels) 72 rows in 5; Ci = 1 the 9 taps in one, padded to 16. N is
//   CO_T = 8 * NT output channels. K is the pixels of a spatial tile of TH
//   rows x TW = 40 columns (every UNet width is a multiple of 40; other
//   widths are masked past W), in k-steps of 8 pixels of one row.
// - A block stages one spatial tile in shared memory: the dy tile of its
//   output channels and the x halo of its input channels. A TF32 fragment
//   element is one 32-bit word, so the tap kw is a word offset into the one
//   staged halo and every fragment is read with 32-bit shared loads. The
//   halo row puts image column w0 at word XOFF = 4, so the interior loads
//   and stages as 16-byte vectors; its edge columns are scalars.
// - Bank spread: the 8 rows g of an A fragment are 8 input channels CS words
//   apart, and the 8 columns g of a B fragment 8 output channels DS words
//   apart; CS and DS are = 4 (mod 8), so g * CS (mod 32) is 8 different
//   multiples of 4 and the 4 k-columns t fill the 32 banks. For Ci = 1 the 8
//   rows are 8 taps: the halo row stride XRS (52 words for TW = 40) is the
//   least that puts their words (kh * XRS + kw + t) in different banks.
// - Accuracy (3xTF32): each operand v is split into big = tf32(v) and small
//   = tf32(v - big), and each product is taken as small*big + big*small +
//   big*big, in that order (conv3x3_tc.cu's order). The tensor cores round
//   their own float32 sums toward zero, so a warp starts a fresh mma
//   accumulator for each row of its tile (5 k-steps, 40 pixels, 15
//   products) and adds it to its running float32 sums in registers with
//   ordinary adds. Nothing is summed across rows or tiles inside the mma.
// - The split is made once per value as it is staged, and both halves are
//   staged, as conv3x3_tc.cu stages them, HALF words apart. Splitting in
//   registers as each fragment is read instead (half the shared bytes, so
//   tiles twice the size or twice the blocks per SM) measured slower on the
//   H100 at every UNet stage: each fragment word is read by WN warps and
//   used for NW or MW mma tiles, so the split's three instructions ran many
//   times per staged value inside the k-loop, and its temporaries pushed
//   the larger warp tiles into spills.
// - The reduction over pixels takes two passes and no float atomics, as in
//   conv3x3_dk_tc.cu: a block owns a (channel tile, chunk of consecutive
//   spatial tiles) and writes its float32 sums to the scratch (n_chunks, Co,
//   Ci, 9); the warps that split a tile's rows (WK > 1) add theirs through
//   shared memory in warp order; pass two (dk_chunk_sum.cuh, shared with
//   conv3x3_dk_tc.cu) sums the chunks in chunk order. Every sum runs in a
//   fixed order, so two runs give the same bits.
// - Tiles (with_cfg): 3 x 4 m- and n-tiles a warp from 33 output channels
//   on, in 2 x 40-pixel tiles so that two blocks of 6 warps fit an SM (162
//   registers); fewer output channels take smaller warp tiles and taller
//   spatial tiles. Shared bytes: 2 x (CI_T * CS + CO_T * DS) words, 48 to
//   101 KB at the UNet's stages.
// - Enough blocks for both ends: the host sizes the chunks so that each shape
//   launches whole waves of the blocks an SM holds. At 256->256, 40^2 the
//   16 x 4 channel tiles take 4 chunks each; at 1->8 or 8->8, 640^2 there is
//   one channel tile and the pixel chunks alone fill the card.
// Staging is synchronous, one barrier per tile: no cp.async or TMA ring, no
// wgmma yet (later work); the blocks resident on an SM overlap each other's
// loads.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dk_chunk_sum.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int SMS = 132;
constexpr int TW = 40;        // tile columns
constexpr int SEGS = TW / 8;  // k-steps of a tile row
constexpr int QW = TW / 4;    // 16-byte vectors of a tile row
constexpr int XOFF = 4;       // halo word of image column w0 (16-byte aligned)

constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The least n' >= n with n' = 4 (mod 8): 8 rows n' words apart, each read at
// 4 consecutive words, then cover the 32 banks.
constexpr int bank_stride(int n) { return n + ((12 - n % 8) % 8); }

// True if the words that one A load reads for Ci = 1 (taps 0..7 of rows
// g = 0..7 at k-columns t = 0..3: kh * rs + kw + t) that differ fall in
// different banks.
constexpr bool taps_spread(int rs) {
  for (int i = 0; i < 32; ++i)
    for (int j = 0; j < 32; ++j) {
      const int wi = i / 4 / 3 * rs + i / 4 % 3 + i % 4;
      const int wj = j / 4 / 3 * rs + j / 4 % 3 + j % 4;
      if (wi != wj && wi % 32 == wj % 32) return false;
    }
  return true;
}

// The least row stride >= n, a multiple of 4, that spreads the taps.
constexpr int tap_row_stride(int n) {
  for (int rs = round4(n); rs < round4(n) + 64; rs += 4)
    if (taps_spread(rs)) return rs;
  return round4(n);
}

// A block's tile: CI_T input channels x NT n-tiles of 8 output channels over
// a spatial tile of TH x TW pixels; warps WM x WN x WK, each MW m-tiles x NW
// n-tiles, the WK warps of an output tile splitting its rows.
template <int CI_T_, int NT_, int TH_, int MW_, int NW_, int WK_, int MINB_>
struct Cfg {
  static constexpr int CI_T = CI_T_, NT = NT_, TH = TH_;
  static constexpr int MW = MW_, NW = NW_, WK = WK_;
  static constexpr int MINB = MINB_;  // blocks an SM holds (register cap), and
                                      // the blocks per SM the chunks aim at
  static constexpr int MT = (9 * CI_T + 15) / 16;  // m-tiles
  static constexpr int WM = MT / MW, WN = NT / NW;
  static_assert(WM * MW == MT && WN * NW == NT, "warps must tile the output");
  static_assert(TH % WK == 0, "the WK warps of an output tile split its rows");
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int CO_T = 8 * NT;
  static constexpr int XR = TH + 2;  // halo rows
  // halo row stride, x channel stride, dy channel stride (words)
  static constexpr int XRS = CI_T == 1 ? tap_row_stride(XOFF + TW + 1) : round4(XOFF + TW + 1);
  static constexpr int CS = CI_T == 1 ? XR * XRS : bank_stride(XR * XRS);
  static constexpr int DS = bank_stride(TH * TW);
  static constexpr int DY = CI_T * CS;        // word of the dy tile
  static constexpr int HALF = DY + CO_T * DS;  // words of the big (or small) halves
  static constexpr int STAGE = 2 * HALF * 4;                         // bytes
  static constexpr int RED = WK > 1 ? WK * MT * 16 * CO_T * 4 : 0;  // bytes
  static constexpr int SMEM = STAGE > RED ? STAGE : RED;
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v -> (big, small) with big + small = v to ~2^-22 relative.
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32(v);
  small = tf32(v - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 operands, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pixels w .. w + 3 of an image row, zero past W. `vec`: W is a multiple of
// 4 and the row 16-byte aligned, so the four are all in or all out.
__device__ __forceinline__ float4 load4(const float* row, int w, int W, bool vec) {
  if (vec) return w < W ? __ldg(reinterpret_cast<const float4*>(row + w)) : make_float4(0, 0, 0, 0);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = w + k < W ? __ldg(row + w + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Stage four words at word `at`: their big halves there, their small halves
// C::HALF words on.
template <class C>
__device__ __forceinline__ void put4(uint32_t* s, int at, float4 v) {
  uint4 big, small;
  split(v.x, big.x, small.x);
  split(v.y, big.y, small.y);
  split(v.z, big.z, small.z);
  split(v.w, big.w, small.w);
  *reinterpret_cast<uint4*>(s + at) = big;
  *reinterpret_cast<uint4*>(s + C::HALF + at) = small;
}

template <class C>
__device__ __forceinline__ void put1(uint32_t* s, int at, float v) {
  split(v, s[at], s[C::HALF + at]);
}

// Stage tile (b, h0, w0): the x halo of input channels ci0.. (halo row rr,
// word XOFF + c holds x[h0 + rr - 1][w0 + c]) and the dy tile of output
// channels co0.., zero outside the image and past Ci and Co. Each part's
// loads are issued together before its stores.
template <class C>
__device__ __forceinline__ void stage(uint32_t* s, const float* __restrict__ x,
                                      const float* __restrict__ dy, int b, int h0, int w0,
                                      int ci0, int co0, int Ci, int Co, int H, int W, bool vec) {
  const size_t plane = static_cast<size_t>(H) * W;
  constexpr int X_VEC = C::CI_T * C::XR * QW;  // interior vectors
  constexpr int X_EDGE = C::CI_T * C::XR * 2;  // edge columns w0 - 1 and w0 + TW
  constexpr int D_VEC = C::CO_T * C::TH * QW;
  constexpr int XSTEPS = (X_VEC + C::THREADS - 1) / C::THREADS;
  constexpr int ESTEPS = (X_EDGE + C::THREADS - 1) / C::THREADS;
  constexpr int DSTEPS = (D_VEC + C::THREADS - 1) / C::THREADS;
  {
    float4 xv[XSTEPS];
    float ev[ESTEPS];
#pragma unroll
    for (int j = 0; j < XSTEPS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      const int c = i / (C::XR * QW);
      const int gh = h0 + i / QW % C::XR - 1;
      xv[j] = make_float4(0, 0, 0, 0);
      if (i < X_VEC && ci0 + c < Ci && gh >= 0 && gh < H)
        xv[j] = load4(x + (static_cast<size_t>(b) * Ci + ci0 + c) * plane +
                          static_cast<size_t>(gh) * W,
                      w0 + 4 * (i % QW), W, vec);
    }
#pragma unroll
    for (int j = 0; j < ESTEPS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      const int c = i / (C::XR * 2);
      const int gh = h0 + i / 2 % C::XR - 1;
      const int gw = i % 2 ? w0 + TW : w0 - 1;
      ev[j] = 0.f;
      if (i < X_EDGE && ci0 + c < Ci && gh >= 0 && gh < H && gw >= 0 && gw < W)
        ev[j] = __ldg(x + (static_cast<size_t>(b) * Ci + ci0 + c) * plane +
                      static_cast<size_t>(gh) * W + gw);
    }
#pragma unroll
    for (int j = 0; j < XSTEPS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      if (i < X_VEC)
        put4<C>(s, i / (C::XR * QW) * C::CS + i / QW % C::XR * C::XRS + XOFF + 4 * (i % QW),
                xv[j]);
    }
#pragma unroll
    for (int j = 0; j < ESTEPS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      if (i < X_EDGE)
        put1<C>(s, i / (C::XR * 2) * C::CS + i / 2 % C::XR * C::XRS +
                       (i % 2 ? XOFF + TW : XOFF - 1),
                ev[j]);
    }
  }
  float4 dv[DSTEPS];
#pragma unroll
  for (int j = 0; j < DSTEPS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    const int c = i / (C::TH * QW);
    const int gh = h0 + i / QW % C::TH;
    dv[j] = make_float4(0, 0, 0, 0);  // pixels past the image contribute nothing
    if (i < D_VEC && co0 + c < Co && gh < H)
      dv[j] = load4(dy + (static_cast<size_t>(b) * Co + co0 + c) * plane +
                        static_cast<size_t>(gh) * W,
                    w0 + 4 * (i % QW), W, vec);
  }
#pragma unroll
  for (int j = 0; j < DSTEPS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    if (i < D_VEC)
      put4<C>(s, C::DY + i / (C::TH * QW) * C::DS + i / QW % C::TH * TW + 4 * (i % QW), dv[j]);
  }
}

// x (B, Ci, H, W), dy (B, Co, H, W) f32 -> partial (n_chunks, Co, Ci, 9) f32.
// grid = (n_ci_t * n_co_t, n_chunks).
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
conv3x3_dk_mma_tf32x3(const float* __restrict__ x, const float* __restrict__ dy,
                      float* __restrict__ partial, int B, int Ci, int Co, int H, int W,
                      int n_ci_t, int tiles_per_chunk) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row group, k-column
  const int wk = warp % C::WK;
  const int wn = warp / C::WK % C::WN;
  const int wm = warp / (C::WK * C::WN);
  const int ci0 = blockIdx.x % n_ci_t * C::CI_T;
  const int co0 = blockIdx.x / n_ci_t * C::CO_T;
  const int n_tw = (W + TW - 1) / TW;
  const int n_th = (H + C::TH - 1) / C::TH;
  const int t_begin = blockIdx.y * tiles_per_chunk;
  const int t_end = min(B * n_th * n_tw, t_begin + tiles_per_chunk);
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16) == 0;

  // A fragment rows g and g + 8 of each m-tile: the word of their (tap,
  // input channel) for pixel tq of the tile's row 0. Padding rows (tap >= 9)
  // read tap 8; their sums are dropped.
  int a_at[C::MW][2];
#pragma unroll
  for (int i = 0; i < C::MW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * C::MW + i) * 16 + g + 8 * h;
      const int tap = min(m / C::CI_T, 8);
      a_at[i][h] = m % C::CI_T * C::CS + tap / 3 * C::XRS + tap % 3 + XOFF - 1 + tq;
    }
  // B fragment column g of each n-tile: output channel n * 8 + g, k-row tq.
  int b_at[C::NW];
#pragma unroll
  for (int f = 0; f < C::NW; ++f) b_at[f] = C::DY + ((wn * C::NW + f) * 8 + g) * C::DS + tq;

  float acc[C::MW][C::NW][4];
#pragma unroll
  for (int i = 0; i < C::MW; ++i)
#pragma unroll
    for (int f = 0; f < C::NW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / (n_th * n_tw);
    const int h0 = t / n_tw % n_th * C::TH;
    const int w0 = t % n_tw * TW;
    __syncthreads();  // the previous tile's fragments are read
    stage<C>(smem, x, dy, b, h0, w0, ci0, co0, Ci, Co, H, W, vec);
    __syncthreads();

#pragma unroll 1
    for (int r = wk; r < C::TH; r += C::WK) {
      // This row's products in a fresh accumulator, added to acc below.
      float d[C::MW][C::NW][4];
#pragma unroll
      for (int i = 0; i < C::MW; ++i)
#pragma unroll
        for (int f = 0; f < C::NW; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][f][e] = 0.f;
#pragma unroll
      for (int sg = 0; sg < SEGS; ++sg) {
        const uint32_t* xs = smem + r * C::XRS + 8 * sg;
        const uint32_t* ds = smem + r * TW + 8 * sg;
        uint32_t ab[C::MW][4], as[C::MW][4], bb[C::NW][2], bs[C::NW][2];
#pragma unroll
        for (int i = 0; i < C::MW; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // a0: (row g, k tq), a1: (g + 8, tq), a2: (g, tq + 4), a3: (g + 8, tq + 4)
            const int at = a_at[i][q % 2] + 4 * (q / 2);
            ab[i][q] = xs[at];
            as[i][q] = xs[C::HALF + at];
          }
#pragma unroll
        for (int f = 0; f < C::NW; ++f)
#pragma unroll
          for (int q = 0; q < 2; ++q) {  // b0: (k tq, column g), b1: (tq + 4, g)
            bb[f][q] = ds[b_at[f] + 4 * q];
            bs[f][q] = ds[C::HALF + b_at[f] + 4 * q];
          }
        // The three products, term by term over the warp's tiles, so that
        // consecutive mma instructions do not wait on each other.
#pragma unroll
        for (int i = 0; i < C::MW; ++i)
#pragma unroll
          for (int f = 0; f < C::NW; ++f) mma_tf32(d[i][f], as[i], bb[f]);
#pragma unroll
        for (int i = 0; i < C::MW; ++i)
#pragma unroll
          for (int f = 0; f < C::NW; ++f) mma_tf32(d[i][f], ab[i], bs[f]);
#pragma unroll
        for (int i = 0; i < C::MW; ++i)
#pragma unroll
          for (int f = 0; f < C::NW; ++f) mma_tf32(d[i][f], ab[i], bb[f]);
      }
#pragma unroll
      for (int i = 0; i < C::MW; ++i)
#pragma unroll
        for (int f = 0; f < C::NW; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][f][e] += d[i][f][e];
    }
  }

  // C fragment: element e is A row g + 8 * (e / 2) of the m-tile, output
  // channel 2 * tq + e % 2 of the n-tile.
  float* out = partial + static_cast<size_t>(blockIdx.y) * Co * Ci * 9;
  auto put = [&](int m, int n, float v) {  // m: row of the block's tile, n: its channel
    const int tap = m / C::CI_T, ci = ci0 + m % C::CI_T, co = co0 + n;
    if (tap < 9 && ci < Ci && co < Co) out[(static_cast<size_t>(co) * Ci + ci) * 9 + tap] = v;
  };
  if constexpr (C::WK == 1) {
#pragma unroll
    for (int i = 0; i < C::MW; ++i)
#pragma unroll
      for (int f = 0; f < C::NW; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put((wm * C::MW + i) * 16 + g + 8 * (e / 2), (wn * C::NW + f) * 8 + 2 * tq + e % 2,
              acc[i][f][e]);
  } else {
    // The WK warps of each output tile add their sums in warp order.
    constexpr int M = C::MT * 16, N = C::CO_T;
    float* red = reinterpret_cast<float*>(smem);  // [WK][M][N]
    __syncthreads();  // the last tile's fragments are read
#pragma unroll
    for (int i = 0; i < C::MW; ++i)
#pragma unroll
      for (int f = 0; f < C::NW; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = (wm * C::MW + i) * 16 + g + 8 * (e / 2);
          const int n = (wn * C::NW + f) * 8 + 2 * tq + e % 2;
          red[(wk * M + m) * N + n] = acc[i][f][e];
        }
    __syncthreads();
    for (int e = threadIdx.x; e < M * N; e += C::THREADS) {
      float s = 0.f;
      for (int w = 0; w < C::WK; ++w) s += red[w * M * N + e];
      put(e / N, e % N, s);
    }
  }
}

// The tile of a shape: CI_T by Ci, NT by Co. TH, the warps and the blocks
// per SM were picked per stage by timing variants at B = 16 on the H100
// (PERF.md). Calls fn(Cfg{}, kernel).
template <typename Fn>
auto with_cfg(int Ci, int Co, Fn fn) {
#define MM_DK_CFG(...) \
  return fn(Cfg<__VA_ARGS__>{}, conv3x3_dk_mma_tf32x3<Cfg<__VA_ARGS__>>)
  if (Ci == 1) {
    if (Co <= 8) MM_DK_CFG(1, 1, 16, 1, 1, 8, 4);
    MM_DK_CFG(1, 2, 16, 1, 2, 8, 2);
  }
  if (Ci <= 8) {
    if (Co <= 8) MM_DK_CFG(8, 1, 16, 5, 1, 8, 2);
    MM_DK_CFG(8, 2, 8, 5, 1, 2, 3);
  }
  if (Co <= 8) MM_DK_CFG(16, 1, 8, 3, 1, 4, 2);
  if (Co <= 16) MM_DK_CFG(16, 2, 8, 3, 2, 2, 2);
  if (Co <= 32) MM_DK_CFG(16, 4, 4, 3, 4, 2, 2);
  MM_DK_CFG(16, 8, 2, 3, 4, 1, 2);
#undef MM_DK_CFG
}

struct Grid {
  int n_ci_t, n_co_t, n_tiles, n_chunks, per_chunk;
};

// Channel tiles, spatial tiles and chunks: at most C::MINB blocks per SM
// (whole waves of the blocks an SM holds), each chunk a run of consecutive
// tiles.
template <class C>
Grid grid_of(int B, int Ci, int Co, int H, int W) {
  Grid g;
  g.n_ci_t = (Ci + C::CI_T - 1) / C::CI_T;
  g.n_co_t = (Co + C::CO_T - 1) / C::CO_T;
  g.n_tiles = B * ((H + C::TH - 1) / C::TH) * ((W + TW - 1) / TW);
  const int target = SMS * C::MINB;
  const int channel_blocks = g.n_ci_t * g.n_co_t;
  int n = target / channel_blocks;
  n = n < 1 ? 1 : (n > g.n_tiles ? g.n_tiles : n);
  g.per_chunk = (g.n_tiles + n - 1) / n;
  g.n_chunks = (g.n_tiles + g.per_chunk - 1) / g.per_chunk;
  return g;
}

}  // namespace

// Number of chunks (the first dimension of the partial-sum scratch) that
// mm_conv3x3_dk_f32 uses for this shape.
extern "C" int mm_conv3x3_dk_chunks(int B, int Ci, int Co, int H, int W) {
  return with_cfg(Ci, Co, [&](auto cfg, auto) {
    return grid_of<decltype(cfg)>(B, Ci, Co, H, W).n_chunks;
  });
}

// Shared bytes of one block of mm_conv3x3_dk_f32 for Ci and Co.
extern "C" size_t mm_conv3x3_dk_f32_smem_bytes(int Ci, int Co) {
  return with_cfg(Ci, Co, [](auto cfg, auto) {
    return static_cast<size_t>(decltype(cfg)::SMEM);
  });
}

// x, dy f32 (B, Ci, H, W) and (B, Co, H, W); partial (n_chunks, Co, Ci, 9)
// f32 scratch; dk (Co, Ci, 3, 3) f32.
extern "C" int mm_conv3x3_dk_f32(const void* x, const void* dy, void* partial, void* dk, int B,
                                 int Ci, int Co, int H, int W, int n_chunks, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int status = with_cfg(Ci, Co, [&](auto cfg, auto kernel) {
    using C = decltype(cfg);
    const Grid g = grid_of<C>(B, Ci, Co, H, W);
    if (n_chunks != g.n_chunks) return static_cast<int>(cudaErrorInvalidValue);
    const int st = mm::opt_in_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
    if (st != 0) return st;
    kernel<<<dim3(g.n_ci_t * g.n_co_t, g.n_chunks), C::THREADS, C::SMEM, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(partial), B, Ci, Co, H, W, g.n_ci_t, g.per_chunk);
    return static_cast<int>(cudaGetLastError());
  });
  if (status != 0) return status;
  return mm::sum_chunks(static_cast<const float*>(partial), static_cast<float*>(dk),
                        Co * Ci * 9, n_chunks, s);
}
