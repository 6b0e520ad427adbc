// Weight gradient of the 3x3 SAME stride-1 convolution for bfloat16 inputs,
// NCHW, float32 sums and result, on the tensor cores.
//
// Replaces: mm_masking_tpu/ops/pallas/conv2d.py::_dk_nhcw_raw (kernel body
// _dk_kernel, pallas_call at :184) for bfloat16 inputs; float32 inputs run
// the 3xTF32 GEMM of conv3x3_dk_tf32_tc.cu.
//
//   dk[co][ci][kh][kw] = sum_{b,h,w} dy[b][co][h][w] * x[b][ci][h+kh-1][w+kw-1]
//
// (x zero outside the image), as a GEMM whose reduction dimension K is the
// pixels (b, h, w): rows M are the 9 * Ci (tap, input channel) pairs, columns
// N the Co output channels.
//
// What bounds it on this card: per pixel the GEMM does 18 * Ci * Co
// operations for 2 * (Ci + Co) bytes of x and dy, 9 * Ci * Co / (Ci + Co)
// operations a byte. At the 640^2 end of the UNet (1..16 channels) that is at
// most 72, far below the ~295 a byte at which the bf16 tensor cores (989
// TFLOP/s) outrun 3.35 TB/s: those stages are bound by bytes (x and dy, 118
// to 419 MB a conv at B = 16), and reading each once at full width is the
// whole game. From 32 channels on the ratio is 144 to 1152 a byte, and the
// stages are bound by operations: they need the tensor cores.
//
// Design: an implicit GEMM on mma.sync.m16n8k16 bf16 with float32 sums.
// - M is 9 taps x CI_T input channels, tap-major (row m = tap * CI_T + ci),
//   in m-tiles of 16: CI_T = 16 fills 9 m-tiles exactly; CI_T = 8 (2..8
//   channels) 72 rows in 5; Ci = 1 the 9 taps in one, padded to 16. N is
//   CO_T = 8 * NT output channels, so the 640^2 stages' Co = 8 fills one n8
//   fragment. K is the pixels of a spatial tile of TH rows x TW = 40
//   columns (every UNet width is a multiple of 40; other widths are masked
//   past W), in k-steps of 16 = two 8-pixel row segments.
// - A block stages one spatial tile in shared memory, in bf16 as it is: the
//   dy tile of its output channels and the x halo of its input channels.
//   Both operands are read along w by ldmatrix. A fragment register holds two
//   neighbouring pixels of a row, so tap kw = 1 would start at an odd bf16
//   address, and ldmatrix needs 16-byte aligned rows. The x halo is therefore
//   staged as three column-shifted copies (kw = 0, 1, 2), each aligned: copy
//   kw holds x[h0 + r - 1][w0 + c + kw - 1] at row r, column c. Staging
//   writes 3x the x bytes into shared memory (built from one 16-byte load and
//   its two edge pixels with byte permutes), and every k-step then takes one
//   ldmatrix.x4 per m-tile and per two n-tiles. The other way, two 16-bit
//   loads and a prmt per register, costs three instructions per register at
//   every k-step of every warp instead of once per staged segment.
// - Row strides are padded to an odd number of 16-byte units, so the 8 row
//   addresses of an ldmatrix fall in 8 different bank groups (for Ci = 1 the
//   copy stride is chosen so that the 8 taps of a matrix do).
// - Accuracy: bf16 products are exact in float32, but the tensor cores' own
//   float32 sums truncate. A warp therefore starts a fresh mma accumulator
//   for each spatial tile (at most 20 k-steps, 320 pixels) and adds it to its
//   running float32 sums in registers with ordinary adds. Nothing is summed
//   across tiles inside the mma.
// - The reduction over pixels takes two passes and no float atomics, as in
//   conv3x3_dk_tf32_tc.cu: a block owns a (channel tile, chunk of
//   consecutive spatial tiles) and writes its float32 sums to the scratch
//   (n_chunks, Co, Ci, 9); the warps that split a tile's k-steps (WK > 1) add
//   theirs through shared memory in warp order; pass two (dk_chunk_sum.cuh,
//   shared with conv3x3_dk_tf32_tc.cu) sums the chunks in chunk order. Every
//   sum runs in a fixed order, so two runs give the same bits.
// - Enough blocks for both ends: the host sizes the chunks so that each shape
//   launches whole waves of the blocks an SM holds (2 to 8 per SM, by tile).
//   At 256->256, 40^2 the 144 x 64 channel tiles give 64 blocks and the
//   pixels are split in 4 chunks; at 1->8 or 8->8, 640^2 there is one
//   channel tile and about 1000 chunks fill the card.
// Staging is synchronous, one barrier per tile: no cp.async or TMA ring, no
// wgmma; the blocks resident on an SM overlap each other's loads.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dk_chunk_sum.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int SMS = 132;

constexpr int odd_at_least(int n) { return n % 2 ? n : n + 1; }

// Shared row stride of a TW-column tile in 16-byte units: odd.
constexpr int row_units(int tw) { return odd_at_least(tw / 8); }

// True if the first 8 taps of one channel, at kh * rs + kw * c units, fall in
// 8 different 16-byte bank groups.
constexpr bool taps_spread(int rs, int c) {
  bool seen[8] = {};
  for (int tap = 0; tap < 8; ++tap) {
    const int g = (tap / 3 * rs + tap % 3 * c) % 8;
    if (seen[g]) return false;
    seen[g] = true;
  }
  return true;
}

// The least copy stride >= n (units) that spreads the taps, else an odd one.
constexpr int tap_stride(int rs, int n) {
  for (int c = n; c < n + 8; ++c)
    if (taps_spread(rs, c)) return c;
  return odd_at_least(n);
}

// A block's tile: CI_T input channels x NT n-tiles of 8 output channels over
// a spatial tile of TH x TW pixels; warps WM x WN x WK, each MW m-tiles x NW
// n-tiles, the WK warps of an output tile splitting its k-steps.
template <int CI_T_, int NT_, int TH_, int MW_, int NW_, int WK_, int MINB_ = 1, int TGT_ = 4,
          bool MERGE_ = false>
struct Cfg {
  static constexpr int CI_T = CI_T_, NT = NT_, TH = TH_, TW = 40;
  static constexpr int MW = MW_, NW = NW_, WK = WK_;
  static constexpr int MINB = MINB_;  // blocks an SM must hold (register cap)
  static constexpr int TGT = TGT_;    // blocks per SM the chunks aim at
  static constexpr bool MERGE = MERGE_;
  static constexpr int MT = (9 * CI_T + 15) / 16;  // m-tiles
  static constexpr int WM = MT / MW, WN = NT / NW;
  static_assert(WM * MW == MT && WN * NW == NT, "warps must tile the output");
  static_assert(NW == 1 || NW % 2 == 0, "n-tiles are read in pairs");
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int CO_T = 8 * NT;
  static constexpr int SW = TW / 8;                  // 8-pixel segments of a row
  static constexpr int KSTEPS = TH * SW / 2;         // 16-pixel k-steps of a tile
  static_assert(TW % 8 == 0 && TH * SW % 2 == 0, "a tile is whole k-steps");
  static constexpr int RS = row_units(TW);           // shared row stride, units
  static constexpr int CS = CI_T == 1 ? tap_stride(RS, (TH + 2) * RS)
                                      : odd_at_least((TH + 2) * RS);  // x channel
  static constexpr int COPY = CI_T * CS;             // one column-shifted x copy
  static constexpr int DS = odd_at_least(TH * RS);   // dy channel
  static constexpr int X_ITEMS = CI_T * (TH + 2) * SW;
  static constexpr int D_ITEMS = CO_T * TH * SW;
  static constexpr int STAGE = (3 * COPY + CO_T * DS) * 16;      // bytes
  static constexpr int RED = WK > 1 ? WK * MT * 16 * CO_T * 4 : 0;  // bytes
  static constexpr int SMEM = STAGE > RED ? STAGE : RED;
};

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

// Pixels w .. w + 7 of an image row (bf16 bits), zero past W. `vec`: W is a
// multiple of 8 and the row 16-byte aligned, so the segment is whole or
// absent and loads as one vector.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int w, int W, bool vec) {
  if (vec) return w < W ? __ldg(reinterpret_cast<const uint4*>(row + w)) : make_uint4(0, 0, 0, 0);
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = w + 2 * k < W ? __ldg(row + w + 2 * k) : 0u;
    const uint32_t hi = w + 2 * k + 1 < W ? __ldg(row + w + 2 * k + 1) : 0u;
    v[k] = lo | hi << 16;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Offset in 16-byte units of 8-pixel segment s of a tile (row s / SW).
template <class C>
__device__ __forceinline__ int seg_units(int s) {
  return s / C::SW * C::RS + s % C::SW;
}

// Stage tile (b, h0, w0): the three column-shifted copies of the x halo of
// input channels ci0.. and the dy tile of output channels co0.., zero
// outside the image and past Ci and Co. The x loads are issued together, then
// the dy loads; C::MERGE puts x's stores after the dy loads (one wait for
// both), else before them (fewer registers).
template <class C>
__device__ __forceinline__ void stage(uint4* xs, uint4* ds, const uint16_t* __restrict__ x,
                                      const uint16_t* __restrict__ dy, int b, int h0, int w0,
                                      int ci0, int co0, int Ci, int Co, int H, int W,
                                      bool vec) {
  const size_t plane = static_cast<size_t>(H) * W;
  constexpr int XSTEPS = (C::X_ITEMS + C::THREADS - 1) / C::THREADS;
  constexpr int DSTEPS = (C::D_ITEMS + C::THREADS - 1) / C::THREADS;
  uint4 xv[XSTEPS], dv[DSTEPS];
  uint32_t left[XSTEPS], right[XSTEPS];  // the edge pixels: high half, low half
#pragma unroll
  for (int j = 0; j < XSTEPS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    const int c = i / ((C::TH + 2) * C::SW);
    const int gh = h0 + i / C::SW % (C::TH + 2) - 1;
    const int gw = w0 + 8 * (i % C::SW);
    xv[j] = make_uint4(0, 0, 0, 0);
    left[j] = right[j] = 0;
    if (i < C::X_ITEMS && ci0 + c < Ci && gh >= 0 && gh < H) {
      const uint16_t* row =
          x + (static_cast<size_t>(b) * Ci + ci0 + c) * plane + static_cast<size_t>(gh) * W;
      xv[j] = load8(row, gw, W, vec);
      if (gw >= 1 && gw - 1 < W) left[j] = static_cast<uint32_t>(__ldg(row + gw - 1)) << 16;
      if (gw + 8 < W) right[j] = __ldg(row + gw + 8);
    }
  }
  auto store_x = [&] {
#pragma unroll
    for (int j = 0; j < XSTEPS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      if (i >= C::X_ITEMS) continue;
      const int at = i / ((C::TH + 2) * C::SW) * C::CS + i / C::SW % (C::TH + 2) * C::RS +
                     i % C::SW;
      const uint4 w = xv[j];
      // copy 0: pixel c holds x[c - 1]; copy 2: x[c + 1] (byte_perm 0x5432
      // takes the high half of its first word and the low half of its second).
      xs[at] = make_uint4(__byte_perm(left[j], w.x, 0x5432), __byte_perm(w.x, w.y, 0x5432),
                          __byte_perm(w.y, w.z, 0x5432), __byte_perm(w.z, w.w, 0x5432));
      xs[C::COPY + at] = w;
      xs[2 * C::COPY + at] =
          make_uint4(__byte_perm(w.x, w.y, 0x5432), __byte_perm(w.y, w.z, 0x5432),
                     __byte_perm(w.z, w.w, 0x5432), __byte_perm(w.w, right[j], 0x5432));
    }
  };
  if constexpr (!C::MERGE) store_x();
#pragma unroll
  for (int j = 0; j < DSTEPS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    const int c = i / (C::TH * C::SW);
    const int gh = h0 + i / C::SW % C::TH;
    const int gw = w0 + 8 * (i % C::SW);
    dv[j] = make_uint4(0, 0, 0, 0);  // pixels past the image contribute nothing
    if (i < C::D_ITEMS && co0 + c < Co && gh < H)
      dv[j] = load8(dy + (static_cast<size_t>(b) * Co + co0 + c) * plane +
                        static_cast<size_t>(gh) * W,
                    gw, W, vec);
  }
  if constexpr (C::MERGE) store_x();
#pragma unroll
  for (int j = 0; j < DSTEPS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    if (i < C::D_ITEMS)
      ds[i / (C::TH * C::SW) * C::DS + i / C::SW % C::TH * C::RS + i % C::SW] = dv[j];
  }
}

// x (B, Ci, H, W), dy (B, Co, H, W) bf16 -> partial (n_chunks, Co, Ci, 9) f32.
// grid = (n_ci_t * n_co_t, n_chunks).
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
conv3x3_dk_mma_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
                    float* __restrict__ partial, int B, int Ci, int Co, int H, int W,
                    int n_ci_t, int tiles_per_chunk) {
  extern __shared__ __align__(16) uint4 smem[];
  uint4* xs = smem;                // [3][CI_T][CS]
  uint4* ds = smem + 3 * C::COPY;  // [CO_T][DS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp % C::WK;
  const int wn = warp / C::WK % C::WN;
  const int wm = warp / (C::WK * C::WN);
  const int ci0 = blockIdx.x % n_ci_t * C::CI_T;
  const int co0 = blockIdx.x / n_ci_t * C::CO_T;
  const int n_tw = (W + C::TW - 1) / C::TW;
  const int n_th = (H + C::TH - 1) / C::TH;
  const int t_begin = blockIdx.y * tiles_per_chunk;
  const int t_end = min(B * n_th * n_tw, t_begin + tiles_per_chunk);
  const bool vec = W % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16) == 0;

  // ldmatrix row addresses. A (x): lanes 8q .. 8q + 7 give the rows of matrix
  // q: A rows (q % 2) * 8 + lane % 8, pixels 0..7 (q < 2) or 8..15 of the
  // k-step. Padding rows (tap >= 9) read tap 8; their sums are dropped.
  const uint32_t xs_base = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const uint32_t ds_base = static_cast<uint32_t>(__cvta_generic_to_shared(ds));
  uint32_t a_row[C::MW];
#pragma unroll
  for (int i = 0; i < C::MW; ++i) {
    const int m = (wm * C::MW + i) * 16 + lane % 8 + 8 * (lane / 8 % 2);
    const int tap = min(m / C::CI_T, 8);
    a_row[i] = xs_base + 16 * (tap % 3 * C::COPY + m % C::CI_T * C::CS + tap / 3 * C::RS);
  }
  const int a_half = lane / 16;
  // B (dy): matrix q is n-tile 2p + q / 2 (x4) of the warp's pair p, pixels
  // 0..7 or 8..15 (q % 2); with one n-tile, x2 reads lanes 0..15.
  constexpr int NP = (C::NW + 1) / 2;
  uint32_t b_row[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int f = wn * C::NW + 2 * p + (C::NW > 1 ? lane / 16 : 0);
    b_row[p] = ds_base + 16 * (f * 8 + lane % 8) * C::DS;
  }
  const int b_half = lane / 8 % 2;

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
    const int w0 = t % n_tw * C::TW;
    __syncthreads();  // the previous tile's fragments are read
    stage<C>(xs, ds, x, dy, b, h0, w0, ci0, co0, Ci, Co, H, W, vec);
    __syncthreads();

    // This tile's products in a fresh accumulator, added to acc below.
    float d[C::MW][C::NW][4];
#pragma unroll
    for (int i = 0; i < C::MW; ++i)
#pragma unroll
      for (int f = 0; f < C::NW; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][f][e] = 0.f;
#pragma unroll 2
    for (int j = wk; j < C::KSTEPS; j += C::WK) {
      const uint32_t a_off = 16 * seg_units<C>(2 * j + a_half);
      const uint32_t b_off = 16 * seg_units<C>(2 * j + b_half);
      uint32_t a[C::MW][4], bf[C::NW][2];
#pragma unroll
      for (int i = 0; i < C::MW; ++i) ldsm_x4(a[i], a_row[i] + a_off);
      if constexpr (C::NW == 1) {
        ldsm_x2(bf[0][0], bf[0][1], b_row[0] + b_off);
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t r[4];
          ldsm_x4(r, b_row[p] + b_off);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < C::MW; ++i)
#pragma unroll
        for (int f = 0; f < C::NW; ++f) mma_bf16(d[i][f], a[i], bf[f][0], bf[f][1]);
    }
#pragma unroll
    for (int i = 0; i < C::MW; ++i)
#pragma unroll
      for (int f = 0; f < C::NW; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][f][e] += d[i][f][e];
  }

  // C fragment: element e is A row g + 8 * (e / 2) of the m-tile, output
  // channel 2 * (lane % 4) + e % 2 of the n-tile.
  float* out = partial + static_cast<size_t>(blockIdx.y) * Co * Ci * 9;
  auto put = [&](int m, int n, float v) {  // m: row of the block's tile, n: its channel
    const int tap = m / C::CI_T, ci = ci0 + m % C::CI_T, co = co0 + n;
    if (tap < 9 && ci < Ci && co < Co) out[(static_cast<size_t>(co) * Ci + ci) * 9 + tap] = v;
  };
  const int g = lane / 4, tq = lane % 4;
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

// The tile of a shape: CI_T by Ci, NT by Co. TH, the warps, the register cap
// and the blocks per SM were picked per stage by timing variants at B = 16 on
// the H100 (PERF.md). Calls fn(Cfg{}, kernel).
template <typename Fn>
auto with_cfg(int Ci, int Co, Fn fn) {
#define MM_DK_CFG(...) \
  return fn(Cfg<__VA_ARGS__>{}, conv3x3_dk_mma_bf16<Cfg<__VA_ARGS__>>)
  if (Ci == 1) {
    if (Co <= 8) MM_DK_CFG(1, 1, 32, 1, 1, 8, 4, 8, true);
    MM_DK_CFG(1, 2, 16, 1, 2, 8, 1, 8, false);
  }
  if (Ci <= 8) {
    if (Co <= 8) MM_DK_CFG(8, 1, 16, 5, 1, 8, 2, 8, true);
    MM_DK_CFG(8, 2, 16, 5, 2, 8, 2, 8, false);
  }
  if (Co <= 8) MM_DK_CFG(16, 1, 16, 3, 1, 4, 2, 8, true);
  if (Co <= 16) MM_DK_CFG(16, 2, 8, 3, 2, 2, 1, 4, false);
  if (Co <= 32) MM_DK_CFG(16, 4, 8, 3, 2, 1, 2, 4, false);
  MM_DK_CFG(16, 8, 4, 3, 4, 1, 2, 2, true);
#undef MM_DK_CFG
}

struct Grid {
  int n_ci_t, n_co_t, n_tiles, n_chunks, per_chunk;
};

// Channel tiles, spatial tiles and chunks: at most C::TGT blocks per SM
// (whole waves of the blocks an SM holds), each chunk a run of consecutive
// tiles.
template <class C>
Grid grid_of(int B, int Ci, int Co, int H, int W) {
  Grid g;
  g.n_ci_t = (Ci + C::CI_T - 1) / C::CI_T;
  g.n_co_t = (Co + C::CO_T - 1) / C::CO_T;
  g.n_tiles = B * ((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW);
  const int target = SMS * C::TGT;
  const int channel_blocks = g.n_ci_t * g.n_co_t;
  int n = target / channel_blocks;
  n = n < 1 ? 1 : (n > g.n_tiles ? g.n_tiles : n);
  g.per_chunk = (g.n_tiles + n - 1) / n;
  g.n_chunks = (g.n_tiles + g.per_chunk - 1) / g.per_chunk;
  return g;
}

}  // namespace

// Number of chunks (the first dimension of the partial-sum scratch) that
// mm_conv3x3_dk_bf16 uses for this shape.
extern "C" int mm_conv3x3_dk_bf16_chunks(int B, int Ci, int Co, int H, int W) {
  return with_cfg(Ci, Co, [&](auto cfg, auto) {
    return grid_of<decltype(cfg)>(B, Ci, Co, H, W).n_chunks;
  });
}

// Shared bytes of one block of mm_conv3x3_dk_bf16 for Ci and Co.
extern "C" size_t mm_conv3x3_dk_bf16_smem_bytes(int Ci, int Co) {
  return with_cfg(Ci, Co, [](auto cfg, auto) {
    return static_cast<size_t>(decltype(cfg)::SMEM);
  });
}

// x, dy bf16 (B, Ci, H, W) and (B, Co, H, W); partial (n_chunks, Co, Ci, 9)
// f32 scratch; dk (Co, Ci, 3, 3) f32.
extern "C" int mm_conv3x3_dk_bf16(const void* x, const void* dy, void* partial, void* dk,
                                  int B, int Ci, int Co, int H, int W, int n_chunks,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int status = with_cfg(Ci, Co, [&](auto cfg, auto kernel) {
    using C = decltype(cfg);
    const Grid g = grid_of<C>(B, Ci, Co, H, W);
    if (n_chunks != g.n_chunks) return static_cast<int>(cudaErrorInvalidValue);
    const int st = mm::opt_in_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
    if (st != 0) return st;
    kernel<<<dim3(g.n_ci_t * g.n_co_t, g.n_chunks), C::THREADS, C::SMEM, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
        static_cast<float*>(partial), B, Ci, Co, H, W, g.n_ci_t, g.per_chunk);
    return static_cast<int>(cudaGetLastError());
  });
  if (status != 0) return status;
  return mm::sum_chunks(static_cast<const float*>(partial), static_cast<float*>(dk),
                        Co * Ci * 9, n_chunks, s);
}
