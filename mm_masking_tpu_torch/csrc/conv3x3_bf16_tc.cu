// 3x3 SAME stride-1 convolution with bias and optional fused ReLU, NCHW,
// bfloat16 inputs with float32 sums, on the tensor cores.
//
// Replaces: mm_masking_tpu/ops/pallas/conv2d.py::_conv_nhcw_raw (kernel body
// _fwd_kernel, pallas_call at :152) for bfloat16 inputs, in both of the conv's
// uses: the forward and, on the rotated and transposed weight, the backward's
// dx. The weights arrive rounded to bfloat16, as the reference rounds kmat to
// x's type (conv2d.py:236, :263); the bias stays float32. float32 inputs run
// conv3x3_tc.cu.
//
// What bounds it on this card: per pixel a stage does 18 * Ci * Co
// operations for 2 * (Ci + Co) bytes of x and y. The 640^2 stages (1..16
// channels, 118 to 419 MB a conv at B = 16) are bound by bytes: reading x and
// writing y once, in wide runs, is the whole game. From 32 channels on the
// stages are bound by operations and need the tensor cores (989 TFLOP/s).
//
// Design: an implicit GEMM on mma.sync.m16n8k16 bf16 with float32 sums.
// - M is pixels: an m-tile is 8 consecutive columns of two neighbouring
//   output rows, so a 40-column tile (every UNet width is a multiple of 40)
//   splits into whole m-tiles. N is output channels, CO_T = 8 * NT of them a
//   block (at most 64), so one staged input chunk serves them all. K is
//   (tap, input channel) pairs, tap-major in chunks of CI_T input channels:
//   CI_T = 16 (Ci > 8) takes one tap a k-step, 9 k-steps a chunk; CI_T = 8
//   (2..8 channels) two taps a k-step, 5 k-steps (the tenth tap's weights are
//   zero); Ci = 1 takes the 9 taps of a pixel in one k-step, padded to 16.
// - A block stages, per chunk, the (TH + 2) x (TW + 2) halo of its tile with
//   the channels innermost, zero outside the image (the SAME padding) and past
//   Ci, and the chunk's weights [tap][co][CI_T], which the host packs in
//   bf16 as (Ci / CI_T, 9, Co up to 8, CI_T), zero-padded. One row of an A
//   matrix is then one pixel's 8 channels, 16 contiguous bytes, and the kw
//   shift moves it by one pixel: ldmatrix (not transposed) reads every tap of
//   the A operand straight from the halo, and the B operand from the weights.
//   For CI_T = 16 a pixel takes 48 bytes (3 units of 16: 2 of channels, 1 of
//   padding), so the 8 consecutive pixels of a matrix fall in 8 different
//   16-byte bank groups; for CI_T = 8 a pixel is one unit. The halo row
//   stride (TW + 2 pixels for CI_T = 16, odd for CI_T = 8) spreads the
//   staging stores of neighbouring rows over the banks too. Ci = 1 keeps the
//   halo as plain pixels and builds its A fragments with 16-bit loads.
// - Staging reads x as 16-byte vectors of 8 pixels (two channels a thread,
//   interleaved into channel pairs with byte permutes); where W is not a
//   multiple of 8 it reads 16-bit scalars. The output tile goes through
//   shared memory (the C fragment holds channel pairs, NCHW wants pixel runs)
//   and leaves as 16-byte stores of 8 pixels.
// - Accuracy: bf16 products are exact in float32, but the tensor cores' own
//   float32 sums round toward zero (as found for conv3x3_tc.cu). Each chunk's
//   k-steps (at most 9) therefore go into a fresh accumulator, which is added
//   to the running sums in float32 registers: nothing is summed across chunks
//   inside the mma.
// - Staging is synchronous, one barrier pair per chunk: the blocks resident
//   on an SM overlap each other's loads. The tiles (with_cfg) were picked per
//   stage by timing variants at B = 16 on the H100: at the 640^2 stages a
//   register cap for 2 or 3 blocks per SM (a few bytes of spill) beat larger
//   tiles; from 64 output channels on, 8 warps of 5 m-tiles x 4 n-tiles, so
//   that more products share each ldmatrix. A cp.async ring that keeps the
//   next chunk's (or tile's) copies in flight during the products, with
//   coalesced row reads, measured no faster, and was left out. No wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "smem_opt_in.cuh"

namespace {

constexpr int odd_at_least(int n) { return n % 2 ? n : n + 1; }

// A block's tile: TH x 40 pixels and NT n-tiles of 8 output channels, for
// chunks of CI_T input channels; warps WM x WN, each MW m-tiles x NW n-tiles.
template <int CI_T_, int NT_, int TH_, int MW_, int NW_, int MINB_>
struct Cfg {
  static constexpr int CI_T = CI_T_, NT = NT_, TH = TH_, TW = 40, MW = MW_, NW = NW_;
  static constexpr int MINB = MINB_;                // blocks an SM must hold (register cap)
  static constexpr int CO_T = 8 * NT;
  static constexpr int SW = TW / 8;                 // 8-pixel segments of a row
  static constexpr int MT = TH / 2 * SW;            // m-tiles: 2 rows x 8 columns
  static constexpr int WM = MT / MW, WN = NT / NW;
  static_assert(TH % 2 == 0 && WM * MW == MT && WN * NW == NT, "warps must tile the block");
  static_assert(NW == 1 || NW % 2 == 0, "n-tiles are read in pairs");
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int HR = TH + 2;                 // halo rows
  static constexpr int PS = CI_T == 16 ? 3 : 1;     // halo pixel / weight row stride, units
  // Halo row stride, pixels. Ci = 1 keeps 7 spare columns on the left so
  // that 8-pixel segments store as aligned 16-byte vectors.
  static constexpr int HC = CI_T == 16 ? TW + 2 : CI_T == 8 ? TW + 3 : TW + 16;
  static constexpr int HALO = CI_T == 1 ? HR * HC * 2 : HR * HC * PS * 16;  // bytes
  static constexpr int WTAPS = CI_T == 8 ? 10 : 9;  // CI_T = 8: a zero tenth tap
  static constexpr int WBYTES = CI_T == 1 ? 0 : WTAPS * CO_T * PS * 16;
  static constexpr int KS = CI_T == 16 ? 9 : CI_T == 8 ? 5 : 1;  // k-steps of a chunk
  static constexpr int NPAIR = CI_T == 1 ? 1 : CI_T / 2;  // channel pairs of a halo item
  static constexpr int X_ITEMS = NPAIR * HR * (SW + 2);    // segments -1 .. SW
  static constexpr int W_ITEMS = CI_T == 1 ? 0 : 9 * CO_T * (CI_T / 8);
  static constexpr int PO = odd_at_least(TH * SW);  // output plane, units (odd)
  static constexpr int O_ITEMS = CO_T * TH * SW;
  static constexpr int OUT = CO_T * PO * 16;
  static constexpr int SMEM = HALO + WBYTES > OUT ? HALO + WBYTES : OUT;
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

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Pixels w .. w + 7 of an image row (bf16 bits), zero outside [0, W).
// `vec`: W is a multiple of 8 and the row 16-byte aligned, so the segment is
// whole or absent and loads as one vector.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int w, int W, bool vec) {
  if (vec) {
    return w >= 0 && w < W ? __ldg(reinterpret_cast<const uint4*>(row + w))
                           : make_uint4(0, 0, 0, 0);
  }
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = w + 2 * k;
    const uint32_t lo = a >= 0 && a < W ? __ldg(row + a) : 0u;
    const uint32_t hi = a + 1 >= 0 && a + 1 < W ? __ldg(row + a + 1) : 0u;
    v[k] = lo | hi << 16;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One chunk's staging data in registers: the x halo items and, for CI_T >
// 1, the weight vectors of this thread.
template <class C>
struct Staged {
  static constexpr int XS = (C::X_ITEMS + C::THREADS - 1) / C::THREADS;
  static constexpr int WS = C::W_ITEMS == 0 ? 1 : (C::W_ITEMS + C::THREADS - 1) / C::THREADS;
  uint4 lo[XS], hi[XS], wv[WS];
};

// Load chunk `chunk` (input channels c0 = chunk * CI_T ..) into registers:
// the halo of tile (b, h0, w0) and, for CI_T > 1, the chunk's weights of
// output channels co0 ...
template <class C>
__device__ __forceinline__ void load_chunk(Staged<C>& st, const uint16_t* __restrict__ x,
                                           const uint16_t* __restrict__ w, int b, int h0,
                                           int w0, int chunk, int co0, int Ci, int cop, int H,
                                           int W, bool vec) {
  const size_t plane = static_cast<size_t>(H) * W;
  const int c0 = chunk * C::CI_T;
#pragma unroll
  for (int j = 0; j < Staged<C>::XS; ++j) {
    // Item (channel pair, halo row r, segment s): lanes take the pairs
    // first, then the rows.
    const int i = threadIdx.x + j * C::THREADS;
    const int c = c0 + (C::CI_T == 1 ? 0 : 2 * (i % C::NPAIR));
    const int gh = h0 + i / C::NPAIR % C::HR - 1;
    const int gw = w0 + 8 * (i / (C::NPAIR * C::HR) - 1);
    st.lo[j] = st.hi[j] = make_uint4(0, 0, 0, 0);
    if (i < C::X_ITEMS && gh >= 0 && gh < H) {
      const uint16_t* row = x + (static_cast<size_t>(b) * Ci + c) * plane +
                            static_cast<size_t>(gh) * W;
      if (c < Ci) st.lo[j] = load8(row, gw, W, vec);
      if (C::CI_T > 1 && c + 1 < Ci) st.hi[j] = load8(row + plane, gw, W, vec);
    }
  }
  if constexpr (C::CI_T > 1) {
#pragma unroll
    for (int j = 0; j < Staged<C>::WS; ++j) {
      // Item (half h of the chunk's channels, output channel co, tap): one
      // 16-byte vector of the packed weights, consecutive in memory.
      const int q = threadIdx.x + j * C::THREADS;
      const int h = q % (C::CI_T / 8);
      const int co = q / (C::CI_T / 8) % C::CO_T;
      const int tap = q / (C::CI_T / 8 * C::CO_T);
      st.wv[j] = make_uint4(0, 0, 0, 0);
      if (q < C::W_ITEMS && co0 + co < cop)
        st.wv[j] = __ldg(reinterpret_cast<const uint4*>(
            w + ((static_cast<size_t>(chunk) * 9 + tap) * cop + co0 + co) * C::CI_T + 8 * h));
    }
  }
}

// Store a loaded chunk into shared memory: the halo with the channels
// innermost (Ci = 1: plain pixels), the weights [tap][co][CI_T].
template <class C>
__device__ __forceinline__ void store_chunk(const Staged<C>& st, unsigned char* smem) {
#pragma unroll
  for (int j = 0; j < Staged<C>::XS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    if (i >= C::X_ITEMS) continue;
    const int pair = i % C::NPAIR;
    const int r = i / C::NPAIR % C::HR;
    const int s = i / (C::NPAIR * C::HR) - 1;  // -1 .. SW
    if constexpr (C::CI_T == 1) {
      *reinterpret_cast<uint4*>(smem + 2 * (r * C::HC + 8 * (s + 1))) = st.lo[j];
    } else {
      // Pixel 8 s + k of the tile is halo column 8 s + k + 1; of the edge
      // segments only the halo's first and last column are kept.
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if ((s < 0 && k != 7) || (s == C::SW && k != 0)) continue;
        const uint32_t v = __byte_perm(word(st.lo[j], k / 2), word(st.hi[j], k / 2),
                                       k % 2 ? 0x7632 : 0x5410);
        *reinterpret_cast<uint32_t*>(smem + (r * C::HC + 8 * s + k + 1) * C::PS * 16 +
                                     4 * pair) = v;
      }
    }
  }
  if constexpr (C::CI_T > 1) {
    unsigned char* ws = smem + C::HALO;
#pragma unroll
    for (int j = 0; j < Staged<C>::WS; ++j) {
      const int q = threadIdx.x + j * C::THREADS;
      if (q >= C::W_ITEMS) continue;
      const int h = q % (C::CI_T / 8);
      const int co = q / (C::CI_T / 8) % C::CO_T;
      const int tap = q / (C::CI_T / 8 * C::CO_T);
      *reinterpret_cast<uint4*>(ws + ((tap * C::CO_T + co) * C::PS + h) * 16) = st.wv[j];
    }
  }
}

// x (B, Ci, H, W) bf16; w (ceil(Ci / CI_T), 9, cop, CI_T) bf16, cop = Co
// rounded up to 8, zero-padded; bias (Co,) f32; y (B, Co, H, W) bf16.
// grid = (ceil(Co / CO_T), ceil(H / TH) * ceil(W / TW), B): the channel
// blocks of one tile run side by side and share its halo in L2.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
conv3x3_mma_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                 const float* __restrict__ bias, uint16_t* __restrict__ y, int Ci, int Co,
                 int H, int W, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % C::WN, wm = warp / C::WN;
  const int co0 = blockIdx.x * C::CO_T;
  const int tiles_w = (W + C::TW - 1) / C::TW;
  const int w0 = blockIdx.y % tiles_w * C::TW;
  const int h0 = blockIdx.y / tiles_w * C::TH;
  const int b = blockIdx.z;
  const int cop = (Co + 7) / 8 * 8;
  const bool vec = W % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair

  float acc[C::MW][C::NW][4];
#pragma unroll
  for (int i = 0; i < C::MW; ++i)
#pragma unroll
    for (int f = 0; f < C::NW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

  Staged<C> st;
  load_chunk<C>(st, x, w, b, h0, w0, 0, co0, Ci, cop, H, W, vec);
  if constexpr (C::CI_T == 1) {
    store_chunk<C>(st, smem);
    // B: k = tap (9 of 16), n = output channel g of each n-tile; taps 9..15
    // are zero.
    uint32_t bf[C::NW][2];
#pragma unroll
    for (int f = 0; f < C::NW; ++f) {
      const int co = co0 + (wn * C::NW + f) * 8 + g;
      bf[f][0] = bf[f][1] = 0;
      if (co < cop) {
        const uint32_t hi = __ldg(w + (2 * t + 1) * cop + co);
        bf[f][0] = __ldg(w + 2 * t * cop + co) | hi << 16;
        if (t == 0) bf[f][1] = __ldg(w + 8 * cop + co);
      }
    }
    __syncthreads();
    // A: row = pixel, k = tap. Halo element of output pixel (r, c) at tap
    // (kh, kw): (r + kh) * HC + c + kw + 7.
    const uint16_t* hs = reinterpret_cast<const uint16_t*>(smem);
    auto off = [](int k) { return k / 3 * C::HC + k % 3 + 7; };
    const int o0 = off(2 * t), o1 = off(2 * t + 1);
#pragma unroll
    for (int i = 0; i < C::MW; ++i) {
      const int q = wm * C::MW + i;
      const int p = 2 * (q / C::SW) * C::HC + 8 * (q % C::SW) + g;
      uint32_t a[4];
      a[0] = hs[p + o0] | static_cast<uint32_t>(hs[p + o1]) << 16;
      a[1] = hs[p + C::HC + o0] | static_cast<uint32_t>(hs[p + C::HC + o1]) << 16;
      a[2] = t == 0 ? hs[p + off(8)] : 0u;
      a[3] = t == 0 ? hs[p + C::HC + off(8)] : 0u;
#pragma unroll
      for (int f = 0; f < C::NW; ++f) mma_bf16(acc[i][f], a, bf[f][0], bf[f][1]);
    }
  } else {
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    if constexpr (C::CI_T == 8) {  // the zero tenth tap
      for (int i = threadIdx.x; i < C::CO_T; i += C::THREADS)
        *reinterpret_cast<uint4*>(smem + C::HALO + (9 * C::CO_T + i) * 16) =
            make_uint4(0, 0, 0, 0);
    }
    // ldmatrix rows. A: lanes 8q .. 8q + 7 give matrix q, rows 0..7 (q even)
    // or 8..15 of the m-tile, i.e. pixel row q % 2 of the two, column lane %
    // 8; q / 2 picks channels 8..15 (CI_T = 16) or the k-step's second tap
    // (CI_T = 8).
    const int a_hi = lane / 16;
    uint32_t a_row[C::MW];
#pragma unroll
    for (int i = 0; i < C::MW; ++i) {
      const int q = wm * C::MW + i;
      const int pix = (2 * (q / C::SW) + lane / 8 % 2) * C::HC + 8 * (q % C::SW) + lane % 8;
      a_row[i] = base + (pix * C::PS + (C::CI_T == 16 ? a_hi : 0)) * 16;
    }
    // B: matrix q of an x4 is n-tile 2p + q / 2 of the warp's pair p, k half
    // q % 2 (channels 8..15, or the second tap); an x2 reads lanes 0..15.
    constexpr int NPB = (C::NW + 1) / 2;
    const int b_hi = lane / 8 % 2;
    uint32_t b_row[NPB];
#pragma unroll
    for (int p = 0; p < NPB; ++p) {
      const int co = (wn * C::NW + 2 * p + (C::NW > 1 ? lane / 16 : 0)) * 8 + lane % 8;
      b_row[p] = base + C::HALO +
                 (C::CI_T == 16 ? (co * 3 + b_hi) * 16 : (b_hi * C::CO_T + co) * 16);
    }
    // Byte offset of tap k in the halo.
    auto tap_off = [](int k) { return (k / 3 * C::HC + k % 3) * C::PS * 16; };

    const int n_chunks = (Ci + C::CI_T - 1) / C::CI_T;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      // Loads first: they are in flight while the block waits for its
      // slowest warp to finish the previous chunk.
      if (chunk > 0) load_chunk<C>(st, x, w, b, h0, w0, chunk, co0, Ci, cop, H, W, vec);
      __syncthreads();  // the previous chunk's fragments are read
      store_chunk<C>(st, smem);
      __syncthreads();
      // This chunk's products in a fresh accumulator, added to acc below.
      float d[C::MW][C::NW][4];
#pragma unroll
      for (int i = 0; i < C::MW; ++i)
#pragma unroll
        for (int f = 0; f < C::NW; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][f][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        uint32_t a_off, b_off;
        if constexpr (C::CI_T == 16) {
          a_off = tap_off(ks);
          b_off = ks * C::CO_T * 3 * 16;
        } else {
          const int k2 = 2 * ks + 1 < 9 ? 2 * ks + 1 : 8;  // the tenth tap's A: any finite row
          a_off = a_hi ? tap_off(k2) : tap_off(2 * ks);
          b_off = 2 * ks * C::CO_T * 16;
        }
        uint32_t a[C::MW][4], bf[C::NW][2];
#pragma unroll
        for (int i = 0; i < C::MW; ++i) ldsm_x4(a[i], a_row[i] + a_off);
        if constexpr (C::NW == 1) {
          ldsm_x2(bf[0][0], bf[0][1], b_row[0] + b_off);
        } else {
#pragma unroll
          for (int p = 0; p < NPB; ++p) {
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
  }

  // Epilogue. C fragment: element e is pixel row e / 2 of the m-tile, column
  // g, output channel 2 t + e % 2 of the n-tile. Bias, ReLU and the rounding
  // to bf16 here; the tile [CO_T][TH][TW] then leaves in 8-pixel vectors.
  __syncthreads();  // every fragment is read: the staging buffers are free
  uint16_t* out = reinterpret_cast<uint16_t*>(smem);
#pragma unroll
  for (int f = 0; f < C::NW; ++f)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int n = (wn * C::NW + f) * 8 + 2 * t + e2;
      const float bv = co0 + n < Co ? bias[co0 + n] : 0.f;
#pragma unroll
      for (int i = 0; i < C::MW; ++i) {
        const int q = wm * C::MW + i;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = acc[i][f][2 * half + e2] + bv;
          if (relu) v = fmaxf(v, 0.f);
          out[n * C::PO * 8 + (2 * (q / C::SW) + half) * C::TW + 8 * (q % C::SW) + g] =
              __bfloat16_as_ushort(__float2bfloat16_rn(v));
        }
      }
    }
  __syncthreads();
  const size_t plane = static_cast<size_t>(H) * W;
  for (int i = threadIdx.x; i < C::O_ITEMS; i += C::THREADS) {
    const int n = i / (C::TH * C::SW);
    const int r = i / C::SW % C::TH;
    const int s = i % C::SW;
    const int gh = h0 + r, gw = w0 + 8 * s;
    if (co0 + n >= Co || gh >= H || gw >= W) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(out + (n * C::PO + r * C::SW + s) * 8);
    uint16_t* dst = y + (static_cast<size_t>(b) * Co + co0 + n) * plane +
                    static_cast<size_t>(gh) * W + gw;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (gw + k < W) dst[k] = static_cast<uint16_t>(word(v, k / 2) >> (16 * (k % 2)));
    }
  }
}

// The tile of a shape: CI_T by Ci (1 for Ci = 1, 8 up to 8, else 16: the
// order of K, which the host's weight packing follows,
// ops/kernels/conv2d.py::ci_tile), NT by Co. Shapes past the UNet's (Ci = 1
// with Co > 8; Ci <= 8 with Co > 16) take more channel blocks. Calls
// fn(Cfg{}, kernel).
template <typename Fn>
auto with_cfg(int Ci, int Co, Fn fn) {
#define MM_CONV_CFG(...) \
  return fn(Cfg<__VA_ARGS__>{}, conv3x3_mma_bf16<Cfg<__VA_ARGS__>>)
  if (Ci == 1) MM_CONV_CFG(1, 1, 16, 4, 1, 1);
  if (Ci <= 8) {
    if (Co <= 8) MM_CONV_CFG(8, 1, 8, 2, 1, 3);
    MM_CONV_CFG(8, 2, 8, 2, 2, 3);
  }
  if (Co <= 8) MM_CONV_CFG(16, 1, 8, 2, 1, 2);
  if (Co <= 16) MM_CONV_CFG(16, 2, 8, 2, 2, 2);
  if (Co <= 32) MM_CONV_CFG(16, 4, 8, 2, 4, 1);
  MM_CONV_CFG(16, 8, 8, 5, 4, 1);
#undef MM_CONV_CFG
}

}  // namespace

// Shared bytes of one block for Ci input and Co output channels; the host
// refuses a shape above the 227 KB a block may have before launching.
extern "C" size_t mm_conv3x3_bf16_smem_bytes(int Ci, int Co) {
  return with_cfg(Ci, Co, [](auto cfg, auto) {
    return static_cast<size_t>(decltype(cfg)::SMEM);
  });
}

// x, y bf16 (B, Ci, H, W) and (B, Co, H, W); w bf16 packed by
// ops/kernels/conv2d.py::pack_weight_bf16; bias f32 (Co,).
extern "C" int mm_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y, int B,
                               int Ci, int Co, int H, int W, int relu, void* stream) {
  return with_cfg(Ci, Co, [&](auto cfg, auto kernel) {
    using C = decltype(cfg);
    const int status = mm::opt_in_smem(reinterpret_cast<const void*>(kernel), C::SMEM);
    if (status != 0) return status;
    const dim3 grid((Co + C::CO_T - 1) / C::CO_T,
                    ((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW), B);
    kernel<<<grid, C::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
        static_cast<const float*>(bias), static_cast<uint16_t*>(y), Ci, Co, H, W, relu);
    return static_cast<int>(cudaGetLastError());
  });
}
