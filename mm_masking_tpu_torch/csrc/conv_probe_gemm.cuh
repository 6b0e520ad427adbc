// The bfloat16 implicit GEMM of the conv probes that read their taps straight
// from a staged halo: P3 (conv_probe_halo.cu), P2's tap-dots
// (conv_probe_nhcw.cu) and P4 (conv_probe_flat.cu). One body, templated over
// where the image's rows lie (NHCW or NCHW) and over how many taps share one
// fresh accumulator.
//
// A 3x3 SAME conv (no bias, optional ReLU) on mma.sync.m16n8k16 with float32
// sums, as K2's bfloat16 kernel (conv3x3_bf16_tc.cu). M is 16 consecutive
// pixels of one output row, N the output channels (NT n-tiles of 8, up to 64
// a block), K the 9 taps times the input channels in chunks of 16 (zero past
// Ci), one k16 step a (tap, chunk). There is no im2col stack: a block walks
// G row tiles of TH rows of one (b, W tile of WT columns); each tile's
// (TH + 2)-row slab is copied with 16-byte cp.async vectors (coalesced along
// W, one vector beyond each side of the tile) and transposed once in shared
// memory into a halo with the channels innermost, (TH + 2) rows x (WT + 2)
// pixels, a pixel 16 bytes a unit of 8 channels and an odd number of units
// apart, so that a tap's shift along W moves whole 16-byte rows and the 8 rows
// of every ldmatrix fall in 8 different bank groups. Outside the image the
// halo holds zeros: the SAME padding, and P4's row-edge mask, which zeroes
// exactly the taps that cross a row's end. NHCW and NCHW tiles differ only in
// their strides: a (row, channel) of the slab is one W-run of x either way.
//
// The weights arrive in bf16, packed as K2's (ops/kernels/conv2d.py::
// pack_weight_bf16 with chunks of 16), and stay in shared memory for the
// block's life. GT taps of one chunk go into a fresh accumulator, added to
// the running sums in float32 registers (the tensor cores' sums round toward
// zero): GT = 9 sums each chunk's nine taps at once (P3, P4 with ndot 1), 3
// one di row of taps (P4 with ndot 3: three K = 3 Ci sums added in di order),
// 1 each tap on its own (tap-dots: nine K = Ci sums added in (di, dj)
// order). The tile's outputs go through shared memory and leave as 16-byte
// rows of 8 pixels along W. With ring, the copy of tile i + 1's slab is in
// flight while tile i is contracted (a two-stage cp.async ring); without it a
// block copies each tile's slab only when its turn comes.
#pragma once

#include <type_traits>

#include "conv_probe.cuh"

namespace probe {

constexpr int CI_T = 16;  // input channels of a K chunk
constexpr int WROW = 48;  // bytes of one (tap, output channel) weight row: 2 units + 1 spare

// Where the image's rows lie: x (B, H, C, W) or (B, C, H, W), y likewise.
enum Layout { NHCW = 0, NCHW = 1 };

// Pixel stride of the halo in 16-byte units: the chunks' units, made odd.
__host__ __device__ inline int halo_units(int n_chunks) { return 2 * n_chunks + 1; }

// One block's shared memory, in bytes: the weights, the halo, the output
// tile and one (ring = 0) or two slab slots. All offsets are multiples of 16
// bytes.
struct SmemHalo {
  size_t weights, halo, out, slot;
  __host__ __device__ SmemHalo(int Ci, int NT, int TH, int Wt) {
    const int n_chunks = (Ci + CI_T - 1) / CI_T;
    weights = static_cast<size_t>(n_chunks) * 9 * NT * 8 * WROW;
    halo = static_cast<size_t>(TH + 2) * (Wt + 2) * halo_units(n_chunks) * 16;
    out = static_cast<size_t>(TH) * NT * 8 * (Wt + 8) * 2;
    slot = static_cast<size_t>(TH + 2) * Ci * (Wt + 2 * vec_elems<__nv_bfloat16>()) * 2;
  }
  __host__ __device__ size_t total(bool ring) const {
    return weights + halo + out + (ring ? 2 : 1) * slot;
  }
};

// SIZE_MAX for a Wt that is no whole number of m-tiles up to 128 columns.
inline size_t halo_smem_bytes(int Ci, int Co, int TH, int Wt, bool ring) {
  if (Wt != 16 && Wt != 32 && Wt != 64 && Wt != 128) return SIZE_MAX;
  return SmemHalo(Ci, n_tiles(Co), TH, Wt).total(ring);
}

// x with hx = H (or, padded, H + 2: a zero row above and below) rows and y
// (H rows) bf16 in LAYOUT; w bf16 (ceil(Ci / 16), 9, cop, 16), cop = Co
// rounded up to 8, zero-padded. A block takes NT n-tiles of output channels,
// WT columns and row tiles first .. last - 1 of TH rows; grid = (ceil(W / WT),
// ceil((H / TH) / G), B * co_groups).
template <int NT, int WT, int LAYOUT, int GT>
__device__ __forceinline__ void halo_gemm(const __nv_bfloat16* __restrict__ x,
                                          const uint16_t* __restrict__ w,
                                          __nv_bfloat16* __restrict__ y, int H, int Ci, int Co,
                                          int W, int TH, int G, int relu, int vec, int ring,
                                          int padded) {
  static_assert(GT == 1 || GT == 3 || GT == 9, "taps a fresh accumulator takes");
  constexpr int V = vec_elems<__nv_bfloat16>();
  constexpr int WARPS = THREADS / 32;
  constexpr int CO_T = 8 * NT;
  // m-tiles a warp takes at once: up to 8 n-tiles' worth, at most 4, so
  // that a tile of 32 m-tiles (TH 8 x 64 columns, TH 16 x 32) keeps all 8
  // warps busy at Co <= 8 too.
  constexpr int MW = NT >= 8 ? 1 : NT >= 2 ? 8 / NT : 4;
  constexpr int HC = WT + 2, SO = WT + 8, S = WT + 2 * V, SEGS = WT / 16;
  constexpr int NV = S / V;  // 16-byte vectors of a slab row: the tile's and one each side
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // C fragment row group, column pair
  const int n_chunks = (Ci + CI_T - 1) / CI_T, psu = halo_units(n_chunks);
  const int cop = (Co + 7) / 8 * 8;
  const int co_groups = (Co + CO_T - 1) / CO_T;
  const int b = blockIdx.z / co_groups, co0 = blockIdx.z % co_groups * CO_T;
  const int w0 = blockIdx.x * WT;
  const int first = blockIdx.y * G, last = min(H / TH, first + G);
  const int mt_count = TH * SEGS;
  const int hx = padded ? H + 2 : H;  // rows of x

  const SmemHalo lay(Ci, NT, TH, WT);
  unsigned char* wsm = smem;
  unsigned char* halo = wsm + lay.weights;
  uint16_t* out = reinterpret_cast<uint16_t*>(halo + lay.halo);
  __nv_bfloat16* slabs = reinterpret_cast<__nv_bfloat16*>(halo + lay.halo + lay.out);
  const size_t slot = lay.slot / 2;  // elements
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * hx * Ci * W;
  // x's W-run of (row h, channel c); with NCHW the copies walk a channel's
  // rows, which lie one after another, before the next channel.
  auto x_row = [&](int h, int c) {
    return LAYOUT == NHCW ? xb + (static_cast<size_t>(h) * Ci + c) * W
                          : xb + (static_cast<size_t>(c) * hx + h) * W;
  };
  auto slab_rc = [&](int r, int& rr, int& c) {  // copy r → (halo row, channel)
    if constexpr (LAYOUT == NHCW) {
      rr = r / Ci;
      c = r % Ci;
    } else {
      c = r / (TH + 2);
      rr = r % (TH + 2);
    }
  };

  // Rows i * TH - 1 .. i * TH + TH of the image (x's rows i * TH .. of a
  // padded x), columns w0 - V .. w0 + WT + V - 1, into slab slot s, row
  // (halo row, channel) S elements apart; zeros outside x's rows and outside
  // [0, W). With vec (W a multiple of 8, x 16-byte aligned) every 16-byte
  // vector lies wholly inside or outside the row and goes by cp.async;
  // otherwise element by element.
  auto fetch = [&](int i, int s) {
    __nv_bfloat16* dst = slabs + s * slot;
    const int rows = (TH + 2) * Ci;
    const int h0 = i * TH - 1 + padded;  // x's row of halo row 0
    if (vec) {
      for (int q = threadIdx.x; q < rows * NV; q += THREADS) {
        int rr, c;
        slab_rc(q / NV, rr, c);
        const int h = h0 + rr, gw = w0 - V + q % NV * V;
        __nv_bfloat16* d = dst + (rr * Ci + c) * S + q % NV * V;
        if (h >= 0 && h < hx && gw >= 0 && gw < W) {
          cp_async16(d, x_row(h, c) + gw);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      for (int q = threadIdx.x; q < rows * HC; q += THREADS) {
        int rr, c;
        slab_rc(q / HC, rr, c);
        const int h = h0 + rr, gw = w0 - 1 + q % HC;
        dst[(rr * Ci + c) * S + V - 1 + q % HC] =
            h >= 0 && h < hx && gw >= 0 && gw < W ? x_row(h, c)[gw] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  if (ring) fetch(first, 0);
  // The block's weights, [chunk][tap][co][16 channels], rows WROW bytes apart.
  for (int q = threadIdx.x; q < n_chunks * 9 * CO_T * 2; q += THREADS) {
    const int h = q % 2, co = q / 2 % CO_T, ct = q / (2 * CO_T);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (co0 + co < cop)
      v = __ldg(reinterpret_cast<const uint4*>(w + (static_cast<size_t>(ct) * cop + co0 + co) *
                                                       CI_T + 8 * h));
    *reinterpret_cast<uint4*>(wsm + (ct * CO_T + co) * WROW + 16 * h) = v;
  }
  const uint32_t halo_s = static_cast<uint32_t>(__cvta_generic_to_shared(halo));
  const uint32_t w_s = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));
  // ldmatrix rows. A: lanes 8q .. 8q + 7 address matrix q: pixels 8 (q % 2)
  // .. of the m-tile, channel half q / 2 of the chunk. B: matrix q of an x4
  // is n-tile 2p + q / 2 of pair p, channel half q % 2.
  const int a_pix = lane / 8 % 2 * 8 + lane % 8, a_half = lane / 16;
  const int b_co = (NT > 1 ? lane / 16 : 0) * 8 + lane % 8, b_half = lane / 8 % 2;

  for (int i = first; i < last; ++i) {
    const int s = ring ? (i - first) & 1 : 0;
    if (!ring) {
      fetch(i, 0);
      cp_async_wait<0>();
    } else if (i + 1 < last) {
      fetch(i + 1, s ^ 1);  // slot s ^ 1 was last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i's slab (and, at first, the weights) is in place
    // The slab into the halo: pixel p (column w0 - 1 + p) of halo row r at
    // (r * HC + p) * psu units, 8 channels a unit, zero past Ci.
    const __nv_bfloat16* slab = slabs + s * slot;
    for (int q = threadIdx.x; q < (TH + 2) * HC; q += THREADS) {
      const int p = q % HC, r = q / HC;
      const __nv_bfloat16* src = slab + static_cast<size_t>(r) * Ci * S + V - 1 + p;
      for (int u = 0; u < 2 * n_chunks; ++u) {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 8 * u + 2 * k;
          const uint32_t lo = c < Ci ? __bfloat16_as_ushort(src[c * S]) : 0u;
          const uint32_t hi = c + 1 < Ci ? __bfloat16_as_ushort(src[(c + 1) * S]) : 0u;
          v[k] = lo | hi << 16;
        }
        *reinterpret_cast<uint4*>(halo + ((r * HC + p) * psu + u) * 16) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    // The products, MW m-tiles of the warp at a time; each group's outputs
    // go into the output tile [row][co][SO] in shared memory.
    for (int m0 = warp * MW; m0 < mt_count; m0 += WARPS * MW) {
      float acc[MW][NT][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
      for (int tap0 = 0; tap0 < 9; tap0 += GT) {
        for (int chunk = 0; chunk < n_chunks; ++chunk) {
          float d[MW][NT][4];  // GT taps of this chunk: a fresh accumulator
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[mi][n][e] = 0.f;
#pragma unroll
          for (int tap = tap0; tap < tap0 + GT; ++tap) {
            uint32_t bf[NT][2];
            const uint32_t b_addr =
                w_s + ((chunk * 9 + tap) * CO_T + b_co) * WROW + 16 * b_half;
            if constexpr (NT == 1) {
              ldsm_x2(bf[0][0], bf[0][1], b_addr);
            } else {
#pragma unroll
              for (int pr = 0; pr < NT / 2; ++pr) {
                uint32_t r[4];
                ldsm_x4(r, b_addr + 16 * WROW * pr);
                bf[2 * pr][0] = r[0];
                bf[2 * pr][1] = r[1];
                bf[2 * pr + 1][0] = r[2];
                bf[2 * pr + 1][1] = r[3];
              }
            }
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
              const int mt = m0 + mi;
              if (mt >= mt_count) break;
              const int row = mt / SEGS, col = mt % SEGS * 16 + a_pix;
              uint32_t a[4];
              ldsm_x4(a, halo_s + (((row + tap / 3) * HC + col + tap % 3) * psu + 2 * chunk +
                                   a_half) * 16);
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_bf16(d[mi][n], a, bf[n][0], bf[n][1]);
            }
          }
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][n][e] += d[mi][n][e];
        }
      }
      // C fragment element e: pixel g + 8 (e / 2) of the m-tile, output
      // channel 2 t + e % 2 of the n-tile.
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        const int mt = m0 + mi;
        if (mt >= mt_count) break;
        const int row = mt / SEGS, col = mt % SEGS * 16 + g;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = relu ? fmaxf(acc[mi][n][e], 0.f) : acc[mi][n][e];
            out[(row * CO_T + n * 8 + 2 * t + e % 2) * SO + col + 8 * (e / 2)] =
                __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
      }
    }
    __syncthreads();
    // The output tile leaves in 8-pixel rows along W.
    const int h0 = i * TH;
    for (int q = threadIdx.x; q < TH * CO_T * (WT / 8); q += THREADS) {
      const int sg = q % (WT / 8), co = q / (WT / 8) % CO_T, row = q / (WT / 8 * CO_T);
      const int gw = w0 + 8 * sg;
      if (co0 + co >= Co || gw >= W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(out + (row * CO_T + co) * SO + 8 * sg);
      const size_t at = LAYOUT == NHCW
                            ? ((static_cast<size_t>(b) * H + h0 + row) * Co + co0 + co) * W + gw
                            : ((static_cast<size_t>(b) * Co + co0 + co) * H + h0 + row) * W + gw;
      uint16_t* dst = reinterpret_cast<uint16_t*>(y) + at;
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
}

// Launch `kernel`, an instantiation of a __global__ wrapper of halo_gemm with
// the same arguments, on a block of `ring ? two : one` slab slots.
template <int NT, int WT, typename Kernel>
int launch_halo_gemm(Kernel kernel, const void* x, const void* w, void* y, int B, int H, int Ci,
                     int Co, int W, int TH, int G, int relu, int vec, int ring, int padded,
                     cudaStream_t stream) {
  const size_t bytes = SmemHalo(Ci, NT, TH, WT).total(ring != 0);
  const int status = smem_opt_in(kernel, bytes);
  if (status != 0) return status;
  const dim3 grid((W + WT - 1) / WT, (H / TH + G - 1) / G, B * ((Co + 8 * NT - 1) / (8 * NT)));
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                            static_cast<const uint16_t*>(w),
                                            static_cast<__nv_bfloat16*>(y), H, Ci, Co, W, TH, G,
                                            relu, vec, ring, padded);
  return static_cast<int>(cudaGetLastError());
}

// f(NT, WT) with NT = n_tiles(Co) and WT = Wt as std::integral_constant,
// so that one generic lambda instantiates a kernel for each; an error code
// for a Wt that is no whole number of m-tiles up to 128 columns.
template <typename F>
int with_tile(int Co, int Wt, F f) {
  auto wt = [&](auto nt) {
    switch (Wt) {
      case 16: return f(nt, std::integral_constant<int, 16>{});
      case 32: return f(nt, std::integral_constant<int, 32>{});
      case 64: return f(nt, std::integral_constant<int, 64>{});
      case 128: return f(nt, std::integral_constant<int, 128>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (n_tiles(Co)) {
    case 1: return wt(std::integral_constant<int, 1>{});
    case 2: return wt(std::integral_constant<int, 2>{});
    case 4: return wt(std::integral_constant<int, 4>{});
    default: return wt(std::integral_constant<int, 8>{});
  }
}

}  // namespace probe
