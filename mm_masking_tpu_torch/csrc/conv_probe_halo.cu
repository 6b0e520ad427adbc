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
// bfloat16 (probe_halo_mma_bf16): an implicit GEMM on mma.sync.m16n8k16
// with float32 sums, as K2's bfloat16 kernel (conv3x3_bf16_tc.cu). M is 16
// consecutive pixels of one output row, N the output channels (NT n-tiles
// of 8, up to 64 a block), K the 9 taps times the input channels in chunks
// of 16 (zero past Ci), one k16 step a tap. There is no im2col stack: each
// tile's slab is transposed once in shared memory into a halo with the
// channels innermost, (TH + 2) rows x (Wt + 2) pixels, a pixel 16 bytes a
// unit of 8 channels and an odd number of units apart, so that a tap's shift
// along W moves whole 16-byte rows and the 8 rows of every ldmatrix fall in
// 8 different bank groups. The weights arrive in bf16, packed as K2's
// (ops/kernels/conv2d.py::pack_weight_bf16 with chunks of 16), and stay in
// shared memory for the block's life. Each chunk's 9 k-steps go into a fresh
// accumulator, added to the running sums in float32 registers (the tensor
// cores' sums round toward zero). The tile's outputs go through shared
// memory and leave as 16-byte rows of 8 pixels along W. The slab's copy
// takes whole 16-byte vectors, one beyond each side of the tile's columns,
// so that no load waits in the ring. With ring = 0 a block copies each
// tile's slab only when its turn comes: the variant without the prefetch.
// The tile's width is a template parameter (16 to 128 columns), so that the
// index arithmetic of the copies divides by constants.
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

constexpr int CI_T = 16;  // input channels of a K chunk: one k16 step a tap
constexpr int WARPS = THREADS / 32;
constexpr int WROW = 48;  // bytes of one (tap, output channel) weight row: 2 units + 1 spare

// Pixel stride of the halo in 16-byte units: the chunks' units, made odd.
__host__ __device__ inline int halo_units(int n_chunks) { return 2 * n_chunks + 1; }

// One block's shared memory, in bytes: the weights, the halo, the output
// tile and one (ring = 0) or two slab slots. All offsets are multiples
// of 16 bytes.
struct SmemBf16 {
  size_t weights, halo, out, slot;
  __host__ __device__ SmemBf16(int Ci, int NT, int TH, int Wt) {
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

size_t smem_bytes_bf16(int Ci, int Co, int TH, int Wt, bool ring) {
  if (Wt != 16 && Wt != 32 && Wt != 64 && Wt != 128) return SIZE_MAX;  // the kernel's widths
  return SmemBf16(Ci, n_tiles(Co), TH, Wt).total(ring);
}

// x (B, H, Ci, W) and y (B, H, Co, W) bf16; w bf16 (ceil(Ci / 16), 9, cop,
// 16), cop = Co rounded up to 8, zero-padded. A block takes NT n-tiles of
// output channels and WT columns; grid = (ceil(W / WT), ceil((H / TH) / G),
// B * co_groups).
template <int NT, int WT>
__global__ void __launch_bounds__(THREADS, 2)
probe_halo_mma_bf16(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int H, int Ci, int Co, int W, int TH, int G,
                    int relu, int vec, int ring) {
  constexpr int V = vec_elems<__nv_bfloat16>();
  constexpr int CO_T = 8 * NT;
  constexpr int MW = NT >= 8 ? 1 : 8 / NT;  // m-tiles a warp takes at once
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

  const SmemBf16 lay(Ci, NT, TH, WT);
  unsigned char* wsm = smem;
  unsigned char* halo = wsm + lay.weights;
  uint16_t* out = reinterpret_cast<uint16_t*>(halo + lay.halo);
  __nv_bfloat16* slabs = reinterpret_cast<__nv_bfloat16*>(halo + lay.halo + lay.out);
  const size_t slot = lay.slot / 2;  // elements
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * Ci * W;

  // Rows i * TH - 1 .. i * TH + TH of x, columns w0 - V .. w0 + WT + V - 1,
  // into slab slot s, row (halo row, channel) S elements apart; zeros above
  // and below the image and outside [0, W). With vec (W a multiple of 8, x
  // 16-byte aligned) every 16-byte vector lies wholly inside or outside the
  // row and goes by cp.async; otherwise element by element.
  auto fetch = [&](int i, int s) {
    __nv_bfloat16* dst = slabs + s * slot;
    const int rows = (TH + 2) * Ci;
    if (vec) {
      for (int q = threadIdx.x; q < rows * NV; q += THREADS) {
        const int r = q / NV, gw = w0 - V + q % NV * V;
        const int h = i * TH - 1 + r / Ci;
        __nv_bfloat16* d = dst + r * S + q % NV * V;
        if (h >= 0 && h < H && gw >= 0 && gw < W) {
          cp_async16(d, xb + (static_cast<size_t>(h) * Ci + r % Ci) * W + gw);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      for (int q = threadIdx.x; q < rows * HC; q += THREADS) {
        const int r = q / HC, gw = w0 - 1 + q % HC;
        const int h = i * TH - 1 + r / Ci;
        dst[r * S + V - 1 + q % HC] =
            h >= 0 && h < H && gw >= 0 && gw < W
                ? xb[(static_cast<size_t>(h) * Ci + r % Ci) * W + gw]
                : __float2bfloat16(0.f);
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
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        float d[MW][NT][4];  // this chunk's fresh accumulator
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[mi][n][e] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
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
}

template <int NT, int WT>
int launch_bf16_cfg(const void* x, const void* w, void* y, int B, int H, int Ci, int Co, int W,
                    int TH, int G, int relu, int vec, int ring, cudaStream_t stream) {
  const size_t bytes = SmemBf16(Ci, NT, TH, WT).total(ring != 0);
  const auto kernel = probe_halo_mma_bf16<NT, WT>;
  const int status = smem_opt_in(kernel, bytes);
  if (status != 0) return status;
  const dim3 grid((W + WT - 1) / WT, (H / TH + G - 1) / G, B * ((Co + 8 * NT - 1) / (8 * NT)));
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                            static_cast<const uint16_t*>(w),
                                            static_cast<__nv_bfloat16*>(y), H, Ci, Co, W, TH, G,
                                            relu, vec, ring);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_bf16(const void* x, const void* w, void* y, int B, int H, int Ci, int Co, int W,
                int TH, int Wt, int G, int relu, int vec, int ring, cudaStream_t stream) {
  switch (Wt) {
    case 16:
      return launch_bf16_cfg<NT, 16>(x, w, y, B, H, Ci, Co, W, TH, G, relu, vec, ring, stream);
    case 32:
      return launch_bf16_cfg<NT, 32>(x, w, y, B, H, Ci, Co, W, TH, G, relu, vec, ring, stream);
    case 64:
      return launch_bf16_cfg<NT, 64>(x, w, y, B, H, Ci, Co, W, TH, G, relu, vec, ring, stream);
    case 128:
      return launch_bf16_cfg<NT, 128>(x, w, y, B, H, Ci, Co, W, TH, G, relu, vec, ring, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);  // whole m-tiles, at most 128 columns
  }
}

}  // namespace

// Shared bytes of one block (float32: elem 4; bfloat16: elem 2, with the
// ring's two slab slots, SIZE_MAX for a Wt that is no multiple of 16): the
// host picks Wt by it.
extern "C" size_t mm_probe_halo_smem_bytes(int Ci, int Co, int TH, int Wt, int elem) {
  return elem == 2 ? smem_bytes_bf16(Ci, Co, TH, Wt, true) : smem_bytes(Ci, Co, TH, Wt, elem);
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
  const auto st = static_cast<cudaStream_t>(stream);
  switch (n_tiles(Co)) {
    case 1: return launch_bf16<1>(x, w, y, B, H, Ci, Co, W, TH, Wt, G, relu, vec, ring, st);
    case 2: return launch_bf16<2>(x, w, y, B, H, Ci, Co, W, TH, Wt, G, relu, vec, ring, st);
    case 4: return launch_bf16<4>(x, w, y, B, H, Ci, Co, W, TH, Wt, G, relu, vec, ring, st);
    default: return launch_bf16<8>(x, w, y, B, H, Ci, Co, W, TH, Wt, G, relu, vec, ring, st);
  }
}
