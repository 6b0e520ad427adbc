// 3x3 SAME stride-1 convolution with bias and optional fused ReLU, NCHW,
// float32, on the tensor cores.
//
// Replaces: mm_masking_tpu/ops/pallas/conv2d.py::_conv_nhcw_raw (kernel body
// _fwd_kernel, pallas_call at :152) for float32 inputs, in both of the conv's
// uses: the forward and, on the rotated and transposed weight, the
// backward's dx. bfloat16 inputs stay on the direct kernel of conv3x3.cu.
//
// What bounds it on this card: from 16 channels on, a stage does 18*Ci*Co
// operations per pixel for 4*(Ci + Co) bytes, far above the H100's ratio of
// operations to bytes, so it is bound by the rate of float32 products: 67
// TFLOP/s on the CUDA cores, 495 / 3 = 165 on the tensor cores through
// 3xTF32. The 640^2 stages at 1..16 channels are bound by bytes.
//
// Design: an implicit GEMM on mma.sync.m16n8k8 TF32, float32-accurate by
// 3xTF32. Each operand v is split into big = tf32(v) and small =
// tf32(v - big), and each product is taken as small*big + big*small +
// big*big, in that order (the dropped small*small is ~2^-22 of the product;
// one TF32 product alone keeps ~2^-11). M is pixels, in strips of 16
// consecutive columns of one output row; N is output channels, in fragments
// of 8; K is input channels, 8 per step, looped over 9 taps x ceil(Ci / 8)
// chunks. The three products of a tap go into a fresh accumulator, which is
// then added to the pixel's running sum in float32 registers: the tensor
// cores round their own float32 sums toward zero, and carried through all
// 27 * Ci / 8 products that bias grew with Ci to 2e-5 of max |y| at 256
// channels; added tap by tap, the sum is as exact as a plain float32 one.
//
// A block owns TH = 8 rows x TW columns (32 where W is a multiple of 32,
// else 16, so that the 40^2 and 80^2 stages waste fewer columns) and CO_T =
// 8 * NF output channels (Co rounded up to 8, at most 64). Each warp owns two
// strips and all CO_T channels, so one staged input chunk serves CO_T output
// channels. Per chunk of 8 input channels the block stages in shared memory
// the (TH + 2) x (TW + 2) halo, zero outside the image (the SAME padding) and
// past Ci (so Ci = 1 and Ci = 3 run the same code), and the chunk's 9 x 8 x
// CO_T weights, which the host packs zero-padded to (9, Ci up to 8, Co up to
// 8) so that they load as 16-byte vectors; both are split into big and small
// once, as they are staged, each part's global loads issued together before
// its stores. A tap's A fragment is read straight from the halo at row offset
// kh and column offset kw: there is no im2col stack. The halo's channel
// stride and the weights' row stride are 8 (mod 32) words, so the four
// k-columns of a fragment (lanes t = 0..3) fall in different banks. Within a
// tap, the products of two output-channel fragments are issued term by term,
// so that consecutive mma instructions are independent. The register count
// is left to the compiler (47 to 168 across the tiles, no spills): capping it
// at 128 for two blocks per SM spilled and ran slower. Staging is
// single-buffered: no cp.async ring, wgmma or TMA yet.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "smem_opt_in.cuh"

namespace {

constexpr int TH = 8;       // output rows of a block
constexpr int CK = 8;       // input channels of a chunk: one k-step of the mma
constexpr int STRIPS = 2;   // 16-column strips of a warp

// The least n' >= n with n' = 8 (mod 32): the fragment's k-columns t and
// t + 1 then lie 8 banks apart.
constexpr int pad_banks(int n) { return n + ((8 - n) % 32 + 32) % 32; }

template <int TW, int NF>
struct Tile {
  static constexpr int HR = TH + 2;                 // halo rows
  static constexpr int HC = TW + 2;                 // halo columns
  static constexpr int PLANE = pad_banks(HR * HC);  // halo channel stride, words
  static constexpr int CO_T = 8 * NF;
  static constexpr int FG = NF < 2 ? NF : 2;        // fragments of an mma group
  static constexpr int NS = pad_banks(CO_T);        // weight row stride, words
  static constexpr int THREADS = 32 * TH * (TW / 16) / STRIPS;
  static constexpr int HALO = CK * HR * HC;         // halo values of a chunk
  static constexpr int WVEC = 9 * CK * CO_T / 4;    // float4s of a chunk's weights
  // big and small halves of the halo [CK][PLANE] and of the weights
  // [9][CK][NS]
  static constexpr size_t SMEM = 2 * (CK * PLANE + 9 * CK * NS) * sizeof(uint32_t);
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v → (big, small) with big + small = v to ~2^-22 relative.
__device__ __forceinline__ void split(float v, uint32_t* big, uint32_t* small) {
  const uint32_t b = tf32(v);
  *big = b;
  *small = tf32(v - __uint_as_float(b));
}

// d = a (16 x 8, row) * b (8 x 8, col), TF32 operands, float32 sums.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += a * b.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x (B, Ci, H, W); w (9, Cip, Cop) zero-padded, tap = 3 * kh + kw, Cip and
// Cop the channel counts rounded up to 8; bias (Co,); y (B, Co, H, W).
// grid = (ceil(W / TW) * ceil(H / TH), ceil(Co / CO_T), B).
template <int TW, int NF>
__global__ void __launch_bounds__(Tile<TW, NF>::THREADS)
conv3x3_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y, int Ci, int Co,
                      int H, int W, int relu) {
  using T = Tile<TW, NF>;
  constexpr int HALO_STEPS = (T::HALO + T::THREADS - 1) / T::THREADS;
  constexpr int WVEC_STEPS = (T::WVEC + T::THREADS - 1) / T::THREADS;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* xs_big = smem;
  uint32_t* xs_small = xs_big + CK * T::PLANE;
  uint32_t* ws_big = xs_small + CK * T::PLANE;
  uint32_t* ws_small = ws_big + 9 * CK * T::NS;

  const int tiles_w = (W + TW - 1) / TW;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int co0 = blockIdx.y * T::CO_T;
  const int b = blockIdx.z;
  const int cip = (Ci + CK - 1) / CK * CK;
  const int cop = (Co + 7) / 8 * 8;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;  // fragment row group
  const int t = threadIdx.x % 4;         // fragment k-column (A, B) / column pair (C)

  // This warp's strips: row and first column within the tile.
  int srow[STRIPS], scol[STRIPS];
#pragma unroll
  for (int i = 0; i < STRIPS; ++i) {
    const int s = warp * STRIPS + i;
    srow[i] = s / (TW / 16);
    scol[i] = (s % (TW / 16)) * 16;
  }

  float acc[STRIPS][NF][4];
#pragma unroll
  for (int i = 0; i < STRIPS; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][f][j] = 0.f;

  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + static_cast<size_t>(b) * Ci * plane;

  for (int c0 = 0; c0 < Ci; c0 += CK) {
    // threadIdx.x read anew through a volatile move, so that the compiler
    // recomputes the staging offsets below for each chunk instead of holding
    // them in registers across the loop (which spilled).
    int tid;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    __syncthreads();  // the previous chunk's fragments are read
    {
      float xv[HALO_STEPS];
#pragma unroll
      for (int j = 0; j < HALO_STEPS; ++j) {
        const int i = tid + j * T::THREADS;
        const int c = i / (T::HR * T::HC);
        const int gh = h0 + (i / T::HC) % T::HR - 1;
        const int gw = w0 + i % T::HC - 1;
        xv[j] = 0.f;
        if (i < T::HALO && c0 + c < Ci && gh >= 0 && gh < H && gw >= 0 && gw < W)
          xv[j] = xb[(c0 + c) * plane + static_cast<size_t>(gh) * W + gw];
      }
#pragma unroll
      for (int j = 0; j < HALO_STEPS; ++j) {
        const int i = tid + j * T::THREADS;
        const int at = i / (T::HR * T::HC) * T::PLANE + i % (T::HR * T::HC);
        if (i < T::HALO) split(xv[j], &xs_big[at], &xs_small[at]);
      }
    }
    {
      float4 wv[WVEC_STEPS];
#pragma unroll
      for (int j = 0; j < WVEC_STEPS; ++j) {
        const int q = tid + j * T::THREADS;
        const int n = q % (T::CO_T / 4) * 4;
        const int row = q / (T::CO_T / 4);  // tap * CK + k
        wv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < T::WVEC && co0 + n < cop)
          wv[j] = *reinterpret_cast<const float4*>(
              w + (static_cast<size_t>(row / CK) * cip + c0 + row % CK) * cop + co0 + n);
      }
#pragma unroll
      for (int j = 0; j < WVEC_STEPS; ++j) {
        const int q = tid + j * T::THREADS;
        if (q >= T::WVEC) continue;
        const int at = q / (T::CO_T / 4) * T::NS + q % (T::CO_T / 4) * 4;
        uint4 big, small;
        split(wv[j].x, &big.x, &small.x);
        split(wv[j].y, &big.y, &small.y);
        split(wv[j].z, &big.z, &small.z);
        split(wv[j].w, &big.w, &small.w);
        *reinterpret_cast<uint4*>(&ws_big[at]) = big;
        *reinterpret_cast<uint4*>(&ws_small[at]) = small;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap - 3 * kh;
      // A fragments: pixel rows g and g + 8 of the strip, k-columns t and
      // t + 4 (input channels), read from the halo shifted by (kh, kw).
      uint32_t a_big[STRIPS][4], a_small[STRIPS][4];
#pragma unroll
      for (int i = 0; i < STRIPS; ++i) {
        const int at = t * T::PLANE + (srow[i] + kh) * T::HC + scol[i] + kw + g;
        const int offs[4] = {0, 8, 4 * T::PLANE, 4 * T::PLANE + 8};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a_big[i][j] = xs_big[at + offs[j]];
          a_small[i][j] = xs_small[at + offs[j]];
        }
      }
      // Output-channel fragments FG at a time: the three products of each
      // (strip, fragment) tile of a group are issued term by term, so that
      // consecutive mma instructions do not wait on each other.
#pragma unroll
      for (int f0 = 0; f0 < NF; f0 += T::FG) {
        // B fragments: k-rows t and t + 4, output channel f * 8 + g.
        uint32_t b_big[T::FG][2], b_small[T::FG][2];
#pragma unroll
        for (int f = 0; f < T::FG; ++f) {
          const int at = (tap * CK + t) * T::NS + (f0 + f) * 8 + g;
          b_big[f][0] = ws_big[at];
          b_big[f][1] = ws_big[at + 4 * T::NS];
          b_small[f][0] = ws_small[at];
          b_small[f][1] = ws_small[at + 4 * T::NS];
        }
        float d[T::FG][STRIPS][4];
#pragma unroll
        for (int f = 0; f < T::FG; ++f)
#pragma unroll
          for (int i = 0; i < STRIPS; ++i) mma_tf32_first(d[f][i], a_small[i], b_big[f]);
#pragma unroll
        for (int f = 0; f < T::FG; ++f)
#pragma unroll
          for (int i = 0; i < STRIPS; ++i) mma_tf32(d[f][i], a_big[i], b_small[f]);
#pragma unroll
        for (int f = 0; f < T::FG; ++f)
#pragma unroll
          for (int i = 0; i < STRIPS; ++i) mma_tf32(d[f][i], a_big[i], b_big[f]);
#pragma unroll
        for (int f = 0; f < T::FG; ++f)
#pragma unroll
          for (int i = 0; i < STRIPS; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][f0 + f][j] += d[f][i][j];
      }
    }
  }

  // C fragment: element 2 * half + j is pixel g + 8 * half of the strip and
  // output channel f * 8 + 2 * t + j.
  float* yb = y + static_cast<size_t>(b) * Co * plane;
#pragma unroll
  for (int i = 0; i < STRIPS; ++i) {
    const int gh = h0 + srow[i];
    if (gh >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gw = w0 + scol[i] + g + 8 * half;
      if (gw >= W) continue;
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + f * 8 + 2 * t + j;
          if (co >= Co) continue;
          float v = acc[i][f][2 * half + j] + bias[co];
          if (relu) v = fmaxf(v, 0.f);
          yb[co * plane + static_cast<size_t>(gh) * W + gw] = v;
        }
    }
  }
}

// The tile of a shape: TW by W, NF by Co. Calls fn(Tile<TW, NF>{}, kernel).
template <typename Fn>
auto with_tile(int Co, int W, Fn fn) {
  auto pick = [&](auto tw) {
    constexpr int TW = decltype(tw)::value;
    if (Co <= 8) return fn(Tile<TW, 1>{}, conv3x3_tf32x3_kernel<TW, 1>);
    if (Co <= 16) return fn(Tile<TW, 2>{}, conv3x3_tf32x3_kernel<TW, 2>);
    if (Co <= 32) return fn(Tile<TW, 4>{}, conv3x3_tf32x3_kernel<TW, 4>);
    return fn(Tile<TW, 8>{}, conv3x3_tf32x3_kernel<TW, 8>);
  };
  return W % 32 == 0 ? pick(std::integral_constant<int, 32>{})
                     : pick(std::integral_constant<int, 16>{});
}

}  // namespace

// Shared bytes of one block for an output of Co channels and W columns; the
// host refuses a shape above the 227 KB a block may have before launching.
extern "C" size_t mm_conv3x3_f32_smem_bytes(int Co, int W) {
  return with_tile(Co, W, [](auto tile, auto) { return decltype(tile)::SMEM; });
}

extern "C" int mm_conv3x3_f32(const void* x, const void* w, const void* bias, void* y, int B,
                              int Ci, int Co, int H, int W, int relu, void* stream) {
  return with_tile(Co, W, [&](auto tile, auto kernel) {
    using T = decltype(tile);
    const int status = mm::opt_in_smem(reinterpret_cast<const void*>(kernel),
                                       static_cast<int>(T::SMEM));
    if (status != 0) return status;
    const int tw = T::HC - 2;
    const dim3 grid(((W + tw - 1) / tw) * ((H + TH - 1) / TH), (Co + T::CO_T - 1) / T::CO_T, B);
    kernel<<<grid, T::THREADS, T::SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), Ci, Co, H, W, relu);
    return static_cast<int>(cudaGetLastError());
  });
}
