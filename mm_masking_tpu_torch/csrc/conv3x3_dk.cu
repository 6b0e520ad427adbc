// Weight gradient of the 3x3 SAME stride-1 convolution, NCHW, float32 inputs
// and result, on the CUDA cores.
//
// Replaces: mm_masking_tpu/ops/pallas/conv2d.py::_dk_nhcw_raw (kernel body
// _dk_kernel, pallas_call at :184), the Pallas TPU kernel in the conv's
// custom VJP that accumulates dk(9Ci, Co) = sum over the batch and rows of
// X9 . dy^T, for float32 inputs. bfloat16 inputs run the tensor-core GEMM of
// conv3x3_dk_tc.cu.
//
//   dk[co][ci][kh][kw] = sum_{b,h,w} dy[b][co][h][w] * x[b][ci][h+kh-1][w+kw-1]
//
// (x zero outside the image). The TPU kernel carried dk in its output block
// across a sequential (batch, row-tile) grid. Blocks on the GPU run in no
// order, so the reduction over B*H*W takes two passes and no float atomics:
//
//   pass one (conv3x3_dk_partial): a block owns an output tile of CI_T input
//     channels x CO_T = COG * 8 output channels x 9 taps and a chunk of
//     consecutive spatial tiles (b, 8 rows, 32 columns). It writes the tile's
//     f32 partial sums for that chunk into scratch (n_chunks, Co, Ci, 9);
//   pass two (conv3x3_dk_sum, dk_chunk_sum.cuh, shared with conv3x3_dk_tc.cu):
//     one thread per output element sums the chunks in chunk order.
//
// Every sum runs in a fixed order, so two runs give the same bits.
//
// What bounds it on this card: the UNet's shapes span two extremes. At
// 1->8, 640^2, B = 16 there are 72 outputs, each a sum over 6.5 M terms: the
// work must be split over pixels (many chunks, many lanes per output). At
// 256->256, 40^2 there are 589,824 outputs over 25,600 terms each: the
// channel tiles alone fill the card. Per tile, a thread keeps 9 taps x 8
// output channels in registers and slides a 3x3 window of x along its run of
// S pixels of one row: per pixel 3 x loads and 8 dy loads from shared
// memory feed 72 fp32 FMAs on the CUDA cores. The staging of x and dy into
// shared memory, a barrier per spatial tile, keeps it far below the fp32
// peak: about 10.5 of 67 TFLOP/s at 256->256, 40^2, B = 16 (H100 SXM,
// 700 W).
// The channel tile and the number of pixel lanes per output adapt to Ci and
// Co (templates below), and the host sizes the chunks so that each shape
// launches about 8 blocks per SM. The tensor cores (conv3x3_dk_tc.cu's GEMM
// in 3xTF32) and TMA are later work.
#include <cuda_runtime.h>

#include "dk_chunk_sum.cuh"

namespace {

constexpr int TH = 8;         // spatial tile: rows
constexpr int TW = 32;        // spatial tile: columns
constexpr int THREADS = 256;
constexpr int CO_R = 8;       // output channels per thread
constexpr int TARGET_BLOCKS = 132 * 8;

struct Tiling {
  int ci_t, cog, n_ci_t, n_co_t, n_tiles;
};

Tiling tiling(int B, int Ci, int Co, int H, int W) {
  Tiling t;
  t.ci_t = Ci == 1 ? 1 : (Ci <= 4 ? 4 : 8);
  t.cog = Co <= CO_R ? 1 : 2;
  t.n_ci_t = (Ci + t.ci_t - 1) / t.ci_t;
  t.n_co_t = (Co + t.cog * CO_R - 1) / (t.cog * CO_R);
  t.n_tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return t;
}

int chunk_count(const Tiling& t) {
  const int channel_blocks = t.n_ci_t * t.n_co_t;
  int n = (TARGET_BLOCKS + channel_blocks - 1) / channel_blocks;
  n = n < 1 ? 1 : (n > t.n_tiles ? t.n_tiles : n);
  const int per_chunk = (t.n_tiles + n - 1) / n;
  return (t.n_tiles + per_chunk - 1) / per_chunk;
}

// x (B, Ci, H, W), dy (B, Co, H, W) -> partial (n_chunks, Co, Ci, 9) f32.
// grid = (n_ci_t * n_co_t, n_chunks).
template <int CI_T, int COG>
__global__ void __launch_bounds__(THREADS)
conv3x3_dk_partial(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ partial, int B, int Ci, int Co, int H, int W,
                   int n_ci_t, int tiles_per_chunk) {
  constexpr int CO_T = COG * CO_R;
  constexpr int COMBOS = CI_T * COG;    // (input channel, output group) pairs
  constexpr int P = THREADS / COMBOS;   // pixel lanes per pair
  constexpr int S = TH * TW / P;        // pixels per lane, a run in one row
  static_assert(TW % S == 0, "a lane's run must stay within one row");
  constexpr int XW = TW + 2;            // x tile with its 1-pixel halo
  constexpr int DW = TW + 1;            // padded dy row (bank spread)
  constexpr int DPLANE = TH * DW + 1;
  constexpr int WIDTH = P < 32 ? P : 32;  // lanes of one pair within a warp

  __shared__ float xs[CI_T][TH + 2][XW];
  __shared__ float dys[CO_T * DPLANE];
  __shared__ float red[THREADS / 32][9 * CO_R];

  const int pair = threadIdx.x / P;
  const int lane = threadIdx.x % P;
  const int ci_l = pair / COG;
  const int cog = pair % COG;
  const int ci0 = (blockIdx.x % n_ci_t) * CI_T;
  const int co0 = (blockIdx.x / n_ci_t) * CO_T;
  const int r = lane * S / TW;   // the lane's row in the tile
  const int c0 = lane * S % TW;  // and the first column of its run

  const int n_tw = (W + TW - 1) / TW;
  const int n_th = (H + TH - 1) / TH;
  const int n_tiles = B * n_th * n_tw;
  const int t_begin = blockIdx.y * tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + tiles_per_chunk);
  const size_t plane = static_cast<size_t>(H) * W;

  float acc[9][CO_R];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int k = 0; k < CO_R; ++k) acc[i][k] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / (n_th * n_tw);
    const int h0 = (t / n_tw) % n_th * TH;
    const int w0 = t % n_tw * TW;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < CI_T * (TH + 2) * XW; i += THREADS) {
      const int c = i / ((TH + 2) * XW);
      const int rr = i / XW % (TH + 2);
      const int cc = i % XW;
      const int gh = h0 + rr - 1;
      const int gw = w0 + cc - 1;
      float v = 0.f;
      if (ci0 + c < Ci && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = x[(static_cast<size_t>(b) * Ci + ci0 + c) * plane +
              static_cast<size_t>(gh) * W + gw];
      xs[c][rr][cc] = v;
    }
    for (int i = threadIdx.x; i < CO_T * TH * TW; i += THREADS) {
      const int c = i / (TH * TW);
      const int rr = i / TW % TH;
      const int cc = i % TW;
      const int gh = h0 + rr;
      const int gw = w0 + cc;
      float v = 0.f;  // pixels past the image edge contribute nothing
      if (co0 + c < Co && gh < H && gw < W)
        v = dy[(static_cast<size_t>(b) * Co + co0 + c) * plane +
               static_cast<size_t>(gh) * W + gw];
      dys[c * DPLANE + rr * DW + cc] = v;
    }
    __syncthreads();

    float win[3][3];  // x[ci][h + kh - 1][w + kw - 1] around the current pixel
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      win[kh][1] = xs[ci_l][r + kh][c0];
      win[kh][2] = xs[ci_l][r + kh][c0 + 1];
    }
    const float* d_row = dys + cog * CO_R * DPLANE + r * DW;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int c = c0 + j;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        win[kh][0] = win[kh][1];
        win[kh][1] = win[kh][2];
        win[kh][2] = xs[ci_l][r + kh][c + 2];
      }
      float d[CO_R];
#pragma unroll
      for (int k = 0; k < CO_R; ++k) d[k] = d_row[k * DPLANE + c];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int k = 0; k < CO_R; ++k)
            acc[kh * 3 + kw][k] = fmaf(win[kh][kw], d[k], acc[kh * 3 + kw][k]);
    }
  }

  // Sum the P lanes of each pair in a fixed order: a shuffle tree within
  // the warp, then (P > 32) the warps of the pair in warp order.
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int k = 0; k < CO_R; ++k) {
      float v = acc[i][k];
#pragma unroll
      for (int off = WIDTH / 2; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off, WIDTH);
      acc[i][k] = v;
    }

  float* out = partial + static_cast<size_t>(blockIdx.y) * Co * Ci * 9;
  if constexpr (P <= 32) {
    if (lane != 0) return;
    const int ci = ci0 + ci_l;
    if (ci >= Ci) return;
#pragma unroll
    for (int k = 0; k < CO_R; ++k) {
      const int co = co0 + cog * CO_R + k;
      if (co >= Co) continue;
#pragma unroll
      for (int i = 0; i < 9; ++i)
        out[(static_cast<size_t>(co) * Ci + ci) * 9 + i] = acc[i][k];
    }
  } else {
    constexpr int WARPS = P / 32;  // warps per pair
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int k = 0; k < CO_R; ++k) red[threadIdx.x / 32][i * CO_R + k] = acc[i][k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < COMBOS * 9 * CO_R; e += THREADS) {
      const int p = e / (9 * CO_R);
      const int i = e / CO_R % 9;
      const int k = e % CO_R;
      const int ci = ci0 + p / COG;
      const int co = co0 + p % COG * CO_R + k;
      if (ci >= Ci || co >= Co) continue;
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[p * WARPS + w][i * CO_R + k];
      out[(static_cast<size_t>(co) * Ci + ci) * 9 + i] = s;
    }
  }
}

template <int CI_T, int COG>
void launch_partial(const float* x, const float* dy, float* partial, int B, int Ci, int Co,
                    int H, int W, const Tiling& t, int n_chunks, cudaStream_t stream) {
  const int per_chunk = (t.n_tiles + n_chunks - 1) / n_chunks;
  const dim3 grid(t.n_ci_t * t.n_co_t, n_chunks);
  conv3x3_dk_partial<CI_T, COG><<<grid, THREADS, 0, stream>>>(
      x, dy, partial, B, Ci, Co, H, W, t.n_ci_t, per_chunk);
}

int launch(const float* x, const float* dy, float* partial, float* dk, int B, int Ci, int Co,
           int H, int W, int n_chunks, cudaStream_t stream) {
  const Tiling t = tiling(B, Ci, Co, H, W);
  if (n_chunks != chunk_count(t)) return static_cast<int>(cudaErrorInvalidValue);
#define MM_DK_CASE(CI_T, COG)                                                         \
  if (t.ci_t == CI_T && t.cog == COG)                                                 \
    launch_partial<CI_T, COG>(x, dy, partial, B, Ci, Co, H, W, t, n_chunks, stream);
  MM_DK_CASE(1, 1) MM_DK_CASE(1, 2) MM_DK_CASE(4, 1) MM_DK_CASE(4, 2)
  MM_DK_CASE(8, 1) MM_DK_CASE(8, 2)
#undef MM_DK_CASE
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mm::sum_chunks(partial, dk, Co * Ci * 9, n_chunks, stream);
}

}  // namespace

// Number of chunks (the first dimension of the partial-sum scratch) that
// mm_conv3x3_dk_f32 uses for this shape.
extern "C" int mm_conv3x3_dk_chunks(int B, int Ci, int Co, int H, int W) {
  return chunk_count(tiling(B, Ci, Co, H, W));
}

// x, dy f32; partial (n_chunks, Co, Ci, 9) f32 scratch; dk (Co, Ci, 3, 3) f32.
extern "C" int mm_conv3x3_dk_f32(const void* x, const void* dy, void* partial, void* dk,
                                 int B, int Ci, int Co, int H, int W, int n_chunks,
                                 void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(dy),
                static_cast<float*>(partial), static_cast<float*>(dk), B, Ci, Co, H, W,
                n_chunks, static_cast<cudaStream_t>(stream));
}
