// 3x3 SAME stride-1 convolution with bias and optional fused ReLU, NCHW,
// bfloat16 inputs with float32 sums.
//
// Replaces: mm_masking_tpu/ops/pallas/conv2d.py::_conv_nhcw_raw (kernel body
// _fwd_kernel), the Pallas TPU kernel behind conv3x3_nhcw that carries every
// UNet 3x3 conv, for bfloat16 inputs (model.dtype = "bfloat16"); float32
// inputs run the tensor-core kernel of conv3x3_tc.cu. The TPU kernel ran in
// (B, H, C, W) so that W filled the 128-wide lanes; on the GPU the port keeps
// PyTorch's NCHW.
//
// What bounds it on this card: the UNet's convs are small-channel (Ci, Co of
// 1..256) and run at 640^2..40^2. The 640^2 stages at 1..16 channels sit near
// the HBM roofline; from 32 channels on they are bound by the fp32 issue
// rate, since this kernel uses the CUDA cores, not the tensor cores.
//
// Design: one block computes a TH x TW = 16 x 32 output tile for a chunk of
// CO_BLK output channels. It stages the input tile plus its 1-pixel halo,
// CI_BLK input channels at a time, in shared memory (zero outside the image,
// which is SAME padding), together with that chunk's weights laid out
// (ci, tap, co). Each thread owns PIX = 4 vertically adjacent pixels of one
// column and CO_BLK output channels in registers: per input channel it reads
// 3 x 6 activations and 9 weight vectors (broadcast, as float4) from shared
// memory for 4 * 9 * CO_BLK multiply-adds. Accumulation is in f32 registers;
// the epilogue adds the bias, applies the ReLU and rounds to bfloat16. Ci is
// handled as it comes (Ci = 1 runs one channel, no padding to 8). Speed
// (tensor cores through mma.sync m16n8k16 or wgmma, staging through a
// cp.async or TMA ring) is work for later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;       // tile width: one warp spans a row of the tile
constexpr int TH = 16;       // tile height
constexpr int PIX = 4;       // output rows per thread
constexpr int CI_BLK = 8;    // input channels staged per shared-memory pass
constexpr int THREADS = TW * (TH / PIX);

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// x (B, Ci, H, W); w (Ci, 9, Co) f32, tap = 3 * kh + kw; bias (Co,) f32;
// y (B, Co, H, W). grid = (ceil(W/TW), ceil(H/TH), B * n_co_blk).
template <typename T, int CO_BLK>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               int Ci, int Co, int H, int W, int relu, int n_co_blk) {
  __shared__ float s_in[CI_BLK][TH + 2][TW + 2];
  __shared__ __align__(16) float s_w[CI_BLK][9][CO_BLK];

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z / n_co_blk;
  const int co0 = (blockIdx.z % n_co_blk) * CO_BLK;

  float acc[PIX][CO_BLK];
#pragma unroll
  for (int p = 0; p < PIX; ++p)
#pragma unroll
    for (int co = 0; co < CO_BLK; ++co) acc[p][co] = 0.f;

  const size_t plane = static_cast<size_t>(H) * W;
  const T* xb = x + static_cast<size_t>(b) * Ci * plane;
  constexpr int TILE = (TH + 2) * (TW + 2);

  for (int c0 = 0; c0 < Ci; c0 += CI_BLK) {
    const int nc = min(CI_BLK, Ci - c0);
    __syncthreads();  // previous chunk's reads are done
    for (int i = threadIdx.x; i < nc * TILE; i += THREADS) {
      const int c = i / TILE;
      const int r = (i % TILE) / (TW + 2);
      const int col = i % (TW + 2);
      const int gh = h0 + r - 1;
      const int gw = w0 + col - 1;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = load_f(xb + (c0 + c) * plane + static_cast<size_t>(gh) * W + gw);
      s_in[c][r][col] = v;
    }
    for (int i = threadIdx.x; i < nc * 9 * CO_BLK; i += THREADS) {
      const int c = i / (9 * CO_BLK);
      const int k = (i / CO_BLK) % 9;
      const int co = i % CO_BLK;
      s_w[c][k][co] = (co0 + co < Co)
          ? w[(static_cast<size_t>(c0 + c) * 9 + k) * Co + co0 + co] : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[PIX + 2];
#pragma unroll
        for (int r = 0; r < PIX + 2; ++r) v[r] = s_in[c][ty * PIX + r][tx + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float wv[CO_BLK];
#pragma unroll
          for (int co = 0; co < CO_BLK; co += 4) {
            const float4 q = *reinterpret_cast<const float4*>(&s_w[c][dy * 3 + dx][co]);
            wv[co] = q.x; wv[co + 1] = q.y; wv[co + 2] = q.z; wv[co + 3] = q.w;
          }
#pragma unroll
          for (int p = 0; p < PIX; ++p)
#pragma unroll
            for (int co = 0; co < CO_BLK; ++co)
              acc[p][co] = fmaf(v[p + dy], wv[co], acc[p][co]);
        }
      }
    }
  }

  const int gw = w0 + tx;
  if (gw >= W) return;
  T* yb = y + static_cast<size_t>(b) * Co * plane;
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const int gh = h0 + ty * PIX + p;
    if (gh >= H) continue;
#pragma unroll
    for (int co = 0; co < CO_BLK; ++co) {
      if (co0 + co >= Co) continue;
      float val = acc[p][co] + bias[co0 + co];
      if (relu) val = fmaxf(val, 0.f);
      store_f(yb + (co0 + co) * plane + static_cast<size_t>(gh) * W + gw, val);
    }
  }
}

template <typename T>
int launch(const T* x, const float* w, const float* bias, T* y, int B, int Ci,
           int Co, int H, int W, int relu, cudaStream_t stream) {
  const dim3 block(THREADS);
  if (Co <= 8) {
    const int n_co_blk = (Co + 7) / 8;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_co_blk);
    conv3x3_kernel<T, 8><<<grid, block, 0, stream>>>(x, w, bias, y, Ci, Co, H, W,
                                                     relu, n_co_blk);
  } else {
    const int n_co_blk = (Co + 15) / 16;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_co_blk);
    conv3x3_kernel<T, 16><<<grid, block, 0, stream>>>(x, w, bias, y, Ci, Co, H, W,
                                                      relu, n_co_blk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mm_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                               int B, int Ci, int Co, int H, int W, int relu,
                               void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), B, Ci,
                Co, H, W, relu, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
