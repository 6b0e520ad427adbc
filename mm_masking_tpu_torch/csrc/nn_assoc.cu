// Nearest-neighbour argmin of scan points against a map, dense or over a
// per-tile window of map blocks ("sorted stripe").
//
// Replaces two Pallas TPU kernels of mm_masking_tpu/ops/pallas/nn_assoc.py
// whose bodies differ only in the map block they start from:
//   * _nn_argmin_pallas_fmt (body _nn_kernel): dense argmin over all M points;
//   * _nn_stripe_pallas (body _nn_stripe_kernel): each 256-row scan tile scans
//     nblk[b, t] map blocks of tm points from block start_blk[b, t]; nblk = 0
//     skips the tile (the ICP's per-item freeze) and writes nothing.
// One __global__ serves both: dense is start 0 with all of M.
//
// What bounds it on this card: fp32 issue rate. Each (scan, map) pair costs
// 3 subtractions, 3 multiplies, 2 adds, a compare and a select; the map is
// read once per block from L2/HBM and reused by every row of the tile, so the
// bytes are negligible next to the arithmetic (at B=32, N=4096, M=16384 the
// dense pass is 2.1e9 pairs).
//
// Design: one thread per scan row, blockDim.x rows per block. The map is
// staged through shared memory in tiles of MAP_TILE points as float4
// (x, y, z, 0), so a thread reads a point with one broadcast 16-byte load.
// A block reads its own start/count from device memory (there is no scalar
// prefetch on a GPU). Distances use the exact (p - q)^2 form in fp32 with
// round-to-nearest intrinsics, so no multiply-add is contracted and d2 is
// bit-identical to the plain PyTorch version's dx*dx + dy*dy + dz*dz;
// reduced-precision (TF32) distances pick wrong neighbours. Map indices are
// scanned in ascending order with a strict <, so the first occurrence of the
// minimum wins, as in the TPU kernel and torch.argmin.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MAP_TILE = 2048;  // float4 map points per shared-memory pass (32 KB)

// p (B, N, 3) f32; q (B, M) float4; start_blk/nblk (B, T) int32 or null
// (dense); idx/d2 (B, N). grid = (T, B), T = ceil(N / blockDim.x).
__global__ void nn_argmin_kernel(const float* __restrict__ p,
                                 const float4* __restrict__ q,
                                 const int* __restrict__ start_blk,
                                 const int* __restrict__ nblk, int N, int M, int tm,
                                 int* __restrict__ idx, float* __restrict__ d2) {
  __shared__ float4 sq[MAP_TILE];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int T = gridDim.x;

  int lo = 0;
  int hi = M;
  if (nblk != nullptr) {
    const int nb = nblk[b * T + t];
    if (nb <= 0) return;  // whole block leaves before any barrier
    lo = start_blk[b * T + t] * tm;
    hi = min(M, lo + nb * tm);
  }

  const int row = t * blockDim.x + threadIdx.x;
  const bool live = row < N;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    const float* pr = p + (static_cast<size_t>(b) * N + row) * 3;
    px = pr[0];
    py = pr[1];
    pz = pr[2];
  }

  const float4* qb = q + static_cast<size_t>(b) * M;
  float best = CUDART_INF_F;
  int best_j = 0;
  for (int base = lo; base < hi; base += MAP_TILE) {
    const int n = min(MAP_TILE, hi - base);
    __syncthreads();  // previous tile's reads are done
    for (int j = threadIdx.x; j < n; j += blockDim.x) sq[j] = qb[base + j];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 v = sq[j];
      const float dx = __fsub_rn(px, v.x);
      const float dy = __fsub_rn(py, v.y);
      const float dz = __fsub_rn(pz, v.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_j = base + j;
      }
    }
  }
  if (live) {
    idx[static_cast<size_t>(b) * N + row] = best_j;
    d2[static_cast<size_t>(b) * N + row] = best;
  }
}

}  // namespace

extern "C" int mm_nn_argmin(const void* p, const void* q, const void* start_blk,
                            const void* nblk, int B, int N, int M, int rows, int tm,
                            void* idx, void* d2, void* stream) {
  const dim3 grid((N + rows - 1) / rows, B);
  nn_argmin_kernel<<<grid, rows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float4*>(q),
      static_cast<const int*>(start_blk), static_cast<const int*>(nblk), N, M, tm,
      static_cast<int*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}

// The text of a CUDA error code that an entry of the library returned
// (ops/kernels/_build.py::launch raises with it).
extern "C" const char* mm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
